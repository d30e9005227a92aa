"""Dense decoder-only transformer (stablelm / mistral / qwen / smollm): the
counterpart of the dense parts of `repro.models.transformer` for one card.

Params are nested mappings of tensors with the JAX package's names, stacked
along a leading L axis and laid out for `x @ W` (not `nn.Linear`'s transposed
layout), so params move between the two packages name for name. The layers
run as a Python loop over that axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from .layers import apply_rope, attention, decode_attention, mlp, rms_norm

PARAM_DTYPE = torch.bfloat16


def dense_param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    """name -> shape, nested as the JAX package's param tree (swiglu MLP,
    separate q/k/v projections: what every dense config uses)."""
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lyr: Dict[str, Any] = {"ln1": (L, D), "wo": (L, H * hd, D), "ln2": (L, D),
                           "wq": (L, D, H * hd), "wk": (L, D, K * hd), "wv": (L, D, K * hd)}
    if cfg.qkv_bias:
        lyr["bq"] = (L, H * hd)
        lyr["bk"] = (L, K * hd)
        lyr["bv"] = (L, K * hd)
    lyr["mlp"] = {"w1": (L, D, F), "w2": (L, F, D), "w3": (L, D, F)}
    defs: Dict[str, Any] = {"emb": (V, D), "layers": lyr, "ln_f": (D,)}
    if not cfg.tie_embeddings:
        defs["head"] = (V, D)
    return defs


def _layer_slice(lyr, i: int):
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in lyr.items()}


def attn_block(x, lp, cfg: ModelConfig, positions, kv, pos: Optional[int] = None):
    """Pre-norm attention block. kv = (k_cache, v_cache), (B, S, K, hd) each,
    updated in place (the JAX package returns new caches; writing in place
    keeps one cache in device memory). pos=None is a prefill, which writes the
    whole prompt and attends over the fresh k and v through the flash kernel;
    pos=int is a one-token decode at that position."""
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["ln1"])
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = apply_rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, K, hd)
    k_cache, v_cache = kv
    if pos is None:
        k_cache[:, :S] = k.to(k_cache.dtype)
        v_cache[:, :S] = v.to(v_cache.dtype)
        o = attention(q, k, v)
    else:
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, pos)
    return o.reshape(B, S, H * hd) @ lp["wo"]


def ffn_block(x, lp):
    return mlp(rms_norm(x, lp["ln2"]), lp["mlp"])


def transformer_layer(x, lp, cfg: ModelConfig, positions, kv, pos: Optional[int] = None):
    x = x + attn_block(x, lp, cfg, positions, kv, pos)
    return x + ffn_block(x, lp)


def embed_tokens(params, tokens):
    return params["emb"][tokens]                   # (B, S, D)


def unembed(params, x, cfg: ModelConfig):
    head = params["emb"] if cfg.tie_embeddings else params["head"]
    return torch.einsum("bsd,vd->bsv", x, head)


def forward_with_cache(params, x, cfg: ModelConfig, positions, cache, pos: Optional[int] = None):
    """Prefill (pos=None) or single-token decode (pos=int). x: (B, S, D)
    embeddings; cache: {"k": (L, B, S, K, hd), "v": ...}, updated in place."""
    lyr = params["layers"]
    for i in range(cfg.n_layers):
        x = transformer_layer(x, _layer_slice(lyr, i), cfg, positions,
                              (cache["k"][i], cache["v"][i]), pos)
    return rms_norm(x, params["ln_f"]), cache
