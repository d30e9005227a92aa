"""Dense decoder-only transformer (stablelm / mistral / qwen / smollm): the
counterpart of the dense parts of `repro.models.transformer` for one card.

Params are nested mappings of tensors with the JAX package's names, stacked
along a leading L axis and laid out for `x @ W` (not `nn.Linear`'s transposed
layout), so params move between the two packages name for name. The layers
run as a Python loop over that axis (the JAX package's `lax.scan`); under
`cfg.remat == "block"` the training forward checkpoints each layer, the
counterpart of `jax.checkpoint` on the scan body.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

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


def attn_block(x, lp, cfg: ModelConfig, positions, kv=None, pos: Optional[int] = None):
    """Pre-norm attention block. kv = (k_cache, v_cache), (B, S, K, hd) each,
    updated in place (the JAX package returns new caches; writing in place
    keeps one cache in device memory). kv=None is the training forward, which
    attends over the fresh k and v through the flash kernel; with a cache,
    pos=None is a prefill, which also writes the whole prompt into it, and
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
    if kv is None:
        o = attention(q, k, v, q_block=cfg.q_block)
    elif pos is None:
        k_cache, v_cache = kv
        k_cache[:, :S] = k.to(k_cache.dtype)
        v_cache[:, :S] = v.to(v_cache.dtype)
        o = attention(q, k, v, q_block=cfg.q_block)
    else:
        k_cache, v_cache = kv
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        o = decode_attention(q, k_cache, v_cache, pos)
    return o.reshape(B, S, H * hd) @ lp["wo"]


def ffn_block(x, lp):
    return mlp(rms_norm(x, lp["ln2"]), lp["mlp"])


def transformer_layer(x, lp, cfg: ModelConfig, positions, kv=None, pos: Optional[int] = None):
    x = x + attn_block(x, lp, cfg, positions, kv, pos)
    return x + ffn_block(x, lp)


def embed_tokens(params, tokens):
    return params["emb"][tokens]                   # (B, S, D)


def unembed(params, x, cfg: ModelConfig):
    head = params["emb"] if cfg.tie_embeddings else params["head"]
    return torch.einsum("bsd,vd->bsv", x, head)


def _layer_slices(lyr, n: int) -> List[Dict[str, Any]]:
    """The L stacked layer params as L per-layer dicts of views. One `unbind`
    per leaf, so backward stacks each leaf's L gradients once instead of
    scattering into a full-size zero tensor per layer."""
    flat = {k: _layer_slices(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in lyr.items()}
    return [{k: v[i] for k, v in flat.items()} for i in range(n)]


def forward(params, x, cfg: ModelConfig, positions):
    """Training trunk (no cache). x: (B, S, D) embeddings; returns the final
    normed hidden states. Under `cfg.remat == "block"`, while autograd
    records, each layer runs through `torch.utils.checkpoint` (non-reentrant):
    its activations are recomputed in backward, so the kernels of a layer's
    forward launch twice per training step."""
    remat = cfg.remat == "block" and torch.is_grad_enabled()
    for lp in _layer_slices(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(transformer_layer, x, lp, cfg, positions, use_reentrant=False)
        else:
            x = transformer_layer(x, lp, cfg, positions)
    return rms_norm(x, params["ln_f"])


def token_nll(logits, targets):
    """Per-token negative log-likelihood in fp32: logsumexp - gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return lse - gold


def cross_entropy(logits, targets):
    """Mean token cross-entropy in fp32 (the JAX package's `cross_entropy`
    without a mask; its masked sum picks the same gold logit as `gather`)."""
    return torch.mean(token_nll(logits, targets))


def forward_with_cache(params, x, cfg: ModelConfig, positions, cache, pos: Optional[int] = None):
    """Prefill (pos=None) or single-token decode (pos=int). x: (B, S, D)
    embeddings; cache: {"k": (L, B, S, K, hd), "v": ...}, updated in place."""
    for i, lp in enumerate(_layer_slices(params["layers"], cfg.n_layers)):
        x = transformer_layer(x, lp, cfg, positions, (cache["k"][i], cache["v"][i]), pos)
    return rms_norm(x, params["ln_f"]), cache
