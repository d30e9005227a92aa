"""Shared neural building blocks: RMSNorm, RoPE, GQA attention (prefill and
training through the flash kernel, decode against the KV cache), MLPs.

The counterpart of `repro.models.layers` for one card: no `Sharder`. The norm
and the prefill attention go through the kernel wrappers in `kernels.ops`;
decode attention and the matrix products have no Pallas kernel in the JAX
package and stay plain PyTorch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=eps)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs          # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd).reshape(b, s, kh * n_rep, hd)


def attention(q, k, v, *, causal: bool = True, q_block: int = 256) -> torch.Tensor:
    """Prefill and training attention through the flash kernel. q: (B, S, H, hd);
    k, v: (B, S, K, hd) with K | H. `q_block` is the backward's query block
    (`cfg.q_block`, as the JAX package's blockwise attention)."""
    h, kh = q.shape[2], k.shape[2]
    return ops.flash_attention(q, _repeat_kv(k, h // kh), _repeat_kv(v, h // kh),
                               causal=causal, q_block=q_block)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token attention against the KV cache.

    q: (B, 1, H, hd); caches: (B, S, K, hd); pos: index of the current token
    (the caches already hold it). GQA stays grouped: q is reshaped to
    (B, 1, K, G, hd) and contracted against the K-head cache. The products
    accumulate in fp32 and the probabilities are cast to the cache dtype before
    the PV product, as the JAX package does."""
    b, s, kh, hd = k_cache.shape
    h = q.shape[2]
    g = h // kh
    qg = q.reshape(b, 1, kh, g, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device) <= pos)[None, None, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def mlp(x: torch.Tensor, params) -> torch.Tensor:
    """swiglu: silu(x@w1) * (x@w3) @ w2."""
    return (F.silu(x @ params["w1"]) * (x @ params["w3"])) @ params["w2"]
