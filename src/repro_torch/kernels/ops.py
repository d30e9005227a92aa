"""Public wrappers around the port's kernels, in the JAX package's layouts
(`repro.kernels.ops`).

Dispatch is by the tensors' device and by nothing else: CPU tensors take the
plain PyTorch version in `ref`; CUDA tensors take the hand-written kernel, and
the wrapper raises if it cannot build or launch it.

`rmsnorm` and `flash_attention` are differentiable: each is a
`torch.autograd.Function` whose forward is the kernel (or, on the CPU, the
plain version) and whose backward is written out in PyTorch ops. The JAX
package has no backward kernel for either; its gradients are autodiff of XLA
ops (`layers.rms_norm`, `layers.blockwise_attention`). The bucket codec's
kernels (K3, K4) and the sharded AdamW update (K5) are in `bucket_codec`;
their launches are counted here too.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from . import bucket_codec as _codec
from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rn


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    return dev


class _RMSNorm(torch.autograd.Function):
    """y = x * rsqrt(mean(x^2) + eps) * scale over rows of a (R, D) x, in fp32.

    Backward, with r = rsqrt(mean(x^2) + eps) and g = dy * scale:
    dx = r * (g - x * r^2 * mean(g * x)), dscale = sum over rows of dy * x * r;
    both in fp32, cast to the inputs' dtypes."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        if x.device.type == "cpu":
            return ref.rmsnorm_ref(x, scale, eps)
        return _rn.rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        xf, dyf = x.float(), dy.float()
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        g = dyf * scale.float()
        dx = r * (g - xf * (r * r) * torch.mean(g * xf, dim=-1, keepdim=True))
        dscale = torch.sum(dyf * xf * r, dim=0)
        return dx.to(x.dtype), dscale.to(scale.dtype), None


class _FlashAttention(torch.autograd.Function):
    """Attention over (BH, S, hd) q, k, v, kv already repeated to the heads.

    Backward walks the queries in blocks of `q_block` and recomputes each
    block's probabilities from q and k, as `blockwise_attention` recomputes
    per block under its checkpoint: it holds a (BH, q_block, S) fp32 tile,
    never (BH, S, S). Causal blocks stop at their last key. With P the
    block's probabilities: dV += Pᵀ dO, dP = dO Vᵀ,
    dS = P ∘ (dP − rowsum(P ∘ dP)), dQ = dS K / √hd, dK += dSᵀ Q / √hd,
    in fp32, cast to the inputs' dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.q_block = causal, q_block
        if q.device.type == "cpu":
            return ref.attention_ref(q, k, v, causal=causal)
        return _fa.flash_attention_fwd(q, k, v, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        bh, s, hd = q.shape
        scale = 1.0 / math.sqrt(hd)
        kf, vf = k.float(), v.float()
        dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        qb = max(1, min(int(ctx.q_block), s))
        for i0 in range(0, s, qb):
            i1 = min(i0 + qb, s)
            kend = i1 if ctx.causal else s
            qi, doi = q[:, i0:i1].float(), do[:, i0:i1].float()
            kk, vv = kf[:, :kend], vf[:, :kend]
            sc = torch.bmm(qi, kk.transpose(1, 2)) * scale              # (BH, qb, kend)
            if ctx.causal:
                mask = (torch.arange(i0, i1, device=q.device)[:, None]
                        >= torch.arange(kend, device=q.device)[None, :])
                sc = torch.where(mask[None], sc, torch.full_like(sc, -1e30))
            p = torch.softmax(sc, dim=-1)
            del sc
            dv[:, :kend] += torch.bmm(p.transpose(1, 2), doi)
            dp = torch.bmm(doi, vv.transpose(1, 2))
            ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
            del p, dp
            dq[:, i0:i1] = torch.bmm(ds, kk) * scale
            dk[:, :kend] += torch.bmm(ds.transpose(1, 2), qi) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, *, causal: bool = True, q_block: int = 256) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) (kv already repeated to H heads).
    Returns (B, S, H, hd). `q_block` is the backward's query block."""
    _device(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k, v of one shape (B, S, H, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    fold = lambda t: t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    out = _FlashAttention.apply(fold(q), fold(k), fold(v), causal, q_block)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def rmsnorm(x, scale, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,)."""
    _device(x, scale)
    shape = x.shape
    out = _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), scale.contiguous(), eps)
    return out.reshape(shape)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {"rmsnorm": _rn.launches, "flash_attention": _fa.launches,
            "bucket_pack": _codec.pack_launches, "bucket_unpack": _codec.unpack_launches,
            "adamw_shard": _codec.adamw_launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches = 0
    _codec.pack_launches = 0
    _codec.unpack_launches = 0
    _codec.adamw_launches = 0
