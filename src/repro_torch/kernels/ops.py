"""Public wrappers around the port's kernels, in the JAX package's layouts
(`repro.kernels.ops`).

Dispatch is by the tensors' device and by nothing else: CPU tensors take the
plain PyTorch version in `ref`; CUDA tensors take the hand-written kernel, and
the wrapper raises if it cannot build or launch it.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import flash_attention as _fa
from . import ref
from . import rmsnorm as _rn


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts[1:]):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    return dev


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, S, H, hd) (kv already repeated to H heads).
    Returns (B, S, H, hd)."""
    dev = _device(q, k, v)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention needs q, k, v of one shape (B, S, H, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, hd = q.shape
    fold = lambda t: t.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    if dev.type == "cpu":
        out = ref.attention_ref(fold(q), fold(k), fold(v), causal=causal)
    else:
        out = _fa.flash_attention_fwd(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(b, h, s, hd).transpose(1, 2)


def rmsnorm(x, scale, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,)."""
    dev = _device(x, scale)
    if dev.type == "cpu":
        return ref.rmsnorm_ref(x, scale, eps)
    shape = x.shape
    return _rn.rmsnorm_fwd(x.reshape(-1, shape[-1]).contiguous(), scale.contiguous(),
                           eps=eps).reshape(shape)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {"rmsnorm": _rn.launches, "flash_attention": _fa.launches}


def reset_launch_counts() -> None:
    _rn.launches = 0
    _fa.launches = 0
