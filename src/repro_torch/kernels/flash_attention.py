"""Flash-attention kernel launcher: the counterpart of
`repro.kernels.flash_attention`.

`flash_attention_fwd` launches csrc/flash_attention.cu, which replaces the
Pallas TPU kernel `_flash_kernel` (src/repro/kernels/flash_attention.py). It
takes CUDA tensors only; `ops.flash_attention` is the public wrapper that also
serves CPU tensors. Unlike the TPU wrapper it needs no S % block == 0: the
kernel masks a ragged last tile.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

HEAD_DIMS = (32, 64)  # the head widths csrc/flash_attention.cu is compiled for
MAX_SEQ = 65535 * 64  # the kernel's grid holds at most 65535 query tiles of 64

# Launches of the kernel since the last reset (ops.reset_launch_counts).
launches = 0


def _entry():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, hd), batch and heads merged, kv repeated to H; contiguous
    CUDA tensors of one dtype (float32 or bfloat16), hd in HEAD_DIMS. Returns (BH, S, hd)."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash attention kernel needs q, k, v on one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _build.DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16 q, k, v of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention kernel needs q, k, v of one shape (BH, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    bh, s, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel is built for head_dim in {HEAD_DIMS}, "
                         f"got {hd}")
    if s > MAX_SEQ or bh >= 2 ** 31:
        raise ValueError(f"flash attention kernel takes S <= {MAX_SEQ} and BH < 2**31, "
                         f"got S={s}, BH={bh}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel needs contiguous q, k, v")
    fn = _entry()  # builds at first use; raises if it cannot
    out = torch.empty_like(q)
    if bh == 0 or s == 0:
        return out
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, s, hd,
                  int(causal), 1.0 / math.sqrt(hd), _build.DTYPE_CODES[q.dtype],
                  _build.stream_of(q))
    _build.check(_build.library("flash_attention"), code, "flash_attention")
    launches += 1
    return out
