"""RMSNorm kernel launcher: the counterpart of `repro.kernels.rmsnorm`.

`rmsnorm_fwd` launches csrc/rmsnorm.cu, which replaces the Pallas TPU kernel
`_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py). It takes CUDA tensors only;
`ops.rmsnorm` is the public wrapper that also serves CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of the kernel since the last reset (ops.reset_launch_counts).
launches = 0


def _entry():
    fn = _build.library("rmsnorm").rmsnorm_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x: (R, D); scale: (D,); both contiguous CUDA tensors of one dtype
    (float32 or bfloat16). Returns (R, D) in x's dtype."""
    global launches
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"rmsnorm kernel needs x and scale on one CUDA device, "
                         f"got {x.device} and {scale.device}")
    if x.dtype not in _build.DTYPE_CODES or scale.dtype != x.dtype:
        raise ValueError(f"rmsnorm kernel takes float32 or bfloat16 x and scale of the "
                         f"same dtype, got {x.dtype} and {scale.dtype}")
    if x.dim() != 2 or scale.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm kernel needs x (R, D) and scale (D,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and scale")
    rows, d = x.shape
    if rows >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError(f"rmsnorm kernel takes fewer than 2**31 rows and columns, got {rows, d}")
    fn = _entry()  # builds at first use; raises if it cannot
    out = torch.empty_like(x)
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, eps,
                  _build.DTYPE_CODES[x.dtype], _build.stream_of(x))
    _build.check(_build.library("rmsnorm"), code, "rmsnorm")
    launches += 1
    return out
