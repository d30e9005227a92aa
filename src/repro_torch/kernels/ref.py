"""Plain PyTorch versions of the port's kernels (the allclose targets).

They mirror `repro.kernels.ref` line for line. The wrappers in `ops` run them
for tensors on the CPU; on the card they are what each kernel is compared with.
"""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q, k, v: (BH, S, hd)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def rmsnorm_ref(x, scale, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
