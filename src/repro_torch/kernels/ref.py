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


# ------------------------------------------------------------- bucket codec
# Line for line the JAX package's `_quantize_rows`, `_pack_xla` and
# `_unpack_xla` (src/repro/kernels/bucket_codec.py). Each op rounds on its own,
# as the eager XLA ops do.
def quantize_rows_ref(carrier: torch.Tensor):
    """Symmetric per-bucket int8 quantization of a (n_buckets, cap) fp32
    carrier -> (q int8, scales fp32 (n_buckets,), new_err fp32)."""
    m = torch.clamp_min(torch.amax(torch.abs(carrier), dim=1), 1e-12)
    # a tensor divisor: PyTorch's CUDA ops multiply by the reciprocal of a
    # Python-scalar divisor, which is not the JAX package's division
    s = m / torch.full_like(m, 127.0)
    q = torch.clamp(torch.round(carrier / s[:, None]), -127, 127).to(torch.int8)
    new_err = carrier - q.float() * s[:, None]
    return q, s, new_err


def pack_ref(table, flat_g, scale: float = 1.0, wire: str = "fp32", err=None):
    """Leaves -> (carrier, scales, new_err): `bucket_codec.pack`'s contract."""
    from .bucket_codec import WIRE_DTYPES

    dev = next((g.device for g in flat_g), torch.device("cpu"))
    flat = torch.zeros((table.carrier_elems,), dtype=torch.float32, device=dev)
    for i, size in enumerate(table.sizes):
        if size == 0:
            continue
        off = table.leaf_offsets[i]
        flat[off:off + size] = flat_g[i].reshape(-1).float()
    carrier = (flat * scale).reshape(table.n_buckets, table.bucket_elems)
    if wire == "int8":
        if err is not None:
            carrier = carrier + err
        return quantize_rows_ref(carrier)
    return carrier.to(WIRE_DTYPES[wire]), None, err


def unpack_ref(table, carrier: torch.Tensor, like, scales=None):
    """Reduced carrier -> per-leaf fp32 tensors shaped like `like` (fresh
    tensors, never views of the carrier)."""
    flat = carrier.float()
    if scales is not None:
        flat = flat * scales[:, None]
    flat = flat.reshape(-1)
    out = []
    for i, g in enumerate(like):
        if table.sizes[i] == 0:
            out.append(torch.zeros(g.shape, dtype=torch.float32, device=carrier.device))
            continue
        off = table.leaf_offsets[i]
        out.append(flat[off:off + table.sizes[i]].reshape(g.shape).clone())
    return out


# ----------------------------------------------------- sharded AdamW update
def adamw_shard_ref(g, p, m, v, clip, lr, bc1, bc2, b1: float, b2: float, eps: float,
                    wd: float, wire: str = "fp32"):
    """One device's (n_buckets, shard_elems) carrier shards -> (p_wire,
    scales, new_m, new_v): line for line the JAX package's `_adamw_shard_xla`,
    each op rounded on its own as the eager XLA ops are. `clip`, `lr`, `bc1`
    and `bc2` are fp32 tensors; `b1`, `b2`, `eps` and `wd` Python floats,
    rounded to fp32 where they meet a tensor, as JAX's weak types are (so
    `1 - b1` is taken in double and rounded once). The divisors are tensors:
    PyTorch's CUDA ops multiply by the reciprocal of a Python-scalar divisor."""
    from .bucket_codec import WIRE_DTYPES

    clip, lr, bc1, bc2 = (torch.as_tensor(x, dtype=torch.float32, device=g.device)
                          for x in (clip, lr, bc1, bc2))
    g = g * clip
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mhat = m / bc1
    vhat = v / bc2
    delta = mhat / (torch.sqrt(vhat) + eps) + wd * p
    p_new = p - lr * delta
    if wire == "int8":
        mx = torch.clamp_min(torch.amax(torch.abs(p_new), dim=1), 1e-12)
        s = mx / torch.full_like(mx, 127.0)
        q = torch.clamp(torch.round(p_new / s[:, None]), -127, 127).to(torch.int8)
        return q, s, m, v
    return p_new.to(WIRE_DTYPES[wire]), None, m, v
