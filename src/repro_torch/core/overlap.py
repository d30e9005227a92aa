"""Gradient buckets and the int8 wire's reduction: the counterpart of the parts
of `repro.core.overlap` that the explicit-DP step runs without overlap.

`Bucket` and `make_buckets` are the JAX module's arithmetic, copied as is:
the codec table (`kernels.bucket_codec.make_table`) is built from them, so
the two packages split the gradient stream at the same boundaries.
`quantized_all_reduce` is the single-tier branch (`dcn_axis=None`,
`n_chunks=1`) on `torch.distributed`. The overlap scan schedule, the chunked
hierarchical pipeline and the two-tier ZeRO legs are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from . import collectives as coll


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One reduction unit: contiguous spans of the flat gradient list.

    `spans` are (tensor_index, lo, hi) element ranges; tensors are split at
    bucket boundaries, so a bucket never exceeds `elems` (except when a single
    element already does — a bucket always holds at least one element)."""

    spans: Tuple[Tuple[int, int, int], ...]
    elems: int


def make_buckets(sizes: Sequence[int], bucket_elems: int,
                 reverse: bool = True) -> List[Bucket]:
    """Assign per-tensor element counts to fixed-size buckets.

    With `reverse=True` (the overlap schedule), tensors are walked from the
    *end* of the list — reverse layer order, because backward produces the last
    layers' gradients first — so bucket 0 is ready earliest during backward.
    `bucket_elems` below one element is clamped to 1 (each element becomes its
    own bucket rather than an infinite loop / zero-size bucket).
    """
    cap = max(int(bucket_elems), 1)
    order = range(len(sizes) - 1, -1, -1) if reverse else range(len(sizes))
    buckets: List[Bucket] = []
    cur: List[Tuple[int, int, int]] = []
    cur_n = 0
    for i in order:
        pos = 0
        size = int(sizes[i])
        while pos < size:
            take = min(size - pos, cap - cur_n)
            cur.append((i, pos, pos + take))
            cur_n += take
            pos += take
            if cur_n == cap:
                buckets.append(Bucket(tuple(cur), cap))
                cur, cur_n = [], 0
    if cur:
        buckets.append(Bucket(tuple(cur), cap))
    return buckets


def quantized_all_reduce(q: torch.Tensor, scale: torch.Tensor, group=None) -> torch.Tensor:
    """Wire-compressed all-reduce of one int8 bucket row and its fp32 scale.

    All-gather the int8 payload and every rank's scale, then dequantize and
    sum locally: the wire moves s/4 + 4 bytes per peer instead of the fp32
    row. Returns the fp32 sum, shaped like `q`."""
    all_gather = coll.get_collective("all_gather", "xla").fn
    qg = all_gather(q.reshape(-1), group)                       # (n, S) int8 wire
    sg = all_gather(scale.reshape(()), group)                   # (n,) fp32 scales
    return torch.tensordot(sg, qg.float(), dims=([0], [0])).reshape(q.shape)
