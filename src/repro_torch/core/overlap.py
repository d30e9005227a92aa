"""Gradient buckets, the overlap issue schedule, the int8 wire and the ZeRO
legs: the counterpart of the parts of `repro.core.overlap` that the
single-tier explicit-DP step runs.

`Bucket` and `make_buckets` are the JAX module's arithmetic, copied as is:
the codec table (`kernels.bucket_codec.make_table`) is built from them, so
the two packages split the gradient stream at the same boundaries.
`scan_bucket_reduce` is the overlap schedule's issue order; the ZeRO legs
(`two_tier_reduce_scatter`, `two_tier_all_gather`, `quantized_all_gather`) and
`quantized_all_reduce` are their single-tier branches (`dcn_axis=None`) on
`torch.distributed`. The two-tier branches and the chunked hierarchical
pipeline wait for 2-D process groups (ROADMAP Queue A6.3) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

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


def _single_tier(what: str, dcn_group, n_chunks: int) -> None:
    if dcn_group is not None or n_chunks > 1:
        raise NotImplementedError(f"{what}: the two-tier (dcn_axis) and chunked legs are not "
                                  f"ported yet (ROADMAP Queue A6.3)")


def _rows(stacked):
    """Row k of a stacked tensor, or of each tensor of a tuple."""
    if isinstance(stacked, torch.Tensor):
        return list(stacked)
    return list(zip(*stacked))


def scan_bucket_reduce(stacked, reduce_fn: Callable, async_op: bool = False):
    """The overlap schedule's issue order: one reduction per bucket row, in
    row order (backward materialization order under `make_table(...,
    reverse=True)`), each issued with `async_op=True`; the library runs one
    group's collectives in issue order, so this is the serialized comm stream
    of the JAX scan. `stacked` is a tensor or a tuple of tensors with the
    buckets on the leading axis; `reduce_fn(row, async_op=True)` returns a
    `Pending`. Returns the reduced rows stacked, or with `async_op=True` a
    `Pending` of them, so a caller can run a backward before it waits."""
    pending = [reduce_fn(row, async_op=True) for row in _rows(stacked)]
    done = coll.Pending([], lambda: torch.stack([p.wait() for p in pending]))
    return done if async_op else done.wait()


def two_tier_reduce_scatter(x: torch.Tensor, group=None, dcn_group=None, n_chunks: int = 1,
                            async_op: bool = False):
    """Reduce-scatter of a 1-D row: the first phase of the ZeRO schedule
    (RS -> sharded update -> AG). Single tier: rank r gets chunk r of the
    summed row, through the registry's "xla" entry; the caller pads the row
    to a multiple of the group size."""
    _single_tier("two_tier_reduce_scatter", dcn_group, n_chunks)
    rs = coll.get_collective("reduce_scatter", "xla").fn
    return rs(x, group, async_op=async_op)


def two_tier_all_gather(shard: torch.Tensor, group=None, dcn_group=None, n_chunks: int = 1,
                        async_op: bool = False):
    """All-gather of a `two_tier_reduce_scatter` shard back into the full row,
    in row order, through the registry's "xla" entry: the return phase of the
    ZeRO schedule."""
    _single_tier("two_tier_all_gather", dcn_group, n_chunks)
    ag = coll.get_collective("all_gather", "xla").fn
    gathered = ag(shard, group, async_op=True)
    return coll.pending_or_result([], lambda: gathered.wait().reshape(-1), async_op)


def quantized_all_gather(q_shard: torch.Tensor, scale: torch.Tensor, group=None,
                         dcn_group=None, n_chunks: int = 1, async_op: bool = False):
    """Wire-compressed return leg of the ZeRO schedule: gather the int8 param
    shards and one fp32 scale per shard, and dequantize only after the full
    gather -> the fp32 full row. Every rank, the shard's owner included, uses
    the dequantized values, so the params stay bit-identically replicated."""
    _single_tier("quantized_all_gather", dcn_group, n_chunks)
    all_gather = coll.get_collective("all_gather", "xla").fn
    qg = all_gather(q_shard.reshape(-1), group, async_op=True)     # (n, S) int8 wire
    sg = all_gather(scale.reshape(()), group, async_op=True)       # (n,) fp32 scales
    return coll.pending_or_result(
        [], lambda: (qg.wait().float() * sg.wait()[:, None]).reshape(-1), async_op)


def quantized_all_reduce(q: torch.Tensor, scale: torch.Tensor, group=None,
                         async_op: bool = False):
    """Wire-compressed all-reduce of one int8 bucket row and its fp32 scale.

    All-gather the int8 payload and every rank's scale, then dequantize and
    sum locally: the wire moves s/4 + 4 bytes per peer instead of the fp32
    row. Returns the fp32 sum, shaped like `q`."""
    all_gather = coll.get_collective("all_gather", "xla").fn
    qg = all_gather(q.reshape(-1), group, async_op=True)        # (n, S) int8 wire
    sg = all_gather(scale.reshape(()), group, async_op=True)    # (n,) fp32 scales
    dequant_sum = lambda: torch.tensordot(sg.wait(), qg.wait().float(), dims=([0], [0]))
    return coll.pending_or_result([], lambda: dequant_sum().reshape(q.shape), async_op)
