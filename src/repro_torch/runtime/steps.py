"""Train steps: the counterpart of `build_train_step` and the explicit-DP branch
of `build_explicit_dp_step` in `repro.runtime.steps`.

  * `build_train_step`       — one process, no collectives.
  * `build_explicit_dp_step` — pure data parallelism over a process group,
    the group standing in for the JAX mesh's `data` axis: NCCL on the card,
    gloo processes on the CPU. Every rank holds the whole params; rank r
    takes rows [r·B/n, (r+1)·B/n) of the global batch, and the gradients are
    packed by the bucket codec (K3), reduced row by row and unpacked (K4).

A step is `(params, opt_state, batch, err) -> (params, opt_state, metrics,
err)` as in the JAX package. `params` is the model's own param tree: the
step updates it in place (one copy of the params in device memory) and
returns it; everything else is functional.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..core import collectives as coll
from ..core import overlap as ov
from ..kernels import bucket_codec as codec
from ..models.model import Model, flat_leaves, unflatten_like
from ..optim import adamw

# Bucket size when none is given: the JAX step's value for a collective
# policy that carries no latency/bandwidth crossover (runtime/steps.py:265).
# The planner that derives the crossover from the topology is not ported yet.
DEFAULT_BUCKET_BYTES = 4 << 20


def value_and_grad(model: Model, params, batch):
    """(loss, grads): the gradients as a tree shaped like `params`, in the
    params' dtypes (`jax.value_and_grad(model.loss)`). Each gradient is
    contiguous, as the codec's kernels take them: autograd may return a
    transposed view (the tied embedding's, from the unembedding product)."""
    leaves = flat_leaves(params)
    loss = model.loss(batch, params)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten_like(params, [g.contiguous() for g in grads])


@torch.no_grad()
def _assign(params, new_params) -> None:
    for p, q in zip(flat_leaves(params), flat_leaves(new_params)):
        p.copy_(q)


def build_train_step(model: Model, opt: adamw.OptConfig, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    if microbatches != 1:
        raise NotImplementedError("gradient accumulation (microbatches > 1) is not ported yet")

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        new_params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt)
        _assign(params, new_params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def init_error_state(params):
    """Per-leaf error-feedback zeros (the per-tensor wire's state shape)."""
    return {k: init_error_state(v) if isinstance(v, dict)
            else torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def build_explicit_dp_step(model: Model, opt: adamw.OptConfig, group=None, *,
                           compress_bits: int = 0, bucket_bytes: Optional[int] = None,
                           dcn_axis: Optional[str] = None, overlap: bool = False,
                           microbatches: int = 1, zero: bool = False) -> Callable:
    """Pure-DP train step over `group` (None: the default process group).

    Bucketing: the flat gradient list (`flat_leaves` order) is packed by the
    codec into rows of `bucket_bytes` (leaves split at bucket boundaries, in
    forward order) and each row is all-reduced through the collective
    registry's "xla" entry, the platform library's all-reduce: what the JAX
    step's `CollectivePolicy` falls back to when its table has no entry. The
    last row keeps its exact size on the wire (its zero pad is never sent).
    `bucket_bytes=None` means `DEFAULT_BUCKET_BYTES` (4 MiB); `0` reduces
    per tensor.

    Compression (`compress_bits=8`): the pack quantizes each row to int8 with
    one symmetric scale and a carrier-shaped fp32 error-feedback state; a row
    is reduced by all-gathering the int8 payload and the scales and summing
    after dequantization (`overlap.quantized_all_reduce`). With no bucket size
    given, compression keeps the JAX step's legacy per-tensor wire
    (per-tensor scales, per-leaf error state).

    Not ported yet, and refused: the overlap schedule, microbatches, ZeRO and
    the two-tier (`dcn_axis`) reduction.

    The returned step exposes `step.init_error_state(params)`: carrier-shaped
    zeros when compression rides buckets, per-leaf zeros otherwise.
    """
    if overlap or zero or microbatches != 1 or dcn_axis is not None:
        raise NotImplementedError("the explicit-DP step's overlap schedule, microbatches, ZeRO "
                                  "and two-tier (dcn_axis) paths are not ported yet")
    if compress_bits not in (0, 8):
        raise ValueError(f"compress_bits must be 0 or 8, got {compress_bits}")
    if bucket_bytes is None:
        bucket_bytes = 0 if compress_bits else DEFAULT_BUCKET_BYTES
    bucketed = bucket_bytes > 0
    bucket_elems = max(bucket_bytes // 4, 1)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    all_reduce = coll.get_collective("all_reduce", "xla").fn

    def pmean(x: torch.Tensor) -> torch.Tensor:
        x = x.float().clone()
        return all_reduce(x, group) / n

    def local_rows(batch):
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v, device=model.device)
            if v.shape[0] % n:
                raise ValueError(f"global batch {v.shape[0]} is not divisible by the "
                                 f"{n} data-parallel ranks")
            b = v.shape[0] // n
            out[k] = v[rank * b:(rank + 1) * b]
        return out

    def make_table(flat):
        return codec.make_table([g.numel() for g in flat], bucket_elems, reverse=False)

    def reduce_bucketed(flat_g, err):
        """Pack into bucket rows, reduce each, unpack: exactly
        ceil(total_bytes / bucket_bytes) reductions, after the backward."""
        table = make_table(flat_g)
        if table.n_buckets == 0:
            return [g.float() for g in flat_g], err
        nb, cap = table.n_buckets, table.bucket_elems
        tail = table.total_elems - (nb - 1) * cap
        width = lambda k: tail if k == nb - 1 else cap
        if compress_bits == 8:
            q, s, new_err = codec.pack(table, flat_g, scale=1.0 / n, wire="int8", err=err)
            rows = torch.zeros((nb, cap), dtype=torch.float32, device=q.device)
            for k in range(nb):
                rows[k, :width(k)] = ov.quantized_all_reduce(q[k, :width(k)], s[k], group)
            return codec.unpack(table, rows, flat_g), new_err
        carrier, _, _ = codec.pack(table, flat_g, scale=1.0 / n)
        for k in range(nb):
            all_reduce(carrier[k, :width(k)], group)   # in place; the pad stays 0
        return codec.unpack(table, carrier, flat_g), err

    def reduce_one(g, e):
        g32 = g.float() / n
        if compress_bits == 8:
            g32 = g32 + e
            m = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12)
            scale = m / torch.full_like(m, 127.0)
            q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            new_e = g32 - q.float() * scale
            # int8 payload + per-tensor fp32 scale on the wire, summed after dequant
            return ov.quantized_all_reduce(q, scale, group), new_e
        return all_reduce(g32, group), e

    def step(params, opt_state, batch, err):
        loss, grads = value_and_grad(model, params, local_rows(batch))
        loss = pmean(loss)
        flat_g = flat_leaves(grads)
        if bucketed:
            reduced, new_err = reduce_bucketed(flat_g, err)
            grads = unflatten_like(params, reduced)
        else:
            out = [reduce_one(g, e) for g, e in zip(flat_g, flat_leaves(err))]
            grads = unflatten_like(params, [o[0] for o in out])
            new_err = unflatten_like(params, [o[1] for o in out])
        new_params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt)
        _assign(params, new_params)
        metrics["loss"] = loss
        return params, opt_state, metrics, new_err

    def make_error_state(params):
        """Zeros of this step's error-feedback state: a carrier-shaped
        (n_buckets, bucket_elems) fp32 buffer when compression rides buckets,
        per-leaf zeros otherwise."""
        if compress_bits == 8 and bucketed:
            table = make_table(flat_leaves(params))
            dev = flat_leaves(params)[0].device
            return torch.zeros((max(table.n_buckets, 1), table.bucket_elems),
                               dtype=torch.float32, device=dev)
        return init_error_state(params)

    step.init_error_state = make_error_state
    return step
