"""Train steps: the counterpart of `build_train_step` and the single-tier
branches of `build_explicit_dp_step` in `repro.runtime.steps`.

  * `build_train_step`       — one process, no collectives; optional
    microbatches accumulate fp32 gradients.
  * `build_explicit_dp_step` — pure data parallelism over a process group,
    the group standing in for the JAX mesh's `data` axis: NCCL on the card,
    gloo processes on the CPU. Every rank holds the whole params; rank r
    takes rows [r·B/n, (r+1)·B/n) of the global batch, and the gradients are
    packed by the bucket codec (K3), reduced row by row and unpacked (K4):
    all-reduced, or under ZeRO reduce-scattered, applied to this rank's
    carrier shard by the fused AdamW kernel (K5) and all-gathered.

A step is `(params, opt_state, batch, err) -> (params, opt_state, metrics,
err)` as in the JAX package. `params` is the model's own param tree: the
step updates it in place (one copy of the params in device memory) and
returns it; everything else is functional.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core import collectives as coll
from ..core import overlap as ov
from ..kernels import bucket_codec as codec
from ..models.model import Model, flat_leaves, unflatten_like
from ..optim import adamw

# Bucket size when none is given: the JAX step's value for a collective
# policy that carries no latency/bandwidth crossover (runtime/steps.py:265).
# The planner that derives the crossover from the topology is not ported yet.
DEFAULT_BUCKET_BYTES = 4 << 20
# The checkpoint shard-spec tag of the ZeRO carrier-sharded moments: the JAX
# step's string for its `data` axis, so checkpoints cross between packages.
ZERO_SHARD_SPEC = "zero-carrier:data"


def value_and_grad(model: Model, params, batch):
    """(loss, grads): the gradients as a tree shaped like `params`, in the
    params' dtypes (`jax.value_and_grad(model.loss)`). Each gradient is
    contiguous, as the codec's kernels take them: autograd may return a
    transposed view (the tied embedding's, from the unembedding product)."""
    leaves = flat_leaves(params)
    loss = model.loss(batch, params)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten_like(params, [g.contiguous() for g in grads])


def _microbatch(batch, n: int) -> List[Dict]:
    """The batch cut into `n` microbatches along its leading axis, in order."""
    for a in batch.values():
        if a.shape[0] % n:
            raise ValueError(
                f"batch leading axis {a.shape[0]} is not divisible by "
                f"microbatches={n}; choose a microbatch count that divides "
                f"the (per-shard) batch size")
    return [{k: a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)] for k, a in batch.items()}
            for i in range(n)]


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true division (PyTorch's CUDA ops multiply by the
    reciprocal of a Python-scalar divisor; JAX divides)."""
    return x / torch.tensor(float(d), dtype=torch.float32, device=x.device)


@torch.no_grad()
def _assign(params, new_params) -> None:
    for p, q in zip(flat_leaves(params), flat_leaves(new_params)):
        p.copy_(q)


def build_train_step(model: Model, opt: adamw.OptConfig, microbatches: int = 1) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics). With
    `microbatches > 1` the batch is cut on its leading axis and the
    gradients accumulate in fp32, as the JAX step's scan does."""

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in flat_leaves(params)]
            lsum = 0.0
            for b in _microbatch(batch, microbatches):
                loss, grads = value_and_grad(model, params, b)
                gsum = [a + g.float() for a, g in zip(gsum, flat_leaves(grads))]
                lsum = lsum + loss
            grads = unflatten_like(params, [_div(g, microbatches) for g in gsum])
            loss = _div(lsum, microbatches)
        else:
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
    (per-tensor scales, per-leaf error state), unless overlap or ZeRO.

    Overlap (`overlap=True`): buckets are built in reverse layer order (the
    order backward materializes them) and reduced whole rows through
    `overlap.scan_bucket_reduce`, each issued asynchronously in row order.
    Gradients are packed after the whole backward, as the JAX step packs
    after its materialization barrier. With `microbatches > 1` the previous
    microbatch's reductions are issued before the next backward runs and the
    reduced rows accumulate; the int8 error feedback carries across
    microbatches.

    ZeRO (`zero=True`): the carrier's columns are padded to a multiple of the
    group size; each row is reduce-scattered, the global gradient norm is
    all-reduced from the shards' sums of squares, this rank's column block of
    the params (packed by K3 at scale 1) is updated by the fused AdamW kernel
    (`bucket_codec.adamw_update_shard`, K5) against the rank's block of fp32
    m and v, and the rows are all-gathered (fp32, or with `compress_bits=8`
    int8 plus one scale per row shard, dequantized after the full gather on
    every rank) and unpacked by K4. `err` passes through as a scalar
    placeholder: the param leg carries no error feedback.

    The two-tier (`dcn_axis`) reduction is not ported yet and raises.

    The returned step exposes `step.init_error_state(params)`, and
    `step.init_opt_state(params)` / `step.abstract_opt_state(params)` (meta
    tensors of the global shapes), `step.zero` and `step.opt_shard_spec`:
    under ZeRO a rank's m and v are its `(n_buckets, padded / n)` column
    block of the JAX step's global `(n_buckets, padded)` arrays.
    """
    if compress_bits not in (0, 8):
        raise ValueError(f"compress_bits must be 0 or 8, got {compress_bits}")
    if microbatches > 1 and not overlap:
        raise ValueError("explicit-DP microbatching is implemented by the "
                         "overlap schedule; pass overlap=True")
    if overlap and bucket_bytes == 0:
        raise ValueError("overlap=True requires bucketing; per-tensor "
                         "reduction (bucket_bytes=0) is not supported — omit "
                         "bucket_bytes to use the plan's crossover")
    if zero and bucket_bytes == 0:
        raise ValueError("zero=True shards the packed carrier; per-tensor "
                         "reduction (bucket_bytes=0) is not supported — omit "
                         "bucket_bytes to use the plan's crossover")
    if dcn_axis is not None:
        raise NotImplementedError("the explicit-DP step's two-tier (dcn_axis) reduction is not "
                                  "ported yet (ROADMAP Queue A6.3)")
    if bucket_bytes is None:
        bucket_bytes = 0 if (compress_bits and not overlap and not zero) else DEFAULT_BUCKET_BYTES
    bucketed = bucket_bytes > 0
    bucket_elems = max(bucket_bytes // 4, 1)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    inv = 1.0 / (n * microbatches)
    all_reduce = coll.get_collective("all_reduce", "xla").fn
    zero_wire = "int8" if compress_bits == 8 else "fp32"

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

    def grads_of(params, batch):
        loss, grads = value_and_grad(model, params, batch)
        return loss, flat_leaves(grads)

    def make_table(sizes, reverse):
        return codec.make_table(sizes, bucket_elems, reverse=reverse)

    def reduce_bucket(row, async_op=False):
        return all_reduce(row, group, async_op=async_op)

    def reduce_q(row_and_scale, async_op=False):
        q_row, s_row = row_and_scale
        return ov.quantized_all_reduce(q_row, s_row, group, async_op=async_op)

    # --------------------------------------------------------- all-reduce
    def reduce_bucketed(flat_g, err):
        """Pack into bucket rows, reduce each, unpack: exactly
        ceil(total_bytes / bucket_bytes) reductions, after the backward."""
        table = make_table([g.numel() for g in flat_g], reverse=False)
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

    def overlap_grads(params, batch, err):
        """Reverse-layer-order buckets under the overlap issue schedule:
        (mean loss over microbatches, reduced flat fp32 grads, new error)."""
        if microbatches == 1:
            loss, flat_g = grads_of(params, batch)
            table = make_table([g.numel() for g in flat_g], reverse=True)
            if table.n_buckets == 0:  # every gradient leaf is zero-size
                return loss, [g.float() for g in flat_g], err
            if compress_bits == 8:
                q, s, new_err = codec.pack(table, flat_g, scale=inv, wire="int8", err=err)
                reduced = ov.scan_bucket_reduce((q, s), reduce_q)
                return loss, codec.unpack(table, reduced, flat_g), new_err
            carrier, _, _ = codec.pack(table, flat_g, scale=inv)
            reduced = ov.scan_bucket_reduce(carrier, reduce_bucket)
            return loss, codec.unpack(table, reduced, flat_g), err

        mbs = _microbatch(batch, microbatches)
        loss0, flat0 = grads_of(params, mbs[0])
        table = make_table([g.numel() for g in flat0], reverse=True)
        nb = table.n_buckets
        if nb == 0:
            raise ValueError("overlap microbatching found no gradient "
                             "elements to reduce (all leaves zero-size)")
        acc = torch.zeros((nb, table.bucket_elems), dtype=torch.float32, device=model.device)
        lsum = loss0
        if compress_bits == 8:
            q_p, s_p, err_c = codec.pack(table, flat0, scale=inv, wire="int8", err=err)
            for b in mbs[1:]:
                # the previous microbatch's reductions go out first: they do
                # not depend on this microbatch's backward
                reduced = ov.scan_bucket_reduce((q_p, s_p), reduce_q, async_op=True)
                loss, flat = grads_of(params, b)
                # per-bucket error feedback carried across microbatches
                q_p, s_p, err_c = codec.pack(table, flat, scale=inv, wire="int8", err=err_c)
                acc = acc + reduced.wait()
                lsum = lsum + loss
            final = ov.scan_bucket_reduce((q_p, s_p), reduce_q)
            return _div(lsum, microbatches), codec.unpack(table, acc + final, flat0), err_c
        pending, _, _ = codec.pack(table, flat0, scale=inv)
        for b in mbs[1:]:
            reduced = ov.scan_bucket_reduce(pending, reduce_bucket, async_op=True)
            loss, flat = grads_of(params, b)
            nxt, _, _ = codec.pack(table, flat, scale=inv)
            acc = acc + reduced.wait()
            pending = nxt
            lsum = lsum + loss
        # the last microbatch's buckets have no backward left to hide behind
        final = ov.scan_bucket_reduce(pending, reduce_bucket)
        return _div(lsum, microbatches), codec.unpack(table, acc + final, flat0), err

    def allreduce_step(params, opt_state, batch, err):
        batch = local_rows(batch)
        if overlap:
            loss, reduced, new_err = overlap_grads(params, batch, err)
            grads = unflatten_like(params, reduced)
        else:
            loss, flat_g = grads_of(params, batch)
            if bucketed:
                reduced, new_err = reduce_bucketed(flat_g, err)
                grads = unflatten_like(params, reduced)
            else:
                out = [reduce_one(g, e) for g, e in zip(flat_g, flat_leaves(err))]
                grads = unflatten_like(params, [o[0] for o in out])
                new_err = unflatten_like(params, [o[1] for o in out])
        loss = pmean(loss)
        new_params, opt_state, metrics = adamw.apply_updates(params, grads, opt_state, opt)
        _assign(params, new_params)
        metrics["loss"] = loss
        return params, opt_state, metrics, new_err

    # --------------------------------------------------------------- ZeRO
    def zero_geometry(sizes):
        """The codec table and the rows' padded width: a multiple of the group
        size, so every row splits into n equal column blocks (zeros are the
        reduction identity and an AdamW fixed point, so pads stay zero)."""
        table = make_table(sizes, reverse=bool(overlap))
        padded = -(-table.bucket_elems // n) * n
        return table, padded

    def pad_cols(carrier, padded):
        return F.pad(carrier, (0, padded - carrier.shape[1])) if padded > carrier.shape[1] \
            else carrier

    def zero_rs(row, async_op=False):
        return ov.two_tier_reduce_scatter(row, group, async_op=async_op)

    def zero_ag(shard, async_op=False):
        return ov.two_tier_all_gather(shard, group, async_op=async_op)

    def zero_ag_q(shard_and_scale, async_op=False):
        q_row, s_row = shard_and_scale
        return ov.quantized_all_gather(q_row, s_row, group, async_op=async_op)

    def zero_step(params, opt_state, batch, err):
        batch = local_rows(batch)
        flat_p = flat_leaves(params)
        table, padded = zero_geometry([p.numel() for p in flat_p])
        nb = table.n_buckets
        step_no = opt_state["step"] + 1
        lr = adamw.schedule(step_no, opt)
        if nb == 0:  # every parameter leaf is zero-size: nothing on the wire
            with torch.no_grad():
                loss = pmean(model.loss(batch, params))
            metrics = {"grad_norm": torch.zeros((), dtype=torch.float32, device=model.device),
                       "lr": lr, "loss": loss}
            return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step_no}, \
                metrics, err
        cap = table.bucket_elems
        shard_elems = padded // n

        def pack_pad(flat):
            carrier, _, _ = codec.pack(table, flat, scale=inv)
            return pad_cols(carrier, padded)

        if microbatches == 1:
            loss, flat_g = grads_of(params, batch)
            carrier = pack_pad(flat_g)
            del flat_g
            # one bucket's reduce-scatter after another, in the table's order
            # (backward order under overlap)
            g_shard = ov.scan_bucket_reduce(carrier, zero_rs)
            del carrier
        else:
            mbs = _microbatch(batch, microbatches)
            loss, flat0 = grads_of(params, mbs[0])
            pending = pack_pad(flat0)
            del flat0
            acc = torch.zeros((nb, shard_elems), dtype=torch.float32, device=model.device)
            for b in mbs[1:]:
                # the previous microbatch's reduce-scatters go out first and
                # overlap this backward; shards accumulate (1/n of the rows an
                # all-reduce would carry)
                red = ov.scan_bucket_reduce(pending, zero_rs, async_op=True)
                loss_b, flat = grads_of(params, b)
                nxt = pack_pad(flat)
                del flat
                acc = acc + red.wait()
                pending = nxt
                loss = loss + loss_b
            g_shard = acc + ov.scan_bucket_reduce(pending, zero_rs)
            del acc, pending
            loss = _div(loss, microbatches)
        loss = pmean(loss)

        # exact global-norm clipping: the shards' sums of squares are summed
        # over the group before the clip factor forms; no shard updates until
        # every bucket's reduce-scatter has landed
        gsq = all_reduce(torch.sum(torch.square(g_shard)), group)
        gnorm = torch.sqrt(gsq)
        clip = torch.clamp_max(torch.full_like(gnorm, opt.clip_norm) / (gnorm + 1e-9), 1.0)
        bc1 = 1 - opt.b1 ** step_no.float()
        bc2 = 1 - opt.b2 ** step_no.float()

        # the params ride the same codec: pack (cast to fp32), pad, and take
        # this rank's column block of every row
        p_carrier = pad_cols(codec.pack(table, [p.detach() for p in flat_p])[0], padded)
        p_shard = p_carrier[:, rank * shard_elems:(rank + 1) * shard_elems].contiguous()
        del p_carrier
        p_wire, p_scales, new_m, new_v = codec.adamw_update_shard(
            g_shard, p_shard, opt_state["m"], opt_state["v"], clip=clip, lr=lr, bc1=bc1,
            bc2=bc2, b1=opt.b1, b2=opt.b2, eps=opt.eps, weight_decay=opt.weight_decay,
            wire=zero_wire)
        del g_shard, p_shard

        full = ov.scan_bucket_reduce((p_wire, p_scales), zero_ag_q) if zero_wire == "int8" \
            else ov.scan_bucket_reduce(p_wire, zero_ag)
        del p_wire, p_scales
        # K4 takes a contiguous carrier: drop the pad columns
        new_flat = codec.unpack(table, full[:, :cap].contiguous(), flat_p)
        del full
        _assign(params, unflatten_like(params, new_flat))
        metrics = {"grad_norm": gnorm, "lr": lr, "loss": loss}
        return params, {"m": new_m, "v": new_v, "step": step_no}, metrics, err

    step = zero_step if zero else allreduce_step

    def make_error_state(params):
        """Zeros of this step's error-feedback state: a carrier-shaped
        (n_buckets, bucket_elems) fp32 buffer when compression rides buckets,
        per-leaf zeros otherwise (the per-tensor legacy wire). The ZeRO step
        carries no error feedback: its state is a placeholder scalar."""
        dev = flat_leaves(params)[0].device
        if zero:
            return torch.zeros((), dtype=torch.float32, device=dev)
        if compress_bits == 8 and bucketed:
            table = make_table([p.numel() for p in flat_leaves(params)], reverse=bool(overlap))
            return torch.zeros((max(table.n_buckets, 1), table.bucket_elems),
                               dtype=torch.float32, device=dev)
        return init_error_state(params)

    def make_opt_state(params):
        """Fresh optimizer state. Under ZeRO: this rank's column block of the
        fp32 moments, (n_buckets, padded / n), and step 0."""
        if not zero:
            return adamw.init_opt_state(params)
        table, padded = zero_geometry([p.numel() for p in flat_leaves(params)])
        dev = flat_leaves(params)[0].device
        mv = lambda: torch.zeros((max(table.n_buckets, 1), padded // n), dtype=torch.float32,
                                 device=dev)
        return {"m": mv(), "v": mv(), "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def make_abstract_opt_state(params):
        """The optimizer state's global shapes and dtypes as meta tensors (a
        checkpoint's restore target): under ZeRO the whole (n_buckets,
        padded) moments, of which each rank holds a column block."""
        if not zero:
            return adamw.abstract_opt_state(params)
        table, padded = zero_geometry([p.numel() for p in flat_leaves(params)])
        mv = lambda: torch.empty((max(table.n_buckets, 1), padded), dtype=torch.float32,
                                 device="meta")
        return {"m": mv(), "v": mv(), "step": torch.empty((), dtype=torch.int32, device="meta")}

    step.init_error_state = make_error_state
    step.init_opt_state = make_opt_state
    step.abstract_opt_state = make_abstract_opt_state
    step.zero = zero
    # the manifest's shard spec of the carrier-sharded moments, so that a
    # replicated restore of a ZeRO checkpoint (or the reverse) raises
    step.opt_shard_spec = ZERO_SHARD_SPEC if zero else None
    return step
