#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no result):
  1. the card: name and power limit from nvidia-smi, compute capability 9.0,
     and the toolchain (torch, CUDA, nvcc, Triton);
  2. builds every kernel from `src/repro_torch/kernels/csrc` (one nvcc each, in
     parallel) and prints the build time and ptxas' register report;
  3. holds each kernel against its plain PyTorch version on the card: K1 and
     K2 in fp32 and bf16 at the serving and training shapes plus ragged ones
     (and K2 at head dim 32, the reduced preset's), K3 and K4
     bit for bit on the fp32, bf16 and int8 wires at smollm-135m's gradient
     leaves in 4 MiB buckets and on a ragged table with zero-size leaves; and
     times the kernel, the plain version and (where there is one) a PyTorch
     library call (device time, by CUDA graph replay) beside its bound, and
     the kernel's eager per-call time;
  4. serves smollm-135m at full width (random weights from seed 0, batch 8,
     128-token prompts, 32 greedy new tokens) through `BatchedServer`, checks
     the kernels' launch counts on that run, and reruns the same tokens
     teacher-forced through the kernels and through the plain versions;
  5. trains smollm-135m at full width through `Trainer` with explicit data
     parallelism on NCCL at world size 1 (bf16 params from seed 0, seq 4096,
     global batch 8): 3 steps on the fp32 wire and 3 on the int8 wire, with
     the launch counts checked, unpack(pack(g)) == g on the first step's
     gradients, the first step's per-token losses through the kernels against
     the plain versions within twice the bf16 noise floor, and one more step
     of each under the profiler for the device time;
  6. trains the same start with ZeRO (reduce-scatter, the fused AdamW kernel
     K5 on the rank's carrier shard, all-gather): 3 steps on the fp32 and 3
     on the int8 all-gather wire, with the launch counts checked, step 0's
     loss equal to phase 5's and its params within one bf16 ulp of phase 5's
     (the int8 wire's within half a quantization step more), a profiled step
     each; one step with the overlap schedule and 2 microbatches (its loss,
     grad norm and params held against the unsplit step's); and a
     checkpoint round trip (save after two steps, restore into a fresh
     Trainer, step 2 equal to the uninterrupted run's bit for bit);
  7. prints a JSON line with each kernel's numbers on each path that runs it
     (serving, training, ZeRO training, and for K3/K4/K5 each wire), then the
     device line last.

Every Trainer writes its checkpoints into a temporary directory that the
script removes.
"""
from __future__ import annotations

import contextlib
import datetime
import importlib.util
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import ShapeConfig, get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import bucket_codec as codec  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_kernel  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.model import Model, flat_leaves  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402
from repro_torch.runtime import steps as rsteps  # noqa: E402
from repro_torch.runtime.serve import BatchedServer, ServeConfig  # noqa: E402
from repro_torch.runtime.train import Trainer, TrainConfig  # noqa: E402

# H100 SXM data sheet: HBM rate, and the peak rates for the kernels' input
# types (bf16 on the tensor cores, float32 outside them), as the bound's
# denominators.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

# Kernel vs plain version, same inputs on the card. fp32: both accumulate in
# fp32 in different orders (1e-5, the JAX package's own flash-vs-reference
# tolerance at these sizes). bf16: both compute in fp32 and round once to bf16,
# so they differ by at most an ulp of the output: 1e-2 relative (two bf16 ulps)
# for the norm; for attention, whose outputs are below 4 in magnitude, 3e-2
# absolute, as tests/test_kernels.py uses.
TOL = {("flash_attention", torch.float32): (1e-5, 0.0),
       ("flash_attention", torch.bfloat16): (3e-2, 0.0),
       ("rmsnorm", torch.float32): (1e-5, 0.0),
       ("rmsnorm", torch.bfloat16): (1e-6, 1e-2)}   # (atol, rtol)

ARCH, BATCH, PROMPT, NEW_TOKENS = "smollm-135m", 8, 128, 32
# Full-width smollm-135m in bf16 through 30 layers of random weights: the
# kernels and the plain versions round to bf16 in different places, and those
# differences grow through the layers. The tolerance on kernel-vs-plain logits
# is therefore measured in the same run as the bf16 noise floor: the plain bf16
# path's largest deviation from an fp32 copy of the same weights, taken twice
# (both bf16 paths carry that noise independently). A wrong kernel moves the
# logits by their own scale, far beyond it.
NOISE_FACTOR = 2.0

SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu",
           "bucket_pack": "src/repro_torch/kernels/csrc/bucket_pack.cu",
           "bucket_unpack": "src/repro_torch/kernels/csrc/bucket_unpack.cu",
           "adamw_shard": "src/repro_torch/kernels/csrc/adamw_shard.cu"}
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:24",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:17",
            "bucket_pack": "src/repro/kernels/bucket_codec.py:178",
            "bucket_unpack": "src/repro/kernels/bucket_codec.py:247",
            "adamw_shard": "src/repro/kernels/bucket_codec.py:316"}

# Training: train_4k's sequence length; its global batch of 256 is cut to 8
# to fit one card (activations and the (8, 4095, 49152) logits).
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 8, 3
BUCKET_BYTES = 4 << 20
# The share of params that the ZeRO step with 2 microbatches may move to
# another bf16 value than the unsplit step does after step 0 (gradient signs
# flipped by rounding; see check_first_step). Measured 2.2e-4 on an H100 80GB
# HBM3 at 700 W; a dropped microbatch of two moves about a quarter of them.
MB_FLIP_SHARE = 1e-3
# The kernels' names as the profiler reports them, for the codec's share and
# the sharded AdamW update's.
CODEC_KERNELS = ("pack_cast_kernel", "pack_int8_pass", "unpack_kernel")
ADAMW_KERNELS = ("adamw_update_kernel", "adamw_quantize_kernel")
# AdamW's constants (OptConfig's defaults) and a step's scalars as the ZeRO
# step gives them to K5 in phase 3: the clip active (grad norm ~1.85), step 2.
ADAMW_CONSTS = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
ADAMW_CLIP, ADAMW_LR, ADAMW_STEP = 0.54, 3e-4, 2


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def call_ms(fn, budget_s: float = 0.1) -> float:
    """Mean time of one call as eager code pays it: CUDA events around a run of
    back-to-back calls. For small work this is the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    iters = int(min(2000, max(10, budget_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls: int = 10, budget_s: float = 0.1) -> float:
    """Mean device time of one call, host overhead excluded: `calls` calls are
    captured in one CUDA graph, and CUDA events time its replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # lazy initialisation, outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    reps = int(min(200, max(3, budget_s * 1e3 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def timings(kernel, plain, library, calls: int = 10) -> dict:
    """Device times (the JSON's ms, plain_ms, library_ms) and the kernel's
    eager per-call time. `calls` per graph: 1 where the plain version's
    intermediates are tens of GB. `library` None: no one PyTorch call
    computes the same function."""
    return dict(ms=device_ms(kernel, calls), plain_ms=device_ms(plain, calls),
                library_ms=None if library is None else device_ms(library, calls),
                call_ms=call_ms(kernel))


def bound(nbytes: float, nops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_violation(got, want, atol, rtol) -> tuple:
    err = (got.float() - want.float()).abs()
    excess = (err - (atol + rtol * want.float().abs())).max().item()
    return err.max().item(), excess


def compare_flash(bh, s, dtype, causal, gen, hd=64):
    q, k, v = (torch.randn(bh, s, hd, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = TOL[("flash_attention", dtype)]
    err, excess = max_violation(got, want, atol, rtol)
    es = q.element_size()
    pairs = s * (s + 1) // 2 if causal else s * s
    b_ms, b_by = bound(4 * bh * s * hd * es, 4 * hd * pairs * bh, dtype)
    return dict(
        name="flash_attention", shape=[bh, s, hd], dtype=str(dtype).split(".")[-1],
        causal=causal, max_abs_err=err, atol=atol, rtol=rtol, ok=excess <= 0,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: fa_kernel.flash_attention_fwd(q, k, v, causal=causal),
                  lambda: ref.attention_ref(q, k, v, causal=causal),
                  # (1, BH, S, hd): the 4-D layout takes SDPA's fused path
                  lambda: F.scaled_dot_product_attention(q[None], k[None], v[None],
                                                         is_causal=causal),
                  calls=1 if s >= 4096 else 10))


def compare_rmsnorm(r, d, dtype, gen):
    x = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    sc = torch.randn(d, generator=gen, device="cuda").to(dtype)
    got = rn_kernel.rmsnorm_fwd(x, sc)
    want = ref.rmsnorm_ref(x, sc)
    torch.cuda.synchronize()
    atol, rtol = TOL[("rmsnorm", dtype)]
    err, excess = max_violation(got, want, atol, rtol)
    b_ms, b_by = bound((2 * r * d + d) * x.element_size(), 4 * r * d, dtype)
    return dict(
        name="rmsnorm", shape=[r, d], dtype=str(dtype).split(".")[-1], max_abs_err=err,
        atol=atol, rtol=rtol, ok=excess <= 0,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: rn_kernel.rmsnorm_fwd(x, sc), lambda: ref.rmsnorm_ref(x, sc),
                  lambda: F.rms_norm(x, (d,), weight=sc, eps=1e-5)))


def smollm_grad_leaves(cfg, dtype, gen):
    """Random leaves shaped as smollm-135m's gradients, in `flat_leaves` order."""
    shapes = flat_leaves(T.dense_param_defs(cfg))
    return [(torch.randn(sh, generator=gen, device="cuda") * 1e-3).to(dtype) for sh in shapes]


def compare_codec(table, leaves, wire, gen, label):
    """K3 and K4 against `pack_ref` / `unpack_ref` on the same CUDA tensors,
    bit for bit, with timings. The int8 wire adds an error-feedback state."""
    nb, cap = table.n_buckets, table.bucket_elems
    err = (torch.randn(nb, cap, generator=gen, device="cuda") * 1e-5
           if wire == "int8" else None)
    scale = 1.0 / 3
    got = codec.bucket_pack(table, leaves, scale, wire, err)
    want = ref.pack_ref(table, leaves, scale, wire, err)
    back = codec.bucket_unpack(table, got[0], leaves, got[1])
    back_want = ref.unpack_ref(table, want[0], leaves, want[1])
    torch.cuda.synchronize()
    pack_ok = all((a is None and b is None) or (a is not None and b is not None and
                                                a.dtype == b.dtype and torch.equal(a, b))
                  for a, b in zip(got, want))
    unpack_ok = all(torch.equal(a, b) for a, b in zip(back, back_want))
    pack_err = max(((a.float() - b.float()).abs().max().item() if a is not None and a.numel()
                    else 0.0) for a, b in zip(got, want))
    unpack_err = max(((a - b).abs().max().item() if a.numel() else 0.0)
                     for a, b in zip(back, back_want))
    total, carrier = table.total_elems, nb * cap
    leaf_bytes = sum(t.numel() * t.element_size() for t in leaves)
    wire_bytes = carrier * codec.WIRE_DTYPES[wire].itemsize
    if wire == "int8":   # reads leaves and err; writes q, scales and new_err
        p_bytes, p_ops = leaf_bytes + 4 * carrier + wire_bytes + 4 * nb + 4 * carrier, 6 * carrier
    else:                # reads leaves; writes the carrier
        p_bytes, p_ops = leaf_bytes + wire_bytes, carrier
    # reads the carrier's live part (and the scales); writes fp32 leaves
    u_bytes = total * codec.WIRE_DTYPES[wire].itemsize + 4 * total + (4 * nb if wire == "int8" else 0)
    rows = []
    for name, ok, err_abs, nbytes, nops, kern, plain in (
            ("bucket_pack", pack_ok, pack_err, p_bytes, p_ops,
             lambda: codec.bucket_pack(table, leaves, scale, wire, err),
             lambda: ref.pack_ref(table, leaves, scale, wire, err)),
            ("bucket_unpack", unpack_ok, unpack_err, u_bytes, total,
             lambda: codec.bucket_unpack(table, got[0], leaves, got[1]),
             lambda: ref.unpack_ref(table, got[0], leaves, got[1]))):
        b_ms, b_by = bound(nbytes, nops, torch.float32)
        rows.append(dict(name=name, shape=[nb, cap], dtype=f"{str(leaves[0].dtype)[6:]}->{wire}",
                         table=label, max_abs_err=err_abs, atol=0.0, rtol=0.0, ok=ok,
                         bound_ms=b_ms, bound_by=b_by, ms=device_ms(kern),
                         plain_ms=device_ms(plain), library_ms=None, call_ms=call_ms(kern)))
    return rows


def compare_adamw(nb, sh, tail, wire, gen, label):
    """K5 against `adamw_shard_ref` on the same CUDA shards, bit for bit
    (p_wire or q and the scales, m, v), with timings. Columns past `tail` in
    the last row are the carrier's zero pad. Library yardstick on the fp32
    wire: `torch._fused_adamw_` on the same flat fp32 tensors, the gradient
    pre-scaled by the clip (its op order differs: times, not bits); the int8
    wire has no one-call equivalent."""
    g = torch.randn(nb, sh, generator=gen, device="cuda") * 1e-4
    p = torch.randn(nb, sh, generator=gen, device="cuda") * 0.05
    m = torch.randn(nb, sh, generator=gen, device="cuda") * 1e-5
    v = torch.rand(nb, sh, generator=gen, device="cuda") * 1e-9
    for t in (g, p, m, v):
        t[-1, tail:] = 0
    step = torch.tensor(float(ADAMW_STEP), device="cuda")
    c = ADAMW_CONSTS
    scal = (torch.tensor(ADAMW_CLIP, device="cuda"), torch.tensor(ADAMW_LR, device="cuda"),
            1 - c["b1"] ** step, 1 - c["b2"] ** step)
    args = (g, p, m, v, *scal, c["b1"], c["b2"], c["eps"], c["wd"], wire)
    got = codec.adamw_shard(*args)
    want = ref.adamw_shard_ref(*args)
    torch.cuda.synchronize()
    ok = all((a is None and b is None) or (a is not None and b is not None and
                                          a.dtype == b.dtype and torch.equal(a, b))
             for a, b in zip(got, want))
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want)
              if a is not None)
    n = nb * sh
    wire_bytes = n * codec.WIRE_DTYPES[wire].itemsize + (4 * nb if wire == "int8" else 0)
    # reads g, p, m, v; writes p_wire (and the scales), m, v. 17 fp32 operations
    # an element (clip, the two moments, the bias corrections, the square root,
    # the quotient, the decay, the step), 3 more for int8's max and quantize
    b_ms, b_by = bound(16 * n + wire_bytes + 8 * n, (20 if wire == "int8" else 17) * n,
                       torch.float32)
    library = None
    if wire == "fp32":
        pf, gf, mf, vf = (t.clone().reshape(-1) for t in (p, g * scal[0], m, v))
        steps = [step.clone()]
        library = lambda: torch._fused_adamw_(
            [pf], [gf], [mf], [vf], [], steps, lr=ADAMW_LR, beta1=c["b1"], beta2=c["b2"],
            weight_decay=c["wd"], eps=c["eps"], amsgrad=False, maximize=False)
    row = dict(name="adamw_shard", shape=[nb, sh], dtype=f"float32->{wire}", table=label,
               max_abs_err=err, atol=0.0, rtol=0.0, ok=ok, bound_ms=b_ms, bound_by=b_by,
               **timings(lambda: codec.adamw_shard(*args), lambda: ref.adamw_shard_ref(*args),
                         library, calls=1))
    del got, want
    return row


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions, for the reference run."""
    saved = ops.rmsnorm, ops.flash_attention

    def flash_plain(q, k, v, *, causal=True, **_):
        b, s, h, hd = q.shape
        fold = lambda t: t.transpose(1, 2).reshape(b * h, s, hd)
        out = ref.attention_ref(fold(q), fold(k), fold(v), causal=causal)
        return out.reshape(b, h, s, hd).transpose(1, 2)

    ops.rmsnorm = lambda x, scale, *, eps=1e-5: ref.rmsnorm_ref(x, scale, eps)
    ops.flash_attention = flash_plain
    try:
        yield
    finally:
        ops.rmsnorm, ops.flash_attention = saved


def teacher_forced(model: Model, shape, prompts: np.ndarray, out: np.ndarray) -> torch.Tensor:
    """Logits for every generated position, feeding the generated tokens back."""
    cache = model.init_cache(shape, batch_size=prompts.shape[0])
    logits, cache = model.prefill(torch.as_tensor(prompts, device="cuda"), cache)
    steps = [logits[:, -1].float()]
    for t in range(out.shape[1] - 1):
        logits, cache = model.decode(cache, torch.as_tensor(out[:, t], device="cuda"),
                                     prompts.shape[1] + t)
        steps.append(logits[:, -1].float())
    return torch.stack(steps, dim=1)                      # (B, new_tokens, V)


def profile_step(trainer, params, opt_state, batch):
    """One more training step under torch.profiler: the device's busy time
    (the union of its kernels' intervals), the codec kernels' and the AdamW
    shard kernel's time, and the step's host time around it, all in ms;
    prints the kernels that took the most device time. (None, None, None,
    host) if no device event shows."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    spans, codec_us, adamw_us, by_name = [], 0.0, 0.0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            if any(k in e.name for k in CODEC_KERNELS):
                codec_us += us
            if any(k in e.name for k in ADAMW_KERNELS):
                adamw_us += us
    if not spans:
        return None, None, None, host
    total = sum(by_name.values())
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  device time {us / 1e3:10.3f} ms ({us / total:.4f})  {name[:90]}")
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, codec_us / 1e3, adamw_us / 1e3, host


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    exp = torch.frexp(x.float().abs().clamp_min(1e-30))[1]
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


def run_with_step0(trainer, params, opt_state):
    """`trainer.run` in two parts, step 0 and then the rest, so that the
    params after step 0 can be kept (a bf16 copy) for the cross-path checks.
    Each part ends with the Trainer's checkpoint save."""
    steps = trainer.cfg.steps
    trainer.cfg.steps = 1
    trainer.run(params, opt_state)
    after0 = [t.detach().clone() for t in flat_leaves(trainer.params)]
    trainer.cfg.steps = steps
    res = trainer.run(trainer.params, trainer.opt_state, start_step=1)
    return res, after0


def train_run(cfg, shape, compress_bits, checks: bool, ckpt_dir: str) -> dict:
    """3 steps of explicit-DP training through `Trainer` (NCCL, world size 1)
    on one wire, their launch counts, one profiled step more; with `checks`,
    the first step's gradient round trip and loss against the plain versions."""
    trainer = Trainer(cfg, shape, OptConfig(warmup_steps=2, decay_steps=100),
                      TrainConfig(steps=TRAIN_STEPS, log_every=1, explicit_dp=True,
                                  bucket_bytes=BUCKET_BYTES, compress_bits=compress_bits,
                                  ckpt_every=0, ckpt_dir=ckpt_dir))
    params, opt_state = trainer.init_state(seed=0)
    batch0 = trainer.data.batch_at(0)
    out = {}
    if checks:
        # unpack(pack(g)) on the fp32 wire gives back the first step's
        # gradient leaves exactly (a bf16 -> fp32 cast and a multiply by 1)
        _, grads = rsteps.value_and_grad(trainer.model, params, batch0)
        g = flat_leaves(grads)
        table = codec.make_table([t.numel() for t in g], BUCKET_BYTES // 4, reverse=False)
        c, _, _ = codec.pack(table, g)
        back = codec.unpack(table, c, g)
        if not all(torch.equal(a, b.float()) for a, b in zip(back, g)):
            raise AssertionError("fp32 unpack(pack(g)) differs from the step's gradients")
        del grads, g, c, back
        # per-token losses of step 0 through the kernels, the plain versions
        # and the plain versions on an fp32 copy of the weights
        with torch.no_grad():
            nll_k = trainer.model.token_nll(batch0)
            fp32_model = Model(cfg, device="cuda", dtype=torch.float32).load_params(params)
            with plain_versions():
                nll_p = trainer.model.token_nll(batch0)
                nll_f = fp32_model.token_nll(batch0)
            del fp32_model
        diff = (nll_k - nll_p).abs().max().item()
        noise = (nll_p - nll_f).abs().max().item()
        out.update(nll_diff=diff, nll_noise=noise, loss_kernel=nll_k.mean().item(),
                   loss_plain=nll_p.mean().item(), loss_fp32=nll_f.mean().item())
        print(f"step-0 per-token loss {tuple(nll_k.shape)}: mean kernel {out['loss_kernel']:.6f}, "
              f"plain {out['loss_plain']:.6f}, fp32 weights {out['loss_fp32']:.6f}; kernel vs "
              f"plain max abs diff {diff:.4e} (tol {NOISE_FACTOR} x {noise:.4e}, plain bf16 vs "
              f"fp32 weights)")
        if not all(torch.isfinite(t).all() for t in (nll_k, nll_p, nll_f)):
            raise AssertionError("non-finite per-token losses")
        if diff > NOISE_FACTOR * noise:
            raise AssertionError(f"kernel vs plain per-token losses differ by {diff}, beyond "
                                 f"{NOISE_FACTOR} x the bf16 noise floor {noise}")
        del nll_k, nll_p, nll_f
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, after0 = run_with_step0(trainer, params, opt_state)
    launches = ops.launch_counts()
    L = cfg.n_layers
    want = {"rmsnorm": TRAIN_STEPS * (4 * L + 1), "flash_attention": TRAIN_STEPS * 2 * L,
            "bucket_pack": TRAIN_STEPS, "bucket_unpack": TRAIN_STEPS, "adamw_shard": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} on {TRAIN_STEPS} training steps, "
                             f"expected {want}")
    rows = res["metrics"]
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows):
        raise AssertionError(f"non-finite loss or grad norm: {rows}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = {k: torch.as_tensor(v) for k, v in trainer.data.batch_at(TRAIN_STEPS).items()}
    dev_ms, codec_ms, _, prof_host = profile_step(trainer, trainer.params, trainer.opt_state,
                                                  batch)
    tokens = shape.global_batch * shape.seq_len
    host = [r["time_s"] * 1e3 for r in rows]
    steady = float(np.median(host[1:]))
    wire = "int8" if compress_bits else "fp32"
    for r in rows:
        print(f"train {wire} step {r['step']}: loss {r['loss']:.6f} grad_norm "
              f"{r['grad_norm']:.6f} lr {r['lr']:.3e} host {r['time_s'] * 1e3:.3f} ms "
              f"({tokens / r['time_s']:.1f} tokens/s)")
    dev_txt = ("not measured (the profiler saw no device activity)" if dev_ms is None else
               f"{dev_ms:.3f} ms busy, pack+unpack {codec_ms:.4f} ms "
               f"({codec_ms / dev_ms:.4f} of it), idle share {1 - dev_ms / prof_host:.4f} of "
               f"the profiled step's {prof_host:.3f} ms host time")
    print(f"train {wire}: steady host {steady:.3f} ms/step, {tokens / steady * 1e3:.1f} tokens/s; "
          f"device (profiled step {TRAIN_STEPS}): {dev_txt}; peak memory {peak_gb:.2f} GB; "
          f"launches {launches}")
    out.update(launches=launches, rows=rows, steady_ms=steady, dev_ms=dev_ms, codec_ms=codec_ms,
               after0=after0)
    del trainer, params, opt_state, res
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir, ignore_errors=True)   # 1.35 GB a checkpoint
    return out


def train_phase(ckpt_root: str) -> dict:
    cfg = get_config(ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    print(f"train {cfg.name} (L={cfg.n_layers}, d={cfg.d_model}) bf16, seq {TRAIN_SEQ}, global "
          f"batch {TRAIN_BATCH} (train_4k's 256 cut to fit one card), explicit DP on NCCL at "
          f"world size 1, {BUCKET_BYTES >> 20} MiB buckets")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        fp32 = train_run(cfg, shape, 0, checks=True, ckpt_dir=f"{ckpt_root}/dp_fp32")
        int8 = train_run(cfg, shape, 8, checks=False, ckpt_dir=f"{ckpt_root}/dp_int8")
    finally:
        dist.destroy_process_group()
    return {"fp32": fp32, "int8": int8}


def zero_trainer(cfg, shape, compress_bits, ckpt_dir, steps=TRAIN_STEPS, ckpt_every=0, **kw):
    return Trainer(cfg, shape, OptConfig(warmup_steps=2, decay_steps=100),
                   TrainConfig(steps=steps, log_every=1, explicit_dp=True, zero=True,
                               bucket_bytes=BUCKET_BYTES, compress_bits=compress_bits,
                               ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, **kw))


def zero_run(cfg, shape, compress_bits, ckpt_dir, ckpt_every=0) -> dict:
    """3 ZeRO steps from the seed-0 start on one all-gather wire, their launch
    counts, the params after step 0, one profiled step more."""
    trainer = zero_trainer(cfg, shape, compress_bits, ckpt_dir, ckpt_every=ckpt_every)
    params, opt_state = trainer.init_state(seed=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res, after0 = run_with_step0(trainer, params, opt_state)
    launches = ops.launch_counts()
    L = cfg.n_layers
    want = {"rmsnorm": TRAIN_STEPS * (4 * L + 1), "flash_attention": TRAIN_STEPS * 2 * L,
            "bucket_pack": 2 * TRAIN_STEPS, "bucket_unpack": TRAIN_STEPS,
            "adamw_shard": TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"launch counts {launches} on {TRAIN_STEPS} ZeRO steps, "
                             f"expected {want}")
    rows = res["metrics"]
    if not all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows):
        raise AssertionError(f"non-finite loss or grad norm: {rows}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    final = [t.detach().clone() for t in flat_leaves(trainer.params)]   # after step 2
    batch = {k: torch.as_tensor(v) for k, v in trainer.data.batch_at(TRAIN_STEPS).items()}
    dev_ms, codec_ms, adamw_ms, prof_host = profile_step(trainer, trainer.params,
                                                         trainer.opt_state, batch)
    tokens = shape.global_batch * shape.seq_len
    host = [r["time_s"] * 1e3 for r in rows]
    steady = float(np.median(host[1:]))
    wire = "int8" if compress_bits else "fp32"
    for r in rows:
        print(f"train zero {wire} step {r['step']}: loss {r['loss']:.6f} grad_norm "
              f"{r['grad_norm']:.6f} lr {r['lr']:.3e} host {r['time_s'] * 1e3:.3f} ms "
              f"({tokens / r['time_s']:.1f} tokens/s)")
    dev_txt = ("not measured (the profiler saw no device activity)" if dev_ms is None else
               f"{dev_ms:.3f} ms busy, pack+unpack {codec_ms:.4f} ms ({codec_ms / dev_ms:.4f} "
               f"of it), adamw_shard {adamw_ms:.4f} ms ({adamw_ms / dev_ms:.4f} of it), idle "
               f"share {1 - dev_ms / prof_host:.4f} of the profiled step's {prof_host:.3f} ms "
               f"host time")
    print(f"train zero {wire}: steady host {steady:.3f} ms/step, {tokens / steady * 1e3:.1f} "
          f"tokens/s; device (profiled step {TRAIN_STEPS}): {dev_txt}; peak memory "
          f"{peak_gb:.2f} GB; m, v per rank {tuple(trainer.opt_state['m'].shape)} fp32; launches "
          f"{launches}")
    out = dict(launches=launches, rows=rows, steady_ms=steady, dev_ms=dev_ms, after0=after0,
               final=final)
    del trainer, params, opt_state, res
    torch.cuda.empty_cache()
    return out


def check_close_bf16(name, got, want, extra=None):
    """Every leaf within one bf16 ulp (of the larger of the two values) of
    `want`, plus `extra` per element where given."""
    worst = 0.0
    for a, b, e in zip(got, want, extra or [None] * len(got)):
        d = (a.float() - b.float()).abs()
        tol = bf16_ulp(torch.maximum(a.float().abs(), b.float().abs())) + (0 if e is None else e)
        worst = max(worst, (d / tol).max().item())
    print(f"{name}: max |diff| / tolerance {worst:.4f}")
    if worst > 1:
        raise AssertionError(f"{name}: outside tolerance ({worst:.4f} of it)")


def check_first_step(name, got, want, lr, max_share):
    """Params after one AdamW step from one start, with gradients that differ
    by rounding. The first step moves an element by lr * g / (|g| + eps) plus
    the decay (the clip cancels), so a gradient's rounding moves it to another
    bf16 value only where g's sign flips, by at most 2 lr: every element within
    one bf16 ulp plus 2 lr, and at most `max_share` of them beyond one ulp (a
    dropped microbatch of two flips about a quarter of the signs)."""
    worst, off, total = 0.0, 0, 0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        ulp = bf16_ulp(torch.maximum(a.float().abs(), b.float().abs()))
        worst = max(worst, (d / (ulp + 2 * lr * (1 + 2 ** -8))).max().item())
        off += int((d > ulp).sum())
        total += d.numel()
    print(f"{name}: max |diff| / (1 bf16 ulp + 2 lr) {worst:.4f}; {off} of {total} elements "
          f"beyond one ulp (share {off / total:.3e}, limit {max_share:.0e})")
    if worst > 1 or off > max_share * total:
        raise AssertionError(f"{name}: outside tolerance ({worst:.4f}, share {off / total:.3e})")


def zero_phase(ckpt_root: str, dp_fp32: dict) -> dict:
    cfg = get_config(ARCH)
    shape = ShapeConfig("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    print(f"train zero {cfg.name}: the phase-5 start (seed 0), ZeRO on NCCL at world size 1 "
          f"(reduce-scatter, K5 on the rank's (129, 1048576) carrier shard, all-gather)")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(minutes=5))
    try:
        # fp32 all-gather wire; a checkpoint after two steps for the round trip
        fp32 = zero_run(cfg, shape, 0, f"{ckpt_root}/zero_fp32", ckpt_every=2)
        if fp32["rows"][0]["loss"] != dp_fp32["rows"][0]["loss"]:
            raise AssertionError(f"ZeRO step-0 loss {fp32['rows'][0]['loss']} differs from the "
                                 f"replicated step's {dp_fp32['rows'][0]['loss']}")
        # the same update of the same gradients; the clip factor may differ by an
        # ulp (the grad norm's sum runs over the carrier, not leaf by leaf)
        check_close_bf16("ZeRO fp32 wire vs replicated, params after step 0",
                         fp32["after0"], dp_fp32["after0"])

        # checkpoint round trip: restore step 2 into a fresh Trainer and run step 2
        trainer = zero_trainer(cfg, shape, 0, f"{ckpt_root}/zero_fp32")
        params, opt_state, start = trainer.restore(step=2)
        res = trainer.run(params, opt_state, start_step=start)
        resumed = flat_leaves(trainer.params)
        same = (start == 2 and res["metrics"][0]["loss"] == fp32["rows"][2]["loss"]
                and all(torch.equal(a, b) for a, b in zip(resumed, fp32["final"])))
        print(f"checkpoint round trip: restored step {start}, step-2 loss "
              f"{res['metrics'][0]['loss']:.6f} (uninterrupted {fp32['rows'][2]['loss']:.6f}), "
              f"params {'equal' if same else 'DIFFERENT'} bit for bit")
        if not same:
            raise AssertionError("the resumed ZeRO run differs from the uninterrupted one")
        del trainer, params, opt_state, res, resumed
        torch.cuda.empty_cache()
        shutil.rmtree(f"{ckpt_root}/zero_fp32", ignore_errors=True)

        # int8 all-gather wire: step 0's params are the fp32 wire's p_new through
        # q = rint(p / s): within half a step s of the row (the codec's row),
        # and a bf16 rounding each side
        int8 = zero_run(cfg, shape, 8, f"{ckpt_root}/zero_int8")
        shutil.rmtree(f"{ckpt_root}/zero_int8", ignore_errors=True)
        table = codec.make_table([t.numel() for t in fp32["after0"]], BUCKET_BYTES // 4,
                                 reverse=False)
        rows_max = codec.pack(table, fp32["after0"])[0].abs().amax(dim=1)
        half_step = codec.unpack(table, (rows_max / 127 * 0.5 * (1 + 2 ** -8))[:, None]
                                 .expand(-1, table.bucket_elems).contiguous(), fp32["after0"])
        check_close_bf16("ZeRO int8 wire vs fp32 wire, params after step 0", int8["after0"],
                         fp32["after0"], half_step)

        # the overlap schedule with 2 microbatches of 4, one step
        trainer = zero_trainer(cfg, shape, 0, f"{ckpt_root}/zero_mb2", steps=1, overlap=True,
                               microbatches=2)
        params, opt_state = trainer.init_state(seed=0)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res = trainer.run(params, opt_state)
        mb_launches = ops.launch_counts()
        mb_peak = torch.cuda.max_memory_allocated() / 1e9
        L = cfg.n_layers
        want = {"rmsnorm": 2 * (4 * L + 1), "flash_attention": 2 * 2 * L, "bucket_pack": 3,
                "bucket_unpack": 1, "adamw_shard": 1}
        loss_mb, loss_one = res["metrics"][0]["loss"], fp32["rows"][0]["loss"]
        gn_mb, gn_one = res["metrics"][0]["grad_norm"], fp32["rows"][0]["grad_norm"]
        print(f"train zero overlap, 2 microbatches of {TRAIN_BATCH // 2}: loss {loss_mb:.6f} "
              f"(unsplit {loss_one:.6f}, relative difference "
              f"{abs(loss_mb - loss_one) / loss_one:.3e}), grad norm {gn_mb:.6f} (unsplit "
              f"{gn_one:.6f}, relative difference {abs(gn_mb - gn_one) / gn_one:.3e}), host "
              f"{res['metrics'][0]['time_s'] * 1e3:.3f} ms, peak memory {mb_peak:.2f} GB; "
              f"launches {mb_launches}")
        if mb_launches != want:
            raise AssertionError(f"launch counts {mb_launches} on the microbatched ZeRO step, "
                                 f"expected {want}")
        if not abs(loss_mb - loss_one) <= 1e-3 * abs(loss_one):
            raise AssertionError(f"microbatched loss {loss_mb} vs unsplit {loss_one}")
        # the loss is the forwards' alone; the accumulated reduce-scatter shards
        # reach the grad norm (a dropped or misscaled microbatch moves it by a
        # quarter or more) and the params
        if not abs(gn_mb - gn_one) <= 1e-3 * gn_one:
            raise AssertionError(f"microbatched grad norm {gn_mb} vs unsplit {gn_one}")
        check_first_step("ZeRO overlap 2 microbatches vs unsplit, params after step 0",
                         flat_leaves(trainer.params), fp32["after0"], res["metrics"][0]["lr"],
                         MB_FLIP_SHARE)
        del trainer, params, opt_state, res
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return {"fp32": fp32, "int8": int8, "mb2": {"launches": mb_launches}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in true fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. The card and the toolchain.
    card = card_line()
    print(card)
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (Hopper), found {cap}")
    nvcc = _build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], check=True, capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    print(f"toolchain: torch {torch.__version__}, CUDA {torch.version.cuda}, capability "
          f"{cap[0]}.{cap[1]}, nvcc {nvcc_ver}, triton "
          f"{'present' if importlib.util.find_spec('triton') else 'absent'}")

    # 2. Build every kernel.
    t0 = time.perf_counter()
    per_kernel = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s wall, per kernel "
          + ", ".join(f"{n} {s:.2f} s" for n, s in per_kernel.items()))
    for name in _build.KERNELS:
        for line in (_build.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3. Each kernel against its plain version: K1 and K2 at the serving
    # prefill's and decode's shapes, the training step's (BH = 8 x 9 heads at
    # S = 4096; 8 x 4096 rows), ragged ones, and K2 at head dim 32 (the
    # launcher's --reduced preset).
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for s, causal in ((128, True), (2048, True), (TRAIN_SEQ, True), (100, True),
                          (128, False)):
            rows.append(compare_flash(BATCH * 9, s, dtype, causal, gen))
        rows.append(compare_flash(16, 64, dtype, True, gen, hd=32))
        for r in (BATCH * PROMPT, BATCH, TRAIN_BATCH * TRAIN_SEQ, 1000):
            rows.append(compare_rmsnorm(r, 576, dtype, gen))
    # K3 and K4: smollm-135m's gradient leaves in 4 MiB buckets (the training
    # path's table), and a ragged table with zero-size leaves.
    cfg = get_config(ARCH)
    for dtype in (torch.bfloat16, torch.float32):
        leaves = smollm_grad_leaves(cfg, dtype, gen)
        table = codec.make_table([t.numel() for t in leaves], BUCKET_BYTES // 4, reverse=False)
        for wire in (("fp32", "bf16", "int8") if dtype == torch.bfloat16 else ("fp32",)):
            rows += compare_codec(table, leaves, wire, gen, "smollm-135m")
        del leaves
    ragged = [torch.randn(sh, generator=gen, device="cuda").to(torch.bfloat16)
              for sh in ((0, 3), (7, 5), (0,), (1000,), (13,), (0,))]
    for wire in ("fp32", "bf16", "int8"):
        rows += compare_codec(codec.make_table([t.numel() for t in ragged], 64, reverse=True),
                              ragged, wire, gen, "ragged")
    # K5 at the ZeRO step's carrier shard at world size 1, the last row's pad
    # included, and at a ragged shape (4-byte accesses, an all-pad row).
    tail = table.total_elems - (table.n_buckets - 1) * table.bucket_elems
    for wire in ("fp32", "int8"):
        rows.append(compare_adamw(table.n_buckets, table.bucket_elems, tail, wire, gen,
                                  "smollm-135m"))
        rows.append(compare_adamw(5, 1003, 0, wire, gen, "ragged"))
    torch.cuda.empty_cache()
    fmt = lambda v: "-" if v is None else f"{v:.5f}"
    print("ms, plain_ms, library_ms: device time per call (CUDA graph replay); call_ms: "
          "the kernel's eager per-call time (events around back-to-back calls)")
    print("kernel           dtype           shape             causal  max_abs_err  tol(a,r)      "
          "ms         plain_ms   library_ms  call_ms    bound_ms   bound_by")
    for r in rows:
        print(f"{r['name']:<16} {r['dtype']:<15} {str(r['shape']):<17} "
              f"{str(r.get('causal', r.get('table', ''))):<7} "
              f"{r['max_abs_err']:<12.3e} {r['atol']:.0e},{r['rtol']:.0e}  {r['ms']:<10.5f} "
              f"{r['plain_ms']:<10.5f} {fmt(r['library_ms']):<11} {r['call_ms']:<10.5f} "
              f"{r['bound_ms']:<10.5f} {r['bound_by']}{'' if r['ok'] else '  FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparisons outside tolerance: {bad}")

    # 4. Serve smollm-135m at full width through the kernels. A short warm-up
    # run first takes cuBLAS' and the allocator's one-time costs.
    server = BatchedServer(cfg, max_seq=PROMPT + NEW_TOKENS + 8, batch_size=BATCH)
    prompts = np.random.RandomState(0).randint(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
    t0 = time.perf_counter()
    server.generate(prompts, ServeConfig(max_new_tokens=2))
    print(f"warm-up generate (2 new tokens): {time.perf_counter() - t0:.3f} s")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = server.generate(prompts, ServeConfig(max_new_tokens=NEW_TOKENS))
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    tm = server.last_timing
    print(f"serve {cfg.name} (L={cfg.n_layers}, d={cfg.d_model}, H={cfg.n_heads}, "
          f"K={cfg.n_kv_heads}, V={cfg.vocab}) bf16, batch {BATCH}, prompt {PROMPT}, "
          f"{NEW_TOKENS} new: prefill {tm['prefill_s'] * 1e3:.3f} ms, decode "
          f"{tm['decode_s'] / tm['decode_steps'] * 1e3:.3f} ms/token, "
          f"{BATCH * out.shape[1] / wall:.1f} tokens/s ({wall:.3f} s wall); launches {launches}")
    want = {"flash_attention": cfg.n_layers,
            "rmsnorm": (2 * cfg.n_layers + 1) * (1 + NEW_TOKENS),
            "bucket_pack": 0, "bucket_unpack": 0, "adamw_shard": 0}
    if launches != want:
        raise AssertionError(f"launch counts {launches} on the serve run, expected {want}")
    if out.shape != (BATCH, NEW_TOKENS) or out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"generated ids out of range or shape {out.shape}")

    # The same tokens, teacher-forced: through the kernels, greedy decoding must
    # give back the served tokens; through the plain versions, the logits agree
    # within the bf16 noise floor, measured against an fp32 copy of the weights.
    lg_kernel = teacher_forced(server.model, server.shape, prompts, out)
    n_before = ops.launch_counts()
    fp32_model = Model(cfg, device="cuda", dtype=torch.float32).load_params(
        server.model.params.as_dict())
    with plain_versions():
        lg_plain = teacher_forced(server.model, server.shape, prompts, out)
        lg_fp32 = teacher_forced(fp32_model, server.shape, prompts, out)
    del fp32_model
    if ops.launch_counts() != n_before:
        raise AssertionError("the plain reference runs launched a kernel")
    if not all(torch.isfinite(t).all() for t in (lg_kernel, lg_plain, lg_fp32)):
        raise AssertionError("non-finite logits")
    regreedy = lg_kernel.argmax(-1).cpu().numpy()
    diff = (lg_kernel - lg_plain).abs().max().item()
    noise = (lg_plain - lg_fp32).abs().max().item()
    k_err = (lg_kernel - lg_fp32).abs()
    p_err = (lg_plain - lg_fp32).abs()
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    print(f"teacher-forced logits {tuple(lg_kernel.shape)}: max|logit| "
          f"{lg_fp32.abs().max().item():.4f}; kernel vs plain max abs diff {diff:.4e} "
          f"(tol {NOISE_FACTOR} x {noise:.4e}); vs fp32 weights: kernel path max "
          f"{k_err.max().item():.4e} mean {k_err.mean().item():.4e}, plain path max "
          f"{p_err.max().item():.4e} mean {p_err.mean().item():.4e}; greedy agreement "
          f"kernel/plain {agree(lg_kernel, lg_plain):.4f}, kernel/fp32 "
          f"{agree(lg_kernel, lg_fp32):.4f}, plain/fp32 {agree(lg_plain, lg_fp32):.4f}")
    if not np.array_equal(regreedy, out):
        raise AssertionError("teacher-forced greedy tokens differ from the served ones")
    if diff > NOISE_FACTOR * noise:
        raise AssertionError(f"kernel vs plain logits differ by {diff}, beyond "
                             f"{NOISE_FACTOR} x the bf16 noise floor {noise}")

    # Device time of one prefill and one decode step (CUDA graph replay), beside
    # the host-clock times of the served run: the difference is host overhead,
    # during which the device idles.
    cache = server.model.init_cache(server.shape, batch_size=BATCH)
    tokens = torch.as_tensor(prompts, device="cuda")
    prefill_dev = device_ms(lambda: server.model.prefill(tokens, cache), calls=1)
    step = torch.as_tensor(out[:, 0], device="cuda")
    decode_dev = device_ms(lambda: server.model.decode(cache, step, PROMPT), calls=1)
    decode_host = tm["decode_s"] / tm["decode_steps"] * 1e3
    print(f"device time per call: prefill {prefill_dev:.4f} ms (host clock "
          f"{tm['prefill_s'] * 1e3:.3f} ms), decode step {decode_dev:.4f} ms (host clock "
          f"{decode_host:.3f} ms): device idle share of decode {1 - decode_dev / decode_host:.4f}")

    del server, cache, tokens, step, lg_kernel, lg_plain, lg_fp32
    torch.cuda.empty_cache()

    # 5. Train smollm-135m at full width through the kernels; 6. the same with
    # ZeRO. Checkpoints go to a temporary directory, removed at the end.
    ckpt_root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        train = train_phase(ckpt_root)
        zero = zero_phase(ckpt_root, train["fp32"])
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    train_launches = {n: train["fp32"]["launches"][n] + train["int8"]["launches"][n]
                      for n in train["fp32"]["launches"]}
    zero_launches = {n: zero["fp32"]["launches"][n] + zero["int8"]["launches"][n]
                     for n in zero["fp32"]["launches"]}

    # 7. Results: one entry per kernel and path, each with the phase-3 row at
    # the shape that path gives the kernel and the launches of that path's run.
    # K1 and K2 serving (prefill shapes), training and ZeRO training (both
    # wires' runs); K3 and K4 on the training path's bf16 leaves, once for each
    # wire's run; under ZeRO K3 packs gradients and params to the fp32 carrier
    # and K4 unpacks an fp32 carrier on either all-gather wire, and K5 updates
    # the (129, 1048576) shard on each wire; the microbatched ZeRO step's own
    # launches.
    headline = (
        ("serve", "flash_attention", [BATCH * 9, PROMPT, 64], "bfloat16", True, launches),
        ("serve", "rmsnorm", [BATCH * PROMPT, 576], "bfloat16", None, launches),
        ("train", "flash_attention", [BATCH * 9, TRAIN_SEQ, 64], "bfloat16", True,
         train_launches),
        ("train", "rmsnorm", [TRAIN_BATCH * TRAIN_SEQ, 576], "bfloat16", None, train_launches),
        ("train, fp32 wire", "bucket_pack", None, "bfloat16->fp32", "smollm-135m",
         train["fp32"]["launches"]),
        ("train, fp32 wire", "bucket_unpack", None, "bfloat16->fp32", "smollm-135m",
         train["fp32"]["launches"]),
        ("train, int8 wire", "bucket_pack", None, "bfloat16->int8", "smollm-135m",
         train["int8"]["launches"]),
        ("train, int8 wire", "bucket_unpack", None, "bfloat16->int8", "smollm-135m",
         train["int8"]["launches"]),
        ("train zero", "flash_attention", [BATCH * 9, TRAIN_SEQ, 64], "bfloat16", True,
         zero_launches),
        ("train zero", "rmsnorm", [TRAIN_BATCH * TRAIN_SEQ, 576], "bfloat16", None,
         zero_launches),
        ("train zero, fp32 wire", "bucket_pack", None, "bfloat16->fp32", "smollm-135m",
         zero["fp32"]["launches"]),
        ("train zero, fp32 wire", "bucket_unpack", None, "bfloat16->fp32", "smollm-135m",
         zero["fp32"]["launches"]),
        ("train zero, fp32 wire", "adamw_shard", None, "float32->fp32", "smollm-135m",
         zero["fp32"]["launches"]),
        ("train zero, int8 wire", "bucket_pack", None, "bfloat16->fp32", "smollm-135m",
         zero["int8"]["launches"]),
        ("train zero, int8 wire", "bucket_unpack", None, "bfloat16->fp32", "smollm-135m",
         zero["int8"]["launches"]),
        ("train zero, int8 wire", "adamw_shard", None, "float32->int8", "smollm-135m",
         zero["int8"]["launches"]),
        ("train zero overlap 2 microbatches, fp32 wire", "bucket_pack", None, "bfloat16->fp32",
         "smollm-135m", zero["mb2"]["launches"]),
        ("train zero overlap 2 microbatches, fp32 wire", "bucket_unpack", None,
         "bfloat16->fp32", "smollm-135m", zero["mb2"]["launches"]),
        ("train zero overlap 2 microbatches, fp32 wire", "adamw_shard", None, "float32->fp32",
         "smollm-135m", zero["mb2"]["launches"]))
    kernels = []
    for path, name, shape, dt, tag, counts in headline:
        r = next(r for r in rows if r["name"] == name and shape in (None, r["shape"])
                 and r["dtype"] == dt and r.get("causal", r.get("table")) == tag)
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "call_ms": r["call_ms"], "shape": r["shape"], "dtype": dt,
                        "path": path})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
