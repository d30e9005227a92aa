#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

  python3 chip_smoke.py

Phases, each fatal on failure (the script exits nonzero and prints no result):
  1. the card: name and power limit from nvidia-smi, compute capability 9.0,
     and the toolchain (torch, CUDA, nvcc, Triton);
  2. builds every kernel from `src/repro_torch/kernels/csrc` (one nvcc each, in
     parallel) and prints the build time and ptxas' register report;
  3. holds each kernel against its plain PyTorch version on the card, in fp32
     and bf16, at the serving shapes plus a ragged one, and times the kernel,
     the plain version and one PyTorch library call (device time, by CUDA
     graph replay) beside its bound, and the kernel's eager per-call time;
  4. serves smollm-135m at full width (random weights from seed 0, batch 8,
     128-token prompts, 32 greedy new tokens) through `BatchedServer`, checks
     the kernels' launch counts on that run, and reruns the same tokens
     teacher-forced through the kernels and through the plain versions;
  5. prints a JSON line with each kernel's numbers, then the device line last.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels import rmsnorm as rn_kernel  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.runtime.serve import BatchedServer, ServeConfig  # noqa: E402

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
           "rmsnorm": "src/repro_torch/kernels/csrc/rmsnorm.cu"}
REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:24",
            "rmsnorm": "src/repro/kernels/rmsnorm.py:17"}


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


def timings(kernel, plain, library) -> dict:
    """Device times (the JSON's ms, plain_ms, library_ms) and the kernel's
    eager per-call time."""
    return dict(ms=device_ms(kernel), plain_ms=device_ms(plain), library_ms=device_ms(library),
                call_ms=call_ms(kernel))


def bound(nbytes: float, nops: float, dtype) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_violation(got, want, atol, rtol) -> tuple:
    err = (got.float() - want.float()).abs()
    excess = (err - (atol + rtol * want.float().abs())).max().item()
    return err.max().item(), excess


def compare_flash(bh, s, dtype, causal, gen):
    q, k, v = (torch.randn(bh, s, fa_kernel.HEAD_DIM, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    got = fa_kernel.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol, rtol = TOL[("flash_attention", dtype)]
    err, excess = max_violation(got, want, atol, rtol)
    hd, es = q.shape[-1], q.element_size()
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
                                                         is_causal=causal)))


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


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to the plain versions, for the reference run."""
    saved = ops.rmsnorm, ops.flash_attention

    def flash_plain(q, k, v, *, causal=True):
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

    # 3. Each kernel against its plain version.
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for s, causal in ((128, True), (2048, True), (100, True), (128, False)):
            rows.append(compare_flash(BATCH * 9, s, dtype, causal, gen))
        for r in (BATCH * PROMPT, BATCH, 1000):
            rows.append(compare_rmsnorm(r, 576, dtype, gen))
    print("ms, plain_ms, library_ms: device time per call (CUDA graph replay); call_ms: "
          "the kernel's eager per-call time (events around back-to-back calls)")
    print("kernel           dtype     shape             causal  max_abs_err  tol(a,r)      "
          "ms         plain_ms   library_ms  call_ms    bound_ms   bound_by")
    for r in rows:
        print(f"{r['name']:<16} {r['dtype']:<9} {str(r['shape']):<17} {str(r.get('causal', '')):<7} "
              f"{r['max_abs_err']:<12.3e} {r['atol']:.0e},{r['rtol']:.0e}  {r['ms']:<10.5f} "
              f"{r['plain_ms']:<10.5f} {r['library_ms']:<11.5f} {r['call_ms']:<10.5f} "
              f"{r['bound_ms']:<10.5f} {r['bound_by']}{'' if r['ok'] else '  FAIL'}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel comparisons outside tolerance: {bad}")

    # 4. Serve smollm-135m at full width through the kernels. A short warm-up
    # run first takes cuBLAS' and the allocator's one-time costs.
    cfg = get_config(ARCH)
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
            "rmsnorm": (2 * cfg.n_layers + 1) * (1 + NEW_TOKENS)}
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

    # 5. Results.
    headline = {"flash_attention": ([BATCH * 9, PROMPT, 64], "bfloat16", True),
                "rmsnorm": ([BATCH * PROMPT, 576], "bfloat16", None)}
    kernels = []
    for name, (shape, dt, causal) in headline.items():
        r = next(r for r in rows if r["name"] == name and r["shape"] == shape
                 and r["dtype"] == dt and r.get("causal") == causal)
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "call_ms": r["call_ms"], "shape": shape, "dtype": dt})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
