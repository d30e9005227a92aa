"""The port's ZeRO slice against the JAX package's, on the same numpy inputs:
the fused sharded AdamW update (K5's plain version), the ZeRO step, and the
overlap schedule and microbatches on both branches of the explicit-DP step,
on gloo ranks against the JAX step on as many forced host devices.

On the CPU `adamw_update_shard` runs its plain version (`kernels/ref.py`);
the CUDA kernel is held against it on the card by tests/test_torch_gpu.py and
chip_smoke.py. Params are fp32 on both sides, as in tests/test_torch_train.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import bucket_codec as jbc
from repro.optim import adamw as jadamw
from repro.runtime import steps as jsteps
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import _build, bucket_codec as bc, ops, ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model, flat_leaves
from repro_torch.optim import adamw
from repro_torch.runtime import steps

from .helpers import run_devices
from .test_torch_codec import _two_threads, run_ranks  # noqa: F401 (autouse fixture)
from .test_torch_train import (ARCH, DP_NOISE, DP_NOISE_SHARE, DP_OPT, DP_PARAM_ATOL, DP_STEPS,
                               _jax_params, with_group)

B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1


# ------------------------------------------------------ K5's plain version
def _k5_inputs(nb, sh, pad_cols, seed):
    """g, p, m, v as (nb, sh) fp32 with the carrier's zero pads: the last
    `pad_cols` columns and, when nb > 1, a whole last row (a bucket shard that
    holds only pad)."""
    rng = np.random.RandomState(seed)
    g = rng.randn(nb, sh).astype(np.float32) * np.float32(1e-2)
    p = rng.randn(nb, sh).astype(np.float32)
    m = rng.randn(nb, sh).astype(np.float32) * np.float32(1e-3)
    v = rng.rand(nb, sh).astype(np.float32) * np.float32(1e-4)
    for a in (g, p, m, v):
        a[:, sh - pad_cols:] = 0
        if nb > 1:
            a[-1] = 0
    return g, p, m, v


def _scalars(step_no, clip):
    """(JAX, port) clip, lr, bc1, bc2: the bias corrections as each package's
    step forms them (equal bits), lr a fixed fp32."""
    jbc1 = 1 - B1 ** jnp.float32(step_no)
    jbc2 = 1 - B2 ** jnp.float32(step_no)
    tbc1 = 1 - B1 ** torch.tensor(float(step_no))
    tbc2 = 1 - B2 ** torch.tensor(float(step_no))
    assert np.float32(jbc1) == tbc1.numpy() and np.float32(jbc2) == tbc2.numpy()
    lr = np.float32(3e-4)
    return ((jnp.float32(clip), jnp.float32(lr), jbc1, jbc2),
            (torch.tensor(clip, dtype=torch.float32), torch.tensor(lr), tbc1, tbc2))


def _both(args, step_no, clip, wire, impl):
    (jc, jl, j1, j2), (tc, tl, t1, t2) = _scalars(step_no, clip)
    want = jbc.adamw_update_shard(*(jnp.asarray(a) for a in args), clip=jc, lr=jl, bc1=j1,
                                  bc2=j2, b1=B1, b2=B2, eps=EPS, weight_decay=WD, wire=wire,
                                  impl=impl)
    got = bc.adamw_update_shard(*(torch.from_numpy(a) for a in args), clip=tc, lr=tl, bc1=t1,
                                bc2=t2, b1=B1, b2=B2, eps=EPS, weight_decay=WD, wire=wire)
    return want, got


def _bits(x):
    """Raw bits as integers (int8, bf16 and fp32 alike): differences of
    these are ulp distances (q's: quantization steps)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view({1: np.int8, 2: np.int16, 4: np.int32}[x.dtype.itemsize]).astype(np.int64)


K5_CASES = [  # (nb, sh, pad_cols, step, clip)
    (4, 1003, 7, 1, 1.0),      # ragged shard width, an all-pad row, step-1 bias corrections
    (4, 1003, 7, 3, 0.37),     # clip < 1, step-3 bias corrections
    (3, 256, 0, 3, 1.0),
    (1, 17, 5, 1, 0.37),
]


@pytest.mark.parametrize("nb,sh,pad_cols,step_no,clip", K5_CASES)
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_adamw_shard_plain_is_jax_eager_bit_for_bit(nb, sh, pad_cols, step_no, clip, wire):
    """Against `_adamw_shard_xla` run op by op: every output equal bit for
    bit (the int8 wire's q, s, m and v too), and the pads stay zero."""
    args = _k5_inputs(nb, sh, pad_cols, nb * sh + step_no)
    want, got = _both(args, step_no, clip, wire, "xla")
    assert (want[1] is None) == (got[1] is None) == (wire != "int8")
    assert got[0].dtype == bc.WIRE_DTYPES[wire] and got[2].dtype == got[3].dtype == torch.float32
    for w, t in zip(want, got):
        if w is not None:
            np.testing.assert_array_equal(_bits(t), _bits(w))
    for t in (got[0], got[2], got[3]):
        assert not t[:, sh - pad_cols:].float().any()
        if nb > 1:
            assert not t[-1].float().any()


@pytest.mark.parametrize("nb,sh,pad_cols,step_no,clip", K5_CASES)
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
def test_adamw_shard_plain_within_one_ulp_of_the_pallas_kernel(nb, sh, pad_cols, step_no,
                                                               clip, wire):
    """Against the Pallas kernel in interpret mode, which XLA compiles as one
    jitted function and so contracts a*b + c into FMAs (the JAX package's own
    notes record the same gap against its eager path): the fp32 outputs within 1 ulp of their row's
    largest magnitude, the bf16 params and the scales within 1 ulp, q within
    one step (an element whose p_new lies within an ulp of a boundary)."""
    args = _k5_inputs(nb, sh, pad_cols, nb * sh + step_no)
    want, got = _both(args, step_no, clip, wire, "pallas")
    for i, (w, t) in enumerate(zip(want, got)):
        if w is None:
            continue
        if t.dtype == torch.float32 and t.dim() == 2:
            # m = b1·m + (1 − b1)·g can cancel, so an FMA's one rounding is an
            # ulp of the terms, not of the result: within 1 ulp of the row's
            # largest magnitude (as tests/test_torch_codec.py holds K3's err)
            w = np.asarray(w)
            ulp = np.spacing(np.abs(w).max(axis=1, keepdims=True))
            assert (np.abs(t.numpy() - w) <= ulp).all(), f"output {i}"
        else:   # bf16 p_wire, int8 q, fp32 scales: elementwise
            assert np.abs(_bits(t) - _bits(w)).max() <= 1, f"output {i}"


def test_adamw_update_shard_refuses_an_unknown_wire():
    args = [torch.zeros(2, 3)] * 4
    with pytest.raises(ValueError, match="unknown wire"):
        bc.adamw_update_shard(*args, clip=1.0, lr=1.0, bc1=1.0, bc2=1.0, b1=B1, b2=B2,
                              eps=EPS, weight_decay=WD, wire="fp8")


def test_cuda_shards_reach_the_adamw_kernel_or_raise(monkeypatch):
    """A CUDA tensor never takes the plain update: it goes to the kernel's
    library, and when that cannot be had the call raises and counts nothing."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError(f"cannot build {name}")

    def plain_taken(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(ref, "adamw_shard_ref", plain_taken)
    ops.reset_launch_counts()
    with FakeTensorMode():
        g, p, m, v = (torch.empty(3, 8, device="cuda") for _ in range(4))
        for wire in ("fp32", "int8"):
            with pytest.raises(RuntimeError, match="cannot build adamw_shard"):
                bc.adamw_update_shard(g, p, m, v, clip=1.0, lr=1.0, bc1=1.0, bc2=1.0, b1=B1,
                                      b2=B2, eps=EPS, weight_decay=WD, wire=wire)
        with pytest.raises(ValueError, match="float32"):
            bc.adamw_update_shard(g, p.bfloat16(), m, v, clip=1.0, lr=1.0, bc1=1.0, bc2=1.0,
                                  b1=B1, b2=B2, eps=EPS, weight_decay=WD)
    assert asked == ["adamw_shard", "adamw_shard"]
    assert ops.launch_counts()["adamw_shard"] == 0


# ------------------------------------------------------- the whole steps
# (name, ranks, step kwargs); every case buckets at 64 KiB, so the reduced
# model's 331,776 parameters fill 21 rows of 16,384 (tail 4,096).
STEP_CASES = [
    ("zero", 2, dict(zero=True)),
    ("zero_int8", 2, dict(zero=True, compress_bits=8)),
    ("zero_overlap", 2, dict(zero=True, overlap=True)),
    ("zero_overlap_mb2", 2, dict(zero=True, overlap=True, microbatches=2)),
    ("overlap", 2, dict(overlap=True)),
    ("overlap_int8", 2, dict(overlap=True, compress_bits=8)),
    ("overlap_mb2", 2, dict(overlap=True, microbatches=2)),
    ("overlap_int8_mb2", 2, dict(overlap=True, compress_bits=8, microbatches=2)),
    ("zero_4", 4, dict(zero=True)),        # padded = ceil(16384 / 4) * 4, 4 column blocks
]
BUCKET_BYTES = 1 << 16


def _cases(n):
    return [(name, kw) for name, r, kw in STEP_CASES if r == n]


@pytest.fixture(scope="module")
def step_runs(tmp_path_factory):
    """Both packages' losses, grad norms, opt-state shapes and final params,
    per case, from the same fp32 params and SyntheticLM batches."""
    tmp = tmp_path_factory.mktemp("zero")
    _, _, params = _jax_params()
    np.savez(tmp / "params.npz", *[np.asarray(a) for a in jax.tree.leaves(params)])
    for n in (2, 4):
        run_devices(f"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import SHAPES, get_config
from repro.data.pipeline import SyntheticLM
from repro.models import build_model
from repro.optim import adamw
from repro.runtime.steps import build_explicit_dp_step
T = {str(tmp)!r}
cfg = get_config("{ARCH}").reduced()
jm = build_model(cfg)
tdef = jax.tree.structure(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
p0 = tdef.unflatten([jnp.asarray(a) for a in np.load(T + "/params.npz").values()])
mesh = Mesh(np.array(jax.devices()[:{n}]), ("data",))
opt = adamw.OptConfig(**{DP_OPT!r})
data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
out = {{}}
for name, kw in {_cases(n)!r}:
    step = build_explicit_dp_step(jm, opt, mesh, "data", bucket_bytes={BUCKET_BYTES}, **kw)
    p, o = p0, step.init_opt_state(p0)
    err = step.init_error_state(p)
    rows = []
    for s in range({DP_STEPS}):
        batch = {{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}}
        p, o, m, err = step(p, o, batch, err)
        rows.append([float(m["loss"]), float(m["grad_norm"])])
    m_shape = [list(o["m"].shape), list(o["m"].addressable_shards[0].data.shape)] \\
        if kw.get("zero") else None
    out[name] = {{"rows": rows, "m": m_shape,
                  "err": [list(e.shape) for e in jax.tree.leaves(err)]}}
    np.savez(T + f"/jax-{{name}}.npz", *[np.asarray(a) for a in jax.tree.leaves(p)])
json.dump(out, open(T + "/jax{n}.json", "w"))
""", n_devices=n)
        run_ranks(f"""
            import json, numpy as np
            from repro_torch.configs import SHAPES, get_config
            from repro_torch.data.pipeline import SyntheticLM
            from repro_torch.models.model import Model, flat_leaves, unflatten_like
            from repro_torch.optim import adamw
            from repro_torch.runtime.steps import build_explicit_dp_step
            cfg = get_config("{ARCH}").reduced()
            model = Model(cfg, device="cpu", dtype=torch.float32)
            p0 = [torch.from_numpy(a) for a in np.load(TMP + "/params.npz").values()]
            data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
            opt = adamw.OptConfig(**{DP_OPT!r})
            out = {{}}
            for name, kw in {_cases(n)!r}:
                model.load_params(unflatten_like(model.params.as_dict(), p0))
                step = build_explicit_dp_step(model, opt, bucket_bytes={BUCKET_BYTES}, **kw)
                p = model.params.as_dict()
                o = step.init_opt_state(p)
                err = step.init_error_state(p)
                rows = []
                for s in range({DP_STEPS}):
                    batch = {{k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}}
                    p, o, m, err = step(p, o, batch, err)
                    rows.append([float(m["loss"]), float(m["grad_norm"])])
                m_shape = [list(step.abstract_opt_state(p)["m"].shape), list(o["m"].shape)] \\
                    if kw.get("zero") else None
                e = flat_leaves(err) if isinstance(err, dict) else [err]
                out[name] = {{"rows": rows, "m": m_shape, "err": [list(t.shape) for t in e]}}
                np.savez(TMP + f"/port{{RANK}}-{{name}}.npz",
                         *[t.detach().numpy() for t in flat_leaves(p)])
            json.dump(out, open(TMP + f"/port{n}-{{RANK}}.json", "w"))
            """, n, tmp)
    return tmp, {n: json.load(open(tmp / f"jax{n}.json")) for n in (2, 4)}, \
        {n: [json.load(open(tmp / f"port{n}-{r}.json")) for r in range(n)] for n in (2, 4)}


@pytest.mark.parametrize("name,n,kw", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_step_matches_jax(step_runs, name, n, kw):
    """Two steps of the port on n gloo ranks against the JAX step on n
    devices: loss and grad norm to 1e-5 relative (summation order: the
    reference's own ZeRO grad norm differs from its replicated one by 3e-6),
    equal error-state and opt-state shapes (under ZeRO each rank's m is its
    (n_buckets, padded / n) column block of the global (n_buckets, padded)),
    params as tests/test_torch_train.py holds the explicit-DP step's, and
    every rank holds the same values."""
    tmp, jx, port = step_runs
    ranks = port[n]
    assert all(r[name] == ranks[0][name] for r in ranks)
    got, want = ranks[0][name], jx[n][name]
    np.testing.assert_allclose(np.array(got["rows"]), np.array(want["rows"]), rtol=1e-5)
    assert got["m"] == want["m"] and got["err"] == want["err"]
    share = DP_NOISE_SHARE[kw.get("compress_bits", 0)]
    finals = [np.load(tmp / f"port{r}-{name}.npz") for r in range(n)]
    for i, (a, b) in enumerate(zip(finals[0].values(), np.load(tmp / f"jax-{name}.npz").values())):
        for other in finals[1:]:
            np.testing.assert_array_equal(other[f"arr_{i}"], a)
        d = np.abs(a - b)
        assert d.max() <= DP_PARAM_ATOL, f"leaf {i}"
        assert (d > DP_NOISE).mean() <= share, f"leaf {i}"


def test_zero_step_equals_the_replicated_step_at_one_rank():
    """With the clip inactive (clip_norm 1e9), one rank's ZeRO step and its
    replicated step do the same fp32 arithmetic on every element: the codec
    packs at scale 1, the reduce-scatter and all-gather of one rank are
    copies, and K5's plain version is `apply_updates`' op order. Params equal
    bit for bit after two steps (the reference holds the same,
    tests/test_codec.py's ZeRO bit-parity test). One intra-op thread: with
    several, the CPU GEMMs of the backward round differently with the
    buffers' alignment, so two runs of either step need not agree."""
    cfg = get_config(ARCH).reduced()
    opt = adamw.OptConfig(**{**DP_OPT, "clip_norm": 1e9})
    data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
    _, _, params = _jax_params()
    p0 = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    def run(**kw):
        model = Model(cfg, device="cpu", dtype=torch.float32)
        model.load_params(p0)
        step = steps.build_explicit_dp_step(model, opt, bucket_bytes=BUCKET_BYTES, **kw)
        p = model.params.as_dict()
        o, err = step.init_opt_state(p), step.init_error_state(p)
        for s in range(DP_STEPS):
            p, o, m, err = step(p, o, data.batch_at(s), err)
        return [t.detach().clone() for t in flat_leaves(p)], m

    def check():
        rep, m_rep = run()
        for kw in (dict(zero=True), dict(zero=True, overlap=True)):
            zero, m_zero = run(**kw)
            assert float(m_zero["loss"]) == float(m_rep["loss"])
            for a, b in zip(zero, rep):
                assert torch.equal(a, b)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with_group(check)
    finally:
        torch.set_num_threads(threads)


def test_explicit_dp_refusals():
    """The JAX step's refusals, by type and message."""
    model = Model(get_config(ARCH).reduced(), device="cpu")

    def check():
        with pytest.raises(ValueError, match="implemented by the overlap schedule"):
            steps.build_explicit_dp_step(model, adamw.OptConfig(), microbatches=2)
        for kw in (dict(overlap=True), dict(zero=True)):
            with pytest.raises(ValueError, match="per-tensor"):
                steps.build_explicit_dp_step(model, adamw.OptConfig(), bucket_bytes=0, **kw)
        step = steps.build_explicit_dp_step(model, adamw.OptConfig(), overlap=True,
                                            microbatches=3)
        p = model.params.as_dict()
        batch = SyntheticLM(model.cfg, SHAPES["train_4k"].reduced()).batch_at(0)
        with pytest.raises(ValueError, match="not divisible by microbatches=3"):
            step(p, step.init_opt_state(p), batch, step.init_error_state(p))
    with_group(check)


def test_zero_opt_state_layout():
    """Per rank (n_buckets, padded / n) fp32 moments and an int32 step; the
    abstract state holds the global shapes as meta tensors; the shard spec is
    the JAX step's string, so checkpoints cross."""
    model = Model(get_config(ARCH).reduced(), device="cpu")
    p = model.params.as_dict()

    def check():
        step = steps.build_explicit_dp_step(model, adamw.OptConfig(), zero=True,
                                            bucket_bytes=BUCKET_BYTES)
        o, a = step.init_opt_state(p), step.abstract_opt_state(p)
        assert tuple(o["m"].shape) == tuple(a["m"].shape) == (21, 1 << 14)
        assert o["m"].dtype == o["v"].dtype == torch.float32 and o["step"].dtype == torch.int32
        assert a["m"].device.type == "meta"
        assert step.zero and step.opt_shard_spec == "zero-carrier:data"
        assert tuple(step.init_error_state(p).shape) == ()
        rep = steps.build_explicit_dp_step(model, adamw.OptConfig())
        assert not rep.zero and rep.opt_shard_spec is None
        assert [tuple(t.shape) for t in flat_leaves(rep.abstract_opt_state(p)["m"])] == \
            [tuple(t.shape) for t in flat_leaves(p)]
    with_group(check)


def test_plain_step_microbatches_match_jax():
    """`build_train_step(microbatches=2)` against the JAX step's fp32
    gradient accumulation (its scan, jitted as the JAX trainer runs it), two
    steps: loss to 1e-5 relative, params as the explicit-DP step's are held."""
    cfg, jm, params = _jax_params()
    opt = jadamw.OptConfig(**DP_OPT)
    data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
    jstep = jax.jit(jsteps.build_train_step(jm, opt, microbatches=2))
    jp, jo = params, jadamw.init_opt_state(params)
    model = Model(get_config(ARCH).reduced(), device="cpu", dtype=torch.float32)
    model.load_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    tstep = steps.build_train_step(model, adamw.OptConfig(**DP_OPT), microbatches=2)
    tp = model.params.as_dict()
    to = adamw.init_opt_state(tp)
    for s in range(DP_STEPS):
        batch = data.batch_at(s)
        jp, jo, jm_ = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm_["loss"]), rtol=1e-5)
    for a, b in zip(flat_leaves(tp), jax.tree.leaves(jp)):
        d = np.abs(a.detach().numpy() - np.asarray(b))
        assert d.max() <= DP_PARAM_ATOL and (d > DP_NOISE).mean() <= DP_NOISE_SHARE[0]
