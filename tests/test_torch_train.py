"""The port's training slice against the JAX package's, on the same numpy
params, gradients and tokens: the K1/K2 gradients, the loss and its
gradients, AdamW, the synthetic data, the explicit-DP step on two gloo ranks
against the JAX step on two forced host devices, and the launcher.

Params are fp32 on both sides (the JAX default is bf16): what is compared is
the algorithm, not where the two frameworks round to bf16.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES, get_config as jget_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.kernels import ref as jref
from repro.models import build_model
from repro.models import layers as jlayers
from repro.optim import adamw as jadamw
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model, flat_leaves, unflatten_like
from repro_torch.optim import adamw
from repro_torch.runtime import steps
from repro_torch.runtime.train import Trainer, TrainConfig

from .helpers import run_devices
from .test_torch_codec import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's CPU work: the suite runs several
    files at once, and some of them time their steps."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ARCH = "smollm-135m"


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _jax_params(seed=0):
    cfg = jget_config(ARCH).reduced()
    jm = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(jax.random.PRNGKey(seed)))
    return cfg, jm, params


# --------------------------------------------------------- K1, K2 gradients
# fp32 on both sides; the two differ in summation order only (1e-5, the
# forward's own tolerance in tests/test_torch_kernels.py).
GRAD_TOL = 1e-5


@pytest.mark.parametrize("shape", [(8, 576), (2, 7, 96)])
def test_rmsnorm_grad_matches_jax_vjp(shape):
    rng = np.random.RandomState(0)
    x, sc, dy = rng.randn(*shape), rng.randn(shape[-1]), rng.randn(*shape)
    want_y, vjp = jax.vjp(jref.rmsnorm_ref, jnp.asarray(x, jnp.float32), jnp.asarray(sc, jnp.float32))
    want_dx, want_ds = vjp(jnp.asarray(dy, jnp.float32))
    xt, st = _t(x).requires_grad_(), _t(sc).requires_grad_()
    y = ops.rmsnorm(xt, st)
    dx, ds = torch.autograd.grad(y, (xt, st), _t(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=GRAD_TOL, rtol=GRAD_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("s,q_block", [(64, 16), (50, 16), (33, 256)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 3])
def test_flash_attention_grad_matches_jax_vjp(s, q_block, causal, n_rep):
    """Through `layers.attention` (GQA via `_repeat_kv`) against `jax.vjp` of
    `_repeat_kv` + `ref.attention_ref`; S = 50 is not a multiple of the
    backward's query block."""
    b, kh, hd = 2, 2, 32
    h = kh * n_rep
    rng = np.random.RandomState(s + n_rep)
    q, k, v = rng.randn(b, s, h, hd), rng.randn(b, s, kh, hd), rng.randn(b, s, kh, hd)
    do = rng.randn(b, s, h, hd)

    def jfn(q, k, v):
        fold = lambda t: t.transpose(0, 2, 1, 3).reshape(b * h, s, hd)
        k, v = jlayers._repeat_kv(k, n_rep), jlayers._repeat_kv(v, n_rep)
        o = jref.attention_ref(fold(q), fold(k), fold(v), causal=causal)
        return o.reshape(b, h, s, hd).transpose(0, 2, 1, 3)

    want, vjp = jax.vjp(jfn, *(jnp.asarray(a, jnp.float32) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(do, jnp.float32))
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.attention(qt, kt, vt, causal=causal, q_block=q_block)
    grads = torch.autograd.grad(out, (qt, kt, vt), _t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=GRAD_TOL, rtol=0)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


# --------------------------------------------------------- loss and grads
def test_flat_leaves_is_jax_tree_flatten_order():
    _, _, params = _jax_params()
    paths = [".".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    names = {}
    for p in paths:
        d = names
        *head, last = p.split(".")
        for part in head:
            d = d.setdefault(part, {})
        d[last] = p
    assert flat_leaves(names) == paths
    assert paths == ["emb", "layers.ln1", "layers.ln2", "layers.mlp.w1", "layers.mlp.w2",
                     "layers.mlp.w3", "layers.wk", "layers.wo", "layers.wq", "layers.wv", "ln_f"]
    assert unflatten_like(names, flat_leaves(names)) == names
    model = Model(get_config(ARCH).reduced(), device="cpu")
    assert [tuple(p.shape) for p in flat_leaves(model.params.as_dict())] == \
        [tuple(a.shape) for a in jax.tree.leaves(params)]


def test_loss_and_grads_match_jax_value_and_grad():
    """Model.loss and its gradients against jax.value_and_grad(Model.loss),
    fp32 params, JAX's defaults (blockwise attention, remat, scan). Both sum
    in fp32 in different orders: the loss to 1e-5 relative, each gradient
    leaf to 1e-4 of its own largest element."""
    cfg, jm, params = _jax_params()
    batch = JSyntheticLM(cfg, JSHAPES["train_4k"].reduced()).batch_at(0)
    want_loss, want_grads = jax.value_and_grad(jm.loss)(params, {"tokens": jnp.asarray(batch["tokens"])})
    model = Model(get_config(ARCH).reduced(), device="cpu", dtype=torch.float32)
    model.load_params(params_from_numpy(jax.tree.map(np.asarray, params), "cpu"))
    loss, grads = steps.value_and_grad(model, model.params.as_dict(), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for g, w in zip(flat_leaves(grads), jax.tree.leaves(want_grads)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4 * np.abs(w).max(), rtol=0)


def test_training_forward_launches_each_wrapper_forward_plus_recompute(monkeypatch):
    """Under remat each layer's forward runs twice per step: the norm
    2L + 2L + 1 times and attention 2L times (the counts chip_smoke.py
    asserts on the card)."""
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    steps.value_and_grad(model, model.params.as_dict(),
                         SyntheticLM(cfg, SHAPES["train_4k"].reduced()).batch_at(0))
    L = cfg.n_layers
    assert calls == {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L}


# ------------------------------------------------------------------- AdamW
def _dyadic(rng, shape):
    """Values k / 64 with |k| <= 8: every square and every partial sum of
    squares is exact in fp32, so the global norm does not depend on the order
    XLA and PyTorch sum in."""
    return (rng.randint(-8, 9, size=shape) / 64.0).astype(np.float32)


def _adamw_run(opt, grads_per_step, p0):
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jadamw.init_opt_state(jp), adamw.init_opt_state(tp)
    out = []
    for g in grads_per_step:
        jp, js, jm = jadamw.apply_updates(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, opt)
        tp, ts, tm = adamw.apply_updates(tp, {k: _t(v) for k, v in g.items()}, ts, opt)
        out.append((jp, js, jm, tp, ts, tm))
    return out


def test_adamw_bit_exact_over_three_steps_with_the_clip_active():
    """Warmup branch of the schedule: every scalar and every element equal."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.randn(40, 30).astype(np.float32), "b": rng.randn(17).astype(np.float32)}
    grads = [{k: _dyadic(rng, v.shape) for k, v in p0.items()} for _ in range(3)]
    for jp, js, jm, tp, ts, tm in _adamw_run(jadamw.OptConfig(), grads, p0):
        assert float(jm["grad_norm"]) > jadamw.OptConfig().clip_norm       # clip active
        for key in ("grad_norm", "lr"):
            assert np.float32(tm[key]) == np.float32(jm[key]), key
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        for k in p0:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
            np.testing.assert_array_equal(ts["m"][k].numpy(), np.asarray(js["m"][k]))
            np.testing.assert_array_equal(ts["v"][k].numpy(), np.asarray(js["v"][k]))


def test_adamw_cosine_branch_within_one_ulp():
    """Past warmup the rate takes a cosine, which XLA and PyTorch may round
    an ulp apart: lr is held to 1 ulp, and then every parameter to 1 ulp
    (p - lr·delta rounds once after a product that moved by an ulp); the
    moments do not see lr and stay bit-exact."""
    rng = np.random.RandomState(1)
    opt = jadamw.OptConfig(warmup_steps=1, decay_steps=7)
    p0 = {"a": rng.randn(64, 9).astype(np.float32)}
    grads = [{"a": _dyadic(rng, (64, 9))} for _ in range(3)]
    for jp, js, jm, tp, ts, tm in _adamw_run(opt, grads, p0):
        np.testing.assert_array_max_ulp(tm["lr"].numpy(), np.asarray(jm["lr"]), maxulp=1)
        np.testing.assert_array_max_ulp(tp["a"].numpy(), np.asarray(jp["a"]), maxulp=1)
        np.testing.assert_array_equal(ts["m"]["a"].numpy(), np.asarray(js["m"]["a"]))


def test_global_norm_of_general_values():
    """On values whose squares do not sum exactly, XLA's and PyTorch's
    reduction orders differ: the norm is held to 1e-6 relative (a few ulps)."""
    rng = np.random.RandomState(2)
    tree = {"a": rng.randn(1000).astype(np.float32), "b": {"c": rng.randn(77, 5).astype(np.float32)}}
    want = jadamw.global_norm(jax.tree.map(jnp.asarray, tree))
    got = adamw.global_norm({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -------------------------------------------------------------------- data
@pytest.mark.parametrize("step", [0, 1, 7])
def test_synthetic_batches_are_jax_batches(step):
    for arch in (ARCH, "internvl2-26b", "musicgen-medium"):
        want = JSyntheticLM(jget_config(arch).reduced(), JSHAPES["train_4k"].reduced()).batch_at(step)
        got = SyntheticLM(get_config(arch).reduced(), SHAPES["train_4k"].reduced()).batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------- the whole step
DP_CASES = [(1 << 16, 0), (1 << 16, 8), (0, 0)]   # (bucket_bytes, compress_bits)
DP_STEPS = 2
DP_OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
# AdamW's first steps move each parameter by about lr·|m̂/√v̂| <= ~lr; an
# element whose gradient is near zero can take the other sign on the two
# sides (fp32 summation order), so one parameter may differ by up to
# 2·lr per step. All but a sliver agree to summation noise: 0.1% of the
# elements may differ by more than 1e-5 on the fp32 wire. On the int8 wire
# the jitted JAX step also multiplies by 1/127 where the port divides
# (scales an ulp apart) and contracts r - q·s into an FMA, so an element
# within an ulp of a rounding boundary quantizes one step apart on the two
# sides: its reduced gradient moves by one quantum and its update by up to
# 2·lr. There 2% may differ by more than 1e-5.
DP_PARAM_ATOL = 2 * DP_OPT["peak_lr"] * DP_STEPS
DP_NOISE = 1e-5
DP_NOISE_SHARE = {0: 1e-3, 8: 2e-2}


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """Both trainers' losses, grad norms, final params and error-state
    shapes, per case, from the same fp32 params and SyntheticLM batches."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg, _, params = _jax_params()
    np.savez(tmp / "params.npz", *[np.asarray(a) for a in jax.tree.leaves(params)])
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
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
opt = adamw.OptConfig(**{DP_OPT!r})
data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
out = {{}}
for bb, cb in {DP_CASES!r}:
    step = build_explicit_dp_step(jm, opt, mesh, "data", compress_bits=cb, bucket_bytes=bb)
    p, o = p0, adamw.init_opt_state(p0)
    err = step.init_error_state(p)
    rows = []
    for s in range({DP_STEPS}):
        batch = {{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}}
        p, o, m, err = step(p, o, batch, err)
        rows.append([float(m["loss"]), float(m["grad_norm"])])
    out[f"{{bb}}-{{cb}}"] = {{"rows": rows, "err": [list(e.shape) for e in jax.tree.leaves(err)]}}
    np.savez(T + f"/jax-{{bb}}-{{cb}}.npz", *[np.asarray(a) for a in jax.tree.leaves(p)])
json.dump(out, open(T + "/jax.json", "w"))
""", n_devices=2)
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
        for bb, cb in {DP_CASES!r}:
            model.load_params(unflatten_like(model.params.as_dict(), p0))
            step = build_explicit_dp_step(model, opt, compress_bits=cb, bucket_bytes=bb)
            p = model.params.as_dict()
            o = adamw.init_opt_state(p)
            err = step.init_error_state(p)
            rows = []
            for s in range({DP_STEPS}):
                batch = {{k: torch.as_tensor(v) for k, v in data.batch_at(s).items()}}
                p, o, m, err = step(p, o, batch, err)
                rows.append([float(m["loss"]), float(m["grad_norm"])])
            e = flat_leaves(err) if isinstance(err, dict) else [err]
            out[f"{{bb}}-{{cb}}"] = {{"rows": rows, "err": [list(t.shape) for t in e]}}
            if RANK == 0:
                np.savez(TMP + f"/port-{{bb}}-{{cb}}.npz",
                         *[t.detach().numpy() for t in flat_leaves(p)])
        json.dump(out, open(TMP + f"/port{{RANK}}.json", "w"))
        """, 2, tmp)
    return tmp, json.load(open(tmp / "jax.json")), \
        [json.load(open(tmp / f"port{r}.json")) for r in range(2)]


@pytest.mark.parametrize("bucket_bytes,compress_bits", DP_CASES)
def test_explicit_dp_step_matches_jax_on_two_ranks(dp_runs, bucket_bytes, compress_bits):
    """Two steps of `build_explicit_dp_step` on two gloo ranks against the JAX
    step on two devices: loss and grad norm to 1e-5 relative (fp32
    summation order and, on the int8 wire, a rare quantization step of
    difference), equal error-state shapes, params as stated above. Both
    ranks hold the same values."""
    tmp, jx, (r0, r1) = dp_runs
    key = f"{bucket_bytes}-{compress_bits}"
    assert r0[key] == r1[key]
    np.testing.assert_allclose(np.array(r0[key]["rows"]), np.array(jx[key]["rows"]), rtol=1e-5)
    assert r0[key]["err"] == jx[key]["err"]
    for a, b in zip(np.load(tmp / f"port-{key}.npz").values(),
                    np.load(tmp / f"jax-{key}.npz").values()):
        d = np.abs(a - b)
        assert d.max() <= DP_PARAM_ATOL
        assert (d > DP_NOISE).mean() <= DP_NOISE_SHARE[compress_bits]


def test_error_state_shapes():
    """Carrier-shaped under bucketed int8 (21 x 16384 for the reduced model at
    64 KiB buckets, as the JAX step gives), per-leaf on the per-tensor wire."""
    model = Model(get_config(ARCH).reduced(), device="cpu")
    p = model.params.as_dict()

    def check():
        e8 = steps.build_explicit_dp_step(model, adamw.OptConfig(), compress_bits=8,
                                          bucket_bytes=1 << 16).init_error_state(p)
        assert tuple(e8.shape) == (21, 1 << 14) and e8.dtype == torch.float32
        per = steps.build_explicit_dp_step(model, adamw.OptConfig(),
                                           compress_bits=8).init_error_state(p)
        assert [t.shape for t in flat_leaves(per)] == [t.shape for t in flat_leaves(p)]
    with_group(check)


def with_group(fn):
    """Run `fn` inside a one-rank gloo group made in memory."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        return fn()
    finally:
        dist.destroy_process_group()


def test_unported_paths_raise(tmp_path):
    """What stays unported raises: the two-tier (dcn_axis) reduction, and the
    Trainer's fault, guard, straggler and retry fields."""
    cfg = get_config(ARCH).reduced()
    model = Model(cfg, device="cpu")

    def check():
        for kw in ({"dcn_axis": "pod"}, {"dcn_axis": "pod", "zero": True}):
            with pytest.raises(NotImplementedError, match="A6.3"):
                steps.build_explicit_dp_step(model, adamw.OptConfig(), **kw)
        with pytest.raises(ValueError, match="compress_bits"):
            steps.build_explicit_dp_step(model, adamw.OptConfig(), compress_bits=4)
    with_group(check)
    for kw in ({"guard": True}, {"faults": "messy:0"}, {"straggler_action": "sync"},
               {"max_retries": 3}):
        with pytest.raises(NotImplementedError):
            Trainer(cfg, SHAPES["train_4k"].reduced(),
                    train_cfg=TrainConfig(ckpt_dir=str(tmp_path), **kw), device="cpu")
    with pytest.raises(ValueError, match="process group"):
        Trainer(cfg, SHAPES["train_4k"].reduced(),
                train_cfg=TrainConfig(explicit_dp=True, ckpt_dir=str(tmp_path)), device="cpu")


def test_trainer_without_explicit_dp_trains_on_one_process(tmp_path):
    cfg = get_config(ARCH).reduced()
    tr = Trainer(cfg, SHAPES["train_4k"].reduced(),
                 train_cfg=TrainConfig(steps=2, ckpt_dir=str(tmp_path)), device="cpu")
    res = tr.run()
    assert res["final_step"] == 2 and res["final_devices"] == 1
    assert [sorted(r) for r in res["metrics"]] == [["grad_norm", "loss", "lr", "step",
                                                    "time_s"]] * 2
    assert all(np.isfinite(r["loss"]) for r in res["metrics"])


# ----------------------------------------------------------------- launcher
def test_launch_train_explicit_dp_on_cpu(capsys, tmp_path):
    assert launch_train.main(["--arch", ARCH, "--reduced", "--explicit-dp", "--device", "cpu",
                              "--steps", "2", "--bucket-bytes", "65536",
                              "--compress-bits", "8", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "gnorm" in out
    assert "done: step 2" in out and "1 rank(s) on cpu" in out
    assert "median host time per step after the first" in out


def test_launch_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", ARCH, "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config(ARCH).reduced(), SHAPES["train_4k"].reduced())


def test_config_fields_match_jax():
    assert dataclasses.asdict(adamw.OptConfig()) == dataclasses.asdict(jadamw.OptConfig())
