"""The port's checkpoint manager and the Trainer's checkpoints against the
JAX package's: the same on-disk layout both ways (a JAX ZeRO checkpoint
resumes training in the port, a port checkpoint restores through the JAX
manager), the same shard-spec refusals, async writes and retention, and a
crash/resume that equals an uninterrupted run bit for bit.
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from ml_dtypes import bfloat16 as ml_bfloat16

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as port_manager
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import flat_leaves
from repro_torch.optim import adamw
from repro_torch.runtime.train import Trainer, TrainConfig

from .helpers import run_devices
from .test_torch_codec import _two_threads, run_ranks  # noqa: F401 (autouse fixture)
from .test_torch_train import ARCH, DP_OPT, _jax_params, with_group

SPEC = "zero-carrier:data"
ZERO_SPECS = {"opt/m": SPEC, "opt/v": SPEC}
BUCKET_BYTES = 1 << 16


def _tree(seed=0):
    """A small state shaped as a ZeRO trainer's: bf16 and fp32 params, fp32
    carrier-shaped moments, an int32 step."""
    rng = np.random.RandomState(seed)
    return {"params": {"emb": torch.from_numpy(rng.randn(5, 3).astype(np.float32)).bfloat16(),
                       "layers": {"w": torch.from_numpy(rng.randn(2, 4).astype(np.float32))}},
            "opt": {"m": torch.from_numpy(rng.randn(3, 8).astype(np.float32)),
                    "v": torch.from_numpy(rng.rand(3, 8).astype(np.float32)),
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _equal_trees(a, b):
    la, lb = flat_leaves(a), flat_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _jax_like(tree):
    dt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32, torch.int32: jnp.int32}
    return jax.tree.map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), dt[t.dtype]), tree)


def _np(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_bfloat16 else a


# -------------------------------------------------------------- the manager
def test_round_trip_async_wait_and_keep_last_three(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        ckpt.save(step, _tree(step), extra={"step": step}, blocking=False)
    ckpt.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_3", "step_4", "step_5"]
    assert ckpt.latest_step() == 5
    got, extra = ckpt.restore(_tree())
    assert extra == {"step": 5} and _equal_trees(got, _tree(5))
    got, _ = ckpt.restore(_tree(), step=3)
    assert _equal_trees(got, _tree(3))
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_tree())


def _hold_writes(monkeypatch, ready):
    """np.save on the writer thread waits until `ready()` is true."""
    np_save = np.save

    def held(*a, **kw):
        deadline = time.monotonic() + 60
        while threading.current_thread() is not threading.main_thread() and not ready():
            assert time.monotonic() < deadline, "the held write was never released"
            time.sleep(0.01)
        np_save(*a, **kw)
    monkeypatch.setattr(port_manager.np, "save", held)


def test_async_save_writes_the_tensors_as_they_were_at_save(tmp_path, monkeypatch):
    """The tensors are updated in place after an async `save` and before its
    write: the checkpoint holds their values at `save`."""
    tree, go = _tree(1), threading.Event()
    _hold_writes(monkeypatch, go.is_set)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, tree, blocking=False)
    for t in flat_leaves(tree):
        t.add_(1)
    go.set()
    ckpt.wait()
    got, _ = ckpt.restore(_tree())
    assert _equal_trees(got, _tree(1))


def test_async_write_error_surfaces_at_wait(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(port_manager.np, "save", broken)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree(), blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint write failed: disk full"):
        ckpt.wait()
    assert ckpt.latest_step() is None   # the .tmp directory never became a checkpoint


def test_restore_checks_shapes_and_leaf_counts(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, _tree())
    bad = _tree()
    bad["opt"]["m"] = torch.zeros(3, 9)
    with pytest.raises(ValueError, match="opt/m: checkpoint shape"):
        ckpt.restore(bad)
    del bad["opt"]["m"]
    with pytest.raises(ValueError, match="incompatible trees"):
        ckpt.restore(bad)
    meta = _tree()
    meta["opt"]["m"] = torch.empty(3, 8, device="meta")
    got, _ = ckpt.restore(meta, device="cpu")
    assert got["opt"]["m"].device.type == "cpu"
    assert torch.equal(got["opt"]["m"], _tree()["opt"]["m"])


@pytest.mark.parametrize("saved,wanted", [(ZERO_SPECS, None), (None, ZERO_SPECS),
                                          (ZERO_SPECS, {"opt/m": "zero-carrier:other",
                                                        "opt/v": SPEC})],
                         ids=["zero-into-replicated", "replicated-into-zero", "other-spec"])
def test_shard_spec_mismatches_raise_the_jax_messages(tmp_path, saved, wanted):
    """A port checkpoint refused by the port's manager and by the JAX
    package's, with the same message."""
    CheckpointManager(str(tmp_path)).save(1, _tree(), specs=saved)
    with pytest.raises(ValueError) as port_err:
        CheckpointManager(str(tmp_path)).restore(_tree(), specs=wanted)
    with pytest.raises(ValueError) as jax_err:
        JCheckpointManager(str(tmp_path)).restore(_jax_like(_tree()), specs=wanted)
    assert str(port_err.value) == str(jax_err.value)


def test_port_checkpoint_restores_through_the_jax_manager(tmp_path):
    """The JAX manager reads the port's files into bit-identical arrays, and
    saving them again gives the same manifest (time aside)."""
    tree = _tree(3)
    CheckpointManager(str(tmp_path / "port")).save(4, tree, extra={"step": 4}, specs=ZERO_SPECS)
    jm = JCheckpointManager(str(tmp_path / "port"))
    got, extra = jm.restore(_jax_like(tree), specs=ZERO_SPECS)
    assert extra == {"step": 4}
    for a, b in zip(jax.tree.leaves(got), flat_leaves(tree)):
        want = b.view(torch.int16).numpy().view(np.uint16) if b.dtype == torch.bfloat16 \
            else b.numpy()
        np.testing.assert_array_equal(_np(a), want)
    JCheckpointManager(str(tmp_path / "jax")).save(4, got, extra={"step": 4}, specs=ZERO_SPECS)
    manifests = [json.loads((tmp_path / d / "step_4" / "manifest.json").read_text())
                 for d in ("port", "jax")]
    for m in manifests:
        m.pop("time")
    assert manifests[0] == manifests[1]


# ------------------------------------------------------------- the Trainer
def _trainer(tmp_path, steps, **kw):
    return Trainer(get_config(ARCH).reduced(), SHAPES["train_4k"].reduced(),
                   adamw.OptConfig(**DP_OPT),
                   TrainConfig(steps=steps, ckpt_dir=str(tmp_path), ckpt_every=2, log_every=100,
                               bucket_bytes=BUCKET_BYTES, **kw),
                   device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("kw", [{}, {"explicit_dp": True, "zero": True},
                                {"explicit_dp": True, "zero": True, "compress_bits": 8}],
                         ids=["plain", "zero", "zero_int8"])
def test_crash_and_resume_equals_the_uninterrupted_run(tmp_path, kw):
    """4 steps straight against 2 steps, a fresh Trainer resuming from the
    step-2 checkpoint, and 2 more: losses and params bit for bit (fp32
    params). One intra-op thread, as in tests/test_torch_zero.py: the CPU
    GEMMs' rounding may follow the buffers' alignment with several."""
    _, _, params = _jax_params()
    p0 = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")

    def run(directory, steps, resume):
        tr = _trainer(directory, steps, **kw)
        if resume:
            return tr, tr.run(resume=True)
        tr.model.load_params(p0)
        p = tr.model.params.as_dict()
        o = tr._dp_step.init_opt_state(p) if tr._dp_step is not None else adamw.init_opt_state(p)
        return tr, tr.run(p, o)

    def check():
        straight, res = run(tmp_path / "a", 4, False)
        run(tmp_path / "b", 2, False)
        resumed, res_b = run(tmp_path / "b", 4, True)
        assert [r["step"] for r in res_b["metrics"]] == [2, 3]
        assert [r["loss"] for r in res["metrics"][2:]] == [r["loss"] for r in res_b["metrics"]]
        assert _equal_trees(straight.params, resumed.params)
        assert _equal_trees(straight.opt_state, resumed.opt_state)
        assert sorted(p.name for p in (tmp_path / "b").iterdir()) == ["step_2", "step_4"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with_group(check) if kw else check()
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("kw", [{}, {"explicit_dp": True, "zero": True}], ids=["plain", "zero"])
def test_async_checkpoint_mid_run_equals_a_blocking_one(tmp_path, monkeypatch, kw):
    """4 steps with a save after step 2: the async save's write is held until
    steps 2 and 3 have updated the params in place, and its step_2 equals a
    blocking save's file for file (one intra-op thread, as above)."""
    def run(directory, ckpt_async):
        tr = _trainer(directory, 4, ckpt_async=ckpt_async, **kw)
        if ckpt_async:
            _hold_writes(monkeypatch, lambda: len(tr.metrics_log) == 4)
        tr.run()
        monkeypatch.undo()

    def check():
        run(tmp_path / "async", True)
        run(tmp_path / "blocking", False)
        a, b = tmp_path / "async" / "step_2", tmp_path / "blocking" / "step_2"
        leaves = json.loads((b / "manifest.json").read_text())["leaves"]
        assert json.loads((a / "manifest.json").read_text())["leaves"] == leaves
        for i in range(len(leaves)):
            assert np.array_equal(np.load(a / f"leaf_{i}.npy"), np.load(b / f"leaf_{i}.npy")), \
                leaves[i]["name"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with_group(check) if kw else check()
    finally:
        torch.set_num_threads(threads)


def test_trainer_refuses_a_cross_restore(tmp_path):
    """A replicated checkpoint does not resume a ZeRO trainer, nor the reverse."""
    def check():
        _trainer(tmp_path / "rep", 1, explicit_dp=True).run()
        _trainer(tmp_path / "zero", 1, explicit_dp=True, zero=True).run()
        with pytest.raises(ValueError, match="replicated checkpoint cannot restore into a ZeRO"):
            _trainer(tmp_path / "rep", 2, explicit_dp=True, zero=True).run(resume=True)
        with pytest.raises(ValueError, match="ZeRO \\(zero=True\\) checkpoint cannot restore"):
            _trainer(tmp_path / "zero", 2, explicit_dp=True).run(resume=True)
    with_group(check)


@pytest.fixture(scope="module")
def jax_zero_resume(tmp_path_factory):
    """A JAX ZeRO state after 2 steps on 2 devices, saved by the JAX manager
    as its Trainer saves it, with the JAX continuation's next two losses; and
    the port resuming from it on 2 gloo ranks (its Trainer writes step 4 into
    the same directory)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    _, _, params = _jax_params()
    np.savez(tmp / "params.npz", *[np.asarray(a) for a in jax.tree.leaves(params)])
    run_devices(f"""
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.checkpoint.manager import CheckpointManager
from repro.configs import SHAPES, get_config
from repro.data.pipeline import SyntheticLM
from repro.models import build_model
from repro.optim import adamw
from repro.runtime.steps import build_explicit_dp_step
T = {str(tmp)!r}
cfg = get_config("{ARCH}").reduced()
jm = build_model(cfg)
tdef = jax.tree.structure(jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
p = tdef.unflatten([jnp.asarray(a) for a in np.load(T + "/params.npz").values()])
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
data = SyntheticLM(cfg, SHAPES["train_4k"].reduced())
step = build_explicit_dp_step(jm, adamw.OptConfig(**{DP_OPT!r}), mesh, "data",
                              bucket_bytes={BUCKET_BYTES}, zero=True)
o, err = step.init_opt_state(p), step.init_error_state(p)
losses = []
for s in range(4):
    if s == 2:
        spec = step.opt_shard_spec
        CheckpointManager(T + "/ckpt").save(2, {{"params": p, "opt": o}}, extra={{"step": 2}},
                                            specs={{"opt/m": spec, "opt/v": spec}})
    p, o, m, err = step(p, o, {{k: jnp.asarray(v) for k, v in data.batch_at(s).items()}}, err)
    losses.append(float(m["loss"]))
json.dump(losses, open(T + "/jax.json", "w"))
""", n_devices=2)
    manifest = json.loads((tmp / "ckpt" / "step_2" / "manifest.json").read_text())
    run_ranks(f"""
        import json
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.optim import adamw
        from repro_torch.runtime.train import Trainer, TrainConfig
        tr = Trainer(get_config("{ARCH}").reduced(), SHAPES["train_4k"].reduced(),
                     adamw.OptConfig(**{DP_OPT!r}),
                     TrainConfig(steps=4, ckpt_dir=TMP + "/ckpt", ckpt_every=0,
                                 explicit_dp=True, zero=True, bucket_bytes={BUCKET_BYTES}),
                     device="cpu", dtype=torch.float32)
        res = tr.run(resume=True)
        json.dump({{"losses": [r["loss"] for r in res["metrics"]],
                    "steps": [r["step"] for r in res["metrics"]],
                    "m": list(tr.opt_state["m"].shape)}}, open(TMP + f"/port{{RANK}}.json", "w"))
        """, 2, tmp)
    return tmp, json.load(open(tmp / "jax.json")), manifest, \
        [json.load(open(tmp / f"port{r}.json")) for r in range(2)]


def test_jax_zero_checkpoint_resumes_in_the_port(jax_zero_resume):
    """Each rank restores its column block of the JAX moments; the next two
    steps' losses match the JAX continuation's to 1e-5 relative (fp32
    summation order, as the steps' own comparison)."""
    _, jax_losses, _, ranks = jax_zero_resume
    for r in ranks:
        assert r["steps"] == [2, 3] and r["losses"] == ranks[0]["losses"]
        assert r["m"] == [21, (1 << 14) // 2]
    np.testing.assert_allclose(ranks[0]["losses"], jax_losses[2:], rtol=1e-5)


def test_port_zero_checkpoint_has_the_jax_manifest(jax_zero_resume):
    """Rank 0's step-4 checkpoint holds the whole moments, gathered from both
    ranks' column blocks: its manifest lists the JAX checkpoint's leaves
    (names, shapes, dtypes, shard specs), and the JAX manager restores it."""
    tmp, _, jax_manifest, _ = jax_zero_resume
    port = json.loads((tmp / "ckpt" / "step_4" / "manifest.json").read_text())
    assert port["leaves"] == jax_manifest["leaves"] and port["extra"] == {"step": 4}
    like = {m["name"]: jax.ShapeDtypeStruct(tuple(m["shape"]), jnp.dtype(m["dtype"]))
            for m in port["leaves"]}
    tree = {"opt": {k: like[f"opt/{k}"] for k in ("m", "step", "v")},
            "params": jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                   _jax_params()[2])}
    got, extra = JCheckpointManager(str(tmp / "ckpt")).restore(tree, specs=ZERO_SPECS)
    assert extra == {"step": 4} and int(got["opt"]["step"]) == 4
    assert got["opt"]["m"].shape == (21, 1 << 14)


def test_launch_train_zero_checkpoints_and_resumes_on_cpu(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--device", "cpu", "--zero", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    assert launch_train.main(args + ["--steps", "4"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]
    assert launch_train.main(args + ["--steps", "6", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "done: step 4" in out and "done: step 6" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
