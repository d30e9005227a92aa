"""The port's serving slice against the JAX package, on the same params and
tokens: param layout, prefill and decode logits, greedy generation; plus the
port's own contracts (launch counts, no CPU fallback, no jax import).

The JAX model runs with attn_impl="pallas", so its prefill goes through the
Pallas flash kernel (interpret mode) as the port's goes through its own.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeConfig as JShape, get_config as jget_config
from repro.models import build_model
from repro.models import layers as jlayers
from repro.runtime.serve import BatchedServer as JServer, ServeConfig as JServeConfig
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers, transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro_torch.runtime.serve import BatchedServer, ServeConfig, throughput_report

ROOT = Path(__file__).resolve().parent.parent
B, P, MAX_SEQ, STEPS = 2, 16, 32, 8
# fp32 params on both sides. Logits of the reduced model are O(1); with an
# fp32 KV cache all that differs is fp32 summation order (~1e-6).
LOGIT_ATOL = 1e-4
BF16_CACHE_ATOL = 5e-3


def _jax_setup():
    cfg = dataclasses.replace(jget_config("smollm-135m").reduced(), attn_impl="pallas")
    jm = build_model(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jm.init(jax.random.PRNGKey(0)))
    tree = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    return cfg, jm, params, tree


def _port_model(cfg, tree):
    return Model(get_config(cfg.name), device="cpu", dtype=torch.float32).load_params(tree)


def _names_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_names_shapes(v, prefix + k + "/"))
        else:
            out[prefix + k] = tuple(v.shape if hasattr(v, "shape") else v)
    return out


@pytest.mark.parametrize("arch", ["smollm-135m", "stablelm-1.6b", "qwen1.5-4b",
                                  "mistral-large-123b"])
def test_param_defs_match_jax_abstract_params(arch):
    want = _names_shapes(build_model(jget_config(arch)).abstract_params())
    assert _names_shapes(T.dense_param_defs(get_config(arch))) == want


def test_smollm_full_width_config():
    c = get_config("smollm-135m")
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.d_ff, c.vocab,
            c.tie_embeddings, c.mlp, c.rope_theta) == \
        (30, 576, 9, 3, 64, 1536, 49152, True, "swiglu", 10000.0)
    assert dataclasses.asdict(c) == dataclasses.asdict(jget_config("smollm-135m"))


def _prefill_and_decode(cache_dtype):
    """Prefill then STEPS teacher-forced decode steps on both sides, with KV
    caches of `cache_dtype`. Yields (step, port logits, jax logits, port cache,
    jax cache); step -1 is the prefill."""
    cfg, jm, params, tree = _jax_setup()
    model = _port_model(cfg, tree)
    rng = np.random.RandomState(0)
    prompts = rng.randint(0, cfg.vocab, (B, P)).astype(np.int32)
    steps = rng.randint(0, cfg.vocab, (STEPS, B)).astype(np.int32)
    jcache = jax.tree.map(lambda a: a.astype(cache_dtype),
                          jm.init_cache(JShape("serve", MAX_SEQ, B, "decode"), batch_size=B))
    cache = model.init_cache(ShapeConfig("serve", MAX_SEQ, B, "decode"), batch_size=B)
    cache = {n: t.to(getattr(torch, jnp.dtype(cache_dtype).name)) for n, t in cache.items()}
    jlog, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(prompts)}, jcache)
    log, cache = model.prefill(torch.from_numpy(prompts), cache)
    assert log.shape == (B, 1, cfg.vocab)
    yield -1, log, jlog, cache, jcache
    jdecode = jax.jit(jm.decode)
    for t in range(STEPS):
        jlog, jcache = jdecode(params, jcache, jnp.asarray(steps[t]), jnp.array(P + t, jnp.int32))
        log, cache = model.decode(cache, torch.from_numpy(steps[t]), P + t)
        yield t, log, jlog, cache, jcache


def test_prefill_and_decode_logits_match_jax():
    """fp32 params and an fp32 cache on both sides: nothing rounds to bf16, so
    every step agrees to fp32 summation-order noise."""
    for t, log, jlog, _, _ in _prefill_and_decode(jnp.float32):
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {t}")


def test_bf16_cache_as_served_matches_jax():
    """The serving default: fp32 params, bf16 KV cache on both sides. Each
    fresh k/v element is rounded to bf16; where the two sides' fp32 values
    (which differ in summation order) straddle a rounding boundary, the
    caches hold neighbouring bf16 values. One such element at the current
    position moves the logits by up to ~1e-3 (seen with these inputs), so
    decode steps are held to BF16_CACHE_ATOL; the prefill attends over fresh
    fp32 k, v and stays at LOGIT_ATOL."""
    for t, log, jlog, cache, jcache in _prefill_and_decode(jnp.bfloat16):
        assert cache["k"].dtype == torch.bfloat16 and tuple(cache["k"].shape) == jcache["k"].shape
        for n in ("k", "v"):
            same = cache[n].float().numpy() == np.asarray(jcache[n].astype(jnp.float32))
            assert same.mean() > 0.99, f"step {t}: {n} caches agree on {same.mean():.4f}"
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, err_msg=f"step {t}",
                                   atol=LOGIT_ATOL if t < 0 else BF16_CACHE_ATOL)


def test_decode_attention_matches_jax():
    """Same q and bf16 caches on both sides: the grouped contraction, the mask
    and the cast of the probabilities to the cache dtype agree to fp32 noise."""
    rng = np.random.RandomState(4)
    q = rng.randn(2, 1, 6, 32).astype(np.float32)
    kc, vc = (jnp.asarray(rng.randn(2, 24, 2, 32), jnp.bfloat16) for _ in range(2))
    want = jlayers.decode_attention(jnp.asarray(q), kc, vc, 13)
    tc = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    got = layers.decode_attention(torch.from_numpy(q), tc(kc), tc(vc), 13)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 6, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_greedy_generate_matches_jax():
    cfg, _, params, tree = _jax_setup()
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (B, P)).astype(np.int32)
    want = JServer(cfg, max_seq=MAX_SEQ, batch_size=B, params=params).generate(
        prompts, JServeConfig(max_new_tokens=STEPS))
    server = BatchedServer(get_config(cfg.name), max_seq=MAX_SEQ, batch_size=B, params=tree,
                           device="cpu", dtype=torch.float32)
    got = server.generate(prompts, ServeConfig(max_new_tokens=STEPS))
    assert got.shape == (B, STEPS) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_serve_run_calls_each_kernel_wrapper_as_the_chip_run_counts(monkeypatch):
    """One generate calls the norm 2L+1 times per forward pass (prefill plus
    one per new token) and flash attention L times (prefill only): the counts
    chip_smoke.py asserts on the card."""
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = get_config("smollm-135m").reduced()
    server = BatchedServer(cfg, max_seq=MAX_SEQ, batch_size=B, device="cpu")
    out = server.generate(np.zeros((B, P), np.int32), ServeConfig(max_new_tokens=5))
    assert out.shape == (B, 5)
    L = cfg.n_layers
    assert calls == {"rmsnorm": (2 * L + 1) * (1 + 5), "flash_attention": L}
    assert server.last_timing["decode_steps"] == 5


def test_temperature_sampling_is_seeded():
    cfg = get_config("smollm-135m").reduced()
    server = BatchedServer(cfg, max_seq=MAX_SEQ, batch_size=B, device="cpu")
    prompts = np.random.RandomState(2).randint(0, cfg.vocab, (B, P)).astype(np.int32)
    sc = ServeConfig(max_new_tokens=6, temperature=1.0, seed=3)
    a, b = server.generate(prompts, sc), server.generate(prompts, sc)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < cfg.vocab


def test_eos_retires_the_batch():
    cfg = get_config("smollm-135m").reduced()
    server = BatchedServer(cfg, max_seq=MAX_SEQ, batch_size=B, device="cpu")
    prompts = np.zeros((B, P), np.int32)
    first = server.generate(prompts, ServeConfig(max_new_tokens=1))
    if first[0, 0] != first[1, 0]:
        pytest.skip("rows disagree on their first token")
    out = server.generate(prompts, ServeConfig(max_new_tokens=6, eos_id=int(first[0, 0])))
    assert out.shape == (B, 1)


def test_params_from_numpy_keeps_bf16_exactly():
    jm = build_model(jget_config("smollm-135m").reduced())
    params = jm.init(jax.random.PRNGKey(0))                  # bf16 leaves
    tree = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    assert tree["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["layers"]["mlp"]["w1"].float().numpy(),
                                  np.asarray(params["layers"]["mlp"]["w1"].astype(jnp.float32)))
    assert params_from_numpy({"a": np.ones(3, np.float32)}, "cpu", torch.bfloat16)["a"].dtype \
        == torch.bfloat16


def test_load_params_rejects_a_foreign_tree():
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, device="cpu")
    with pytest.raises(ValueError, match="param names differ"):
        model.load_params({"emb": torch.zeros(cfg.vocab, cfg.d_model)})


def test_entry_points_default_to_the_card_and_refuse_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card")
    cfg = get_config("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedServer(cfg, max_seq=MAX_SEQ, batch_size=B)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "smollm-135m", "--reduced"])
    with pytest.raises(NotImplementedError):
        Model(get_config("mamba2-2.7b").reduced(), device="cpu")


def test_launch_serve_on_cpu(capsys):
    assert launch_serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"]) == 0
    line = capsys.readouterr().out
    assert "smollm-135m-reduced on cpu" in line and "tok/s" in line


def test_throughput_report_keys():
    server = BatchedServer(get_config("smollm-135m").reduced(), max_seq=MAX_SEQ, batch_size=B,
                           device="cpu")
    rep = throughput_report(server, prompt_len=8, new_tokens=3)
    assert rep["batch"] == B and rep["new_tokens"] == 3
    assert rep["tokens_per_s"] > 0 and rep["prefill_s"] > 0 and rep["decode_s_per_token"] > 0


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "mods = ('repro_torch.core.overlap', 'repro_torch.kernels.bucket_codec',\n"
        "        'repro_torch.optim.adamw', 'repro_torch.runtime.train',\n"
        "        'repro_torch.launch.train', 'repro_torch.data.pipeline')\n"
        "assert all(m in sys.modules for m in mods), [m for m in mods if m not in sys.modules]\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
