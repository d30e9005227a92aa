"""The port's bucket codec (K3 pack, K4 unpack) against the JAX package's, on
the same numpy inputs, and the port's gradient reduction on two gloo ranks
against the JAX sequence on two forced host devices.

On the CPU `pack` and `unpack` run their plain versions (`kernels/ref.py`);
the JAX side runs `impl="xla"` and the Pallas kernels in interpret mode, as
tests/test_codec.py runs them. The CUDA kernels are held against the plain
versions on the card by tests/test_torch_gpu.py and chip_smoke.py.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import bucket_codec as jbc
from repro_torch.kernels import _build, bucket_codec as bc, ops, ref

from .helpers import run_devices

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this file's CPU work: the suite runs several
    files at once, and some of them time their steps."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

SHAPE_SETS = [
    [(3, 2), (5,), (1,)],              # ragged small leaves
    [(2, 2), (0,), (3,)],              # zero-size leaf in the middle
    [(7, 3), (1000,), (13,)],          # bucket-spanning large leaf
    [(0, 4), (40, 9), (0,), (17,)],    # zero-size leaves at both ends
]


def run_ranks(code: str, n: int, tmp_path: Path, timeout: int = 240) -> None:
    """Run `code` in `n` fresh processes that form a gloo group through a
    file in `tmp_path` (no port to clash on between test workers). The code
    sees RANK, WORLD and TMP and the port on its path; it imports no jax."""
    prelude = textwrap.dedent(f"""\
        import os, sys
        import torch, torch.distributed as dist
        RANK, WORLD, TMP = int(os.environ["RANK"]), {n}, {str(tmp_path)!r}
        torch.set_num_threads(2)
        dist.init_process_group("gloo", init_method="file://" + TMP + "/gloo_store",
                                rank=RANK, world_size=WORLD)
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", prelude + textwrap.dedent(code)
                               + "\ndist.destroy_process_group()\n"],
                              env={**env, "RANK": str(r)}, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}\n{err[-3000:]}"


def _leaves(rng, shapes, dtype="float32"):
    """The same leaves as numpy fp32 values, jax arrays and torch tensors."""
    vals = [rng.randn(*s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(v, getattr(jnp, dtype)) for v in vals]
    tt = [torch.from_numpy(v).to(getattr(torch, dtype)) for v in vals]
    return jx, tt


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


@pytest.mark.parametrize("reverse", [True, False])
def test_make_table_matches_jax(reverse):
    rng = np.random.RandomState(7)
    for trial in range(40):
        sizes = [int(s) for s in rng.choice([0, 1, 3, 17, 64, 500, 4099], size=rng.randint(1, 9))]
        cap = int(rng.choice([0, 1, 5, 16, 64, 1000, 1 << 14]))
        got, want = bc.make_table(sizes, cap, reverse), jbc.make_table(sizes, cap, reverse)
        assert (got.sizes, got.bucket_elems, got.spans, got.leaf_offsets) == \
            (want.sizes, want.bucket_elems, want.spans, want.leaf_offsets), (sizes, cap)
        live = got.live_order()
        assert [got.leaf_offsets[i] for i in live] == \
            list(np.cumsum([0] + [sizes[i] for i in live])[:-1])


@pytest.mark.parametrize("shapes", SHAPE_SETS)
@pytest.mark.parametrize("wire,dtype", [("fp32", "float32"), ("fp32", "bfloat16"),
                                        ("bf16", "float32"), ("bf16", "bfloat16")])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_pack_unpack_bit_exact_against_jax(shapes, wire, dtype, impl):
    """fp32 and bf16 wires: the carrier and the unpacked leaves equal JAX's
    bit for bit (a cast, one fp32 multiply by the scale, zero padding)."""
    rng = np.random.RandomState(len(shapes))
    jx, tt = _leaves(rng, shapes, dtype)
    sizes = [int(np.prod(s)) for s in shapes]
    for cap, reverse, scale in ((64, False, 1.0), (256, True, 1.0 / 3)):
        jt, table = jbc.make_table(sizes, cap, reverse), bc.make_table(sizes, cap, reverse)
        jc, js, _ = jbc.pack(jt, jx, scale=scale, wire=wire, impl=impl)
        c, s, e = bc.pack(table, tt, scale=scale, wire=wire)
        assert s is None and e is None and js is None
        assert c.dtype == bc.WIRE_DTYPES[wire] and tuple(c.shape) == jc.shape
        np.testing.assert_array_equal(_np(c), _np(jc))
        back = bc.unpack(table, c, tt)
        for a, b, g in zip(back, jbc.unpack(jt, jc, jx, impl=impl), tt):
            assert a.dtype == torch.float32 and a.shape == g.shape
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shapes", SHAPE_SETS)
@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("with_err", [True, False])
def test_int8_pack_equals_jax(shapes, impl, with_err):
    """int8 wire, scale 1/3 and a nonzero err: q, the per-bucket scales and
    new_err equal JAX's (division by 127 and by s, round half to even, each
    product rounded on its own). The dequantizing unpack equals JAX's too.

    Against the Pallas kernel in interpret mode the reference itself moves:
    under that mode's jit XLA turns `/ 127` into a multiply by 1/127 (scales
    held to 1 ulp) and contracts `r - q * s` into one FMA, so its new_err is
    the exact residual where the port and the eager `impl="xla"` round q·s
    first. new_err then differs by |q|·Δs <= 127 ulp(s) <= 2 ulp(127·s) from
    the scale, plus half an ulp of |q·s| <= 127·s from the rounding: it is
    held to 3 ulps of the row's max|r| = 127·s there."""
    rng = np.random.RandomState(3 + len(shapes))
    jx, tt = _leaves(rng, shapes)
    sizes = [int(np.prod(s)) for s in shapes]
    table, jt = bc.make_table(sizes, 128, False), jbc.make_table(sizes, 128, False)
    err = (rng.randn(table.n_buckets, table.bucket_elems) * 1e-2).astype(np.float32) \
        if with_err else None
    jq, js, je = jbc.pack(jt, jx, scale=1.0 / 3, wire="int8",
                          err=None if err is None else jnp.asarray(err), impl=impl)
    q, s, e = bc.pack(table, tt, scale=1.0 / 3, wire="int8",
                      err=None if err is None else torch.from_numpy(err))
    assert q.dtype == torch.int8 and s.shape == (table.n_buckets,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    if impl == "xla":
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    else:
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
        ulp_row = np.spacing(np.float32(127) * s.numpy())[:, None]
        assert np.all(np.abs(e.numpy() - np.asarray(je)) <= 3 * ulp_row)
    # the dequantizing unpack, on the same q and scales: one product each
    for a, b in zip(bc.unpack(table, q, tt, scales=s),
                    jbc.unpack(jt, jnp.asarray(q.numpy()), jx, scales=jnp.asarray(s.numpy()),
                               impl=impl)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_unpack_takes_a_list_of_rows_and_zero_size_leaves_come_back_as_zeros():
    rng = np.random.RandomState(5)
    _, tt = _leaves(rng, [(0, 3), (10,), (0,)])
    table = bc.make_table([0, 10, 0], 4)
    c, _, _ = bc.pack(table, tt)
    back = bc.unpack(table, list(c), tt)
    assert back[0].shape == (0, 3) and back[2].shape == (0,)
    np.testing.assert_array_equal(back[1].numpy(), tt[1].numpy())
    c[0, 0] = 99.0                      # outputs are fresh tensors, not views
    assert back[1].max() < 99.0


def test_empty_table_and_bad_wire_raise():
    table = bc.make_table([0, 0], 8)
    with pytest.raises(ValueError, match="empty table"):
        bc.pack(table, [torch.zeros(0), torch.zeros(0, 2)])
    with pytest.raises(ValueError, match="unknown wire"):
        bc.pack(bc.make_table([3], 8), [torch.zeros(3)], wire="fp8")


def test_cuda_tensors_reach_the_codec_kernels_or_raise(monkeypatch):
    """A CUDA tensor never takes the plain codec: pack and unpack go to the
    kernels' libraries, and when those cannot be had they raise and count
    nothing."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError(f"cannot build {name}")

    def plain_taken(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(ref, "pack_ref", plain_taken)
    monkeypatch.setattr(ref, "unpack_ref", plain_taken)
    ops.reset_launch_counts()
    table = bc.make_table([6, 0, 10], 4)
    with FakeTensorMode():
        leaves = [torch.empty(6, device="cuda", dtype=torch.bfloat16),
                  torch.empty(0, device="cuda", dtype=torch.bfloat16),
                  torch.empty(2, 5, device="cuda", dtype=torch.bfloat16)]
        carrier = torch.empty(table.n_buckets, 4, device="cuda")
        for wire in ("fp32", "int8"):
            with pytest.raises(RuntimeError, match="cannot build bucket_pack"):
                bc.pack(table, leaves, wire=wire)
        with pytest.raises(RuntimeError, match="cannot build bucket_unpack"):
            bc.unpack(table, carrier, leaves)
        with pytest.raises(ValueError, match="one dtype"):
            bc.pack(table, [leaves[0], leaves[1], leaves[2].float()])
    assert asked == ["bucket_pack", "bucket_pack", "bucket_unpack"]
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "bucket_pack": 0,
                                   "bucket_unpack": 0, "adamw_shard": 0}


def test_cpu_codec_counts_no_launch():
    ops.reset_launch_counts()
    table = bc.make_table([5], 2)
    c, _, _ = bc.pack(table, [torch.ones(5)])
    bc.unpack(table, c, [torch.ones(5)])
    assert ops.launch_counts()["bucket_pack"] == 0 == ops.launch_counts()["bucket_unpack"]


# ------------------------------------------------ the reduction on two ranks
RED_SIZES = [700, 0, 2048, 31, 300]    # 3079 elements: 4 buckets of 1024, tail 7
RED_CAP = 1024


def _rank_grads(rank):
    rng = np.random.RandomState(100 + rank)
    return [rng.randn(s).astype(np.float32) for s in RED_SIZES]


def _rank_err(rank, nb):
    return (np.random.RandomState(200 + rank).randn(nb, RED_CAP) * 1e-2).astype(np.float32)


def test_two_rank_reduction_matches_jax(tmp_path):
    """pack -> per-row all-reduce (the last row at its exact size) -> unpack,
    on two gloo ranks, against the same sequence written from the JAX
    package's `codec.pack`, `lax.psum`, `overlap.quantized_all_reduce` and
    `codec.unpack` under shard_map on two devices. The JAX packs run eagerly,
    op by op, as the port's plain versions do.

    fp32 wire: bit-exact (a sum of two is the same in either order). int8
    wire: q, scales and new_err bit-exact; the reduced values are
    s0·q0 + s1·q1, which the two libraries' tensordots may contract with or
    without an FMA: at most 1 ulp."""
    for r in range(2):
        np.savez(tmp_path / f"in{r}.npz", *_rank_grads(r))
    run_ranks(f"""
        import numpy as np
        from repro_torch.core import collectives as coll, overlap as ov
        from repro_torch.kernels import bucket_codec as bc
        g = [torch.from_numpy(a) for a in np.load(TMP + f"/in{{RANK}}.npz").values()]
        table = bc.make_table([x.numel() for x in g], {RED_CAP}, reverse=False)
        nb, cap = table.n_buckets, table.bucket_elems
        width = lambda k: table.total_elems - (nb - 1) * cap if k == nb - 1 else cap
        err = torch.from_numpy((np.random.RandomState(200 + RANK).randn(nb, cap) * 1e-2)
                               .astype(np.float32))
        c, _, _ = bc.pack(table, g, scale=1.0 / WORLD)
        for k in range(nb):
            coll.xla_all_reduce(c[k, :width(k)])
        fp32 = bc.unpack(table, c, g)
        q, s, new_err = bc.pack(table, g, scale=1.0 / WORLD, wire="int8", err=err)
        rows = torch.zeros((nb, cap))
        for k in range(nb):
            rows[k, :width(k)] = ov.quantized_all_reduce(q[k, :width(k)], s[k])
        int8 = bc.unpack(table, rows, g)
        np.savez(TMP + f"/port{{RANK}}.npz", *[t.numpy() for t in fp32 + int8],
                 q=q.numpy(), s=s.numpy(), e=new_err.numpy())
        """, 2, tmp_path)
    run_devices(f"""
import numpy as np, jax, jax.numpy as jnp
from functools import partial
from jax.sharding import Mesh, PartitionSpec as P
from repro.core import overlap as ov
from repro.kernels import bucket_codec as bc
from jax import shard_map
T = {str(tmp_path)!r}
g = [[jnp.asarray(a) for a in np.load(T + f"/in{{r}}.npz").values()] for r in range(2)]
table = bc.make_table([x.size for x in g[0]], {RED_CAP}, reverse=False)
nb, cap = table.n_buckets, table.bucket_elems
tail = table.total_elems - (nb - 1) * cap
err = [jnp.asarray((np.random.RandomState(200 + r).randn(nb, cap) * 1e-2).astype(np.float32))
       for r in range(2)]
mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
smap = lambda f, n_in: jax.jit(shard_map(f, mesh=mesh, in_specs=(P("data"),) * n_in,
                                         out_specs=P("data"), check_vma=False))
def red_fp32(c):
    rows = [jax.lax.psum(c[0, k], "data") for k in range(nb - 1)]
    last = jax.lax.psum(c[0, nb - 1, :tail], "data")
    rows.append(jnp.concatenate([last, jnp.zeros((cap - tail,), last.dtype)]))
    return jnp.stack(rows)[None]
def red_int8(q, s):
    rows = [ov.quantized_all_reduce(q[0, k], s[0, k], "data") for k in range(nb - 1)]
    last = ov.quantized_all_reduce(q[0, nb - 1, :tail], s[0, nb - 1], "data")
    rows.append(jnp.concatenate([last, jnp.zeros((cap - tail,), last.dtype)]))
    return jnp.stack(rows)[None]
packed = [bc.pack(table, g[r], scale=1.0 / 2, impl="xla")[0] for r in range(2)]
red = smap(red_fp32, 1)(jnp.stack(packed))
qs = [bc.pack(table, g[r], scale=1.0 / 2, wire="int8", err=err[r], impl="xla")
      for r in range(2)]
red8 = smap(red_int8, 2)(jnp.stack([x[0] for x in qs]), jnp.stack([x[1] for x in qs]))
for r in range(2):
    fp32 = bc.unpack(table, red[r], g[r], impl="xla")
    int8 = bc.unpack(table, red8[r], g[r], impl="xla")
    np.savez(T + f"/jax{{r}}.npz", *[np.asarray(t) for t in fp32 + int8],
             q=np.asarray(qs[r][0]), s=np.asarray(qs[r][1]), e=np.asarray(qs[r][2]))
""", n_devices=2)
    n = len(RED_SIZES)
    for r in range(2):
        port, jx = np.load(tmp_path / f"port{r}.npz"), np.load(tmp_path / f"jax{r}.npz")
        for key in ("q", "s", "e"):
            np.testing.assert_array_equal(port[key], jx[key], err_msg=f"rank {r} {key}")
        for i in range(n):
            a, b = port[f"arr_{i}"], jx[f"arr_{i}"]
            np.testing.assert_array_equal(a, b, err_msg=f"rank {r} fp32 leaf {i}")
            a8, b8 = port[f"arr_{n + i}"], jx[f"arr_{n + i}"]
            np.testing.assert_array_max_ulp(a8, b8, maxulp=1)
        want = sum(_rank_grads(q)[i] * np.float32(0.5) for q in range(2) for i in [0])
        np.testing.assert_array_equal(port["arr_0"], want)


def test_registry_xla_entries_on_two_gloo_ranks(tmp_path):
    """The registry's "xla" entries on gloo against numpy: all-reduce in
    place, reduce-scatter of the zero-padded flat buffer (len padded / n per
    rank), all-gather stacking (n,) + shape, for fp32 and int8 payloads."""
    run_ranks("""
        import numpy as np
        from repro_torch.core import collectives as coll
        assert sorted(coll.registered("all_reduce")) == ["xla"]
        assert coll.get_collective("reduce_scatter", "xla").fn is coll.xla_reduce_scatter
        x = torch.arange(7, dtype=torch.float32) * (RANK + 1)
        ar = coll.xla_all_reduce(x.clone())
        rs = coll.xla_reduce_scatter(x)
        ag = coll.xla_all_gather(torch.full((2, 3), RANK, dtype=torch.int8))
        np.savez(TMP + f"/coll{RANK}.npz", ar=ar.numpy(), rs=rs.numpy(), ag=ag.numpy())
        """, 2, tmp_path)
    total = np.arange(7, dtype=np.float32) * 3
    padded = np.concatenate([total, [0.0]]).astype(np.float32)
    for r in range(2):
        out = np.load(tmp_path / f"coll{r}.npz")
        np.testing.assert_array_equal(out["ar"], total)
        np.testing.assert_array_equal(out["rs"], padded[4 * r:4 * (r + 1)])
        assert out["ag"].dtype == np.int8 and out["ag"].shape == (2, 2, 3)
        np.testing.assert_array_equal(out["ag"][:, 0, 0], [0, 1])
    with pytest.raises(KeyError, match="registered"):
        from repro_torch.core import collectives as coll
        coll.get_collective("all_reduce", "ring")
