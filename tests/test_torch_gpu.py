"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and one explicit-DP training step through all of them.

Every test here is marked `gpu` and skips without a card. This file imports
neither jax nor the JAX package, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import bucket_codec as bc, flash_attention as fa, ops, ref, rmsnorm as rn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in true fp32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s", [128, 100, 2048])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_kernel_matches_plain_on_card(cuda, s, causal, dtype, hd):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(72, s, hd, generator=g, device=cuda).to(dtype) for _ in range(3))
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1024, 8, 1000])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_on_card(cuda, rows, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 576, generator=g, device=cuda).to(dtype)
    sc = torch.randn(576, generator=g, device=cuda).to(dtype)
    got, want = rn.rmsnorm_fwd(x, sc), ref.rmsnorm_ref(x, sc)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=1e-2)


@pytest.mark.gpu
def test_wrappers_launch_and_count_on_card(cuda):
    ops.reset_launch_counts()
    x = torch.randn(2, 100, 9, 64, device=cuda, dtype=torch.bfloat16)
    out = ops.flash_attention(x, x, x)
    assert out.shape == x.shape and out.dtype == x.dtype
    sc = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    assert ops.rmsnorm(x, sc).shape == x.shape
    assert ops.launch_counts() == {"rmsnorm": 1, "flash_attention": 1, "bucket_pack": 0,
                                   "bucket_unpack": 0, "adamw_shard": 0}


# ------------------------------------------------------------ bucket codec
def _codec_leaves(shapes, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype) for s in shapes]


CODEC_CASES = [
    # ragged small table with zero-size leaves at both ends and in the middle
    ([(0, 3), (7, 5), (0,), (1000,), (13,), (0,)], 64),
    # one leaf spanning many buckets, a ragged tail
    ([(300, 577), (576,)], 1 << 14),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shapes,cap", CODEC_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("reverse", [False, True])
def test_codec_kernels_match_plain_on_card(cuda, shapes, cap, dtype, wire, reverse):
    """K3 and K4 bit for bit against `ref.pack_ref` / `ref.unpack_ref` on the
    same CUDA tensors: the kernels round each product and sum on their own and
    divide as the plain versions do."""
    leaves = _codec_leaves(shapes, dtype, cuda, cap)
    table = bc.make_table([t.numel() for t in leaves], cap, reverse)
    err = torch.randn(table.n_buckets, table.bucket_elems, device=cuda) * 1e-2 \
        if wire == "int8" else None
    got = bc.bucket_pack(table, leaves, 1.0 / 3, wire, err)
    want = ref.pack_ref(table, leaves, 1.0 / 3, wire, err)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)
    back = bc.bucket_unpack(table, got[0], leaves, got[1])
    for a, b in zip(back, ref.unpack_ref(table, want[0], leaves, want[1])):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_codec_wrappers_launch_and_count_on_card(cuda):
    ops.reset_launch_counts()
    leaves = _codec_leaves([(10,), (0,), (3, 4)], torch.bfloat16, cuda, 0)
    table = bc.make_table([t.numel() for t in leaves], 8)
    err = torch.zeros(table.n_buckets, table.bucket_elems, device=cuda)
    q, s, e = bc.pack(table, leaves, wire="int8", err=err)        # two passes, one call
    c, _, _ = bc.pack(table, leaves)
    back = bc.unpack(table, c, leaves)
    assert [tuple(t.shape) for t in back] == [(10,), (0,), (3, 4)]
    assert torch.equal(back[2], leaves[2].float())
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "bucket_pack": 2,
                                   "bucket_unpack": 1, "adamw_shard": 0}


# ------------------------------------------------------- sharded AdamW (K5)
def _adamw_args(nb, sh, pad, offset, device, seed):
    """g, p, m, v (nb, sh) fp32 with zero pad columns and, when nb > 1, an
    all-pad last row; `offset` elements into a larger buffer, so offset 1
    gives contiguous shards that are not 16-byte aligned (the kernel's
    4-byte path)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = []
    for s in (1e-2, 1.0, 1e-3, None):       # g, p, m, and v >= 0
        t = torch.randn(nb * sh + offset, generator=gen, device=device)[offset:].view(nb, sh)
        t.copy_(t.abs() * 1e-4 if s is None else t * s)
        t[:, sh - pad:] = 0
        if nb > 1:
            t[-1] = 0
        out.append(t)
    return out


ADAMW_CASES = [(5, 1003, 7, 0), (3, 3 * 4096 + 8, 8, 0), (129, 1 << 14, 0, 0), (4, 1024, 4, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("nb,sh,pad,offset", ADAMW_CASES)
@pytest.mark.parametrize("wire", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("step_no,clip", [(1, 1.0), (3, 0.37)])
def test_adamw_kernel_matches_plain_on_card(cuda, nb, sh, pad, offset, wire, step_no, clip):
    """K5 bit for bit against `ref.adamw_shard_ref` on the same CUDA tensors:
    p_wire (or q and the scales), m and v; pads stay zero. Rows that are not
    a multiple of 4 elements, or shards that are not 16-byte aligned, take
    the kernel's 4-byte accesses."""
    g, p, m, v = _adamw_args(nb, sh, pad, offset, cuda, nb * sh + step_no)
    step = torch.tensor(float(step_no), device=cuda)
    scal = (torch.tensor(clip, device=cuda), torch.tensor(3e-4, device=cuda),
            1 - 0.9 ** step, 1 - 0.95 ** step)
    got = bc.adamw_shard(g, p, m, v, *scal, 0.9, 0.95, 1e-8, 0.1, wire)
    want = ref.adamw_shard_ref(g, p, m, v, *scal, 0.9, 0.95, 1e-8, 0.1, wire)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    for t in (got[0], got[2], got[3]):
        assert not t[:, sh - pad:].float().any()


@pytest.mark.gpu
def test_adamw_wrapper_launches_and_counts_on_card(cuda):
    ops.reset_launch_counts()
    g, p, m, v = _adamw_args(2, 64, 0, 0, cuda, 0)
    kw = dict(clip=torch.tensor(1.0, device=cuda), lr=1e-3, bc1=0.1, bc2=0.05, b1=0.9,
              b2=0.95, eps=1e-8, weight_decay=0.1)
    q, s, _, _ = bc.adamw_update_shard(g, p, m, v, wire="int8", **kw)   # two passes, one call
    pw, none, m2, v2 = bc.adamw_update_shard(g, p, m, v, **kw)
    assert q.dtype == torch.int8 and s.shape == (2,) and none is None
    assert pw.dtype == m2.dtype == v2.dtype == torch.float32
    assert ops.launch_counts()["adamw_shard"] == 2
    with pytest.raises(ValueError, match="float32"):
        bc.adamw_update_shard(g, p.bfloat16(), m, v, **kw)


# ------------------------------------------------------------------ training
def _reduced_hd64():
    """The reduced smollm with head dim 64, the flash kernel's."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("smollm-135m").reduced(), n_heads=2, n_kv_heads=1)


@pytest.mark.gpu
@pytest.mark.parametrize("compress_bits", [0, 8])
def test_one_explicit_dp_step_on_nccl(cuda, tmp_path, compress_bits):
    """One explicit-DP step at world size 1 on NCCL through every kernel: a
    reduced smollm with head dim 64 (the flash kernel's), bf16 params."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.runtime.train import Trainer, TrainConfig

    cfg = _reduced_hd64()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        tr = Trainer(cfg, SHAPES["train_4k"].reduced(),
                     train_cfg=TrainConfig(steps=1, explicit_dp=True, bucket_bytes=1 << 16,
                                           compress_bits=compress_bits,
                                           ckpt_dir=str(tmp_path)))
        ops.reset_launch_counts()
        res = tr.run()
    finally:
        dist.destroy_process_group()
    L = cfg.n_layers
    assert ops.launch_counts() == {"rmsnorm": 4 * L + 1, "flash_attention": 2 * L,
                                   "bucket_pack": 1, "bucket_unpack": 1, "adamw_shard": 0}
    row = res["metrics"][0]
    assert torch.isfinite(torch.tensor([row["loss"], row["grad_norm"]])).all()


@pytest.mark.gpu
@pytest.mark.parametrize("compress_bits", [0, 8])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_one_zero_step_on_nccl(cuda, tmp_path, compress_bits, microbatches):
    """One ZeRO step at world size 1 on NCCL: K3 packs the gradients (once a
    microbatch) and the params, K5 updates the shard, K4 unpacks; the
    checkpoint at the end of the run holds the whole moments."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import SHAPES
    from repro_torch.runtime.train import Trainer, TrainConfig

    cfg = _reduced_hd64()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        tr = Trainer(cfg, SHAPES["train_4k"].reduced(),
                     train_cfg=TrainConfig(steps=1, explicit_dp=True, zero=True,
                                           overlap=microbatches > 1, microbatches=microbatches,
                                           bucket_bytes=1 << 16, compress_bits=compress_bits,
                                           ckpt_dir=str(tmp_path)))
        ops.reset_launch_counts()
        res = tr.run()
    finally:
        dist.destroy_process_group()
    L = cfg.n_layers
    assert ops.launch_counts() == {"rmsnorm": microbatches * (4 * L + 1),
                                   "flash_attention": microbatches * 2 * L,
                                   "bucket_pack": microbatches + 1, "bucket_unpack": 1,
                                   "adamw_shard": 1}
    row = res["metrics"][0]
    assert torch.isfinite(torch.tensor([row["loss"], row["grad_norm"]])).all()
    assert CheckpointManager(str(tmp_path)).latest_step() == 1


@pytest.mark.gpu
@pytest.mark.parametrize("args", [["--explicit-dp", "--compress-bits", "0"],
                                  ["--explicit-dp", "--compress-bits", "8"],
                                  ["--zero", "--steps", "4"]])
def test_launch_train_reduced_on_the_card(cuda, capsys, tmp_path, args):
    """The launcher's default device at the reduced preset (head dim 32):
    one rank on NCCL, every step through the kernels."""
    from repro_torch.launch import train as launch_train

    ops.reset_launch_counts()
    assert launch_train.main(["--arch", "smollm-135m", "--reduced", "--steps", "2",
                              "--bucket-bytes", "65536", "--ckpt-dir", str(tmp_path),
                              *args]) == 0
    steps = 4 if "--zero" in args else 2
    out = capsys.readouterr().out
    assert "step     0 loss" in out and f"done: step {steps}" in out and "on cuda" in out
    assert "median host time per step after the first" in out
    counts = ops.launch_counts()
    zero = "--zero" in args
    assert counts["bucket_pack"] == (2 if zero else 1) * steps
    assert counts["bucket_unpack"] == steps and counts["adamw_shard"] == (steps if zero else 0)
    assert counts["flash_attention"] == 2 * 2 * steps   # 2 layers, forward + recompute
