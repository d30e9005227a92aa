"""The port's kernel wrappers against the JAX package's, on the same numpy inputs.

On the CPU the wrappers run their plain PyTorch versions; the JAX side runs its
Pallas kernels in interpret mode. The CUDA kernels themselves are held against
the plain versions on the card by tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import _build, ops, ref

# fp32: both sides accumulate in fp32 in different orders (tests/test_kernels.py
# holds the Pallas kernel to its reference at the same 5e-6 / 1e-5).
# bf16: both compute in fp32 and round once, so they differ by at most an ulp:
# 1e-2 relative (two bf16 ulps) for the norm, 3e-2 for attention outputs.
RMS_FP32_ATOL, RMS_BF16_RTOL = 1e-5, 1e-2
FLASH_TOL = {"float32": 5e-6, "bfloat16": 3e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of `dtype`."""
    t = torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
    return jnp.asarray(a, getattr(jnp, dtype)), t


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


@pytest.mark.parametrize("shape", [(8, 576), (64, 576), (5, 64), (2, 7, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(shape, dtype):
    rng = np.random.RandomState(0)
    xj, xt = _pair(rng.randn(*shape), dtype)
    sj, st = _pair(rng.randn(shape[-1]), dtype)
    got = _np(ops.rmsnorm(xt, st))
    for want in (jops.rmsnorm(xj, sj), jlayers.rms_norm(xj, sj)):
        if dtype == "float32":
            np.testing.assert_allclose(got, _np(want), atol=RMS_FP32_ATOL, rtol=0)
        else:
            np.testing.assert_allclose(got, _np(want), atol=0, rtol=RMS_BF16_RTOL)


@pytest.mark.parametrize("s", [16, 64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(s, causal, dtype):
    rng = np.random.RandomState(s + causal)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.randn(2, s, 3, 64), dtype) for _ in range(3))
    want = jops.flash_attention(qj, kj, vj, causal=causal)   # q_block = min(128, S) divides S
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.shape == (2, s, 3, 64) and got.dtype == qt.dtype
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(4, 6, 2, 64).astype(np.float32))
    torch.testing.assert_close(ops.flash_attention(x, x, x),
                               ref.attention_ref(*(x.transpose(1, 2).reshape(8, 6, 64),) * 3)
                               .reshape(4, 2, 6, 64).transpose(1, 2), rtol=0, atol=0)
    sc = torch.ones(64)
    torch.testing.assert_close(ops.rmsnorm(x, sc), ref.rmsnorm_ref(x, sc), rtol=0, atol=0)
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "bucket_pack": 0,
                                   "bucket_unpack": 0, "adamw_shard": 0}


def test_cuda_tensors_reach_the_kernel_or_raise(monkeypatch):
    """A CUDA tensor never takes the plain version: the wrappers go to the
    kernel's library, and when it cannot be had they raise and count nothing."""
    asked = []

    def no_library(name):
        asked.append(name)
        raise RuntimeError(f"cannot build {name}")

    def plain_taken(*a, **kw):
        raise AssertionError("plain version taken for a CUDA tensor")

    monkeypatch.setattr(_build, "library", no_library)
    monkeypatch.setattr(ref, "rmsnorm_ref", plain_taken)
    monkeypatch.setattr(ref, "attention_ref", plain_taken)
    ops.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(4, 8, 3, 64, device="cuda", dtype=torch.bfloat16)
        sc = torch.empty(64, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(RuntimeError, match="cannot build rmsnorm"):
            ops.rmsnorm(x, sc)
        with pytest.raises(RuntimeError, match="cannot build flash_attention"):
            ops.flash_attention(x, x, x)
    assert asked == ["rmsnorm", "flash_attention"]
    assert ops.launch_counts() == {"rmsnorm": 0, "flash_attention": 0, "bucket_pack": 0,
                                   "bucket_unpack": 0, "adamw_shard": 0}


def test_cuda_tensors_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card")
    with FakeTensorMode():
        x = torch.empty(4, 64, device="cuda", dtype=torch.float32)
        sc = torch.empty(64, device="cuda", dtype=torch.float32)
        with pytest.raises((RuntimeError, AssertionError)):
            ops.rmsnorm(x, sc)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    with FakeTensorMode():
        x16 = torch.empty(4, 64, device="cuda", dtype=torch.float16)
        s16 = torch.empty(64, device="cuda", dtype=torch.float16)
        x = torch.empty(4, 64, device="cuda", dtype=torch.float32)
        s32 = torch.empty(32, device="cuda", dtype=torch.float32)
        q128 = torch.empty(2, 16, 128, device="cuda", dtype=torch.float32)
        strided = torch.empty_strided((2, 16, 64), (2048, 128, 1), device="cuda",
                                      dtype=torch.float32)
    from repro_torch.kernels import flash_attention as fa, rmsnorm as rn
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rn.rmsnorm_fwd(x16, s16)
    with pytest.raises(ValueError, match="same dtype"):
        rn.rmsnorm_fwd(x, s16)
    with pytest.raises(ValueError, match=r"\(D,\)"):
        rn.rmsnorm_fwd(x, s32)
    with pytest.raises(ValueError, match=r"head_dim in \(32, 64\)"):
        fa.flash_attention_fwd(q128, q128, q128)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(strided, strided, strided)
    with pytest.raises(ValueError, match="CUDA device"):
        rn.rmsnorm_fwd(torch.ones(4, 64), torch.ones(64))


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_key_follows_the_sources():
    for name in _build.KERNELS:
        p = _build.library_path(name)
        assert p.parent == _build.BUILD_DIR and p.name.startswith(name + "-")
        assert p == _build.library_path(name)
