"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `gpu` and skips without a card. This file imports
neither jax nor the JAX package, so it runs where only the port is installed:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ops, ref, rmsnorm as rn


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
def test_flash_kernel_matches_plain_on_card(cuda, s, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(s)
    q, k, v = (torch.randn(72, s, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
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
    assert ops.launch_counts() == {"rmsnorm": 1, "flash_attention": 1}
