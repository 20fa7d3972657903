"""The CUDA kernels of seed_tpu_torch against their plain versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked ``cuda``
and skips on a machine without a GPU. These tests need no JAX; where JAX is
not installed, run them without the suite's conftest (which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import pytest
import torch

from seed_tpu_torch.models import layers as L
from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain
from seed_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
from seed_tpu_torch.ops.quantization import quantize_weight

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact,D", [(True, 88), (False, 88), (False, 128),
                                     (True, 40)])
def test_short_mha_kernel_matches_plain(gen, dtype, exact, D):
    """Tolerance: fp32 2e-5 (sum order); bf16 2**-6 (a rounding of p or of
    the output one bf16 ulp apart)."""
    B, S, H = 2, 257, 3
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, exact)
    assert short_mha.launches == before + 1
    want = short_mha_plain(q, k, v, D ** -0.5, exact)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    assert got.dtype == dtype and got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 256, 300])
def test_int8_matmul_kernel_matches_plain(gen, dtype, M):
    """Tolerance relative to max|y|: fp32 1e-5, bf16 2**-7."""
    K, N = 512, 384
    qw = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    before = int8_matmul.launches
    got = int8_matmul(x, qw["kernel_q"], qw["scale"])
    assert int8_matmul.launches == before + 1
    want = int8_matmul_plain(x, qw["kernel_q"], qw["scale"])
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


def test_kernels_raise_instead_of_falling_back(gen):
    x = torch.randn(256, 200, generator=gen, device="cuda")
    w = torch.zeros(200, 256, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="tile by 128"):
        int8_matmul(x, w, torch.ones(256, device="cuda"))
    q = torch.zeros(1, 257, 2, 88, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="not supported"):
        short_mha(q, q, q, 1.0)


def test_linear_routes_prefill_to_the_kernel(gen):
    p = quantize_weight(torch.randn(256, 384, generator=gen, device="cuda"))
    before = int8_matmul.launches
    L.linear(p, torch.randn(4, 8, 256, generator=gen, device="cuda"))   # M=32
    assert int8_matmul.launches == before
    L.linear(p, torch.randn(4, 64, 256, generator=gen, device="cuda"))  # M=256
    assert int8_matmul.launches == before + 1
