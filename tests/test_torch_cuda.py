"""The CUDA kernels of seed_tpu_torch against their plain versions, on the
card. A CUDA kernel has no CPU mode, so every test here is marked ``cuda``
and skips on a machine without a GPU. These tests need no JAX; where JAX is
not installed, run them without the suite's conftest (which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import pytest
import torch

from seed_tpu_torch.models import layers as L
from seed_tpu_torch.ops import flash_attention as TF
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


# (Sq, Sk, H, D, causal, q_offset): the training shape cut in batch and
# heads, ragged causal, ragged non-causal (kv masking), a chunk at an offset,
# and D > 128 (the smaller tile)
FLASH_CASES = [(1024, 1024, 2, 128, True, 0), (300, 300, 2, 64, True, 0),
               (257, 257, 2, 88, False, 0), (256, 512, 2, 128, True, 256),
               (260, 260, 1, 160, True, 0)]
# fp32: sum order only. bf16: an output one bf16 ulp apart where a rounding
# of p or of the output lands differently (|o| < 4), lse is fp32 either way.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.0 ** -6}


def _flash_inputs(gen, Sq, Sk, H, D, dtype, B=2):
    mk = lambda S: torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    return mk(Sq), mk(Sk), mk(Sk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,D,causal,off", FLASH_CASES)
def test_flash_fwd_kernel_matches_plain(gen, dtype, Sq, Sk, H, D, causal, off):
    q, k, v = _flash_inputs(gen, Sq, Sk, H, D, dtype)
    before = TF.flash_fwd.launches
    got, lse = TF.flash_fwd(q, k, v, causal, D ** -0.5, off)
    assert TF.flash_fwd.launches == before + 1
    want, want_lse = TF.flash_fwd_plain(q, k, v, causal, D ** -0.5, off)
    assert got.dtype == dtype and got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= FLASH_TOL[dtype]
    assert (lse - want_lse).abs().max().item() <= 2e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,D,causal,off",
                         [c for c in FLASH_CASES if c[-1] == 0])
def test_flash_bwd_kernels_match_plain(gen, dtype, Sq, Sk, H, D, causal, off):
    """Gradients are sums of up to Sq products of O(1) terms: fp32 differs by
    sum order (1e-4 absolute at these sizes), bf16 by roundings of p and ds
    that land one ulp apart (2**-5 relative to the largest gradient)."""
    q, k, v = _flash_inputs(gen, Sq, Sk, H, D, dtype)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = D ** -0.5
    out, lse = TF.flash_fwd_plain(q, k, v, causal, scale)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    n_dq, n_dkv = TF.flash_bwd_dq.launches, TF.flash_bwd_dkv.launches
    dq = TF.flash_bwd_dq(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = TF.flash_bwd_dkv(q, k, v, dout, lse, delta, causal, scale)
    assert TF.flash_bwd_dq.launches == n_dq + 1
    assert TF.flash_bwd_dkv.launches == n_dkv + 1
    want_dq = TF.flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal, scale)
    want_dk, want_dv = TF.flash_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                              causal, scale)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            assert err <= 1e-4
        else:
            assert err <= 2.0 ** -5 * want.float().abs().max().item()


def test_tiled_flash_autograd_runs_the_three_kernels(gen):
    """backward launches dq and dk/dv once each and agrees with autograd
    through the plain mha path (fp32: 3e-3, seed_tpu's own bound); strided
    q/k/v views of one fused projection are read in place."""
    from seed_tpu_torch.ops.attention import mha, sliced_causal_mask
    B, S, H, D = 2, 300, 2, 64
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda",
                      requires_grad=True)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    counts = [f.launches for f in (TF.flash_fwd, TF.flash_bwd_dq,
                                   TF.flash_bwd_dkv)]
    (TF.tiled_flash(q, k, v, True, D ** -0.5) ** 2).sum().backward()
    got, qkv.grad = qkv.grad, None
    assert [f.launches for f in (TF.flash_fwd, TF.flash_bwd_dq,
                                 TF.flash_bwd_dkv)] == [c + 1 for c in counts]
    mask = sliced_causal_mask(S, S, 0, "cuda")
    (mha(q, k, v, mask=mask) ** 2).sum().backward()
    assert (got - qkv.grad).abs().max().item() <= 3e-3


def test_flash_attention_gqa_and_empty_rows(gen):
    """GQA through the dispatcher (kv heads repeated outside the kernel), and
    a q tile that meets no kv tile: output 0, lse 0."""
    from seed_tpu_torch.ops.attention import mha, sliced_causal_mask
    q = torch.randn(1, 256, 4, 128, generator=gen, device="cuda")
    k = torch.randn(1, 256, 2, 128, generator=gen, device="cuda")
    v = torch.randn(1, 256, 2, 128, generator=gen, device="cuda")
    before = TF.flash_fwd.launches
    got = TF.flash_attention(q, k, v, causal=True)
    assert TF.flash_fwd.launches == before + 1
    want = mha(q, k, v, mask=sliced_causal_mask(256, 256, 0, "cuda"))
    assert (got - want).abs().max().item() <= 2e-4
    out, lse = TF.flash_fwd(q[:, :, :2], k, v, True, 128 ** -0.5, -256)
    assert not out.any() and not lse.any()


def test_kernels_raise_instead_of_falling_back(gen):
    x = torch.randn(256, 200, generator=gen, device="cuda")
    w = torch.zeros(200, 256, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="tile by 128"):
        int8_matmul(x, w, torch.ones(256, device="cuda"))
    q = torch.zeros(1, 257, 2, 88, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="not supported"):
        short_mha(q, q, q, 1.0)
    with pytest.raises(ValueError, match="not supported"):
        TF.flash_fwd(q, q, q, True, 1.0)
    x = torch.zeros(1, 256, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        TF.flash_fwd(x, x[:, :, :1], x[:, :, :1], True, 1.0)


def test_linear_routes_prefill_to_the_kernel(gen):
    p = quantize_weight(torch.randn(256, 384, generator=gen, device="cuda"))
    before = int8_matmul.launches
    L.linear(p, torch.randn(4, 8, 256, generator=gen, device="cuda"))   # M=32
    assert int8_matmul.launches == before
    L.linear(p, torch.randn(4, 64, 256, generator=gen, device="cuda"))  # M=256
    assert int8_matmul.launches == before + 1
