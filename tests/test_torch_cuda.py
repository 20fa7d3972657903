"""The CUDA kernels of seed_tpu_torch against their plain versions, on the
card, and the unCLIP de-tokenizer at SD2.1 width (bf16 against fp32). A
CUDA kernel has no CPU mode, so every test here is marked ``cuda``
and skips on a machine without a GPU. These tests need no JAX; where JAX is
not installed, run them without the suite's conftest (which imports it):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""
import math

import numpy as np
import pytest
import torch

from seed_tpu_torch.models import layers as L
from seed_tpu_torch.models import unclip as TU
from seed_tpu_torch.models.unclip import unet as TUN
from seed_tpu_torch.ops import flash_attention as TF
from seed_tpu_torch.ops import group_norm as GN
from seed_tpu_torch.ops import int8_matmul as TI
from seed_tpu_torch.ops.attention import mha
from seed_tpu_torch.ops.flash_attention import short_mha, short_mha_plain
from seed_tpu_torch.ops.int8_matmul import (int8_matmul, int8_matmul_plain,
                                            w8a8_matmul, w8a8_matmul_plain)
from seed_tpu_torch.ops.quantization import quantize_acts, quantize_weight
from seed_tpu_torch.serving.offload import OffloadedParams
from seed_tpu_torch.utils.tree import leaves as _leaves
from seed_tpu_torch.utils.tree import tree_map

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


# (exact, D, S): the ViT's three epilogues, a narrow ragged head, D=64, the
# longest sequence the dispatcher routes here (Sk = 1024, K/V streamed), and
# D=100 (not a multiple of 8: element-wise staging)
SHORT_CASES = [(True, 88, 257), (False, 88, 257), (False, 128, 257),
               (True, 40, 257), (True, 64, 257), (True, 88, 1024),
               (False, 64, 1024), (True, 100, 257)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("exact,D,S", SHORT_CASES)
def test_short_mha_kernel_matches_plain(gen, dtype, exact, D, S):
    """Tolerance: fp32 2e-5 (sum order); bf16 2**-6 (a rounding of p or of
    the output one bf16 ulp apart)."""
    B, H = 2, 3
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, exact)
    assert short_mha.launches == before + 1
    want = short_mha_plain(q, k, v, D ** -0.5, exact)
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -6
    assert got.dtype == dtype and got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= tol


# bf16 (B, H, S, D, layout): the one-pass design (a row's scores in
# registers: Sk <= 264, D from 33 to 96) at the EVA-ViT's D = 88 and the CLIP
# towers' 64 and 80, with B H below 2 x 132 (the q tiles of a (b, h) split
# over blocks) and far above (a block walks all five: B=256, H=16 is the
# encode's call); Sk = 256 and 264, the edges of its last 8 keys; layout
# "fused": q/k/v views of one [B, S, 3 H D] projection (16-byte cp.async
# staging), "offset": one element past an aligned base (element-wise
# staging); Sk = 300 and 1024 take the recompute design
BF16_DESIGN_CASES = [(2, 16, 257, 88, "fused"), (256, 16, 257, 88, "fused"),
                     (1, 16, 257, 64, "fused"), (40, 16, 257, 80, "fused"),
                     (8, 16, 257, 88, "offset"), (24, 16, 256, 64, "offset"),
                     (3, 5, 264, 88, "fused"), (2, 16, 300, 88, "fused"),
                     (1, 4, 1024, 80, "fused")]


def _bf16_views(gen, B, S, H, D, layout):
    if layout == "fused":
        return _qkv_fused(gen, B, S, H, D, torch.bfloat16)
    flat = lambda: torch.randn(B * S * H * D + 1, generator=gen,
                               device="cuda").bfloat16()
    return tuple(flat()[1:].view(B, S, H, D) for _ in range(3))


def _qkv_fused(gen, B, S, H, D, dtype):
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda").to(dtype)
    return tuple(t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("B,H,S,D,layout", BF16_DESIGN_CASES)
def test_short_mha_bf16_designs(gen, exact, B, H, S, D, layout):
    """Each bf16 design against the plain version within 2**-6 (a rounding
    of p or of the output one bf16 ulp apart), the exact epilogue also
    against mha (the arithmetic the ViT's default route stands in for; the
    same 2**-6 for the same reason), and a second call bit for bit (no
    atomics, no split over keys)."""
    q, k, v = _bf16_views(gen, B, S, H, D, layout)
    assert TF._vec(q, (q, k, v)) == int(layout == "fused")
    one_pass = TF._lib().seed_short_mha_bf16_one_pass(S, D, TF._mode(exact, D))
    assert one_pass == int(S <= 264)
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, exact)
    assert short_mha.launches == before + 1
    want = short_mha_plain(q, k, v, D ** -0.5, exact)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert (got.float() - want.float()).abs().max().item() <= 2.0 ** -6
    if exact:
        ref = mha(q, k, v)
        assert (got.float() - ref.float()).abs().max().item() <= 2.0 ** -6
    again = short_mha(q, k, v, D ** -0.5, exact)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_encode_launches_short_mha_once_a_block_in_bf16(gen):
    """The default SEED_TOKENIZER encode at B=2: in bf16 each of the 39 ViT
    blocks runs its attention through short_mha's exact epilogue (one
    launch a block), in fp32 through mha (none)."""
    from seed_tpu_torch.models import seed_tokenizer as ST
    params = ST.init_seed_tokenizer(gen, ST.SEED_TOKENIZER, torch.float32)
    images = torch.randn(2, 224, 224, 3, generator=gen, device="cuda")
    depth = ST.SEED_TOKENIZER.vit.depth
    with torch.inference_mode():
        before = short_mha.launches
        ST.encode(params, images, ST.SEED_TOKENIZER)
        torch.cuda.synchronize()
        assert short_mha.launches == before
        params = tree_map(lambda t: t.to(torch.bfloat16)
                          if t.is_floating_point() else t, params)
        ids = ST.encode(params, images.bfloat16(), ST.SEED_TOKENIZER)
        torch.cuda.synchronize()
        assert short_mha.launches == before + depth
        assert ids.shape == (2, 32) and ids.min() >= 0 and ids.max() < 8192


# fp32 only (Sq, Sk, D, layout): Sq that the 16-row groups do not divide
# (65: a 3-group and a 2-group tile; 257: 4 + 4 + 3 + 3 + 3 groups), one
# row, Sq != Sk both ways, D below one 32-column slab, odd D (4-byte
# staging and stores), D = 160 (a zero slab of the 192 instance); layout
# "fused": q/k/v split from one [B, S, 3 H D] tensor (16-byte staging where
# D allows), "offset": views one element past an aligned base (4-byte
# staging at any D)
F32_TILE_CASES = [(65, 65, 88, "fused"), (257, 257, 88, "offset"),
                  (1, 257, 88, "fused"), (100, 300, 64, "fused"),
                  (300, 100, 64, "offset"), (40, 40, 8, "fused"),
                  (77, 77, 33, "fused"), (130, 130, 160, "fused"),
                  (33, 1024, 256, "offset")]


def _f32_views(gen, B, Sq, Sk, H, D, layout):
    if layout == "fused":
        q = torch.randn(B, Sq, 3 * H * D, generator=gen, device="cuda")
        k = torch.randn(B, Sk, 3 * H * D, generator=gen, device="cuda")
        return (q[..., :H * D].reshape(B, Sq, H, D),
                k[..., H * D:2 * H * D].reshape(B, Sk, H, D),
                k[..., 2 * H * D:].reshape(B, Sk, H, D))
    flat = lambda S: torch.randn(B * S * H * D + 1, generator=gen, device="cuda")
    return tuple(flat(S)[1:].view(B, S, H, D) for S in (Sq, Sk, Sk))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("Sq,Sk,D,layout", F32_TILE_CASES)
def test_short_mha_fp32_tiles_and_staging(gen, exact, Sq, Sk, D, layout):
    """The fp32 kernel against its plain version, 2e-5 (sum order), at
    tiles that do not divide Sq and through both staging paths; the launch
    follows short_mha_f32_plan, which the wrapper checked against the
    library."""
    q, k, v = _f32_views(gen, 2, Sq, Sk, 3, D, layout)
    assert TF._vec(q, (q, k, v)) == int(layout == "fused" and D % 4 == 0)
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, exact)
    assert short_mha.launches == before + 1
    want = short_mha_plain(q, k, v, D ** -0.5, exact)
    assert got.shape == (2, Sq, 3, D) and got.is_contiguous()
    assert (got - want).abs().max().item() <= 2e-5


# (M, K, N): a narrow product at decode, prefill and ragged M; the four 8B
# prefill shapes at M = 256 (the plan splits K at three of them) and
# 4096 x 4096 at M = 512 (the scheduler's bucket); one K step of 128
INT8_CASES = [(1, 512, 384), (256, 512, 384), (300, 512, 384),
              (256, 4096, 4096), (256, 4096, 11008), (256, 11008, 4096),
              (256, 4096, 40320), (512, 4096, 4096), (256, 128, 256)]


def _int8_inputs(gen, M, K, N, dtype):
    qw = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    return x, qw["kernel_q"], qw["scale"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", INT8_CASES)
def test_int8_matmul_kernel_matches_plain(gen, dtype, M, K, N):
    """Tolerance relative to max|y|: fp32 1e-5, bf16 2**-7."""
    x, wq, sc = _int8_inputs(gen, M, K, N, dtype)
    before = (int8_matmul.launches, int8_matmul.launches_f32)
    got = int8_matmul(x, wq, sc)
    assert (int8_matmul.launches, int8_matmul.launches_f32) == (
        before[0] + 1, before[1] + (dtype == torch.float32))
    want = int8_matmul_plain(x, wq, sc)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


def _plan_split(monkeypatch, split):
    """Make the wrapper launch with ``split`` in place of int8_plan's."""
    monkeypatch.setattr(TI, "int8_plan",
                        lambda M, N, K, dtype: (*TI.TILES[dtype], split))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("split", range(1, TI.MAX_SPLIT + 1))
def test_int8_matmul_every_split_matches_plain(gen, monkeypatch, split, dtype):
    """K = 11008 (86 chunks of 128: ragged runs unless the split divides
    86) with a ragged M, under every split the plan can choose; relative to
    max|y|, fp32 1e-5, bf16 2**-7."""
    x, wq, sc = _int8_inputs(gen, 300, 11008, 256, dtype)
    _plan_split(monkeypatch, split)
    got = int8_matmul(x, wq, sc)
    want = int8_matmul_plain(x, wq, sc)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(256, 4096, 4096), (300, 11008, 256)])
def test_int8_matmul_repeats_bit_for_bit(gen, dtype, M, K, N):
    """No atomics, and the split partials summed in split order: two calls
    give the same bits, split (4096 x 4096 at M = 256) or not."""
    x, wq, sc = _int8_inputs(gen, M, K, N, dtype)
    first, second = int8_matmul(x, wq, sc), int8_matmul(x, wq, sc)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_refuses_a_bad_plan(gen, monkeypatch, dtype):
    """The C entry point checks the plan: no split of zero, no run shorter
    than one 128-wide chunk, only the tile built for x's type."""
    x, wq, sc = _int8_inputs(gen, 256, 512, 384, dtype)
    for split in (0, 5):
        _plan_split(monkeypatch, split)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            int8_matmul(x, wq, sc)
    for tile in {(64, 64), (64, 128), (128, 128)} - {TI.TILES[dtype]}:
        monkeypatch.setattr(TI, "int8_plan", lambda M, N, K, dtype: (*tile, 1))
        with pytest.raises(RuntimeError, match="cudaError_t"):
            int8_matmul(x, wq, sc)


# the four encoder shapes at B=8 (M = 8 x 257), the four 8B shapes at M = 256,
# a ragged M below 128, and decode-sized rows (the small tile)
W8A8_CASES = [(2056, 1408, 4224), (2056, 1408, 1408), (2056, 1408, 6144),
              (2056, 6144, 1408), (256, 4096, 4096), (256, 4096, 11008),
              (256, 11008, 4096), (256, 4096, 40320), (100, 1408, 4224),
              (16, 4096, 11008), (1, 11008, 4096), (65, 256, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", W8A8_CASES)
def test_w8a8_matmul_kernel_matches_plain(gen, dtype, M, K, N):
    """The int32 sums are exact and the epilogue is two fp32 products in the
    plain version's order, so kernel and plain version are equal bit for bit;
    the stated tolerance is one rounding of the output type."""
    qw = quantize_weight(torch.randn(K, N, generator=gen, device="cuda") * 0.02)
    xq, xs = quantize_acts(torch.randn(M, K, generator=gen, device="cuda") * 3)
    before = w8a8_matmul.launches
    got = w8a8_matmul(xq, xs, qw["kernel_q"], qw["scale"], dtype)
    assert w8a8_matmul.launches == before + 1
    want = w8a8_matmul_plain(xq, xs, qw["kernel_q"], qw["scale"], dtype)
    assert got.dtype == dtype and got.shape == (M, N)
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 2.0 ** -23
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item()
    assert torch.equal(got, want)


def test_w8a8_matmul_saturated_sums_are_exact(gen):
    """Every product at +-127 * +-127: the largest int32 sums the 8B shapes
    can produce (K = 11008), far past fp32's 24 bits."""
    M, K, N = 130, 11008, 128
    xq = torch.full((M, K), 127, dtype=torch.int8, device="cuda")
    wq = torch.full((K, N), -127, dtype=torch.int8, device="cuda")
    wq[:, ::2] = 127
    xs = torch.ones((M, 1), device="cuda")
    ws = torch.ones((N,), device="cuda")
    got = w8a8_matmul(xq, xs, wq, ws, torch.float32)
    want = torch.tensor(float(K * 127 * 127), device="cuda").expand(M, N).clone()
    want[:, 1::2] *= -1
    assert torch.equal(got, want)


def test_linear_w8a8_routes_every_m_to_the_kernel(gen):
    p = quantize_weight(torch.randn(256, 384, generator=gen, device="cuda"))
    p["bias"] = torch.randn(384, generator=gen, device="cuda")
    before = w8a8_matmul.launches
    for lead in ((4, 64), (4, 8), (1, 1)):                  # M = 256, 32, 1
        x = torch.randn(*lead, 256, generator=gen, device="cuda")
        y = L.linear_w8a8(p, x)
        xq, xs = quantize_acts(x)
        want = w8a8_matmul_plain(xq.reshape(-1, 256), xs.reshape(-1, 1),
                                 p["kernel_q"], p["scale"], x.dtype)
        assert torch.equal(y, want.reshape(*lead, 384) + p["bias"])
    assert w8a8_matmul.launches == before + 3
    # K, N that do not tile by 128: the library product, no launch
    q = quantize_weight(torch.randn(96, 160, generator=gen, device="cuda"))
    L.linear_w8a8(q, torch.randn(300, 96, generator=gen, device="cuda"))
    assert w8a8_matmul.launches == before + 3


# (Sq, Sk, H, D, causal, q_offset): the training shape cut in batch and
# heads, ragged causal, ragged non-causal (kv masking), a chunk at an offset,
# D > 128 (the smaller kv tile), D=256 with Sq not a multiple of the 64-row
# q tile, a ragged chunk at an offset, and D=36 (element-wise staging)
FLASH_CASES = [(1024, 1024, 2, 128, True, 0), (300, 300, 2, 64, True, 0),
               (257, 257, 2, 88, False, 0), (256, 512, 2, 128, True, 256),
               (260, 260, 1, 160, True, 0), (333, 333, 2, 256, True, 0),
               (190, 450, 2, 64, True, 260), (100, 100, 2, 36, True, 0)]
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


# the backward adds D=88 causal with S a multiple of neither backward tile
# (dk/dv's 32-row q tile, dq's 64-row kv tile) and D=36 non-causal
FLASH_BWD_CASES = [c for c in FLASH_CASES if c[-1] == 0] + [
    (200, 200, 2, 88, True, 0), (96, 96, 2, 36, False, 0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,D,causal,off", FLASH_BWD_CASES)
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


# fp32 only (Sq, Sk, D, causal, q_offset): the split-TF32 kernels at the
# head dims 36 (padded to 48), 64, 88 (96), 128 and 256, ragged Sq and
# Sk against the 64-row blocks and the 32-row kv / 16-row q tiles, chunks at
# an offset (forward only), non-causal, D=30 (element-wise staging), and
# long sequences: SEED-LLaMA-8B's max_seq_len (2048) and twice it, where dq
# sums over 256 kv tiles and dk/dv over 256 q tiles
F32_FLASH_CASES = [(300, 300, 36, True, 0), (111, 111, 64, True, 0),
                   (257, 257, 88, False, 0), (1024, 1024, 128, True, 0),
                   (333, 333, 256, True, 0), (190, 450, 128, True, 260),
                   (100, 356, 88, True, 256), (150, 97, 256, False, 0),
                   (77, 77, 36, False, 0), (130, 130, 30, True, 0),
                   (2048, 2048, 128, True, 0), (4096, 4096, 128, True, 0),
                   (4096, 4096, 128, False, 0)]


@pytest.mark.parametrize("Sq,Sk,D,causal,off", F32_FLASH_CASES)
def test_fp32_flash_fwd_and_dkv_match_plain(gen, Sq, Sk, D, causal, off):
    """The fp32 forward and dk/dv kernels (split TF32) against their plain
    versions (true fp32): the forward within 2e-5 (sum order and the split's
    3 * 2**-22 a product), lse 2e-5, dk and dv 1e-4 absolute, one launch
    each."""
    q, k, v = _flash_inputs(gen, Sq, Sk, 2, D, torch.float32)
    scale = D ** -0.5
    before = (TF.flash_fwd.launches_f32, TF.flash_bwd_dkv.launches_f32)
    got, lse = TF.flash_fwd(q, k, v, causal, scale, off)
    want, want_lse = TF.flash_fwd_plain(q, k, v, causal, scale, off)
    assert (got - want).abs().max().item() <= 2e-5
    assert (lse - want_lse).abs().max().item() <= 2e-5
    if off == 0:
        dout = torch.randn(q.shape, generator=gen, device="cuda")
        delta = (dout * want).sum(-1).permute(0, 2, 1).contiguous()
        args = (q, k, v, dout, want_lse, delta, causal, scale)
        dk, dv = TF.flash_bwd_dkv(*args)
        want_dk, want_dv = TF.flash_bwd_dkv_plain(*args)
        assert (dk - want_dk).abs().max().item() <= 1e-4
        assert (dv - want_dv).abs().max().item() <= 1e-4
    assert (TF.flash_fwd.launches_f32, TF.flash_bwd_dkv.launches_f32) == (
        before[0] + 1, before[1] + (off == 0))


@pytest.mark.parametrize("Sq,Sk,D,causal,off", F32_FLASH_CASES)
def test_fp32_dq_matches_plain(gen, Sq, Sk, D, causal, off):
    """The fp32 dq kernel (split TF32) against its plain version (true
    fp32) within 1e-4 absolute, one fp32 launch, on the cases of the forward
    and dk/dv (dq has no q offset: the forward's lse is taken at 0)."""
    q, k, v = _flash_inputs(gen, Sq, Sk, 2, D, torch.float32)
    scale = D ** -0.5
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = TF.flash_fwd_plain(q, k, v, causal, scale)
    delta = (dout * out).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, dout, lse, delta, causal, scale)
    before = TF.flash_bwd_dq.launches_f32
    got = TF.flash_bwd_dq(*args)
    assert TF.flash_bwd_dq.launches_f32 == before + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert (got - TF.flash_bwd_dq_plain(*args)).abs().max().item() <= 1e-4


def test_fp32_dq_repeats_bit_for_bit(gen):
    """No atomics and one block per q tile in the fp32 dq kernel: two calls
    at B=2 S=1024 H=4 D=128 give the same bits."""
    q, k, v = _flash_inputs(gen, 1024, 1024, 4, 128, torch.float32)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = TF.flash_fwd(q, k, v, True, 128 ** -0.5)
    delta = (dout * out).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, dout, lse, delta, True, 128 ** -0.5)
    first, second = TF.flash_bwd_dq(*args), TF.flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_fp32_dkv_repeats_bit_for_bit(gen):
    """No atomics and one block per kv tile in the fp32 dk/dv kernel: two
    calls at B=2 S=1024 H=4 D=128 give the same bits."""
    q, k, v = _flash_inputs(gen, 1024, 1024, 4, 128, torch.float32)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    out, lse = TF.flash_fwd(q, k, v, True, 128 ** -0.5)
    delta = (dout * out).sum(-1).permute(0, 2, 1).contiguous()
    args = (q, k, v, dout, lse, delta, True, 128 ** -0.5)
    first, second = TF.flash_bwd_dkv(*args), TF.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("S,D", [(300, 64), (256, 128), (200, 88)])
def test_tiled_flash_fp32_gradients_match_mha(gen, S, D):
    """_TiledFlash in fp32 (the forward, dq and dk/dv kernels) against
    autograd through the plain mha path: q, k and v gradients of sum(O**2)
    within 2e-4, the bound of seed_tpu's own flash tests."""
    from seed_tpu_torch.ops.attention import mha, sliced_causal_mask
    leaves = [t.requires_grad_() for t in _flash_inputs(gen, S, S, 2, D,
                                                        torch.float32)]
    refs = [t.detach().clone().requires_grad_() for t in leaves]
    (TF.tiled_flash(*leaves, True, D ** -0.5) ** 2).sum().backward()
    mask = sliced_causal_mask(S, S, 0, "cuda")
    (mha(*refs, mask=mask, scale=D ** -0.5) ** 2).sum().backward()
    for t, r in zip(leaves, refs):
        assert (t.grad - r.grad).abs().max().item() <= 2e-4


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
    xq = torch.zeros(256, 200, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="tile by 128"):
        w8a8_matmul(xq, torch.ones(256, 1, device="cuda"), w,
                    torch.ones(256, device="cuda"))
    xq = torch.zeros(256, 256, dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="not supported"):
        w8a8_matmul(xq, torch.ones(256, 1, device="cuda"), xq,
                    torch.ones(256, device="cuda"), torch.float16)
    q = torch.zeros(1, 257, 2, 88, dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="not supported"):
        short_mha(q, q, q, 1.0)
    with pytest.raises(ValueError, match="not supported"):
        TF.flash_fwd(q, q, q, True, 1.0)
    x = torch.zeros(1, 256, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        TF.flash_fwd(x, x[:, :, :1], x[:, :, :1], True, 1.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_short_route_gradients_match_mha(gen, dtype):
    """q, k and v get their gradients through flash_attention's short
    non-causal route (one short_mha launch forward, the mha recompute
    backward) at the ViT's S=257, D=88: against the port's mha autograd,
    within 3e-3 (seed_tpu's bound) in fp32 and 2**-5 of the largest
    gradient in bf16."""
    B, S, H, D = 1, 257, 2, 88
    leaves = [torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
              .requires_grad_() for _ in range(3)]
    refs = [t.detach().clone().requires_grad_() for t in leaves]
    dout = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dtype)
    before = short_mha.launches
    out = TF.flash_attention(*leaves)
    assert short_mha.launches == before + 1 and out.grad_fn is not None
    out.backward(dout)
    mha(*refs).backward(dout)
    for t, r in zip(leaves, refs):
        assert t.grad is not None and t.grad.dtype == dtype
        err = (t.grad.float() - r.grad.float()).abs().max().item()
        tol = 3e-3 if dtype == torch.float32 else 2.0 ** -5 * r.grad.float().abs().max().item()
        assert err <= tol


def test_linear_routes_prefill_to_the_kernel(gen):
    p = quantize_weight(torch.randn(256, 384, generator=gen, device="cuda"))
    before = int8_matmul.launches
    L.linear(p, torch.randn(4, 8, 256, generator=gen, device="cuda"))   # M=32
    assert int8_matmul.launches == before
    L.linear(p, torch.randn(4, 64, 256, generator=gen, device="cuda"))  # M=256
    assert int8_matmul.launches == before + 1


def _bwd_args(gen, S, H, D, B=2):
    """bf16 backward inputs: q, k, v, dout, the forward's lse and delta."""
    q, k, v = _flash_inputs(gen, S, S, H, D, torch.bfloat16, B)
    dout = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    out, lse = TF.flash_fwd(q, k, v, True, D ** -0.5)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    return q, k, v, dout, lse, delta, True, D ** -0.5


@pytest.mark.parametrize("kernel", ["flash_fwd", "short_mha", "flash_bwd_dq",
                                    "flash_bwd_dkv", "int8_matmul",
                                    "w8a8_matmul"])
def test_bf16_kernels_repeat_bit_for_bit(gen, kernel):
    """No atomics, no split over kv, and int8_matmul's split of K summed in
    a fixed order: two calls on the same inputs give the same bits
    (training's resume check depends on it)."""
    if kernel == "int8_matmul":
        x, wq, sc = _int8_inputs(gen, 256, 11008, 4096, torch.bfloat16)
        run = lambda: (int8_matmul(x, wq, sc),)
    elif kernel == "w8a8_matmul":
        qw = quantize_weight(torch.randn(1408, 4224, generator=gen,
                                         device="cuda") * 0.02)
        xq, xs = quantize_acts(torch.randn(2056, 1408, generator=gen,
                                           device="cuda") * 3)
        run = lambda: (w8a8_matmul(xq, xs, qw["kernel_q"], qw["scale"]),)
    elif kernel == "flash_fwd":
        q, k, v = _flash_inputs(gen, 1024, 1024, 4, 128, torch.bfloat16)
        run = lambda: TF.flash_fwd(q, k, v, True, 128 ** -0.5)
    elif kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
        args = _bwd_args(gen, 1024, 4, 128, B=4)
        fn = getattr(TF, kernel)
        run = lambda: fn(*args)
    else:
        qkv = torch.randn(4, 257, 3 * 16 * 88, generator=gen,
                          device="cuda").bfloat16()
        q, k, v = (t.reshape(4, 257, 16, 88) for t in qkv.split(16 * 88, dim=-1))
        run = lambda: (short_mha(q, k, v, 88 ** -0.5, True),
                       short_mha(q, k, v, 88 ** -0.5, False))
    first, second = run(), run()
    torch.cuda.synchronize()
    if kernel == "flash_bwd_dq":
        first, second = (first,), (second,)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel,S,D", [("flash_fwd", 300, 256),
                                        ("short_mha", 257, 256),
                                        ("short_mha", 1024, 88),
                                        ("flash_fwd", 1024, 88),
                                        ("flash_bwd_dq", 300, 256),
                                        ("flash_bwd_dkv", 300, 256),
                                        ("flash_bwd_dq", 1024, 88),
                                        ("flash_bwd_dkv", 1024, 88)])
def test_bf16_kernels_launch_at_the_edge_shapes(gen, kernel, S, D):
    """D=256 (the backward's split dK/dV columns) and S=1024 in bf16 go to
    the kernel: one launch, no error."""
    fn = short_mha if kernel == "short_mha" else getattr(TF, kernel)
    if kernel.startswith("flash_bwd"):
        args = _bwd_args(gen, S, 2, D, B=1)
        q = args[0]
        before = fn.launches
        outs = fn(*args)
    else:
        q, k, v = _flash_inputs(gen, S, S, 2, D, torch.bfloat16, B=1)
        before = fn.launches
        outs = (TF.flash_fwd(q, k, v, True, D ** -0.5)[0] if kernel == "flash_fwd"
                else short_mha(q, k, v, D ** -0.5, True))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for out in (outs if isinstance(outs, tuple) else (outs,)):
        assert out.shape == q.shape and out.isfinite().all()


def test_fp32_short_mha_repeats_bit_for_bit(gen):
    """No atomics and no split over keys in the fp32 kernel either: two
    calls at B=4 S=257 H=16 D=88 give the same bits, exact and fast."""
    qkv = torch.randn(4, 257, 3 * 16 * 88, generator=gen, device="cuda")
    q, k, v = (t.reshape(4, 257, 16, 88) for t in qkv.split(16 * 88, dim=-1))
    run = lambda: (short_mha(q, k, v, 88 ** -0.5, True),
                   short_mha(q, k, v, 88 ** -0.5, False))
    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("S,D", [(1024, 256), (1024, 88)])
@pytest.mark.parametrize("exact", [True, False])
def test_fp32_short_mha_launches_at_the_edge_shapes(gen, S, D, exact):
    """The longest sequence the dispatcher routes here at the widest and
    the ViT's head dim, fp32: one launch (the plan takes fewer rows a tile
    where 64 do not fit), finite, within 2e-5 of the plain version."""
    q, k, v = _flash_inputs(gen, S, S, 2, D, torch.float32, B=1)
    assert TF.short_mha_f32_plan(S, S, D)[1] <= TF.SMEM_LIMIT
    before = short_mha.launches
    out = short_mha(q, k, v, D ** -0.5, exact)
    torch.cuda.synchronize()
    assert short_mha.launches == before + 1
    assert out.shape == q.shape and out.isfinite().all()
    want = short_mha_plain(q, k, v, D ** -0.5, exact)
    assert (out - want).abs().max().item() <= 2e-5


# ------------------ the unCLIP de-tokenizer (the flash forward) ---------------

# the UNet's self-attention calls that take the flash forward: (tokens,
# heads of 64) at levels 0-2 of the 96x96 latent, at the CFG batch of 2
UNET_ROUTED = [(9216, 5), (2304, 10), (576, 20)]


@pytest.mark.parametrize("N,heads", UNET_ROUTED)
def test_unet_self_attention_runs_the_flash_forward(gen, N, heads):
    """attention_apply at a routed UNet shape launches the flash forward
    once and equals its projections around unmasked_attention bit for bit.
    The attention is within 2**-6 of flash_fwd_plain (FLASH_TOL: an output
    rounding one ulp apart) and of mha (|o| < 4; p rounded after the
    normalisation in mha and before it here: a rounding of p or of the
    output one bf16 ulp apart)."""
    B, C = 2, 64 * heads
    p = TUN.init_attention(gen, C, C, torch.bfloat16, "cuda")
    x = torch.randn(B, N, C, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.inference_mode():
        before = TF.flash_fwd.launches
        got = TUN.attention_apply(p, x, x, heads)
        assert TF.flash_fwd.launches == before + 1
        q, k, v = (L.linear(p[n], x).reshape(B, N, heads, 64)
                   for n in ("to_q", "to_k", "to_v"))
        o = TF.unmasked_attention(q, k, v)
        assert o.is_contiguous() and o.shape == (B, N, heads, 64)
        assert torch.equal(got, L.linear(p["to_out"], o.reshape(B, N, C)))
        want_plain, _ = TF.flash_fwd_plain(q, k, v, False, 64 ** -0.5)
        want_mha = mha(q, k, v)
    assert want_mha.float().abs().max().item() < 4
    for want in (want_plain, want_mha):
        assert (o.float() - want.float()).abs().max().item() <= 2.0 ** -6

# ------------------------- the GroupNorm kernel ------------------------------

# every (B, H * W, C) of the de-tokenizer's GroupNorms: the UNet at CFG batch 2
# (levels of 96, 48, 24 and 12 a side), the VAE at B=1 (96 to 768 a side)
GN_CASES = [(2, n, c) for n, cs in (
    (9216, (320, 640, 960)), (2304, (320, 640, 960, 1280, 1920)),
    (576, (640, 1280, 1920, 2560)), (144, (1280, 2560))) for c in cs]
GN_CASES += [(1, 96 * 96, 512), (1, 192 * 192, 512), (1, 384 * 384, 512),
             (1, 384 * 384, 256), (1, 768 * 768, 256), (1, 768 * 768, 128)]


def _gn_inputs(gen, B, N, C):
    """bf16 x [B, side, side, C] with a spread of channel means and scales
    (so groups differ), bf16 scale and bias as the bf16 model holds them."""
    side = math.isqrt(N)
    m = 2 * torch.randn(C, generator=gen, device="cuda")
    sd = 0.5 + 1.5 * torch.rand(C, generator=gen, device="cuda")
    x = (torch.randn(B, side, side, C, generator=gen, device="cuda") * sd
         + m).to(torch.bfloat16)
    scale = torch.randn(C, generator=gen, device="cuda").to(torch.bfloat16)
    bias = torch.randn(C, generator=gen, device="cuda").to(torch.bfloat16)
    return x, scale, bias


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("B,N,C", GN_CASES)
def test_group_norm_kernel_matches_the_fp32_chain(gen, B, N, C, silu):
    """The kernel against the plain fp32 chain (fp32 input, scale and bias:
    the same function, unrounded): within one bf16 ulp of the output's
    magnitude (2**-7 of |y|, plus 1e-5 of max |y| for the order of the fp32
    sums); its mean and variance of each group against float64 within 1e-5
    (the mean relative to the group's |mean| + std, the variance relative to
    itself). One call, one count."""
    x, scale, bias = _gn_inputs(gen, B, N, C)
    assert GN.group_norm_route(x, 32)
    stats = torch.empty(B, 32, 2, device="cuda")
    before = GN.group_norm_kernel.launches
    got = GN.group_norm_kernel(x, scale, bias, 32, 1e-5, silu, stats)
    assert GN.group_norm_kernel.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    want = GN.group_norm_plain(x.float(), scale.float(), bias.float(), 32,
                               1e-5, silu)
    err = (got.float() - want).abs()
    tol = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
    assert (err <= tol).all(), (err - tol).max().item()
    x64 = x.double().reshape(B, N, 32, C // 32)
    mean64 = x64.mean(dim=(1, 3))
    var64 = (x64 - mean64[:, None, :, None]).square().mean(dim=(1, 3))
    mean, var = stats[..., 0].double(), stats[..., 1].double()
    assert ((mean - mean64).abs()
            <= 1e-5 * (mean64.abs() + var64.sqrt())).all()
    assert ((var - var64).abs() <= 1e-5 * var64).all()


# the resident design's shapes on the streaming design, and the resident
# design at its capacity (slices of 184,320 bytes: a group of 10 channels over
# 9,216 positions, of 40 over 2,304), which the plan gives the streaming one
GN_OTHER_DESIGN = [(2, 144, 1280, False), (2, 144, 2560, False),
                   (2, 576, 1280, False), (2, 2304, 640, False),
                   (2, 2304, 320, False), (2, 9216, 320, True),
                   (2, 2304, 1280, True)]


@pytest.mark.parametrize("B,N,C,resident", GN_OTHER_DESIGN)
def test_group_norm_other_design_matches_the_fp32_chain(gen, monkeypatch, B,
                                                        N, C, resident):
    """Each design where the plan chose the other one (forced through
    resident_fits), with SiLU, within the same bf16 ulp of the fp32 chain."""
    assert GN.resident_fits(N, C, 32) != resident
    monkeypatch.setattr(GN, "resident_fits", lambda n, c, groups: resident)
    x, scale, bias = _gn_inputs(gen, B, N, C)
    assert GN.group_norm_plan(B, N, C, 32)[0] == resident
    got = GN.group_norm_kernel(x, scale, bias, 32, 1e-5, True)
    want = GN.group_norm_plain(x.float(), scale.float(), bias.float(), 32,
                               1e-5, True)
    err = (got.float() - want).abs()
    tol = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
    assert (err <= tol).all(), (err - tol).max().item()


@pytest.mark.parametrize("B,N,C", [(2, 9216, 960), (2, 144, 2560),
                                   (2, 576, 1280), (1, 768 * 768, 256)])
def test_group_norm_kernel_repeats_bit_for_bit(gen, B, N, C):
    """No atomics: two calls give the same bits, with SiLU and without, in
    both designs (resident at 144 and 576 positions)."""
    x, scale, bias = _gn_inputs(gen, B, N, C)
    for silu in (False, True):
        first = GN.group_norm_kernel(x, scale, bias, 32, 1e-5, silu)
        assert torch.equal(first, GN.group_norm_kernel(x, scale, bias, 32,
                                                       1e-5, silu))


def test_group_norm_kernels_link_to_their_operation_in_a_trace(gen):
    """Under torch.profiler every kernel of a call (the resident design's
    one, the streaming design's two) links to the host operation that
    launched it, _GroupNormKernel, as the benchmark's split by span needs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    inputs = [_gn_inputs(gen, 2, 576, 1280), _gn_inputs(gen, 2, 9216, 320)]
    for x, scale, bias in inputs:       # load the kernels before the trace
        GN.group_norm_kernel(x, scale, bias, 32, 1e-5, True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for x, scale, bias in inputs:
            GN.group_norm_kernel(x, scale, bias, 32, 1e-5, True)
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    # host events by correlation id, as h100bench's split reads them (the
    # profiler's own events, such as its buffer requests, may share an id)
    host = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA and e.linked_correlation_id() == 0:
            host.setdefault(e.correlation_id(), set()).add(e.name())
    linked = [host.get(e.linked_correlation_id(), set()) for e in events
              if e.device_type() == DeviceType.CUDA and "gn_" in e.name()]
    assert len(linked) == 3
    assert all("_GroupNormKernel" in names for names in linked), linked


def test_group_norm_kernel_raises_instead_of_falling_back(gen):
    """fp32, a layout or a grouping the kernel does not take: a ValueError,
    never the plain chain on the card."""
    x = torch.randn(2, 8, 8, 320, generator=gen, device="cuda")
    p = torch.ones(320, device="cuda")
    with pytest.raises(ValueError, match="not a shape"):
        GN.group_norm_kernel(x, p, p, 32)
    with pytest.raises(ValueError, match="not a shape"):
        GN.group_norm_kernel(x.bfloat16(), p, p, 30)
    with pytest.raises(ValueError, match="not a shape"):
        GN.group_norm_kernel(x.bfloat16().transpose(1, 2), p, p, 32)
    with pytest.raises(ValueError, match="scale"):
        GN.group_norm_kernel(x.bfloat16(), p[:64], p[:64], 32)


@pytest.fixture
def no_tf32():
    """fp32 convolutions and matmuls in full fp32 for the comparison."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = saved


def test_unclip_unet_pass_bf16_against_fp32(gen, no_tf32):
    """One SD2.1-width UNet pass at the decode's shape (CFG batch 2 at
    96x96x4, a [2, 77, 1024] context): bf16 within 5e-2 of the fp32 output's
    largest magnitude (chip_smoke.py's UNET_BF16_TOL). The bf16 pass
    launches the flash forward 15 times (the self-attention over 9,216,
    2,304 and 576 tokens, five calls each) and the GroupNorm kernel 61 times
    (every GroupNorm of the pass); the fp32 pass launches neither, and no
    other kernel runs."""
    cfg = TU.SD21_UNCLIP
    p32 = TU.init_unet(gen, cfg.unet)
    p16 = tree_map(lambda t: t.to(torch.bfloat16), p32)
    lat = torch.randn((2, 96, 96, 4), generator=gen, device="cuda")
    ctx = torch.randn((2, 77, 1024), generator=gen, device="cuda")
    labels = torch.randn((2, 2048), generator=gen, device="cuda")
    t = torch.tensor([951, 951], device="cuda")
    counters = lambda: (short_mha.launches, int8_matmul.launches,
                        TF.flash_fwd.launches, GN.group_norm_kernel.launches)
    before = counters()
    with torch.inference_mode():
        ref = TU.unet_apply(p32, lat, t, ctx, labels, cfg.unet)
        assert counters() == before
        got = TU.unet_apply(p16, lat.bfloat16(), t, ctx.bfloat16(),
                            labels.bfloat16(), cfg.unet)
    assert counters() == (*before[:2], before[2] + 15, before[3] + 61)
    assert got.shape == ref.shape == (2, 96, 96, 4) and got.isfinite().all()
    rel = ((got.float() - ref).abs().max() / ref.abs().max()).item()
    assert rel <= 5e-2, rel


def test_unclip_conv_weights_stay_channels_last_through_offload(gen):
    """Weights held in pinned host memory come back to the card in
    channels_last, and a conv of an NHWC activation returns NHWC memory: no
    copy of a weight or an activation around a conv."""
    p = {"kernel": TUN.init_conv(gen, 3, 3, 64, 32)["kernel"],
         "bias": torch.zeros(32, device="cuda")}
    off = OffloadedParams(p)
    assert off.params["kernel"].is_pinned()
    with off as live:
        assert live["kernel"].is_contiguous(memory_format=torch.channels_last)
        x = torch.randn((2, 16, 16, 64), generator=gen, device="cuda")
        y = TUN.conv2d(live, x)
    assert y.shape == (2, 16, 16, 32) and y.is_contiguous()


def test_unclip_decoder_generates_pixels(gen):
    """UnCLIPDecoder on the card at a small config, offloaded, in bf16:
    [0, 1] pixels, the same on a second call."""
    cfg = TU.TINY_UNCLIP
    dec = TU.UnCLIPDecoder(TU.init_unclip(gen, cfg, torch.bfloat16), cfg,
                           num_inference_steps=4, offload=True)
    emb = torch.randn((2, cfg.image_embed_dim), generator=gen, device="cuda")
    img = dec.generate(emb)
    side = cfg.latent_size * cfg.vae.upscale
    assert img.shape == (2, side, side, 3) and img.min() >= 0 and img.max() <= 1
    assert (img == dec.generate(emb)).all()


@pytest.fixture(scope="module")
def unclip16():
    """Seeded SD2.1 unCLIP weights on the card in bf16."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(1)
    return TU.init_unclip(g, TU.SD21_UNCLIP, torch.bfloat16)


def _eager_pixels(dec, emb):
    """The decoder's weights and latents through the loop with the default
    ``unet_apply``: its pass enqueued eagerly."""
    with torch.inference_mode():
        lat = dec.latents.expand(emb.shape[0], *dec.latents.shape[1:])
        x = TU.generate_latents(dec.params, emb, lat, dec.cfg,
                                dec.num_inference_steps, dec.guidance_scale)
        return TU.decode_to_images(dec.params, x, dec.cfg).float().cpu().numpy()


@pytest.mark.parametrize("B", [1, 2])
def test_unclip_graphed_decode_bit_equal_to_eager(gen, unclip16, B):
    """A resident bf16 decoder at SD2.1 width (3 DDIM steps) captures one
    graph of the UNet pass at its CFG batch 2B on its first call: the flash
    forward runs in the warm-up and the capture passes only, the replays
    launch it from the graph. Its pixels equal the eager pass's bit for bit;
    a second call with other embeddings refreshes the static inputs and
    gives other pixels, again equal to the eager pass's."""
    dec = TU.UnCLIPDecoder(unclip16, TU.SD21_UNCLIP, num_inference_steps=3)
    embs = [torch.randn((B, 1024), generator=gen, device="cuda")
            for _ in range(2)]
    before = TF.flash_fwd.launches
    got = [dec.generate(embs[0])]
    assert TF.flash_fwd.launches == before + 2 * 15
    got.append(dec.generate(embs[1]))
    assert TF.flash_fwd.launches == before + 2 * 15
    assert len(dec.unet_graphs.graphs) == 1
    assert got[0].shape == (B, 768, 768, 3)
    for emb, img in zip(embs, got):
        np.testing.assert_array_equal(img, _eager_pixels(dec, emb))
    assert not np.array_equal(got[0], got[1])


def test_unclip_decoder_replays_only_resident_and_unprofiled(gen):
    """Offloaded weights, or a profiler recording, run the pass eagerly and
    capture nothing; the same resident decoder then captures and replays,
    with the traced call's pixels."""
    from torch.profiler import ProfilerActivity, profile
    cfg = TU.TINY_UNCLIP
    params = TU.init_unclip(gen, cfg, torch.bfloat16)
    emb = torch.randn((1, cfg.image_embed_dim), generator=gen, device="cuda")
    off = TU.UnCLIPDecoder(params, cfg, num_inference_steps=2, offload=True)
    off.generate(emb)
    assert off.unet_graphs.graphs == {}
    dec = TU.UnCLIPDecoder(params, cfg, num_inference_steps=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        traced = dec.generate(emb)
    assert dec.unet_graphs.graphs == {}
    np.testing.assert_array_equal(dec.generate(emb), traced)
    assert len(dec.unet_graphs.graphs) == 1


# ------------------------ tokenizer training (stages 1 and 2) ----------------

def _to(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def test_qformer_text_and_caption_paths_card_vs_cpu(gen):
    """The Q-Former's text, joint and caption paths and the LM head at full
    width (12 layers, BERT vocabulary) on the card against the same calls on
    the CPU, fp32 with TF32 off: 1e-4 of the output's scale."""
    import dataclasses
    from seed_tpu_torch.models import qformer as TQ
    cfg = dataclasses.replace(TQ.SEED_QFORMER, with_text=True)
    p = TQ.init_qformer(gen, cfg)
    head = TQ.init_lm_head(gen, cfg)
    feats = torch.randn((4, 257, cfg.encoder_width), generator=gen,
                        device="cuda")
    ids = torch.randint(3, cfg.vocab_size, (4, 32), generator=gen, device="cuda")
    pad = (torch.arange(32, device="cuda")[None] < torch.tensor(
        [32, 20, 9, 2], device="cuda")[:, None]).int()
    cpu = lambda *a: [x.cpu() if isinstance(x, torch.Tensor) else _to(x, "cpu")
                      for x in a]

    def both(fn, *args):
        got = fn(*args)
        want = fn(*cpu(*args))
        scale = want.abs().max()
        assert ((got.cpu() - want).abs().max() / scale).item() <= 1e-4
        return got

    both(lambda p, i, m: TQ.qformer_text_apply(p, i, cfg, m), p, ids, pad)
    both(lambda p, f, i, m: TQ.qformer_apply(p, f, cfg, text_ids=i,
                                             text_pad=m), p, feats, ids, pad)
    h = both(lambda p, f, i, m: TQ.qformer_caption_apply(p, f, i, cfg, m),
             p, feats, ids, pad)
    both(lambda hd, p, h: TQ.lm_head_apply(
        hd, p["embeddings"]["word_embeddings"], h, cfg), head, p, h)


def test_clip_image_embed_and_stage2_loss_card_vs_cpu(gen, no_tf32):
    """The CLIP target tower (ln_pre, no patch bias) and the stage-2 loss
    with both distill heads, on the card against the CPU, fp32 with TF32
    off: 1e-4 relative."""
    import dataclasses
    from seed_tpu_torch.models import seed_tokenizer as TST
    from seed_tpu_torch.models import vit as TV
    from seed_tpu_torch.train import tokenizer_training as TTT
    vit = TV.ViTConfig(image_size=224, patch_size=14, dim=176, depth=2,
                       heads=2, mlp_dim=256)
    clip_cfg = dataclasses.replace(vit, qkv_bias="full", ln_pre=True,
                                   patch_bias=False)
    clip = {"vit": TV.init_vit(gen, clip_cfg),
            "head": TV.init_clip_vision_projection(gen, clip_cfg, 64)}
    imgs = torch.randn((4, 224, 224, 3), generator=gen, device="cuda")
    got = TV.clip_image_embed(clip["vit"], clip["head"], imgs, clip_cfg)
    want = TV.clip_image_embed(_to(clip["vit"], "cpu"), _to(clip["head"], "cpu"),
                               imgs.cpu(), clip_cfg)
    assert ((got.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4
    for reverse in (True, False):
        tcfg = dataclasses.replace(
            TST.TINY_TOKENIZER, vit=vit, image_embed_dim=64,
            qformer=dataclasses.replace(TST.TINY_TOKENIZER.qformer,
                                        encoder_width=176),
            with_recon_blocks=True, use_qformer_image=reverse)
        cfg = TTT.Stage2Config(tokenizer=tcfg)
        p = TST.init_seed_tokenizer(gen, tcfg)
        batch = {"images": imgs, "clip_embeds": got}
        loss, m = TTT.stage2_loss(p, batch, None, cfg)
        loss_c, m_c = TTT.stage2_loss(_to(p, "cpu"), _to(batch, "cpu"), None,
                                      cfg)
        for k in ("vq", "recon", "distill", "codebook_usage"):
            assert abs(m[k].item() - m_c[k].item()) <= 1e-4 * max(
                1.0, abs(m_c[k].item())), k
        assert abs(loss.item() - loss_c.item()) <= 1e-4 * abs(loss_c.item())


def test_short_mha_fp32_at_the_stage1_shape(gen):
    """Row 1's fp32 instance on the tokenizer training path: B=16, S=257,
    H=16, D=88, the fast epilogue (the ones column), 2e-5 against its plain
    version, one launch."""
    B, S, H, D = 16, 257, 16, 88
    qkv = torch.randn(B, S, 3 * H * D, generator=gen, device="cuda")
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    before = short_mha.launches
    got = short_mha(q, k, v, D ** -0.5, False)
    assert short_mha.launches == before + 1
    want = short_mha_plain(q, k, v, D ** -0.5, False)
    assert (got - want).abs().max().item() <= 2e-5


# ------------------------- eval and the discrete vision model ----------------

def test_inception_fp32_card_vs_cpu(gen, no_tf32):
    """Inception-v3 pool3 and logits at 299 (the FID / IS network, cuDNN
    convolutions) on the card against the same call on the CPU, fp32 with
    TF32 off: 1e-3 of the largest |feature|."""
    from seed_tpu_torch.eval import inception as TI
    p = TI.init_inception(gen, with_fc=True)
    imgs = torch.rand((2, 256, 256, 3), generator=gen, device="cuda")
    pc = _to(p, "cpu")
    for fn, x in ((TI.inception_pool3, imgs), (TI.inception_logits,
                                               imgs * 2 - 1)):
        got = fn(p, x)
        want = fn(pc, x.cpu())
        assert got.isfinite().all()
        assert ((got.cpu() - want).abs().max()
                / want.abs().max()).item() <= 1e-3, fn.__name__
    for k in p:
        if p[k]["kernel"].dim() == 4:
            assert p[k]["kernel"].is_contiguous(
                memory_format=torch.channels_last), k


def test_dvm_step_on_the_card(gen):
    """One Trainer step of the discrete vision model on the card: a frozen
    tower (bf16) and head, fp32 trainable parts; the loss finite, the tower
    and head bit-identical after the step, every trainable leaf moved."""
    import dataclasses
    from seed_tpu_torch.models import discrete_vision as TDV
    from seed_tpu_torch.models import vit as TV
    from seed_tpu_torch.train import optim as TO
    from seed_tpu_torch.train.trainer import Trainer
    cfg = dataclasses.replace(TDV.TINY_DVM, hidden=128, proj_dim=64, heads=4,
                              mlp_dim=256, n_codes=512)
    tcfg = TV.ViTConfig(image_size=56, patch_size=14, dim=128, depth=2,
                        heads=4, mlp_dim=256, qkv_bias="full", ln_eps=1e-5,
                        ln_pre=True, patch_bias=False)
    params = {"dvm": TDV.init_dvm(gen, cfg),
              "tower": L.cast_tree(TV.init_vit(gen, tcfg), torch.bfloat16),
              "head": L.cast_tree(TV.init_clip_vision_projection(
                  gen, tcfg, cfg.proj_dim), torch.bfloat16)}
    frozen = {k: [t.clone() for t in _leaves(params[k])]
              for k in ("tower", "head")}
    tx = TO.masked_trainable(TO.adamw(lambda step: 1e-3), params, r"^dvm/")

    def loss_fn(p, batch, rng):
        total, m = TDV.dvm_loss(p["dvm"], p["tower"], p["head"],
                                batch["images"], cfg, tcfg)
        return total, {k: m[k] for k in ("loss_rec", "loss_quant",
                                         "loss_iti")}

    trainer = Trainer(loss_fn, params, tx)
    before = [t.clone() for t in _leaves(trainer.state.params["dvm"])]
    imgs = torch.randn((4, 56, 56, 3), generator=gen, device="cuda")
    m = trainer.step({"images": imgs.to(torch.bfloat16)})
    assert all(torch.isfinite(v).all() for v in m.values())
    for k in ("tower", "head"):
        assert all(torch.equal(a, b) for a, b in zip(
            frozen[k], _leaves(trainer.state.params[k]))), k
    moved = [not torch.equal(a, b) for a, b in zip(
        before, _leaves(trainer.state.params["dvm"]))]
    assert sum(moved) >= len(moved) - 1    # the codebook rows no id picked


def test_caption_generators_card_cached_vs_recompute(gen):
    """The Q-Former caption generators at full width (12 layers, BERT
    vocabulary, 32 queries) on the card: cached and recompute give the same
    tokens, fp32."""
    import dataclasses
    from seed_tpu_torch.models import qformer as TQ
    cfg = dataclasses.replace(TQ.SEED_QFORMER, with_text=True)
    p = TQ.init_qformer(gen, cfg)
    head = TQ.init_lm_head(gen, cfg)
    feats = torch.randn((4, 257, cfg.encoder_width), generator=gen,
                        device="cuda")
    a = TQ.qformer_generate_caption(p, head, feats, cfg, 101, 102, 12)
    b = TQ.qformer_generate_caption_cached(p, head, feats, cfg, 101, 102, 12)
    assert a.shape == (4, 12) and (a[:, 0] == 101).all()
    assert torch.equal(a, b)


@pytest.fixture
def nccl_mesh(gen, tmp_path):
    """A one-rank NCCL process group (FileStore under tmp_path) and its
    (1, 1, 1, 1) mesh; the group is destroyed after the test."""
    import datetime
    import torch.distributed as dist
    from seed_tpu_torch import parallel as TP
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120))
    try:
        yield TP.make_mesh(1, 1, 1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_trainer_step_equals_the_plain_step(gen, nccl_mesh):
    """A LLaMA of 2 layers, 4 heads of 64, S=256 (so causal attention takes
    the flash kernels) in bf16: one mesh Trainer step (DTensor state by
    LLAMA_TP_RULES) against the same step without a mesh: the flash kernels
    launch as many times, loss and grad_norm equal, parameters equal."""
    from seed_tpu_torch import parallel as TP
    from seed_tpu_torch.models import llama as TM
    from seed_tpu_torch.parallel.partition import full_tree
    from seed_tpu_torch.train import optim as TO
    from seed_tpu_torch.train.losses import next_token_loss
    from seed_tpu_torch.train.trainer import Trainer
    cfg = TM.LlamaConfig(vocab_size=512, dim=256, layers=2, heads=4,
                         kv_heads=4, ffn_dim=512, max_seq_len=256)
    params = TM.init_llama(gen, cfg, torch.bfloat16, "cuda")
    ids = torch.randint(3, 500, (2, 256), generator=gen, device="cuda")

    def loss_fn(p, batch, rng):
        logits = TM.forward(p, batch["ids"], cfg, use_flash=True)
        return next_token_loss(logits, batch["ids"])

    def run(mesh):
        tr = Trainer(loss_fn, params, TO.adamw(lambda s: 1e-3),
                     device="cuda", mesh=mesh, rules=TP.LLAMA_TP_RULES)
        before = TF.flash_fwd.launches
        m = tr.step({"ids": ids})
        return (TF.flash_fwd.launches - before, {k: float(v) for k, v in
                                                 m.items()},
                full_tree(tr.state.params))

    n0, m0, p0 = run(None)
    n1, m1, p1 = run(nccl_mesh)
    assert n1 == n0 == cfg.layers
    assert m1["loss"] == pytest.approx(m0["loss"], rel=1e-3)
    assert m1["grad_norm"] == pytest.approx(m0["grad_norm"], rel=1e-2)
    for a, b in zip(_leaves(p0), _leaves(p1)):
        assert (a.float() - b.float()).abs().max().item() <= 2e-3


def test_ring_attention_on_the_card(gen, nccl_mesh):
    """ring_attention over the one-rank 'data' axis on cuda bf16 tensors at
    the 8B layer's shape against mha (1/64 of the output's scale), and its
    gradient against mha's (fp32, 1e-4)."""
    from seed_tpu_torch import parallel as TP
    from seed_tpu_torch.ops.attention import sliced_causal_mask
    B, S, H, D = 1, 1024, 32, 128
    q, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda")
               for _ in range(3))
    mask = sliced_causal_mask(S, S, 0, "cuda")
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    got = TP.sequence_parallel_attention(qb, kb, vb, nccl_mesh, axis="data")
    want = mha(qb, kb, vb, mask=mask).float()
    assert got.dtype == torch.bfloat16 and got.is_cuda
    assert (got.float() - want).abs().max().item() <= want.abs().max().item() / 64
    q, k, v = (t[:, :256, :4].clone().requires_grad_() for t in (q, k, v))
    TP.sequence_parallel_attention(q, k, v, nccl_mesh, axis="data").sum().backward()
    g = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    mha(q, k, v, mask=sliced_causal_mask(256, 256, 0, "cuda")).sum().backward()
    for a, t in zip(g, (q, k, v)):
        assert (a - t.grad).abs().max().item() <= 1e-4
