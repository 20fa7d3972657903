"""The tiled flash attention of seed_tpu_torch against seed_tpu, on the CPU.

seed_tpu's Pallas kernels (_flash_kernel, _flash_bwd_dq_kernel,
_flash_bwd_dkv_kernel) run in interpret mode, as tests/test_flash_attention.py
runs them; the port runs the plain versions of its three CUDA kernels, which
repeat the kernels' arithmetic tile by tile. Inputs come from numpy seeds and
reach both sides as the same numbers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import llama as JM
from seed_tpu.ops import flash_attention as JF
from seed_tpu.train import next_token_loss as j_next_token_loss
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.ops import flash_attention as TF
from seed_tpu_torch.ops.attention import mha
from seed_tpu_torch.train import next_token_loss as t_next_token_loss

# (name, Sq, Sk, H, D, causal, q_offset)
CASES = [
    ("causal", 256, 256, 2, 128, True, 0),
    ("ragged_causal", 300, 300, 2, 64, True, 0),
    ("noncausal_kv_mask", 257, 257, 2, 88, False, 0),
    ("q_offset", 256, 512, 2, 128, True, 256),
]
IDS = [c[0] for c in CASES]


def randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def qkv(Sq, Sk, H, D, B=1, h_kv=None):
    h_kv = h_kv or H
    return (randn((B, Sq, H, D), 0), randn((B, Sk, h_kv, D), 1),
            randn((B, Sk, h_kv, D), 2))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def as_jax(arrays, dtype=jnp.float32):
    return tuple(jnp.asarray(a, dtype) for a in arrays)


def as_torch(arrays, dtype=torch.float32):
    return tuple(torch.from_numpy(a).to(dtype) for a in arrays)


@pytest.mark.parametrize("name,Sq,Sk,H,D,causal,off", CASES, ids=IDS)
def test_forward_fp32_matches_pallas(name, Sq, Sk, H, D, causal, off):
    """O within 2e-4 (the bound seed_tpu's own flash tests use; only the
    order of fp32 sums and rescalings differs: 64/32-row tiles against 512),
    and the per-row lse the backward consumes within 1e-5."""
    arrays = qkv(Sq, Sk, H, D)
    want, want_lse = JF._flash_impl(*as_jax(arrays), causal, D ** -0.5, off,
                                    JF.BLOCK_Q, JF.BLOCK_K)
    got, lse = TF.flash_fwd(*as_torch(arrays), causal, D ** -0.5, off)
    assert got.shape == (1, Sq, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(f32(lse), f32(want_lse)[:, :, :Sq, 0],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,Sq,Sk,H,D,causal,off", CASES, ids=IDS)
def test_forward_bf16_within_output_ulps(name, Sq, Sk, H, D, causal, off):
    """bf16 io: both sides round p to bf16 before P@V, but against different
    running maxima (the tiles differ), and round the output once. The two
    outputs sit within one bf16 ulp of the larger magnitude (2**-7 relative)
    plus half an ulp at |o| ~ 1 (2**-8 absolute)."""
    arrays = qkv(Sq, Sk, H, D)
    want = JF._flash(*as_jax(arrays, jnp.bfloat16), causal, D ** -0.5, off)
    got, _ = TF.flash_fwd(*as_torch(arrays, torch.bfloat16), causal,
                          D ** -0.5, off)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), atol=2.0 ** -8,
                               rtol=2.0 ** -7)


def test_forward_gqa_through_the_dispatcher():
    """4 query heads over 2 kv heads: kv heads are repeated before the
    kernel, as seed_tpu does."""
    arrays = qkv(256, 256, 4, 64, h_kv=2)
    want = JF.flash_attention(*as_jax(arrays), causal=True)
    got = TF.flash_attention(*as_torch(arrays), causal=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-4, rtol=2e-4)


def test_q_tile_that_meets_no_kv_tile_gives_zero_output_and_zero_lse():
    """A causal chunk placed wholly before the keys (q_offset = -512, one
    whole seed_tpu q tile): every q tile's loop is empty, so l stays 0 and
    both sides write O = 0, lse = 0 rather than dividing by zero."""
    arrays = qkv(256, 256, 2, 64)
    want, want_lse = JF._flash_impl(*as_jax(arrays), True, 0.125, -512,
                                    JF.BLOCK_Q, JF.BLOCK_K)
    got, lse = TF.flash_fwd(*as_torch(arrays), True, 0.125, -512)
    assert not f32(want).any() and not f32(want_lse)[:, :, :256].any()
    assert not got.any() and not lse.any()


@pytest.mark.parametrize("name,Sq,Sk,H,D,causal,off", CASES, ids=IDS)
def test_gradients_match_pallas_backward(name, Sq, Sk, H, D, causal, off):
    """dq, dk, dv of sum(O**2) from the port's autograd function against
    jax.grad through seed_tpu's _flash, at 3e-3 (TestFlashBackward's bound).
    The q_offset case takes the mha recompute on both sides."""
    arrays = qkv(Sq, Sk, H, D)

    def loss(q, k, v):
        return jnp.sum(JF._flash(q, k, v, causal, D ** -0.5, off) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*as_jax(arrays))
    leaves = [t.requires_grad_() for t in as_torch(arrays)]
    (TF.tiled_flash(*leaves, causal, D ** -0.5, off) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(f32(t.grad), f32(w), atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("exact", [True, False])
def test_short_mha_gradients_match_pallas_custom_vjp(exact):
    """dq, dk, dv of sum(O**2) through the port's short_mha (its autograd
    function: the plain forward on the CPU, the mha recompute backward)
    against jax.grad through seed_tpu's _short_mha custom_vjp (the Pallas
    kernel in interpret mode, the mha backward), at the ViT's S=257, D=88,
    fp32, within 3e-3 (seed_tpu's own bound). The output carries the
    function's grad_fn."""
    B, S, H, D = 1, 257, 2, 88
    arrays = qkv(S, S, H, D, B)

    def loss(q, k, v):
        return jnp.sum(JF._short_mha(q, k, v, D ** -0.5, exact) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*as_jax(arrays))
    leaves = [t.requires_grad_() for t in as_torch(arrays)]
    out = TF.short_mha(*leaves, D ** -0.5, exact)
    assert type(out.grad_fn).__name__ == "_ShortMHABackward"
    (out ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(f32(t.grad), f32(w), atol=3e-3, rtol=3e-3)


def test_flash_attention_short_route_is_differentiable():
    """flash_attention's short non-causal route (S=257) gives q, k and v the
    gradient of the plain mha path, and counts no launch on the CPU."""
    arrays = qkv(257, 257, 2, 88)
    before = TF.short_mha.launches
    leaves = [t.requires_grad_() for t in as_torch(arrays)]
    TF.flash_attention(*leaves).sum().backward()
    refs = [t.detach().clone().requires_grad_() for t in leaves]
    mha(*refs).sum().backward()
    assert TF.short_mha.launches == before
    for t, r in zip(leaves, refs):
        np.testing.assert_allclose(f32(t.grad), f32(r.grad), atol=1e-5, rtol=1e-5)


# (device, dtype, Sq, Sk, H, h_kv, D, takes the kernel): the encode's call
# (B=256, S=257, 16 heads of 88), the CLIP towers' D = 64 and 80, a longer
# sequence the short kernel still takes; fp32, the CPU, TINY_VIT's 5 tokens,
# 1025 tokens (past the short kernel), 2048 (its VMEM estimate) and fewer kv
# heads than q heads stay on mha
ROUTE_CASES = [
    ("cuda", torch.bfloat16, 257, 257, 16, 16, 88, True),
    ("cuda", torch.bfloat16, 257, 257, 16, 16, 64, True),
    ("cuda", torch.bfloat16, 257, 257, 16, 16, 80, True),
    ("cuda", torch.bfloat16, 512, 512, 2, 2, 88, True),
    ("cuda", torch.float32, 257, 257, 16, 16, 88, False),
    ("cpu", torch.bfloat16, 257, 257, 16, 16, 88, False),
    ("cuda", torch.bfloat16, 5, 5, 2, 2, 16, False),
    ("cuda", torch.bfloat16, 1025, 1025, 2, 2, 88, False),
    ("cuda", torch.bfloat16, 257, 2048, 2, 2, 88, False),
    ("cuda", torch.bfloat16, 257, 257, 16, 8, 88, False),
]


@pytest.mark.parametrize("device,dtype,Sq,Sk,H,h_kv,D,takes", ROUTE_CASES)
def test_short_exact_route_decides_from_the_input(device, dtype, Sq, Sk, H,
                                                  h_kv, D, takes):
    """exact_attention's choice reads only the input's device, dtype and
    shape (stand-ins here: no card is needed to decide)."""
    from types import SimpleNamespace
    dev = torch.device(device)
    q = SimpleNamespace(shape=(256, Sq, H, D), dtype=dtype, device=dev)
    k = SimpleNamespace(shape=(256, Sk, h_kv, D), dtype=dtype, device=dev)
    assert TF.short_exact_route(q, k) is takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_block_attention_on_the_cpu_is_mha(monkeypatch, dtype):
    """On the CPU the ViT block's default attention is mha itself, bit for
    bit, and reaches no short_mha; with the route forced open, the kernel's
    exact epilogue (its plain version here) gives mha's numbers: fp32 within
    1e-6 (the softmax's division against p / l), bf16 within 2**-6 (one
    rounding of p or of the output a bf16 ulp apart)."""
    from seed_tpu_torch.models import vit as TV
    arrays = qkv(257, 257, 2, 88, B=2)
    q, k, v = as_torch(arrays, dtype)
    calls = []
    plain = TF.short_mha_plain
    monkeypatch.setattr(TF, "short_mha", lambda *a, exact:
                        calls.append(exact) or plain(*a, exact))
    assert torch.equal(TF.exact_attention(q, k, v), mha(q, k, v)) and not calls
    gen = torch.Generator().manual_seed(0)
    params = TV.init_vit(gen, TV.TINY_VIT, dtype=dtype, device="cpu")
    x = torch.randn(2, 5, TV.TINY_VIT.dim, generator=gen).to(dtype)
    TV.block_apply(params["blocks"][0], x, TV.TINY_VIT)
    assert not calls
    monkeypatch.setattr(TF, "short_exact_route", lambda q, k: True)
    got = TF.exact_attention(q, k, v)
    assert calls == [True]
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -6
    assert (got.float() - mha(q, k, v).float()).abs().max().item() <= tol


# (device, dtype, Sq, Sk, H, h_kv, D, takes the kernel): the UNet's
# self-attention at levels 0-2 (9,216 x 5, 2,304 x 10, 576 x 20 heads of
# 64; 9,216 keys is past seed_tpu's MAX_KERNEL_KV), both lengths at
# MIN_FLASH_SEQ, D = 256; its cross-attention (77 keys), the mid block's
# 144 tokens, fp32, the CPU, fewer kv heads than q heads, D above 256 (the
# VAE's one head of 512) and one length below MIN_FLASH_SEQ stay on mha
TILED_ROUTE_CASES = [
    ("cuda", torch.bfloat16, 9216, 9216, 5, 5, 64, True),
    ("cuda", torch.bfloat16, 2304, 2304, 10, 10, 64, True),
    ("cuda", torch.bfloat16, 576, 576, 20, 20, 64, True),
    ("cuda", torch.bfloat16, 256, 256, 2, 2, 64, True),
    ("cuda", torch.bfloat16, 300, 300, 2, 2, 256, True),
    ("cuda", torch.bfloat16, 9216, 77, 5, 5, 64, False),
    ("cuda", torch.bfloat16, 144, 144, 20, 20, 64, False),
    ("cuda", torch.float32, 9216, 9216, 5, 5, 64, False),
    ("cpu", torch.bfloat16, 9216, 9216, 5, 5, 64, False),
    ("cuda", torch.bfloat16, 2304, 2304, 10, 5, 64, False),
    ("cuda", torch.bfloat16, 9216, 9216, 1, 1, 512, False),
    ("cuda", torch.bfloat16, 255, 2304, 10, 10, 64, False),
]


@pytest.mark.parametrize("device,dtype,Sq,Sk,H,h_kv,D,takes",
                         TILED_ROUTE_CASES)
def test_tiled_route_decides_from_the_input(device, dtype, Sq, Sk, H, h_kv,
                                            D, takes):
    """unmasked_attention's choice reads only the input's device, dtype and
    shape (stand-ins here: no card is needed to decide)."""
    from types import SimpleNamespace
    dev = torch.device(device)
    q = SimpleNamespace(shape=(2, Sq, H, D), dtype=dtype, device=dev)
    k = SimpleNamespace(shape=(2, Sk, h_kv, D), dtype=dtype, device=dev)
    assert TF.tiled_route(q, k) is takes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_forward_plain_at_a_ragged_unet_shape_matches_mha(dtype):
    """The forward kernel's function, non-causal at B=2, S=300 (no multiple
    of the 64-row tiles: the last kv tile is masked), 5 heads of 64, against
    mha. fp32 within 2e-6: only the order of fp32 sums, the online
    rescaling and 1 / l against the softmax's division differ (|o| < 1).
    bf16 within 2**-7: |o| < 1, so a bf16 ulp is at most 2**-8, and the two
    roundings of each side (p before P@V, normalised in mha and not here;
    the output) may each land one ulp apart."""
    q, k, v = as_torch(qkv(300, 300, 5, 64, B=2), dtype)
    got, _ = TF.flash_fwd_plain(q, k, v, False, 64 ** -0.5)
    want = mha(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    assert want.float().abs().max().item() < 1
    tol = 2e-6 if dtype == torch.float32 else 2.0 ** -7
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_gradients_gqa_sum_over_repeated_heads():
    arrays = qkv(256, 256, 4, 64, h_kv=2)

    def loss(q, k, v):
        return jnp.sum(JF.flash_attention(q, k, v, causal=True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(*as_jax(arrays))
    leaves = [t.requires_grad_() for t in as_torch(arrays)]
    (TF.flash_attention(*leaves, causal=True) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(f32(t.grad), f32(w), atol=3e-3, rtol=3e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plain_versions_agree_with_autograd_of_the_forward(dtype):
    """The dq and dk/dv plain versions are the analytic gradient of the
    forward plain version: fp32 to 1e-4; bf16 (p and ds rounded before their
    products) to 2**-5 of the largest gradient."""
    arrays = qkv(300, 300, 2, 64)
    q, k, v = as_torch(arrays, dtype)
    dout = torch.from_numpy(randn(q.shape, 3)).to(dtype)
    out, lse = TF.flash_fwd_plain(q, k, v, True, 0.125)
    delta = (dout.float() * out.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = TF.flash_bwd_dq(q, k, v, dout, lse, delta, True, 0.125)
    dk, dv = TF.flash_bwd_dkv(q, k, v, dout, lse, delta, True, 0.125)
    ref = [t.float().requires_grad_() for t in (q, k, v)]
    TF.flash_fwd_plain(*ref, True, 0.125)[0].backward(dout.float())
    for got, r in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.is_contiguous()
        err = (got.float() - r.grad).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -5 * r.grad.abs().max().item()
        assert err <= tol


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    counts = [f.launches for f in (TF.flash_fwd, TF.flash_bwd_dq,
                                   TF.flash_bwd_dkv)]
    leaves = [t.requires_grad_() for t in as_torch(qkv(256, 256, 1, 32))]
    TF.tiled_flash(*leaves, True, 1.0).sum().backward()
    assert [f.launches for f in (TF.flash_fwd, TF.flash_bwd_dq,
                                 TF.flash_bwd_dkv)] == counts


@pytest.mark.parametrize(
    "dtype,D,fwd,bwd",
    [(torch.bfloat16, 128, (64, 64), ((64, 64), (64, 32))),
     (torch.bfloat16, 160, (64, 32), ((64, 32), (64, 32))),
     (torch.float32, 128, (64, 32), ((64, 16), (64, 16))),
     (torch.float32, 256, (64, 32), ((64, 16), (64, 16))),
     (torch.bfloat16, 64, (64, 64), ((64, 64), (64, 64))),
     (torch.float32, 36, (64, 32), ((64, 16), (64, 16))),
     (torch.float32, 144, (64, 32), ((64, 16), (64, 16)))],
    ids=["dtype0-128-fwd0-64", "dtype1-160-fwd1-32", "dtype2-128-fwd2-32",
         "dtype3-256-fwd3-16", "bf16-64", "fp32-36", "fp32-144"])
def test_plain_versions_walk_the_kernels_tiles(dtype, D, fwd, bwd):
    """The forward's (q tile, kv tile) and the backward's ((dq q rows, kv
    tile), (dk/dv kv rows, q tile)): bf16 blocks own 64 rows; the forward
    and dq halve their kv tile above D = 128, dk/dv streams 32-row q tiles
    above D = 64. fp32, at every D: the forward's 64 q rows over 32-row kv
    tiles, dq's 64 q rows over 16-row kv tiles, dk/dv's 64 kv rows over
    16-row q tiles."""
    assert TF.fwd_tiles(dtype, D) == fwd
    assert TF.bwd_tiles(dtype, D) == bwd


def test_flash_lib_raises_when_the_kernels_tiles_differ(monkeypatch):
    """_flash_lib reads the six tile sizes the library was built with
    (seed_flash_tile) and refuses a library whose tiles the plain versions
    do not walk: here one whose dk/dv q tile is 64 rows at D = 128."""
    fwd, (dq, dkv) = (TF.fwd_tiles(torch.bfloat16, 128),
                      TF.bwd_tiles(torch.bfloat16, 128))

    class Library:
        def __init__(self, rows):
            self.rows = rows

        def seed_flash_tile(self, dtype, head_dim, which):
            return self.rows[which]

    rows = [*fwd, *dq, *dkv]
    monkeypatch.setattr(TF.kernels, "load", lambda name, sig: Library(rows))
    assert TF._flash_lib(torch.bfloat16, 128).rows == rows
    monkeypatch.setattr(TF.kernels, "load",
                        lambda name, sig: Library(rows[:5] + [64]))
    with pytest.raises(RuntimeError, match="no longer mirror"):
        TF._flash_lib(torch.bfloat16, 128)


# (name, Sq, Sk, D, causal, q_offset): Sq not a multiple of the forward's
# 64-row q tile, D=88 (padded to 96 by the bf16 kernel); S=111 splits into
# 32-row fp32 kv tiles 32 + 32 + 32 + 15 under 64-row q tiles 64 + 47, D=36
# (padded to 48 by the fp32 kernels, 64 by the bf16 ones)
RETILED = [("ragged_causal_d88", 200, 200, 88, True, 0),
           ("offset_ragged_d88", 100, 356, 88, True, 256),
           ("uneven_kv_tiles_d36", 111, 111, 36, True, 0)]


def _pallas_fwd_bhsd(arrays, causal, scale, off, dtype, block=128):
    """seed_tpu's _flash_fwd_bhsd in interpret mode on [B, H, S, D] inputs
    padded to its tiles (rows) and to 128 lanes (D), as _flash_impl pads
    them -> (o [B, Sq, H, D], lse [B, H, Sq])."""
    q, k, v = (jnp.asarray(a, dtype).transpose(0, 2, 1, 3) for a in arrays)
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    pad = lambda t, n: jnp.pad(t, ((0, 0), (0, 0), (0, -(-n // block) * block - n),
                                   (0, 128 - D)))
    o, lse = JF._flash_fwd_bhsd(pad(q, Sq), pad(k, Sk), pad(v, Sk), causal,
                                scale, off, Sk, block, block)
    return o[:, :, :Sq, :D].transpose(0, 2, 1, 3), lse[:, :, :Sq, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,Sq,Sk,D,causal,off", RETILED,
                         ids=[c[0] for c in RETILED])
def test_retiled_forward_plain_matches_pallas_kernel(name, Sq, Sk, D, causal,
                                                     off, dtype):
    """flash_fwd_plain on the forward's own tiles (bf16: 64 q rows, 64-row kv
    tiles, base-2 scores) against the Pallas _flash_fwd_bhsd. fp32: 2e-4 on
    O, 1e-5 on lse (sum and rescale order only); bf16: within output ulps
    (2**-7 relative plus 2**-8 absolute) and lse within 1e-4 (p rounded at
    other running maxima)."""
    arrays = qkv(Sq, Sk, 2, D, B=2)
    want, want_lse = _pallas_fwd_bhsd(arrays, causal, D ** -0.5, off,
                                      getattr(jnp, dtype))
    got, lse = TF.flash_fwd_plain(*as_torch(arrays, getattr(torch, dtype)),
                                  causal, D ** -0.5, off)
    assert got.shape == (2, Sq, 2, D) and lse.shape == (2, 2, Sq)
    if dtype == "float32":
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(f32(lse), f32(want_lse), atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(f32(got), f32(want), atol=2.0 ** -8,
                                   rtol=2.0 ** -7)
        np.testing.assert_allclose(f32(lse), f32(want_lse), atol=1e-4, rtol=1e-5)


# (name, S, D, causal): S = 200 is a multiple of neither backward tile (64,
# 32), D = 88 pads to 96 (dk/dv's 32-row q tiles); D = 64 takes 64-row q tiles;
# S = 111 gives the fp32 dk/dv kernel's 64-row kv blocks 64 + 47 over q tiles
# of 16 (six whole and 15 rows)
RETILED_BWD = [("ragged_causal_d88", 200, 88, True),
               ("ragged_noncausal_d64", 150, 64, False),
               ("uneven_q_tiles_d36", 111, 36, True)]


def _pallas_bwd_bhsd(arrays, dout, lse, delta, causal, scale, dtype,
                     block=128):
    """seed_tpu's _flash_bwd_bhsd in interpret mode on [B, H, S, D] inputs
    padded to its square tiles (rows) and to 128 lanes (D), as
    _flash_bwd_rule pads them -> (dq, dk, dv) as [B, S, H, D]."""
    q, k, v, g = (jnp.asarray(a, dtype).transpose(0, 2, 1, 3)
                  for a in (*arrays, dout))
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    rows = lambda n: -(-n // block) * block - n
    pad = lambda t, n: jnp.pad(t, ((0, 0), (0, 0), (0, rows(n)), (0, 128 - D)))
    vec = lambda x: jnp.pad(jnp.asarray(x, jnp.float32),
                            ((0, 0), (0, 0), (0, rows(Sq))))[..., None]
    grads = JF._flash_bwd_bhsd(pad(q, Sq), pad(k, Sk), pad(v, Sk), pad(g, Sq),
                               vec(lse), vec(delta), causal, scale, Sk, block,
                               block)
    return [t[:, :, :n, :D].transpose(0, 2, 1, 3)
            for t, n in zip(grads, (Sq, Sk, Sk))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,S,D,causal", RETILED_BWD,
                         ids=[c[0] for c in RETILED_BWD])
def test_retiled_backward_plain_matches_pallas_kernels(name, S, D, causal,
                                                        dtype):
    """flash_bwd_dq_plain and flash_bwd_dkv_plain on the backward kernels'
    own tiles (bf16: 64-row dq blocks over 64-row kv tiles, 64-row dk/dv
    blocks over 32- or 64-row q tiles, base-2 scores) against the Pallas
    _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (128-row square tiles,
    base e), on the same lse and delta. fp32: 1e-4 (sum order only); bf16:
    2**-5 of the largest gradient (p and ds rounded to bf16 from scores in
    another base and order, one ulp apart)."""
    arrays = qkv(S, S, 2, D, B=2)
    dout = randn((2, S, 2, D), 3)
    scale = D ** -0.5
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o, lse = _pallas_fwd_bhsd(arrays, causal, scale, 0, jdt)
    delta = np.einsum("bshd,bshd->bhs", f32(jnp.asarray(dout, jdt)), f32(o))
    want = _pallas_bwd_bhsd(arrays, dout, f32(lse), delta, causal, scale, jdt)
    q, k, v, g = as_torch((*arrays, dout), tdt)
    args = (q, k, v, g, torch.from_numpy(f32(lse)).contiguous(),
            torch.from_numpy(delta).contiguous(), causal, scale)
    got = [TF.flash_bwd_dq_plain(*args), *TF.flash_bwd_dkv_plain(*args)]
    for label, t, w in zip(("dq", "dk", "dv"), got, want):
        assert t.shape == (2, S, 2, D) and t.dtype == tdt, label
        err = np.abs(f32(t) - f32(w)).max()
        tol = 1e-4 if dtype == "float32" else 2.0 ** -5 * np.abs(f32(w)).max()
        assert err <= tol, (label, err, tol)


# ------------------------------------- split TF32 (the fp32 kernels' products)

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in integer ops on the fp32 pattern: adding half
    of the lowest kept bit (0x1000) to the magnitude rounds the low 13
    mantissa bits to nearest with ties away from zero (the sign bit is
    untouched, so negative values round the same way), then they are
    cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x: torch.Tensor):
    """``sm90::split_tf32``: hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def test_split_tf32_mirror_holds_its_error_bounds():
    """The fp32 flash kernels take every fp32 product as
    a_lo b_hi + a_hi b_lo + a_hi b_hi (csrc/mma_sm90.cuh). Here a mirror of
    the split in integer ops: ties round away from zero; hi and lo are tf32
    values (low 13 bits zero); hi + lo holds x within 2**-22 of |x|. On
    seeded D = 128 rows the three-term product (summed exactly, in float64)
    is within 3 * 2**-22 of sum |q_i k_i| of the exact product of the same
    fp32 inputs, and the scores (times D**-0.5) within 2e-6 of theirs: the
    margin under FLASH_FWD_TOL (2e-5 on outputs, chip_smoke.py), which the
    split leaves unchanged. Then int8_mm_f32's two-product form against an
    int8 weight, which needs no split."""
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23],
                       dtype=torch.float32)
    assert _tf32_rna(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]

    r = np.random.RandomState(13)
    q = torch.from_numpy(r.randn(512, 128).astype(np.float32))
    k = torch.from_numpy(r.randn(512, 128).astype(np.float32))
    for x in (q, k):
        hi, lo = _split_tf32(x)
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 0x1FFF).any()
        err = (x.double() - hi.double() - lo.double()).abs()
        assert (err <= 2.0 ** -22 * x.double().abs()).all()
    (qh, ql), (kh, kl) = _split_tf32(q), _split_tf32(k)
    d = lambda t: t.double()
    three = d(ql) @ d(kh).T + d(qh) @ d(kl).T + d(qh) @ d(kh).T
    exact = d(q) @ d(k).T
    err = (three - exact).abs()
    assert (err <= 3 * 2.0 ** -22 * (d(q).abs() @ d(k).abs().T)).all()
    assert err.max().item() * 128 ** -0.5 <= 2e-6

    # the exact-B form of int8_mm_f32 (sm90::mma_2xtf32_exact_b): every
    # int8 value is its own tf32 rounding, so its lo part is zero, and
    # x_hi w + x_lo w is within 2**-22 of |x w| a product; over K = 4096 the
    # two-product sum is within 2**-22 of sum |x_i w_i| of the exact one
    w8 = torch.arange(-128, 128, dtype=torch.float32)
    hi, lo = _split_tf32(w8)
    assert torch.equal(hi, w8) and not lo.any()
    x = torch.from_numpy(r.randn(64, 4096).astype(np.float32))
    w = torch.from_numpy(r.randint(-127, 128, (4096, 32)).astype(np.float32))
    xh, xl = _split_tf32(x)
    two = d(xl) @ d(w) + d(xh) @ d(w)
    exact = d(x) @ d(w)
    assert ((d(xh) + d(xl) - d(x)).abs() <= 2.0 ** -22 * d(x).abs()).all()
    assert ((two - exact).abs() <= 2.0 ** -22 * (d(x).abs() @ d(w).abs())).all()


# ------------------------------------------------ the slice: LLaMA training

LLAMA = dict(vocab_size=300, dim=64, layers=2, heads=2, kv_heads=2,
             ffn_dim=128, max_seq_len=512)


@pytest.fixture(scope="module")
def llama():
    jcfg, tcfg = JM.LlamaConfig(**LLAMA), TM.LlamaConfig(**LLAMA)
    jp = JM.init_llama(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = bridge.from_seed_tpu(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_llama_forward_use_flash_remat_logits_match(llama):
    """Logits of forward(use_flash=True, remat=True) on TestFlashInLlama's
    2-layer dim-64 config at S=256, weights carried with the bridge: 1e-4
    (fp32 sum order through two layers)."""
    jcfg, tcfg, jp, tp = llama
    ids = np.random.RandomState(0).randint(3, 280, size=(2, 256))
    want = f32(JM.forward(jp, jnp.asarray(ids, jnp.int32), jcfg,
                          use_flash=True, remat=True))
    got = f32(TM.forward(tp, torch.from_numpy(ids), tcfg, use_flash=True,
                         remat=True))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    plain = f32(TM.forward(tp, torch.from_numpy(ids), tcfg))
    np.testing.assert_allclose(got, plain, atol=3e-3, rtol=3e-3)


def test_llama_parameter_gradients_match(llama):
    """d next_token_loss / d params through the flash backward and the
    per-layer recompute, every leaf against jax.grad: 1e-5 absolute plus
    1e-3 of the leaf's largest gradient."""
    jcfg, tcfg, jp, tp = llama
    ids = np.random.RandomState(1).randint(3, 280, size=(1, 256))
    jids = jnp.asarray(ids, jnp.int32)

    def jloss(p):
        return j_next_token_loss(
            JM.forward(p, jids, jcfg, use_flash=True, remat=True), jids)

    want = jax.tree.map(np.asarray, jax.grad(jloss)(jp))
    from seed_tpu_torch.utils.tree import leaves_with_path, tree_map
    live = tree_map(lambda t: t.clone().requires_grad_(), tp)
    tids = torch.from_numpy(ids)
    t_next_token_loss(TM.forward(live, tids, tcfg, use_flash=True, remat=True),
                      tids).backward()
    got = dict(leaves_with_path(tree_map(lambda t: t.grad, live)))
    checked = 0
    for name, g in got.items():
        parts = name.split("/")
        if parts[0] == "layers":
            w = want["layers"]
            for key in parts[2:]:
                w = w[key]
            w = w[int(parts[1])]
        else:
            w = want
            for key in parts:
                w = w[key]
        assert g is not None, name
        tol = 1e-5 + 1e-3 * np.abs(w).max()
        assert np.abs(f32(g) - w).max() <= tol, name
        checked += 1
    assert checked == 2 * 9 + 3


def test_logits_padding_mask_is_safe_under_autograd(llama):
    """In fp32 the lm_head's output is the tensor whose padding columns are
    masked; the mask must not write into the autograd graph, and the padded
    columns must carry no gradient."""
    _, tcfg, _, tp = llama
    head = tp["lm_head"]["kernel"].clone().requires_grad_()
    params = dict(tp, lm_head={"kernel": head})
    ids = torch.from_numpy(np.random.RandomState(2).randint(3, 280, size=(1, 8)))
    logits = TM.forward(params, ids, tcfg)
    assert (logits[..., tcfg.vocab_size:] == -1e9).all()
    logits.sum().backward()
    assert head.grad[:, :tcfg.vocab_size].abs().sum() > 0
    assert not head.grad[:, tcfg.vocab_size:].any()
