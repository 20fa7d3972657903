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


@pytest.mark.parametrize("dtype,D,tile", [(torch.bfloat16, 128, 64),
                                          (torch.bfloat16, 160, 32),
                                          (torch.float32, 128, 32),
                                          (torch.float32, 256, 16)])
def test_plain_versions_walk_the_kernels_tiles(dtype, D, tile):
    assert TF.kv_tile(dtype, D) == tile


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
