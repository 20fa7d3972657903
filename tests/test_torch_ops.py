"""seed_tpu_torch ops against seed_tpu, on the CPU.

The plain versions of the two CUDA kernels are held against the Pallas
kernels they replace (interpret mode on the CPU, as tests/test_flash_attention
and tests/test_quant_conversation run them); layers, attention, quantization,
preprocessing and sampling against their seed_tpu counterparts. Inputs come
from numpy seeds and reach both sides as the same numbers.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import layers as JL
from seed_tpu.ops import attention as JA
from seed_tpu.ops import flash_attention as JF
from seed_tpu.ops import int8_matmul as JI
from seed_tpu.ops import quantization as JQ
from seed_tpu.ops import sampling as JS
from seed_tpu_torch import bridge
from seed_tpu_torch.models import layers as TL
from seed_tpu_torch.ops import attention as TA
from seed_tpu_torch.ops import flash_attention as TF
from seed_tpu_torch.ops import int8_matmul as TI
from seed_tpu_torch.ops import preprocess as TP
from seed_tpu_torch.ops import quantization as TQ
from seed_tpu_torch.ops import sampling as TS

# seed_tpu.ops re-exports a function named ``preprocess`` over its module
JP = importlib.import_module("seed_tpu.ops.preprocess")


def from_seed_tpu(tree):
    """seed_tpu weights (numpy leaves) as the port's tensors, on the CPU."""
    return bridge.from_seed_tpu(tree, device="cpu")


def randn(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def f32(x):
    """JAX or torch array -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def to_bf16(a):
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).bfloat16()


# ------------------------------------------------ kernel 1: short_mha

@pytest.mark.parametrize("exact,D", [(True, 88), (False, 88), (False, 128)])
def test_short_mha_plain_matches_pallas_fp32(exact, D):
    """All three epilogues at the ViT's S=257 (ragged) in fp32: only the
    order of fp32 sums differs, so atol 1e-5."""
    B, S, H = 2, 257, 2
    q, k, v = (randn((B, S, H, D), s) for s in (0, 1, 2))
    want = JF._short_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         D ** -0.5, exact)
    got = TF.short_mha_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), D ** -0.5, exact)
    assert got.shape == (B, S, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)


def test_short_mha_plain_bf16_exact_at_least_as_close_as_fast():
    """bf16: one bf16 ulp apart at most (atol 4e-3 at |o| < 1), and the exact
    epilogue agrees with the plain mha path at least as often as the fast
    one (test_flash_attention.py's bf16 check, applied to the port)."""
    B, S, H, D = 2, 65, 4, 24
    (jq, tq), (jk, tk), (jv, tv) = (to_bf16(randn((B, S, H, D), s))
                                    for s in (10, 11, 12))
    ref = f32(JA.mha(jq, jk, jv))
    for exact in (True, False):
        got = f32(TF.short_mha_plain(tq, tk, tv, D ** -0.5, exact))
        want = f32(JF._short_mha(jq, jk, jv, D ** -0.5, exact))
        np.testing.assert_allclose(got, want, atol=4e-3, rtol=1e-2)
    exact = f32(TF.short_mha_plain(tq, tk, tv, D ** -0.5, True))
    fast = f32(TF.short_mha_plain(tq, tk, tv, D ** -0.5, False))
    assert (exact == ref).mean() > 0.99
    assert (exact == ref).mean() >= (fast == ref).mean()


def test_short_mha_plain_reads_strided_views():
    """The ViT passes q/k/v as views of one fused qkv projection."""
    B, S, H, D = 2, 257, 2, 88
    qkv = torch.from_numpy(randn((B, S, 3 * H * D), 3))
    q, k, v = (x.reshape(B, S, H, D) for x in qkv.split(H * D, dim=-1))
    got = TF.short_mha(q, k, v, D ** -0.5, True)
    want = TF.short_mha_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                              D ** -0.5, True)
    assert torch.equal(got, want)


def test_flash_attention_routes_like_seed_tpu():
    """Same routing as seed_tpu: S=257 non-causal -> short kernel (plain
    version on the CPU, no launch counted); S < 256 -> mha; the tiled causal
    kernel is not ported and raises rather than taking another path."""
    B, H, D = 1, 2, 88
    before = TF.short_mha.launches
    for S in (257, 64):
        q, k, v = (randn((B, S, H, D), s) for s in (4, 5, 6))
        want = JF.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), exact=True)
        got = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), exact=True)
        np.testing.assert_allclose(f32(got), f32(want), atol=1e-5, rtol=1e-5)
    assert TF.short_mha.launches == before
    q = torch.zeros(1, 512, 2, 64)
    with pytest.raises(NotImplementedError, match="row 3"):
        TF.flash_attention(q, q, q, causal=True)


# ------------------------------------------------ kernel 2: int8_matmul

@pytest.mark.parametrize("M", [256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_matmul_plain_matches_pallas(M, dtype):
    """M=256 with K=512 (two K tiles of 256 on the Pallas side) and a
    ragged M=300. fp32: sum order only (rtol 1e-5 of max|y|); bf16: one
    output rounding apart (2**-7 of max|y|)."""
    K, N = 512, 384
    rs = np.random.RandomState(M)
    x = rs.randn(M, K).astype(np.float32)
    wq = rs.randint(-127, 128, (K, N)).astype(np.int8)
    scale = (np.abs(rs.randn(N)) * 0.01).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = f32(JI.int8_matmul(jx, jnp.asarray(wq), jnp.asarray(scale),
                              block_k=256))
    tx = torch.from_numpy(f32(jx)).to(getattr(torch, dtype))
    got = TI.int8_matmul(tx, torch.from_numpy(wq), torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == (M, N)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    assert np.abs(f32(got) - want).max() <= tol * np.abs(want).max()


def test_can_use_kernel_is_seed_tpus_predicate():
    shapes = [(m, k, n) for m in (1, 32, 255, 256, 300)
              for k in (64, 128, 4096, 11008) for n in (64, 384, 40320)]
    for m, k, n in shapes:
        assert TI.can_use_kernel(m, k, n) == JI.can_use_kernel(m, k, n)


@pytest.mark.parametrize("M", [8, 256])
def test_linear_int8_dispatch_matches(M):
    """layers.linear on an int8 leaf: M >= 256 is the kernel branch (Pallas
    on the seed_tpu side, the plain version here), M = 8 the dequant one."""
    w = randn((256, 384), 7)
    b = randn((384,), 8)
    jp = JQ.quantize_weight(jnp.asarray(w))
    jp["bias"] = jnp.asarray(b)
    tp = from_seed_tpu({k: np.asarray(v) for k, v in jp.items()})
    x = randn((2, M // 2, 256), 9)
    want = JL.linear(jp, jnp.asarray(x))
    got = TL.linear(tp, torch.from_numpy(x))
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


# ------------------------------------------------ layers and attention

def test_layers_match():
    x = randn((3, 5, 16), 20)
    p = {"scale": randn((16,), 21), "bias": randn((16,), 22)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = from_seed_tpu(p)
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(f32(TL.layer_norm(tp, tx, 1e-6)),
                               f32(JL.layer_norm(jp, jnp.asarray(x), 1e-6)),
                               atol=2e-6)
    np.testing.assert_allclose(f32(TL.rms_norm(tp, tx)),
                               f32(JL.rms_norm(jp, jnp.asarray(x))), atol=2e-6)
    np.testing.assert_allclose(f32(TL.gelu(tx)), f32(JL.gelu(jnp.asarray(x))),
                               atol=2e-6)
    lin = {"kernel": randn((16, 8), 23), "bias": randn((8,), 24)}
    np.testing.assert_allclose(
        f32(TL.linear(from_seed_tpu(lin), tx)),
        f32(JL.linear({k: jnp.asarray(v) for k, v in lin.items()},
                      jnp.asarray(x))), atol=2e-5)
    table = {"embedding": randn((10, 4), 25)}
    ids = np.array([[0, 3, 9, 12, -2]])   # out-of-range ids clip
    np.testing.assert_array_equal(
        f32(TL.embed(from_seed_tpu(table), torch.from_numpy(ids))),
        f32(JL.embed({"embedding": jnp.asarray(table["embedding"])},
                     jnp.asarray(ids))))


def test_mha_masks_and_gqa_match():
    B, N, M, H, Hkv, D = 2, 6, 9, 4, 2, 8
    q = randn((B, N, H, D), 30)
    k, v = randn((B, M, Hkv, D), 31), randn((B, M, Hkv, D), 32)
    jmask = JA.sliced_causal_mask(N, M, 3)
    tmask = TA.sliced_causal_mask(N, M, 3)
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    np.testing.assert_array_equal(np.asarray(JA.causal_mask(N, M)),
                                  TA.causal_mask(N, M).numpy())
    np.testing.assert_array_equal(np.asarray(JA.decode_mask(M, 4)),
                                  TA.decode_mask(M, 4).numpy())
    want = JA.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jmask)
    got = TA.mha(torch.from_numpy(q), torch.from_numpy(k),
                 torch.from_numpy(v), mask=tmask)
    np.testing.assert_allclose(f32(got), f32(want), atol=1e-6)


# ------------------------------------------------ quantization

def test_quantization_matches():
    w = randn((2, 64, 48), 40)                     # stacked [L, in, out] too
    jq, tq = JQ.quantize_weight(jnp.asarray(w)), TQ.quantize_weight(
        torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jq["kernel_q"]),
                                  tq["kernel_q"].numpy())
    np.testing.assert_allclose(tq["scale"].numpy(), np.asarray(jq["scale"]),
                               rtol=1e-7)
    np.testing.assert_allclose(TQ.dequantize_weight(tq).numpy(),
                               np.asarray(JQ.dequantize_weight(jq)), rtol=1e-7)
    x = randn((4, 64), 41)
    (jxq, jxs), (txq, txs) = (JQ.quantize_acts(jnp.asarray(x)),
                              TQ.quantize_acts(torch.from_numpy(x)))
    np.testing.assert_array_equal(np.asarray(jxq), txq.numpy())
    np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), rtol=1e-7)


def test_quantize_tree_targets_match():
    """DEFAULT_TARGETS on a LLaMA-shaped tree and VIT_TARGETS on a ViT-shaped
    one quantize the same leaves on both sides (the port's blocks are a
    list, seed_tpu's are stacked)."""
    layer = {"q_proj": {"kernel": randn((2, 8, 8), 50)},
             "input_layernorm": {"scale": randn((2, 8), 51)}}
    tree = {"layers": layer, "lm_head": {"kernel": randn((8, 16), 52)},
            "embed_tokens": {"embedding": randn((16, 8), 53)}}
    jq = JQ.quantize_tree(tree)
    tq = TQ.quantize_tree(from_seed_tpu(tree))
    want = from_seed_tpu(jq)
    assert set(tq["lm_head"]) == set(want["lm_head"]) == {"kernel_q", "scale"}
    for got_l, want_l in zip(tq["layers"], want["layers"]):
        assert set(got_l["q_proj"]) == {"kernel_q", "scale"}
        assert torch.equal(got_l["q_proj"]["kernel_q"],
                           want_l["q_proj"]["kernel_q"])
    assert "embedding" in tq["embed_tokens"]
    vit = {"blocks": {"attn": {"qkv": {"kernel": randn((2, 8, 24), 54)},
                               "q_bias": randn((2, 8), 55)},
                      "mlp": {"fc1": {"kernel": randn((2, 8, 16), 56)}}},
           "patch_embed": {"kernel": randn((12, 8), 57)}}
    tv = TQ.quantize_tree(from_seed_tpu(vit), TQ.VIT_TARGETS)
    jv = from_seed_tpu(JQ.quantize_tree(vit, JQ.VIT_TARGETS))
    assert "kernel" in tv["patch_embed"] and "kernel" in jv["patch_embed"]
    for got_b, want_b in zip(tv["blocks"], jv["blocks"]):
        for path in (("attn", "qkv"), ("mlp", "fc1")):
            g, w_ = got_b[path[0]][path[1]], want_b[path[0]][path[1]]
            assert torch.equal(g["kernel_q"], w_["kernel_q"])


# ------------------------------------------------ preprocessing

@pytest.mark.parametrize("src,dst", [((40, 56), (24, 24)), ((20, 17), (32, 32))])
def test_resize_bicubic_pil_bit_exact(src, dst):
    img = np.random.RandomState(60).randint(0, 256, (2, *src, 3)).astype(np.uint8)
    want = np.asarray(JP.resize_bicubic_pil(jnp.asarray(img), dst))
    got = TP.resize_bicubic_pil(torch.from_numpy(img), dst).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pil_exact", [True, False])
def test_preprocess_matches(pil_exact):
    """uint8 -> resize -> CLIP normalize. The PIL-exact path is equal up to
    the fp32 normalize; the float bicubic path within 1e-4 (seed_tpu's
    jax.image.resize matches PIL's continuous bicubic to ~3e-5)."""
    img = np.random.RandomState(61).randint(0, 256, (2, 48, 40, 3)).astype(np.uint8)
    want = f32(JP.preprocess(jnp.asarray(img), 28, jnp.float32, pil_exact))
    got = f32(TP.preprocess(torch.from_numpy(img), 28, torch.float32, pil_exact))
    np.testing.assert_allclose(got, want, atol=1e-6 if pil_exact else 1e-4)
    same = np.random.RandomState(62).randint(0, 256, (1, 28, 28, 3)).astype(np.uint8)
    np.testing.assert_allclose(
        f32(TP.preprocess(torch.from_numpy(same), 28, torch.float32)),
        f32(JP.preprocess(jnp.asarray(same), 28, jnp.float32)), atol=1e-6)


# ------------------------------------------------ sampling

def test_sampling_filters_match():
    """Sampled paths are checked on the filtered logits, never on draws."""
    logits = randn((3, 300), 70) * 3
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    for k in (0, 1, 40):
        np.testing.assert_array_equal(f32(TS.apply_top_k(tl, k)),
                                      f32(JS.apply_top_k(jl, k)))
    for p in (0.1, 0.5, 0.9):
        for cand in (0, 64):
            np.testing.assert_array_equal(
                f32(TS.apply_top_p(tl, p, candidates=cand)),
                f32(JS.apply_top_p(jl, p, candidates=cand)))
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        TS.sample(gen, tl, do_sample=False).numpy(),
        np.asarray(JS.sample(None, jl, do_sample=False)))
    drawn = TS.sample(gen, tl, temperature=1.0, top_p=0.5)
    kept = TS.apply_top_p(tl, 0.5) > TS.NEG_INF
    assert kept[torch.arange(3), drawn].all()
