"""The quantized serving paths of seed_tpu_torch against seed_tpu, on the
CPU: the W8A8 matmul (seed_tpu's Pallas kernel in interpret mode, the port's
plain version), ``linear_w8a8``, ``quantize_for_serving``,
``LlamaConfig.w8a8``, the fp8 and int8 ring caches, and batched sampling.
The same numpy-seeded inputs and bridged weights go through both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from seed_tpu.models import layers as JL
from seed_tpu.models import llama as JM
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.ops import int8_matmul as JI
from seed_tpu.ops import quantization as JQ
from seed_tpu.ops import sampling as JS
from seed_tpu.serving import engine as JE
from seed_tpu_torch import bridge
from seed_tpu_torch.models import layers as TL
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.ops import int8_matmul as TI
from seed_tpu_torch.ops import sampling as TS
from seed_tpu_torch.serving import engine as TE

JCFG, TCFG = JM.TINY_LLAMA, TM.TINY_LLAMA
# dims that tile by 128: the w8a8 predicate holds for a prefill of 256 tokens
KERNEL_CFG = dict(vocab_size=270, dim=128, layers=2, heads=4, kv_heads=2,
                  ffn_dim=256, max_seq_len=320)


def bridged(tree):
    return bridge.from_seed_tpu(jax.tree.map(np.asarray, tree), device="cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def bits(x):
    """bf16 / fp32 values as their fp32 bit patterns, for exact equality."""
    return f32(x).view(np.uint32)


def quant_inputs(M, K, N, seed):
    rs = np.random.RandomState(seed)
    xq = rs.randint(-127, 128, (M, K)).astype(np.int8)
    xs = (np.abs(rs.randn(M, 1)) * 0.01 + 1e-4).astype(np.float32)
    wq = rs.randint(-127, 128, (K, N)).astype(np.int8)
    ws = (np.abs(rs.randn(N)) * 0.01 + 1e-4).astype(np.float32)
    return xq, xs, wq, ws


# ------------------------------ W8A8 matmul ---------------------------------

# (M, K, N, block_k): ragged M (the pad path of seed_tpu), K in one block, K
# tiled in several blocks, M below one tile
W8A8_CASES = [(300, 256, 384, 2048), (256, 512, 128, 128), (130, 384, 256, 128),
              (64, 128, 128, 2048)]


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bk", W8A8_CASES)
def test_w8a8_matmul_plain_equals_pallas_kernel(M, K, N, bk, out):
    """Exact int32 sums and the same fp32 epilogue on both sides: equal bit
    for bit in fp32, and equal after the one rounding to bf16."""
    xq, xs, wq, ws = quant_inputs(M, K, N, seed=M + K)
    want = JI.w8a8_matmul(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq),
                          jnp.asarray(ws), out_dtype=getattr(jnp, out),
                          block_m=128, block_n=128, block_k=bk)
    before = TI.w8a8_matmul.launches
    got = TI.w8a8_matmul(torch.from_numpy(xq), torch.from_numpy(xs),
                         torch.from_numpy(wq), torch.from_numpy(ws),
                         getattr(torch, out))
    assert TI.w8a8_matmul.launches == before     # plain version on the CPU
    assert got.dtype == getattr(torch, out) and got.shape == (M, N)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_w8a8_plain_keeps_sums_past_24_bits():
    """Every product at 127 * 127 over K = 11008: 1.8e8 needs 28 bits. The
    plain version multiplies in integers, so the sum is exact."""
    K = 11008
    xq = torch.full((2, K), 127, dtype=torch.int8)
    wq = torch.full((K, 3), 127, dtype=torch.int8)
    wq[:, 1] = -127
    wq[::2, 2] = 126
    acc = TI.int_dot(xq, wq)
    assert acc.dtype == torch.int32
    assert acc[0].tolist() == [K * 127 * 127, -K * 127 * 127,
                               K // 2 * 127 * (127 + 126)]
    y = TI.w8a8_matmul_plain(xq, torch.ones(2, 1), wq, torch.ones(3),
                             torch.float32)
    assert y[0].tolist() == [float(np.float32(v)) for v in acc[0].tolist()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead,bias", [((512,), False), ((2, 130), True),
                                       ((3,), True)])
def test_linear_w8a8_equals_seed_tpu(lead, bias, dtype):
    """linear_w8a8 (dynamic activation quantization + the W8A8 product):
    equal bit for bit to seed_tpu's, which takes an XLA integer dot."""
    rs = np.random.RandomState(len(lead) + 7)
    w = rs.randn(256, 384).astype(np.float32)
    x = (rs.randn(*lead, 256) * 2).astype(np.float32)
    jp = JQ.quantize_weight(jnp.asarray(w))
    if bias:
        jp["bias"] = jnp.asarray(rs.randn(384).astype(np.float32))
    tp = bridged(jp)
    np.testing.assert_array_equal(f32(tp["kernel_q"]), f32(jp["kernel_q"]))
    want = JL.linear_w8a8(jp, jnp.asarray(x).astype(getattr(jnp, dtype)))
    got = TL.linear_w8a8(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_w8a8_predicates_equal_seed_tpu():
    dims = [1, 64, 128, 200, 256, 384, 1408, 1536, 2048, 4096, 4224, 6144,
            11008, 40320]
    for m in (1, 16, 255, 256, 2056):
        for k in dims:
            for n in dims:
                assert (TI.can_use_w8a8_kernel(m, k, n)
                        == JI.can_use_w8a8_kernel(m, k, n)), (m, k, n)
                if TI.can_use_w8a8_kernel(m, k, n):
                    assert TI.w8a8_kernel_takes(k, n)
    for dim in dims[2:]:
        for prefer in (128, 1536, 2048):
            try:
                want = JI._pick_w8a8_block(dim, prefer)
            except ValueError:
                with pytest.raises(ValueError):
                    TI._pick_w8a8_block(dim, prefer)
            else:
                assert TI._pick_w8a8_block(dim, prefer) == want


# -------------------------- W8A8 encoder and LLaMA --------------------------

def test_quantize_for_serving_tree_and_features_equal():
    """The quantized tree equals seed_tpu's (codes equal, scales to 1 ulp);
    W8A8 encoder features in fp32 agree to 1e-3 of their scale: the integer
    products are exact, what differs is fp32 sum order in norms, attention
    and the Q-Former, which can move an activation across a rounding step of
    its int8 quantization."""
    from tests.test_torch_tokenizer import configs, images, weights
    jcfg, tcfg = configs(use_flash=False)
    jp, tp = weights(jcfg, seed=3)
    jq, jqcfg = JST.quantize_for_serving(jp, jcfg)
    tq, tqcfg = TST.quantize_for_serving(tp, tcfg)
    assert jqcfg.vit.w8a8 and tqcfg.vit.w8a8 and not tcfg.vit.w8a8
    jb = bridged(jq)
    for i, blk in enumerate(tq["vit"]["blocks"]):
        for a, b in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                     ("mlp", "fc2")):
            got, want = blk[a][b], jb["vit"]["blocks"][i][a][b]
            assert set(got) == set(want) and "kernel" not in got
            assert torch.equal(got["kernel_q"], want["kernel_q"])
            np.testing.assert_array_max_ulp(f32(got["scale"]),
                                            f32(want["scale"]), maxulp=1)
    assert "kernel" in tq["vit"]["patch_embed"]          # stays high precision
    from seed_tpu_torch.utils.tree import leaves_with_path
    assert not any("kernel_q" in path
                   for path, _ in leaves_with_path(tq["qformer"]))
    # serving_fast_config composes with it, as bench.py applies both
    assert TST.serving_fast_config(tqcfg).vit.w8a8
    img = images(2, 224, seed=5)
    want = f32(JST.encode_features(jq, jnp.asarray(img), jqcfg))
    got = f32(TST.encode_features(jb, torch.from_numpy(img), tqcfg))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.fixture(scope="module")
def w8a8_llama():
    jcfg = JM.LlamaConfig(**KERNEL_CFG, w8a8=True)
    tcfg = TM.LlamaConfig(**KERNEL_CFG, w8a8=True)
    jp = JQ.quantize_tree(JM.init_llama(jax.random.PRNGKey(1), jcfg,
                                        jnp.float32))
    return jcfg, tcfg, jp, bridged(jp)


def test_llama_w8a8_prefill_and_decode_logits(w8a8_llama):
    """LlamaConfig.w8a8: prefill at M = 256 (the kernel's predicate holds)
    and two decode steps (M = 1). The products are exact, but an activation
    that differs in its last fp32 bits can round to the neighbouring int8
    code (one step of absmax/127, about 1% of the row's largest value), and
    that moves the logits (of scale 1) that depend on it: 99% of the fp32
    logits agree to 2e-3, all to 5e-2."""

    def close(got, want):
        diff = np.abs(f32(got) - f32(want))[..., :270]
        assert diff.max() <= 5e-2 and (diff > 2e-3).mean() < 0.01

    jcfg, tcfg, jp, tp = w8a8_llama
    ids = np.random.RandomState(3).randint(3, 270, (1, 258))
    jc = JM.init_cache(jcfg, 1, 288, jnp.float32)
    tc = TM.init_cache(tcfg, 1, 288, torch.float32, "cpu")
    jl, jc = JM.prefill(jp, jnp.asarray(ids[:, :256]), jc, jcfg)
    tl, tc = TM.prefill(tp, torch.from_numpy(ids[:, :256]), tc, tcfg)
    close(tl, jl)
    for t in (256, 257):
        jl, jc = JM.decode_step(jp, jnp.asarray(ids[:, t:t + 1]), jc, jcfg)
        tl, tc = TM.decode_step(tp, torch.from_numpy(ids[:, t:t + 1]), tc, tcfg)
        close(tl, jl)
    # the flag changes the function: weight-only int8 gives other logits
    plain, _ = TM.prefill(tp, torch.from_numpy(ids[:, :256]),
                          TM.init_cache(tcfg, 1, 288, torch.float32, "cpu"),
                          dataclasses.replace(tcfg, w8a8=False))
    assert not np.allclose(f32(plain), f32(tl), atol=1e-5)


# --------------------------- quantized ring caches --------------------------

@pytest.fixture(scope="module")
def tiny():
    jp = JM.init_llama(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, bridged(jp)


def jax_layout(t):
    """The port's k or v [L, B, H, S, D] in seed_tpu's [L, S, H, B, D]."""
    return t.permute(0, 3, 2, 1, 4)


def run_both(tiny, jdtype, tdtype):
    """A left-padded prefill and three decode steps through both caches."""
    jp, tp = tiny
    ids = np.random.RandomState(2).randint(3, 270, (2, 11))
    mask = np.ones((2, 8), np.int32)
    mask[0, :3] = 0
    jc = JM.init_cache(JCFG, 2, 32, jdtype)
    tc = TM.init_cache(TCFG, 2, 32, tdtype, device="cpu")
    jl, jc = JM.prefill(jp, jnp.asarray(ids[:, :8]), jc, JCFG,
                        chunk_mask=jnp.asarray(mask))
    tl, tc = TM.prefill(tp, torch.from_numpy(ids[:, :8]), tc, TCFG,
                        chunk_mask=torch.from_numpy(mask))
    logits = [(f32(tl), f32(jl))]
    for t in (8, 9, 10):
        jl, jc = JM.decode_step(jp, jnp.asarray(ids[:, t:t + 1]), jc, JCFG)
        tl, tc = TM.decode_step(tp, torch.from_numpy(ids[:, t:t + 1]), tc, TCFG)
        logits.append((f32(tl), f32(jl)))
    return jc, tc, logits


def test_int8_cache_codes_and_scales_equal(tiny):
    """int8 ring cache: after a prefill and three decode steps the stored
    codes agree with seed_tpu's (a k or v value within fp32 sum-order noise
    of a rounding boundary may land on the neighbouring code: at most 1 step,
    in under 0.1% of the entries), scales to 1e-6 relative, logits to 1e-3."""
    jc, tc, logits = run_both(tiny, jnp.int8, torch.int8)
    D = JCFG.head_dim
    assert tc.k.dtype == torch.int8 and tc.scale.shape == (2, 2, 2, 32, 2)
    jkv = np.asarray(jc.kv).astype(np.int32)
    for half, t in ((slice(0, D), tc.k), (slice(D, None), tc.v)):
        diff = np.abs(jax_layout(t).numpy().astype(np.int32) - jkv[..., half])
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    np.testing.assert_allclose(jax_layout(tc.scale).numpy(),
                               np.asarray(jc.scale), rtol=1e-6)
    assert not tc.k[:, :, :, 11:].any()             # rows never written
    for got, want in logits:
        np.testing.assert_allclose(got, want, atol=1e-3)


def test_fp8_cache_codes_equal(tiny):
    """fp8 ring cache: a cast on write and on read. The stored bytes agree
    with seed_tpu's except where sum-order noise crosses an e4m3 rounding
    boundary (under 0.5% of the entries, one code apart); logits to 2e-2
    (e4m3 keeps 3 mantissa bits, so a flipped code moves a value by 6%)."""
    jc, tc, logits = run_both(tiny, jnp.float8_e4m3fn, torch.float8_e4m3fn)
    D = JCFG.head_dim
    jkv = np.asarray(jc.kv).view(np.uint8).astype(np.int32)
    for half, t in ((slice(0, D), tc.k), (slice(D, None), tc.v)):
        got = jax_layout(t.view(torch.uint8)).numpy().astype(np.int32)
        diff = np.abs(got - jkv[..., half])
        assert diff.max() <= 1 and (diff > 0).mean() < 5e-3
    for got, want in logits:
        np.testing.assert_allclose(got, want, atol=2e-2)


def test_fp8_cast_rounds_once_and_saturates():
    """The cache's cast to e4m3 equals ml_dtypes' (seed_tpu's) bit for bit
    up to 464, the last value that rounds to 448, from fp32 and from bf16
    (one rounding, not two); above it the port saturates at 448 where
    seed_tpu's cast gives NaN."""
    rs = np.random.RandomState(0)
    x = np.concatenate([rs.randn(4096) * 3, rs.uniform(-464, 464, 4096),
                        [447.9, 448.0, 463.9, -463.9, 0.0, 1e-9, 0.0019]]
                       ).astype(np.float32)
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = TM._cache_cast(torch.from_numpy(x), torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    xb = x.astype(ml_dtypes.bfloat16)
    want = xb.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = TM._cache_cast(torch.from_numpy(xb.astype(np.float32)).bfloat16(),
                         torch.float8_e4m3fn)
    np.testing.assert_array_equal(got.view(torch.uint8).numpy(), want)
    big = np.array([465.0, 1e4, -1e4], np.float32)
    assert np.isnan(big.astype(ml_dtypes.float8_e4m3fn).astype(np.float32)).all()
    assert TM._cache_cast(torch.from_numpy(big), torch.float8_e4m3fn
                          ).float().tolist() == [448.0, 448.0, -448.0]


@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "int8"])
def test_engine_greedy_tokens_equal_under_quantized_cache(tiny, dtype):
    jp, tp = tiny
    rs = np.random.RandomState(4)
    prompts = [rs.randint(3, 270, 5).tolist(), rs.randint(3, 270, 11).tolist()]
    kw = dict(max_new_tokens=10, do_sample=False)
    want = JE.LlamaEngine(jp, JCFG, max_len=64, cache_dtype=getattr(jnp, dtype),
                          chunk_steps=4).generate(prompts,
                                                  JE.GenerationConfig(**kw))
    got = TE.LlamaEngine(tp, TCFG, max_len=64, cache_dtype=getattr(torch, dtype),
                         chunk_steps=4, device="cpu").generate(
        prompts, TE.GenerationConfig(**kw))
    assert got == want


# ------------------------------ beam search ---------------------------------

def beam_inputs(tiny, K, forced):
    """One prefilled prompt per row, expanded K-fold, on both sides."""
    jp, tp = tiny
    ids = np.random.RandomState(6).randint(3, 270, (2, 8))
    jc = JM.init_cache(JCFG, 2, 32, jnp.float32)
    tc = TM.init_cache(TCFG, 2, 32, torch.float32, device="cpu")
    jl, jc = JM.prefill(jp, jnp.asarray(ids), jc, JCFG)
    tl, tc = TM.prefill(tp, torch.from_numpy(ids), tc, TCFG)
    logp0 = np.asarray(jax.nn.log_softmax(jl[:, -1]))
    if forced is None:
        tok0 = np.argsort(-logp0, axis=-1)[:, :K]
        scores0 = np.take_along_axis(logp0, tok0, axis=-1)
    else:
        tok0 = np.full((2, K), forced)
        scores0 = np.full((2, K), JM._BEAM_NEG, np.float32)
        scores0[:, 0] = logp0[:, forced]
    jc = JM.KVCache(jnp.repeat(jc.kv, K, axis=3), jnp.repeat(jc.valid, K, axis=0),
                    jc.index, None)
    tc = TM.gather_cache_rows(tc, torch.arange(2).repeat_interleave(K))
    return jp, tp, jc, tc, tok0, scores0.astype(np.float32)


@pytest.mark.parametrize("forced,eos", [(None, -1), (7, -1), (None, "mid")])
def test_beam_loop_equals_seed_tpu(tiny, forced, eos):
    """beam_loop: tokens and generated lengths equal, normalized scores to
    1e-4, with and without a forced first token, and with an eos that the
    search hits midway (the best beam's third token of the eos-free run)."""
    K, steps = 3, 6
    jp, tp, jc, tc, tok0, scores0 = beam_inputs(tiny, K, forced)
    if eos == "mid":
        hist, norm, _ = JM.beam_loop(jp, jnp.asarray(tok0, jnp.int32),
                                     jnp.asarray(scores0), jc, JCFG,
                                     steps=steps, eos_id=-1)
        eos = int(np.asarray(hist)[0, int(np.asarray(norm)[0].argmax()), 2])
    want = JM.beam_loop(jp, jnp.asarray(tok0, jnp.int32), jnp.asarray(scores0),
                        jc, JCFG, steps=steps, eos_id=eos, length_penalty=0.8)
    got = TM.beam_loop(tp, torch.from_numpy(tok0), torch.from_numpy(scores0),
                       tc, TCFG, steps=steps, eos_id=eos, length_penalty=0.8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if eos != -1:
        assert (got[2].numpy() < steps + 1).any()        # a beam did finish


@pytest.mark.parametrize("forced", [None, 7])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_engine_beam_generate_equals_seed_tpu(tiny, forced, dtype):
    """LlamaEngine.generate(num_beams=K): the K-fold cache expansion (the
    int8 scales follow), the forced first token with only beam 0 viable,
    the ranking by score / len**length_penalty; tokens equal."""
    jp, tp = tiny
    rs = np.random.RandomState(8)
    prompts = [rs.randint(3, 270, 6).tolist(), rs.randint(3, 270, 9).tolist()]
    kw = dict(max_new_tokens=7, num_beams=3, length_penalty=1.2,
              forced_first_token=forced)
    want = JE.LlamaEngine(jp, JCFG, max_len=48, cache_dtype=getattr(jnp, dtype)
                          ).generate(prompts, JE.GenerationConfig(**kw))
    got = TE.LlamaEngine(tp, TCFG, max_len=48, cache_dtype=getattr(torch, dtype),
                         device="cpu").generate(prompts,
                                                TE.GenerationConfig(**kw))
    assert got == want and all(len(r) == 7 for r in got)


def test_decode_loop_pins_finished_rows(tiny):
    """decode_loop: seed_tpu's return values; a row that has hit eos keeps
    decoding in lockstep with its outputs pinned to eos. Greedy tokens equal
    seed_tpu's."""
    jp, tp = tiny
    ids = np.random.RandomState(9).randint(3, 270, (2, 8))
    jc = JM.init_cache(JCFG, 2, 32, jnp.float32)
    tc = TM.init_cache(TCFG, 2, 32, torch.float32, device="cpu")
    jl, jc = JM.prefill(jp, jnp.asarray(ids), jc, JCFG)
    tl, tc = TM.prefill(tp, torch.from_numpy(ids), tc, TCFG)
    tok = np.asarray(jl[:, -1].argmax(-1))
    free, _, _, _ = JM.decode_loop(jp, jnp.asarray(tok, jnp.int32), jc,
                                   jax.random.PRNGKey(0), JCFG, steps=5,
                                   do_sample=False, eos_id=-1)
    eos = int(np.asarray(free)[0, 1])        # row 0 finishes at its 2nd step
    want, want_done, _, _ = JM.decode_loop(
        jp, jnp.asarray(tok, jnp.int32), jc, jax.random.PRNGKey(0), JCFG,
        steps=5, do_sample=False, eos_id=eos)
    got, done, cache, rng = TM.decode_loop(
        tp, torch.from_numpy(tok), tc, torch.Generator().manual_seed(0), TCFG,
        steps=5, do_sample=False, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))
    assert got.shape == (2, 5) and (got[0, 1:] == eos).all() and done[0]
    assert cache.index == 13 and isinstance(rng, torch.Generator)


# ------------------------------- sampling -----------------------------------

@pytest.mark.parametrize("top_k,candidates", [(0, 0), (5, 0), (0, 16)])
def test_sample_batched_filters_and_greedy_rows_equal(top_k, candidates):
    """Per-row temperature, top-p and the shared top-k: the filtered logits
    equal seed_tpu's (same kept set; kept values to 1e-6) and greedy rows
    take the argmax. The draws are the port's own and are not compared."""
    rs = np.random.RandomState(11)
    logits = (rs.randn(5, 64) * 2).astype(np.float32)
    temp = np.array([1.0, 0.7, 1.3, 1.0, 0.0], np.float32)
    top_p = np.array([0.5, 0.9, 1.0, 0.2, 1.0], np.float32)
    greedy = np.array([False, False, False, True, True])
    scaled = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temp), 1e-6)[:, None]
    if top_k:
        scaled = JS.apply_top_k(scaled, top_k)
    want = np.asarray(JS.apply_top_p_rowwise(scaled, jnp.asarray(top_p),
                                             candidates=candidates))
    got = TS.filter_batched(torch.from_numpy(logits), torch.from_numpy(temp),
                            torch.from_numpy(top_p), top_k, candidates).numpy()
    np.testing.assert_array_equal(got == TS.NEG_INF, want == JS.NEG_INF)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (want[2] != JS.NEG_INF).sum() == (5 if top_k else 64)   # p = 1
    keys = torch.from_numpy(rs.randint(0, 2 ** 31, (5, 2)))
    jtok = np.asarray(JS.sample_batched(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.asarray(temp),
        jnp.asarray(top_p), jnp.asarray(greedy), top_k, candidates))
    ttok = TS.sample_batched(TS.fold_in(keys, torch.zeros(5, dtype=torch.long)),
                             torch.from_numpy(logits), torch.from_numpy(temp),
                             torch.from_numpy(top_p), torch.from_numpy(greedy),
                             top_k, candidates).numpy()
    np.testing.assert_array_equal(ttok[greedy], jtok[greedy])
    np.testing.assert_array_equal(ttok[greedy], logits.argmax(-1)[greedy])
    assert (got[np.arange(5), ttok] != TS.NEG_INF).all()   # drawn from the kept set


def test_sample_batched_streams_depend_on_key_and_counter_only():
    """A row's draw is a function of (its key, its counter, its logits): the
    same in any batch, at any row; other keys or counters give other draws;
    the draws follow the softmax of the filtered logits."""
    rs = np.random.RandomState(12)
    logits = torch.from_numpy(rs.randn(1, 270).astype(np.float32))
    ones, no = torch.ones(1), torch.zeros(1, dtype=torch.bool)
    key = torch.tensor([[1234, 7]])
    solo = [int(TS.sample_batched(TS.fold_in(key, torch.tensor([t])), logits,
                                  ones, ones, no)[0]) for t in range(8)]
    keys = torch.tensor([[5, 6], [1234, 7], [9, 9], [1234, 8]])
    for t in range(8):
        mixed = TS.sample_batched(
            TS.fold_in(keys, torch.tensor([3, t, 0, t])), logits.expand(4, -1),
            torch.ones(4), torch.ones(4), torch.zeros(4, dtype=torch.bool))
        assert int(mixed[1]) == solo[t]
    assert len(set(solo)) > 1
    other = [int(TS.sample_batched(TS.fold_in(keys[3:], torch.tensor([t])),
                                   logits, ones, ones, no)[0]) for t in range(8)]
    assert other != solo
    # 20000 independent keys on 3 logits: frequencies within 0.015 of softmax
    n = 20000
    small = torch.tensor([[0.0, 1.0, 2.0]]).expand(n, -1)
    ks = torch.stack([torch.arange(n), torch.full((n,), 99)], dim=1)
    tok = TS.sample_batched(TS.fold_in(ks, torch.zeros(n, dtype=torch.long)),
                            small, torch.ones(n), torch.ones(n),
                            torch.zeros(n, dtype=torch.bool))
    freq = torch.bincount(tok, minlength=3).float() / n
    assert (freq - torch.softmax(small[0], 0)).abs().max() < 0.015
