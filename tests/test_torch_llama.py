"""LLaMA, the engine and the multimodal interface of seed_tpu_torch against
seed_tpu, on the CPU, on seed_tpu's own weights carried across by
seed_tpu_torch.bridge; plus the port's import isolation and its default
device.
"""
import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import llama as JM
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.ops import quantization as JQ
from seed_tpu.serving import engine as JE
from seed_tpu.serving import multimodal as JMM
from seed_tpu_torch import BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.ops.int8_matmul import int8_matmul
from seed_tpu_torch.serving import engine as TE
from seed_tpu_torch.serving import multimodal as TMM

JCFG, TCFG = JM.TINY_LLAMA, TM.TINY_LLAMA
# dims that tile by 128, so a prefill of B x 128 tokens meets can_use_kernel
# (M >= 256) on its q/o/gate/up/down/lm_head projections
KERNEL_CFG = dict(vocab_size=270, dim=128, layers=2, heads=4, kv_heads=2,
                  ffn_dim=256, max_seq_len=192)


def from_seed_tpu(tree):
    """seed_tpu weights (numpy leaves) as the port's tensors, on the CPU."""
    return bridge.from_seed_tpu(tree, device="cpu")


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def bridged(tree):
    return from_seed_tpu(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def tiny():
    jp = JM.init_llama(jax.random.PRNGKey(0), JCFG, jnp.float32)
    return jp, bridged(jp)


def token_ids(shape, seed, vocab=270):
    return np.random.RandomState(seed).randint(3, vocab, shape)


def test_forward_logits_match(tiny):
    jp, tp = tiny
    ids = token_ids((2, 12), 0)
    mask = np.ones((2, 12), np.int32)
    mask[1, :4] = 0
    want = f32(JM.forward(jp, jnp.asarray(ids), JCFG,
                          attn_mask=jnp.asarray(mask)))
    got = f32(TM.forward(tp, torch.from_numpy(ids), TCFG,
                         attn_mask=torch.from_numpy(mask)))
    assert got.shape == (2, 12, JCFG.padded_vocab)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert (got[..., JCFG.vocab_size:] == -1e9).all()


@pytest.mark.parametrize("scaling", [None, "linear", "ntk"])
def test_rope_matches(scaling):
    x = np.random.RandomState(1).randn(2, 5, 3, 16).astype(np.float32)
    pos = np.arange(10).reshape(2, 5) * 7
    want = JM.rope(jnp.asarray(x), jnp.asarray(pos), scaling=scaling, factor=2.0)
    got = TM.rope(torch.from_numpy(x), torch.from_numpy(pos), scaling=scaling,
                  factor=2.0)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-5)


def test_prefill_decode_match_forward_and_seed_tpu(tiny):
    """Left-padded prefill then decode steps over the in-place cache: logits
    equal the full forward at the same positions, and seed_tpu's."""
    jp, tp = tiny
    ids = token_ids((2, 10), 2)
    mask = np.ones((2, 8), np.int32)
    mask[0, :3] = 0                                   # row 0 left-padded
    jcache = JM.init_cache(JCFG, 2, 32, jnp.float32)
    tcache = TM.init_cache(TCFG, 2, 32, torch.float32, device="cpu")
    jl, jcache = JM.prefill(jp, jnp.asarray(ids[:, :8]), jcache, JCFG,
                            chunk_mask=jnp.asarray(mask))
    tl, tcache = TM.prefill(tp, torch.from_numpy(ids[:, :8]), tcache, TCFG,
                            chunk_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-4)
    for t in (8, 9):
        jl, jcache = JM.decode_step(jp, jnp.asarray(ids[:, t:t + 1]), jcache, JCFG)
        tl, tcache = TM.decode_step(tp, torch.from_numpy(ids[:, t:t + 1]),
                                    tcache, TCFG)
        np.testing.assert_allclose(f32(tl), f32(jl), atol=1e-4)
    assert tcache.index == 10
    # row 1 has no padding: its last decode logits equal the plain forward
    full = f32(TM.forward(tp, torch.from_numpy(ids[1:]), TCFG))
    np.testing.assert_allclose(f32(tl)[1, 0], full[0, -1], atol=1e-4)


def test_int8_prefill_reaches_kernel_branch():
    """An int8 tree whose prefill has M = 2 x 128 >= 256: seed_tpu runs the
    Pallas int8 kernel (interpret mode), the port its plain version."""
    jcfg, tcfg = JM.LlamaConfig(**KERNEL_CFG), TM.LlamaConfig(**KERNEL_CFG)
    jp = JQ.quantize_tree(JM.init_llama(jax.random.PRNGKey(1), jcfg, jnp.float32))
    tp = bridged(jp)
    assert set(tp["layers"][0]["q_proj"]) == {"kernel_q", "scale"}
    ids = token_ids((2, 128), 3)
    jl, _ = JM.prefill(jp, jnp.asarray(ids), JM.init_cache(jcfg, 2, 160,
                                                           jnp.float32), jcfg)
    before = int8_matmul.launches
    tl, _ = TM.prefill(tp, torch.from_numpy(ids),
                       TM.init_cache(tcfg, 2, 160, torch.float32, "cpu"), tcfg)
    assert int8_matmul.launches == before       # plain version on the CPU
    np.testing.assert_allclose(f32(tl), f32(jl), atol=2e-4)


def test_port_quantizes_layer_by_layer():
    """init_llama(quantize_targets=...) gives the same int8 leaves as
    quantizing the whole tree afterwards."""
    from seed_tpu_torch.ops.quantization import DEFAULT_TARGETS, quantize_tree
    cfg = TM.LlamaConfig(**KERNEL_CFG)
    whole = quantize_tree(TM.init_llama(torch.Generator().manual_seed(0), cfg,
                                        torch.float32, "cpu"))
    staged = TM.init_llama(torch.Generator().manual_seed(0), cfg,
                           torch.float32, "cpu", quantize_targets=DEFAULT_TARGETS)
    assert torch.equal(whole["lm_head"]["kernel_q"], staged["lm_head"]["kernel_q"])
    assert torch.equal(whole["layers"][1]["down_proj"]["kernel_q"],
                       staged["layers"][1]["down_proj"]["kernel_q"])
    assert staged["embed_tokens"]["embedding"].dtype == torch.float32


@pytest.mark.parametrize("forced", [None, 7])
def test_engine_greedy_tokens_equal(tiny, forced):
    """LlamaEngine.generate: same buckets, left padding, forced first token
    and stopping rule as seed_tpu's engine; greedy tokens equal."""
    jp, tp = tiny
    prompts = [token_ids(5, 4).tolist(), token_ids(11, 5).tolist()]
    jgen = JE.GenerationConfig(max_new_tokens=12, do_sample=False,
                               forced_first_token=forced)
    tgen = TE.GenerationConfig(max_new_tokens=12, do_sample=False,
                               forced_first_token=forced)
    want = JE.LlamaEngine(jp, JCFG, max_len=64, cache_dtype=jnp.float32,
                          chunk_steps=4).generate(prompts, jgen)
    got = TE.LlamaEngine(tp, TCFG, max_len=64, cache_dtype=torch.float32,
                         chunk_steps=4, device="cpu").generate(prompts, tgen)
    assert got == want
    assert all(len(row) > 0 for row in got)


def test_engine_stops_at_the_end_of_the_cache(tiny):
    """A long request stops where seed_tpu's does: chunk by chunk, before a
    chunk would run past the cache."""
    jp, tp = tiny
    prompts = [token_ids(30, 6).tolist()]
    kw = dict(max_new_tokens=100, do_sample=False, eos_token_id=-1)
    want = JE.LlamaEngine(jp, JCFG, max_len=48, cache_dtype=jnp.float32,
                          chunk_steps=5).generate(prompts, JE.GenerationConfig(**kw))
    got = TE.LlamaEngine(tp, TCFG, max_len=48, cache_dtype=torch.float32,
                         chunk_steps=5, device="cpu").generate(
        prompts, TE.GenerationConfig(**kw))
    assert got == want and len(got[0]) < 100


def test_engine_defaults_to_the_card(tiny):
    """With no CUDA, an engine built without device= raises a clear error
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TE.LlamaEngine(tiny[1], TCFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TMM.SeedLlamaInterface(None)


@pytest.fixture(scope="module")
def interfaces(tiny):
    jp, tp = tiny
    # the tiny tokenizer with the real 32 queries, so a generated image
    # block (BOI + 32 codes + EOI) decodes
    jcfg, tcfg = (dataclasses.replace(c, qformer=dataclasses.replace(
        c.qformer, query_len=32)) for c in (JST.TINY_TOKENIZER,
                                            TST.TINY_TOKENIZER))
    jtok = JST.init_seed_tokenizer(jax.random.PRNGKey(2), jcfg)
    ttok = bridged(jtok)
    jeng = JE.LlamaEngine(jp, JCFG, max_len=128, cache_dtype=jnp.float32)
    teng = TE.LlamaEngine(tp, TCFG, max_len=128, cache_dtype=torch.float32,
                          device="cpu")
    return (JMM.SeedLlamaInterface(jeng, jtok, jcfg),
            TMM.SeedLlamaInterface(teng, ttok, tcfg, device="cpu"))


def segments(segs):
    return [(s.kind, s.text, None if s.image_codes is None
             else s.image_codes.tolist()) for s in segs]


@pytest.mark.parametrize("force_image", [False, True])
def test_interface_greedy_segments_equal(interfaces, force_image):
    """encode an image -> VQA-style prompt -> greedy generate -> segments,
    and a force_image request; equal to seed_tpu's."""
    jif, tif = interfaces
    img = np.random.RandomState(7).randn(1, 28, 28, 3).astype(np.float32)
    codes = tif.encode_image(torch.from_numpy(img))
    np.testing.assert_array_equal(codes, jif.encode_image(jnp.asarray(img)))
    parts = [codes[0], "What is this?"]
    assert tif.build_prompt(parts) == jif.build_prompt(parts)
    kw = dict(max_new_tokens=10, do_sample=False)
    want = jif.generate(parts, JE.GenerationConfig(**kw), force_image=force_image)
    gen = TE.GenerationConfig(**kw)
    got = tif.generate(parts, gen, force_image=force_image)
    assert gen.forced_first_token is None          # the caller's config is kept
    assert segments(got) == segments(want)


def test_split_output_and_image_segments_match(interfaces):
    """Generated ids split at BOI/EOI; a valid image block decodes to the
    unCLIP embedding, a malformed one surfaces as text."""
    jif, tif = interfaces
    codes = list(range(3, 35))
    ids = ([72 + 3, 105 + 3, BOI_TOKEN_ID]
           + [c + IMAGE_ID_SHIFT for c in codes] + [EOI_TOKEN_ID, 33 + 3,
                                                  BOI_TOKEN_ID, 40000, 65])
    want, got = jif.split_output(ids), tif.split_output(ids)
    assert segments(got) == segments(want)
    assert [s.kind for s in got] == ["text", "image", "text"]
    np.testing.assert_allclose(got[1].image_embedding,
                               want[1].image_embedding, atol=1e-5)
    assert TMM.segments_to_string(got) == JMM.segments_to_string(want)
    s = "hi " + TMM.codes_to_string(codes) + " there"
    assert [p if isinstance(p, str) else p.tolist()
            for p in TMM.string_to_parts(s)] == [
        p if isinstance(p, str) else p.tolist() for p in JMM.string_to_parts(s)]


def test_port_imports_neither_jax_nor_seed_tpu():
    """The port and its serving modules import torch, numpy and the standard
    library only: no jax, nothing of seed_tpu."""
    code = textwrap.dedent("""
        import sys
        import seed_tpu_torch, seed_tpu_torch.bridge
        import seed_tpu_torch.serving.multimodal, seed_tpu_torch.serving.engine
        import seed_tpu_torch.models.seed_tokenizer, seed_tpu_torch.models.llama
        import seed_tpu_torch.ops.preprocess, seed_tpu_torch.ops.kernels
        import seed_tpu_torch.serving.server, seed_tpu_torch.serving.scheduler
        import seed_tpu_torch.serving.offload, seed_tpu_torch.serving.webui
        import seed_tpu_torch.serving.conversation
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "seed_tpu")]
        assert not bad, bad
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
