"""The port's command lines of ``seed_tpu_torch.scripts`` on the CPU
(``--device cpu``), against what scripts/merge_lora.py,
scripts/seed_tokenizer_inference.py, scripts/seed_llama_inference.py and
scripts/acceptance.py do with seed_tpu. The scripts are not importable as
functions, so the seed_tpu side calls their seed_tpu functions in the
scripts' order.

Contracts: the merged tree equals seed_tpu's ``merge_lora_weights`` in
each checkpoint layout (unadapted leaves bit for bit, adapted kernels within
1e-6 in fp32 and one ulp in bf16); token ids equal and
the unCLIP embedding within 1e-5 (fp32, the token-ids contract); pixels
within tests/test_torch_unclip.py's loop tolerance on seed_tpu's latents;
greedy tokens equal; sampled runs checked on the filtered logits and on
structure, never on draws (the Sampling contract).
"""
import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu import BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT
from seed_tpu.models import llama as JM
from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import unclip as JU
from seed_tpu.ops.sampling import apply_top_p as j_top_p
from seed_tpu.serving import ByteTextTokenizer as JByteTok
from seed_tpu.serving import GenerationConfig as JGen
from seed_tpu.serving import LlamaEngine as JEngine
from seed_tpu.serving import SeedLlamaInterface as JIface
from seed_tpu.train import lora as JLORA
from seed_tpu_torch import bridge
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import unclip as TU
from seed_tpu_torch.ops.sampling import apply_top_p
from seed_tpu_torch.scripts import (acceptance, check_full_geometry,
                                    merge_lora, seed_llama_inference,
                                    seed_tokenizer_inference)
from seed_tpu_torch.serving import GenerationConfig
from seed_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                             save_checkpoint)
from seed_tpu_torch.utils.tree import leaves_with_path

j_preprocess = importlib.import_module("seed_tpu.ops.preprocess").preprocess
LOOP = dict(rtol=2e-3, atol=3e-4)      # tests/test_torch_unclip.py
CPU = ["--device", "cpu"]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def seeded(shapes, seed):
    """A seed_tpu tree of ``shapes`` with seeded fp32 leaves: kernels scaled
    by fan-in, norm scales near 1, non-zero biases."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = getattr(path[-1], "key", None)
        x = rs.randn(*s.shape)
        if name == "kernel":
            x = x / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            x = 1.0 + 0.1 * x
        elif name == "std":
            x = 0.5 + np.abs(x)
        else:
            x = 0.1 * x
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def write_jpeg(path, h, w, seed):
    from PIL import Image
    arr = np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)
    Image.fromarray(arr).save(path, quality=95)
    return np.asarray(Image.open(path).convert("RGB"), np.uint8)


# ------------------------------- merge_lora ---------------------------------

@pytest.fixture(scope="module")
def lora_pair():
    """seed_tpu's TINY_LLAMA and LoRA adapters with non-zero B, as numpy."""
    base = JM.init_llama(jax.random.PRNGKey(0), JM.TINY_LLAMA, jnp.float32)
    lora = np_tree(JLORA.init_lora(jax.random.PRNGKey(1), base))
    rs = np.random.RandomState(2)
    for ad in lora["adapters"].values():
        ad["b"] = (0.05 * rs.randn(*ad["b"].shape)).astype(np.float32)
    return np_tree(base), lora


def _bits(t: torch.Tensor) -> torch.Tensor:
    """bf16 bits as integers: neighbours of one sign differ by one."""
    return t.view(torch.int16).long()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["base_and_lora", "bare_base",
                                    "lora_only_save"])
def test_merge_lora_equals_seed_tpu(tmp_path, lora_pair, layout, dtype):
    """main() through save / restore: the merged tree equals seed_tpu's
    merge_lora_weights on the same weights, for seed_tpu's {"base", "lora"}
    tree, a bare base beside an adapter tree, and train_llm --lora's
    {"lora"}-only save. Leaves without an adapter are bit
    for bit the same. The rank-16 product A @ B sums in XLA's order on one
    side and torch's on the other, so an adapted kernel is held within 1e-6
    in fp32 (tests/test_torch_train.py's merge bound) and within one ulp in
    bf16 (where the fp32 sum sits at a rounding boundary)."""
    jbase, jlora = lora_pair
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jbase = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)), jbase)
    want = bridge.from_seed_tpu(np_tree(JLORA.merge_lora_weights(
        jax.tree.map(jnp.asarray, jbase), jax.tree.map(jnp.asarray, jlora))),
        device="cpu")
    tbase = bridge.from_seed_tpu(jbase, device="cpu")
    tlora = bridge.lora_from_seed_tpu(jlora, device="cpu")
    b, l, out = tmp_path / "base", tmp_path / "lora", tmp_path / "merged"
    if layout == "base_and_lora":
        save_checkpoint(b, {"base": tbase, "lora": tlora})
    elif layout == "bare_base":
        save_checkpoint(b, tbase)
        save_checkpoint(l, tlora)
    else:
        save_checkpoint(b, tbase)
        save_checkpoint(l, {"lora": tlora})
    merge_lora.main(["--base", str(b), "--lora", str(l), "--output",
                     str(out)] + CPU)
    got = dict(leaves_with_path(restore_checkpoint(out, device="cpu")))
    want = dict(leaves_with_path(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if path not in tlora["adapters"]:
            assert torch.equal(g, w), path
        elif dtype == "bfloat16":
            assert (_bits(g) - _bits(w)).abs().max().item() <= 1, path
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    # the merge changed the adapted kernels
    assert not torch.equal(got["layers/0/q_proj/kernel"],
                           tbase["layers"][0]["q_proj"]["kernel"])


# ------------------------- seed_tokenizer_inference -------------------------

# TINY_TOKENIZER with the unCLIP embedding of TINY_UNCLIP, so one pipeline
# runs end to end
TOK = dataclasses.replace(JST.TINY_TOKENIZER,
                          image_embed_dim=JU.TINY_UNCLIP.image_embed_dim)
TTOK = dataclasses.replace(TST.TINY_TOKENIZER,
                           image_embed_dim=TU.TINY_UNCLIP.image_embed_dim)


@pytest.fixture(scope="module")
def tokenizer_weights():
    shapes = jax.eval_shape(lambda k: JST.init_seed_tokenizer(k, TOK),
                            jax.random.PRNGKey(0))
    jp = seeded(shapes, 3)
    return jp, bridge.from_seed_tpu(jp, device="cpu")


@pytest.fixture(scope="module")
def unclip_weights():
    shapes = jax.eval_shape(lambda k: JU.init_unclip(k, JU.TINY_UNCLIP),
                            jax.random.PRNGKey(0))
    jp = seeded(shapes, 4)
    return jp, bridge.unclip_from_seed_tpu(jp, device="cpu")


def _seed_tpu_tokenize(jp, raw):
    """scripts/seed_tokenizer_inference.py's two jitted calls, in fp32."""
    ids = jax.jit(lambda p, x: JST.encode(
        p, j_preprocess(x, TOK.vit.image_size, jnp.float32), TOK))(
            jp, jnp.asarray(raw))
    emb = jax.jit(lambda p, i: JST.decode_embedding(p, i, TOK))(jp, ids)
    return np.asarray(ids), np.asarray(emb)


def test_tokenizer_cli_ids_and_embedding_equal_seed_tpu(tokenizer_weights):
    """tokenize() at TINY_TOKENIZER in fp32 on a 40x36 image (resized to
    28): ids equal, the unCLIP embedding within 1e-5."""
    jp, tp = tokenizer_weights
    raw = np.random.RandomState(5).randint(0, 256, (2, 40, 36, 3), np.uint8)
    jids, jemb = _seed_tpu_tokenize(jp, raw)
    ids, emb = seed_tokenizer_inference.tokenize(tp, torch.from_numpy(raw),
                                                 TTOK, torch.float32)
    np.testing.assert_array_equal(ids.numpy(), jids)
    np.testing.assert_allclose(emb.numpy(), jemb, rtol=0, atol=1e-5)


def test_tokenizer_cli_pixels_match_seed_tpu(tokenizer_weights,
                                             unclip_weights):
    """The script's decode (20 DDIM steps, guidance 10) of the embedding on
    seed_tpu's latents: within the unCLIP tests' loop tolerance (fp32)."""
    jp, tp = tokenizer_weights
    jup, tup = unclip_weights
    raw = np.random.RandomState(6).randint(0, 256, (1, 28, 28, 3), np.uint8)
    _, jemb = _seed_tpu_tokenize(jp, raw)
    _, emb = seed_tokenizer_inference.tokenize(tp, torch.from_numpy(raw),
                                               TTOK, torch.float32)
    jdec = JU.UnCLIPDecoder(jax.tree.map(jnp.asarray, jup), JU.TINY_UNCLIP,
                            dtype=jnp.float32)
    tdec = TU.UnCLIPDecoder(tup, TU.TINY_UNCLIP, dtype=torch.float32,
                            device="cpu")
    tdec.latents = torch.from_numpy(np.array(jdec.latents))
    want = jdec.generate(jemb)
    got = tdec.generate(emb)
    assert got.shape == want.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(got, want, **LOOP)


def test_tokenizer_cli_main_writes_the_image(tmp_path, tokenizer_weights,
                                             unclip_weights, capsys):
    """main() from checkpoints: the printed ids are the image's, and --save
    holds a JPEG of the decoder's size; without --diffusion-ckpt it skips
    the pixels."""
    from PIL import Image
    _, tp = tokenizer_weights
    _, tup = unclip_weights
    save_checkpoint(tmp_path / "tok", tp)
    save_checkpoint(tmp_path / "unclip", tup)
    img = write_jpeg(tmp_path / "in.jpg", 30, 42, 7)
    out = tmp_path / "out.jpg"
    argv = ["--image", str(tmp_path / "in.jpg"), "--tokenizer-ckpt",
            str(tmp_path / "tok"), "--save", str(out)] + CPU
    res = seed_tokenizer_inference.main(
        argv + ["--diffusion-ckpt", str(tmp_path / "unclip")],
        tok_cfg=TTOK, unclip_cfg=TU.TINY_UNCLIP)
    ids, _ = seed_tokenizer_inference.tokenize(
        tp, torch.from_numpy(img.copy())[None], TTOK)
    np.testing.assert_array_equal(res["ids"], ids.numpy())
    assert f"token ids: {ids[0].tolist()}" in capsys.readouterr().out
    back = Image.open(out)
    assert back.format == "JPEG" and back.size == (16, 16)
    assert np.asarray(back.convert("RGB")).shape == res["image"].shape
    res = seed_tokenizer_inference.main(argv, tok_cfg=TTOK)
    assert res["image"] is None
    assert "skipping pixel reconstruction" in capsys.readouterr().out


# --------------------------- seed_llama_inference ---------------------------

JTINY = JM.LlamaConfig(vocab_size=40194, dim=256, layers=2, heads=4,
                       kv_heads=4, ffn_dim=512, max_seq_len=1024)
CODES = np.random.RandomState(8).permutation(64)[:32].astype(np.int32)


def _llama_args(n=512):
    return seed_llama_inference.parse_args(
        ["--model", "tiny", "--max-new-tokens", str(n)] + CPU)


@pytest.fixture(scope="module")
def llama_weights():
    """The script's tiny LLaMA (seeded fp32 weights) as seed_tpu and port
    trees, and the synthetic tokenizer of the runbook on both sides."""
    jp = JM.init_llama(jax.random.PRNGKey(0), JTINY, jnp.float32)
    return jp, bridge.from_seed_tpu(np_tree(jp), device="cpu")


def _port_iface(llm_params, n=512):
    """build() on the given LLM and the runbook's small tokenizer (query_len
    32), so a well-formed block decodes."""
    tok_cfg = acceptance.synthetic_tokenizer_config()
    tok = TST.init_seed_tokenizer(torch.Generator().manual_seed(0), tok_cfg,
                                  device="cpu")
    return seed_llama_inference.build(_llama_args(n=n), tok_cfg=tok_cfg,
                                      tok_params=tok, llm_params=llm_params)


class _Recorder:
    def __init__(self, engine):
        self.engine, self.ids = engine, []

    def generate(self, prompts, gen, seed=0):
        out = self.engine.generate(prompts, gen, seed=seed)
        self.ids.append(list(out[0]))
        return out


def _seed_tpu_prompts(jp, gen, codes):
    """scripts/seed_llama_inference.py's three generate calls on seed_tpu;
    the ids of each."""
    rec = _Recorder(JEngine(jp, JTINY))
    iface = JIface(rec, None, JST.SEED_TOKENIZER, JByteTok())
    iface.generate([codes, seed_llama_inference.VQA], dataclasses.replace(gen))
    iface.generate([seed_llama_inference.T2I], dataclasses.replace(gen),
                   force_image=True)
    iface.generate([codes, seed_llama_inference.EDIT],
                   dataclasses.replace(gen), force_image=True)
    return rec.ids


def test_llama_cli_greedy_tokens_equal_seed_tpu(llama_weights):
    """run_prompts with a greedy config: the three prompts' tokens equal
    seed_tpu's at the script's tiny config; the forced prompts start with
    BOI."""
    jp, tp = llama_weights
    iface, _, _ = _port_iface(tp)
    res = seed_llama_inference.run_prompts(
        iface, GenerationConfig(max_new_tokens=12, do_sample=False), CODES)
    want = _seed_tpu_prompts(jp, JGen(max_new_tokens=12, do_sample=False),
                             CODES)
    assert [r["ids"] for r in res] == want
    assert [r["forced"] for r in res] == [False, True, True]
    assert all(r["ids"][0] == BOI_TOKEN_ID for r in res[1:])


def _first_logits_port(iface, parts):
    logits, _, _ = iface.engine._prefill_prompts([iface.build_prompt(parts)])
    return logits[:, -1]


def _first_logits_seed_tpu(jp, parts):
    iface = JIface(JEngine(jp, JTINY), None, JST.SEED_TOKENIZER, JByteTok())
    prompt = iface.build_prompt(parts)
    eng = iface.engine
    bucket = eng._bucket(len(prompt))
    ids = np.zeros((1, bucket), np.int32)
    mask = np.zeros((1, bucket), np.int32)
    ids[0, bucket - len(prompt):] = prompt
    mask[0, bucket - len(prompt):] = 1
    cache = JM.init_cache(JTINY, 1, eng.max_len, eng.cache_dtype)
    logits, _ = eng._prefill(jp, jnp.asarray(ids), cache,
                             chunk_mask=jnp.asarray(mask))
    return np.asarray(logits[:, -1])


@pytest.mark.parametrize("task", ["vqa", "t2i"])
def test_llama_cli_sampled_filter_equals_seed_tpu(llama_weights, task):
    """The script's sampling (top_p 0.5, temperature 1.0) at the first
    step: the port's filter on seed_tpu's logits gives seed_tpu's filtered
    logits exactly; the port's own logits are within 2e-3 of seed_tpu's
    (fp32 weights, logits of magnitude up to about 4; prefill attends through
    the engines' bf16 KV cache, where an fp32 key or value at a rounding
    boundary rounds one bf16 ulp, 2**-8 of itself, apart), so its own kept
    set differs only at tokens that close to the threshold."""
    jp, tp = llama_weights
    iface, gen, _ = _port_iface(tp)
    assert gen.do_sample and gen.top_p == 0.5 and gen.temperature == 1.0
    parts = ([CODES, seed_llama_inference.VQA] if task == "vqa"
             else [seed_llama_inference.T2I])
    jlogits = _first_logits_seed_tpu(jp, parts)
    want = np.asarray(j_top_p(jnp.asarray(jlogits), gen.top_p))
    kept = want > -1e8
    assert 1 <= kept.sum() < kept.size
    np.testing.assert_array_equal(
        apply_top_p(torch.from_numpy(jlogits) / gen.temperature,
                    gen.top_p).numpy(), want)
    with torch.inference_mode():
        own = _first_logits_port(iface, parts).numpy()
        own_kept = apply_top_p(torch.from_numpy(own), gen.top_p).numpy() > -1e8
    np.testing.assert_allclose(own, jlogits, rtol=0, atol=2e-3)
    threshold = jlogits[kept].min()
    assert (np.abs(jlogits[own_kept != kept] - threshold) <= 4e-3).all()


def _chain_model(jp, codes):
    """The tiny model rewired so that the token after BOI, after each code
    and after EOI is fixed: every layer's o_proj and down_proj zero (the
    residual stays the current token's embedding), the chain's embeddings
    basis vectors and the lm_head columns of their successors those vectors
    (logit 32 against at most about 5)."""
    p = np_tree(jp)
    chain = ([BOI_TOKEN_ID] + [int(c) + IMAGE_ID_SHIFT for c in codes]
             + [EOI_TOKEN_ID, 2])
    for name in ("o_proj", "down_proj"):
        p["layers"][name]["kernel"] = np.zeros_like(
            p["layers"][name]["kernel"])
    emb = p["embed_tokens"]["embedding"].copy()
    head = p["lm_head"]["kernel"].copy()
    for i, (tok, nxt) in enumerate(zip(chain[:-1], chain[1:])):
        emb[tok] = 0.0
        emb[tok, i] = 1.0
        head[:, nxt] = 0.0
        head[i, nxt] = 2.0
    p["embed_tokens"]["embedding"], p["lm_head"]["kernel"] = emb, head
    return p


def test_llama_cli_forced_images_are_well_formed(llama_weights):
    """The script's sampled default on a model whose continuation after BOI
    is a 32-code block: each forced prompt gives BOI, 32 codes, EOI, split
    into one image segment of those codes (decoded by the tokenizer), on
    both packages; the VQA prompt is not forced."""
    jp, _ = llama_weights
    chain = _chain_model(jp, CODES)
    iface, gen, _ = _port_iface(bridge.from_seed_tpu(chain, device="cpu"),
                                n=40)
    res = seed_llama_inference.run_prompts(iface, gen, CODES)
    want_block = [BOI_TOKEN_ID] + [int(c) + IMAGE_ID_SHIFT
                                   for c in CODES] + [EOI_TOKEN_ID]
    jgen = JGen(max_new_tokens=40, top_p=0.5, temperature=1.0,
                do_sample=True, eos_token_id=2)
    jids = _seed_tpu_prompts(jax.tree.map(jnp.asarray, chain), jgen, CODES)
    for r, ids in zip(res, jids):
        if not r["forced"]:
            continue
        for stream in (r["ids"], ids):
            assert stream[:34] == want_block
        images = [s for s in r["segments"] if s.kind == "image"]
        assert len(images) == 1
        np.testing.assert_array_equal(images[0].image_codes, CODES[None])
        assert images[0].image_embedding.shape == (
            1, iface.tok_cfg.image_embed_dim)


# --------------------------------- acceptance -------------------------------

def test_acceptance_synthetic_passes(tmp_path):
    """--synthetic on the CPU: exit 0, report pass; the unCLIP decode and
    the canonical prompts pass; tokenizer parity is skipped, with its
    reason, where the reference tree is absent; convert has no input."""
    shims = acceptance.load_shims()
    argv = ["--synthetic", "--out", str(tmp_path), "--max-images", "2",
            "--max-new-tokens", "8", "--diffusion-steps", "2"] + CPU
    with pytest.raises(SystemExit) as exit_:
        acceptance.main(argv)
    assert exit_.value.code == 0
    rep = json.load(open(tmp_path / "acceptance.json"))
    st = rep["stages"]
    assert rep["pass"] is True and rep["synthetic"] is True
    assert st["convert"]["status"] == "skipped"
    assert st["unclip_decode"] == {"status": "pass",
                                   "shape": [1, 16, 16, 3],
                                   "deterministic": True}
    assert st["canonical_prompts"]["status"] == "pass"
    assert set(st["canonical_prompts"]) >= {"vqa", "t2i", "mm_edit"}
    import os
    if not os.path.isdir(shims.REFERENCE_MODELS):
        assert st["tokenizer_parity"]["status"] == "skipped"
        assert "absent" in st["tokenizer_parity"]["reason"]
    else:
        assert st["tokenizer_parity"]["status"] == "pass"


def test_acceptance_golden_ids_stage(tmp_path):
    """Stage 2 from recorded ids: the port's fp32 encode of the corpus
    against an .npz of ids passes when they are its own and fails on one
    changed id."""
    args = acceptance.parse_args(["--max-images", "2"] + CPU)
    cfg = acceptance.synthetic_tokenizer_config()
    params = TST.init_seed_tokenizer(torch.Generator().manual_seed(0), cfg,
                                     device="cpu")
    ids, _, _ = acceptance._encode_fp32(
        params, acceptance.load_corpus(args, cfg.vit.image_size), cfg, "cpu")
    for want, status in ((ids, "pass"), (ids + (np.arange(ids.size) == 3)
                                         .reshape(ids.shape), "FAIL")):
        np.savez(tmp_path / "ids.npz", ids=want)
        args.golden_ids = str(tmp_path / "ids.npz")
        report = {"stages": {}}
        acceptance.stage_golden_ids(args, report, cfg, params, "cpu")
        assert report["stages"]["tokenizer_parity"]["status"] == status


# -------------------------------- --device ----------------------------------

@pytest.mark.parametrize("cli, argv", [
    (merge_lora, ["--base", "b", "--lora", "l", "--output", "o"]),
    (seed_tokenizer_inference, ["--image", "x.jpg"]),
    (seed_llama_inference, []),
    (acceptance, ["--synthetic", "--out", "o"]),
    (check_full_geometry, []),
], ids=lambda x: getattr(x, "__name__", "").rsplit(".", 1)[-1] or None)
def test_cli_defaults_to_the_card(cli, argv, monkeypatch, tmp_path):
    """Without --device each command line takes the card, and raises where
    there is none."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
