"""/generate with the unCLIP de-tokenizer attached, on the CPU: a generated
image block comes back as a PNG, against seed_tpu's service on the same
weights and latents; ``split_output`` carries pixels; ``main`` and
``build_service`` read ``--diffusion-ckpt``.

The engines' generation is replaced by a fixed stream holding one valid
image block: a random-weight LLM does not close a block by itself.
Tolerances: pixels rtol 2e-3 / atol 3e-4 in fp32 (the denoise loop's bound,
tests/test_unclip.py:225); PNG bytes of the two packages one 8-bit level
apart at most (a pixel within the loop's bound may round to either side).
"""
import base64
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import unclip as JU
from seed_tpu.serving import multimodal as JMM
from seed_tpu.serving import server as JSRV
from seed_tpu_torch import BOI_TOKEN_ID, EOI_TOKEN_ID, IMAGE_ID_SHIFT, IMG_FLAG
from seed_tpu_torch import bridge
from seed_tpu_torch.models import llama as TM
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import unclip as TU
from seed_tpu_torch.serving import multimodal as TMM
from seed_tpu_torch.serving import server as TSRV
from seed_tpu_torch.serving.offload import OffloadedParams
from seed_tpu_torch.utils.checkpoint import save_checkpoint
from seed_tpu_torch.utils.tree import leaves_with_path

LOOP = dict(rtol=2e-3, atol=3e-4)
STEPS = 3
CODES = [(11 * i + 5) % 64 for i in range(32)]
TEXT_IDS = [ord(c) + 3 for c in "look: "]
STREAM = (TEXT_IDS + [BOI_TOKEN_ID] + [c + IMAGE_ID_SHIFT for c in CODES]
          + [EOI_TOKEN_ID] + [ord(c) + 3 for c in " done"])
SIDE = TU.TINY_UNCLIP.latent_size * TU.TINY_UNCLIP.vae.upscale     # 16


def tokenizer_cfgs():
    """TINY_TOKENIZER with 32 queries (a block of 32 codes decodes) and
    TINY_UNCLIP's embedding width."""
    return [dataclasses.replace(c, image_embed_dim=5, qformer=dataclasses.replace(
        c.qformer, query_len=32)) for c in (JST.TINY_TOKENIZER,
                                            TST.TINY_TOKENIZER)]


def seeded(shapes, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(lambda s: (0.3 * rs.randn(*s.shape)).astype(np.float32),
                        shapes)


def png_pixels(b64: str) -> np.ndarray:
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    assert img.format == "PNG" and img.mode == "RGB"
    return np.asarray(img)


class FixedEngine:
    """Stands in for the LLM: every request generates ``STREAM``."""

    def generate(self, prompts, gen, seed=0):
        return [list(STREAM) for _ in prompts]


@pytest.fixture(scope="module")
def pair():
    """seed_tpu's and the port's service on the same tokenizer and unCLIP
    weights, fp32 decoders on the same latents."""
    jcfg, tcfg = tokenizer_cfgs()
    jtok = JST.init_seed_tokenizer(jax.random.PRNGKey(1), jcfg)
    shapes = jax.eval_shape(lambda k: JU.init_unclip(k, JU.TINY_UNCLIP),
                            jax.random.PRNGKey(0))
    unclip = seeded(shapes, 2)
    unclip["image_normalizer"]["std"] = np.abs(unclip["image_normalizer"]["std"]) + 0.5
    jdec = JU.UnCLIPDecoder(jax.tree.map(jnp.asarray, unclip), JU.TINY_UNCLIP,
                            num_inference_steps=STEPS, dtype=jnp.float32)
    tdec = TU.UnCLIPDecoder(bridge.unclip_from_seed_tpu(unclip, device="cpu"),
                            TU.TINY_UNCLIP, num_inference_steps=STEPS,
                            dtype=torch.float32, device="cpu")
    tdec.latents = torch.from_numpy(np.array(jdec.latents))
    jsvc = JSRV.GenerateService(JMM.SeedLlamaInterface(
        FixedEngine(), jtok, jcfg, diffusion=jdec))
    tiface = TMM.SeedLlamaInterface(
        FixedEngine(), bridge.from_seed_tpu(jax.tree.map(np.asarray, jtok),
                                            device="cpu"),
        tcfg, diffusion=tdec, device="cpu")
    return jsvc, TSRV.GenerateService(tiface)


def test_generate_returns_the_png(pair):
    """One generated block -> one base64 PNG of latent_size * upscale
    pixels a side, its 32 ids in images_ids, IMG_FLAG in the text; the
    same response as seed_tpu's, pixels one level apart at most."""
    jsvc, tsvc = pair
    req = {"text": "draw a cat", "max_new_tokens": 40}
    got, want = tsvc.generate(dict(req)), jsvc.generate(dict(req))
    assert got["error_msg"] == [] and got["images_ids"] == [CODES]
    assert got["text"] == want["text"] == f"look: {IMG_FLAG} done"
    assert got["images_ids"] == want["images_ids"]
    assert len(got["images"]) == 1 and got["images"][0]
    pixels = png_pixels(got["images"][0])
    assert pixels.shape == (SIDE, SIDE, 3)
    diff = np.abs(pixels.astype(int) - png_pixels(want["images"][0]).astype(int))
    assert diff.max() <= 1


def test_png_holds_the_decoders_pixels(pair):
    """The PNG is the decoder's output for the block's embedding, rounded
    to 8 bits the way encode_image_b64 rounds."""
    _, tsvc = pair
    iface = tsvc.iface
    emb = TST.decode_embedding(iface.tok_params, torch.tensor([CODES]),
                               iface.tok_cfg).numpy()
    want = (np.clip(iface.diffusion.generate(emb)[0], 0, 1) * 255).astype(np.uint8)
    got = png_pixels(tsvc.generate({"text": "x"})["images"][0])
    np.testing.assert_array_equal(got, want)


def test_split_output_carries_pixels(pair):
    """Segment.image holds the pixels, image_embedding stays None; the
    pixels equal seed_tpu's split_output within the loop's tolerance."""
    jsvc, tsvc = pair
    segs = tsvc.iface.split_output(STREAM)
    assert [s.kind for s in segs] == ["text", "image", "text"]
    img = segs[1]
    assert img.image_embedding is None
    assert img.image_codes.tolist() == [CODES]
    assert img.image.shape == (1, SIDE, SIDE, 3) and img.image.dtype == np.float32
    assert 0.0 <= img.image.min() and img.image.max() <= 1.0
    want = jsvc.iface.split_output(STREAM)[1].image
    np.testing.assert_allclose(img.image, want, **LOOP)


def test_without_a_decoder_the_image_is_an_embedding(pair):
    _, tsvc = pair
    iface = TMM.SeedLlamaInterface(FixedEngine(), tsvc.iface.tok_params,
                                   tsvc.iface.tok_cfg, device="cpu")
    seg = iface.split_output(STREAM)[1]
    assert seg.image is None and seg.image_embedding.shape == (1, 5)
    out = TSRV.GenerateService(iface).generate({"text": "x"})
    assert out["images"] == [""] and out["images_ids"] == [CODES]


# -------------------------- the entry point's flag --------------------------

def test_main_reads_diffusion_ckpt(monkeypatch):
    seen = {}
    monkeypatch.setattr(TSRV, "build_service", lambda args: seen.update(
        vars(args)) or "svc")
    monkeypatch.setattr(TSRV, "serve", lambda svc, host, port: None)
    TSRV.main(["--diffusion-ckpt", "ckpts/unclip", "--offload"])
    assert seen["diffusion_ckpt"] == "ckpts/unclip" and seen["offload"]
    TSRV.main([])
    assert seen["diffusion_ckpt"] is None


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Tiny LLM (the server's --model tiny shape), tokenizer and unCLIP
    checkpoints."""
    root = tmp_path_factory.mktemp("ckpt")
    gen = torch.Generator().manual_seed(0)
    llm_cfg = TM.LlamaConfig(vocab_size=40194, dim=256, layers=2, heads=4,
                             kv_heads=4, ffn_dim=512, max_seq_len=1024)
    paths = {k: str(root / k) for k in ("llm", "tok", "unclip")}
    save_checkpoint(paths["llm"], TM.init_llama(gen, llm_cfg, torch.float32,
                                                "cpu"))
    save_checkpoint(paths["tok"], TST.init_seed_tokenizer(
        gen, TST.TINY_TOKENIZER, device="cpu"))
    unclip = TU.init_unclip(gen, TU.TINY_UNCLIP, device="cpu")
    save_checkpoint(paths["unclip"], unclip)
    return paths, unclip


@pytest.mark.parametrize("offload", [False, True])
def test_build_service_attaches_the_decoder(monkeypatch, checkpoints, offload):
    """main -> build_service with --diffusion-ckpt: an SD2.1 UnCLIPDecoder
    on the checkpoint's weights (held on the host under --offload); without
    the flag, no decoder."""
    paths, unclip = checkpoints
    built = []
    monkeypatch.setattr(TSRV, "serve", lambda svc, host, port: built.append(svc))
    argv = ["--model", "tiny", "--device", "cpu", "--llm-ckpt", paths["llm"],
            "--tokenizer-ckpt", paths["tok"]] + (["--offload"] if offload else [])
    TSRV.main(argv + ["--diffusion-ckpt", paths["unclip"]])
    TSRV.main(argv)
    dec = built[0].iface.diffusion
    assert isinstance(dec, TU.UnCLIPDecoder) and dec.cfg == TU.SD21_UNCLIP
    assert isinstance(dec._params, OffloadedParams) == offload
    got, want = leaves_with_path(dec.params), leaves_with_path(unclip)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(got, want))
    assert built[1].iface.diffusion is None
