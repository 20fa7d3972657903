"""The unCLIP de-tokenizer of seed_tpu_torch against seed_tpu's, on the CPU.

Weights: seed_tpu's own tree (the structure of its ``init_*``, from
``jax.eval_shape``) filled with seeded numpy values, norms, biases, the
image normalizer and the cached prompt context included, so that no wiring
bug hides behind zeros and ones; the port gets them through
``bridge.unclip_from_seed_tpu``. seed_tpu's functions run under ``jax.jit``.

Tolerances, fp32: 1e-6 for the scheduler's arithmetic, 1e-5 for one conv or
norm, 1e-4 for one UNet, VAE or CLIP pass (seed_tpu's single-pass bound,
tests/test_unclip.py:118), rtol 2e-3 / atol 3e-4 for the denoise loop and
the pixels decoded from it (tests/test_unclip.py:225,259).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seed_tpu.models import seed_tokenizer as JST
from seed_tpu.models import unclip as J
from seed_tpu.models.unclip import schedulers as JS
from seed_tpu.models.unclip import unet as JU
from seed_tpu_torch import bridge
from seed_tpu_torch.models import seed_tokenizer as TST
from seed_tpu_torch.models import unclip as T
from seed_tpu_torch.models.unclip import pipeline as TP
from seed_tpu_torch.models.unclip import schedulers as TS
from seed_tpu_torch.models.unclip import unet as TU
from seed_tpu_torch.utils.tree import tree_map

LOOP = dict(rtol=2e-3, atol=3e-4)

j_unet = jax.jit(J.unet_apply, static_argnums=(5,))
j_vae = jax.jit(J.vae_decode, static_argnums=(2,))
j_clip = jax.jit(J.clip_text_apply, static_argnums=(2,))
j_latents = jax.jit(J.generate_latents, static_argnames=(
    "cfg", "num_inference_steps", "guidance_scale", "noise_level"))
j_images = jax.jit(J.decode_to_images, static_argnums=(2,))


def seeded(shapes, seed):
    """A seed_tpu tree of the given shapes with seeded fp32 numpy leaves:
    kernels scaled by fan-in, norm scales near 1, non-zero biases."""
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


def weights(init, cfg, seed):
    """(seed_tpu tree, the port's tree on the CPU) of ``init``'s shapes."""
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    npt = seeded(shapes, seed)
    return npt, bridge.unclip_from_seed_tpu(npt, device="cpu")


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **(tol or dict(rtol=0, atol=1e-4)))


# SD2.1's structural triggers at CPU size: head dim 64 at every attention
# level, 32 norm groups, no attention at the last level, two layers per
# block, the unCLIP class-embedding projection
SD_LIKE = dict(block_channels=(64, 128, 128), attention_head_dim=(1, 2, 2),
               attn_levels=(True, True, False), layers_per_block=2,
               cross_attention_dim=64, norm_groups=32, class_embed_input_dim=32)


@pytest.fixture(scope="module")
def tiny():
    jp, tp = weights(J.init_unclip, J.TINY_UNCLIP, seed=0)
    return jp, tp


@pytest.fixture(scope="module")
def sd_like():
    jcfg = dataclasses.replace(J.TINY_UNET, **SD_LIKE)
    tcfg = dataclasses.replace(T.TINY_UNET, **SD_LIKE)
    jp, tp = weights(J.init_unet, jcfg, seed=1)
    rs = np.random.RandomState(2)
    inputs = (rs.randn(2, 16, 16, 4).astype(np.float32), np.asarray([17, 901]),
              rs.randn(2, 6, 64).astype(np.float32),
              rs.randn(2, 32).astype(np.float32))
    want = np.asarray(j_unet(jp, *inputs, jcfg))
    return tcfg, tp, inputs, want


# ------------------------------ bridge --------------------------------------

def test_bridge_keeps_lists_and_makes_convs_oihw(tiny):
    """unCLIP's ``blocks`` and CLIP's ``layers`` are lists in seed_tpu (not
    stacked trees) and stay lists; conv kernels become OIHW channels_last;
    linear kernels keep [in, out]."""
    jp, tp = tiny
    st = tp["unet"]["down_blocks"][0]["attentions"][0]
    assert isinstance(st["blocks"], list) and len(st["blocks"]) == 1
    conv = tp["unet"]["conv_in"]["kernel"]
    assert conv.shape == (8, 4, 3, 3)
    assert conv.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(
        conv.numpy(), jp["unet"]["conv_in"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tp["vae"]["mid"]["attn"]["to_q"]["kernel"],
                                  jp["vae"]["mid"]["attn"]["to_q"]["kernel"])
    _, text = weights(J.init_clip_text, J.TINY_TEXT, seed=3)
    assert isinstance(text["layers"], list) and len(text["layers"]) == 2


# ----------------------------- schedulers ----------------------------------

@pytest.mark.parametrize("schedule", ["scaled_linear", "linear",
                                      "squaredcos_cap_v2"])
def test_make_betas_equal(schedule):
    np.testing.assert_array_equal(TS.make_betas(1000, schedule),
                                  JS.make_betas(1000, schedule))


@pytest.mark.parametrize("steps", [3, 20, 50])
def test_ddim_tables_equal(steps):
    """Built in float64 and cast once: equal bit for bit."""
    got = T.DDIMScheduler().make_tables(steps, device="cpu")
    want = J.DDIMScheduler().make_tables(steps)
    assert got[0].dtype == torch.int32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("prediction_type,clip", [("v_prediction", False),
                                                  ("epsilon", False),
                                                  ("epsilon", True)])
def test_ddim_step_equal(prediction_type, clip):
    rs = np.random.RandomState(4)
    out, x = rs.randn(2, 4, 4, 4).astype(np.float32), rs.randn(2, 4, 4, 4).astype(np.float32)
    a_t, a_prev = np.float32(0.3), np.float32(0.6)
    got = T.DDIMScheduler(prediction_type=prediction_type, clip_sample=clip
                          ).step(t(out), t(x), t(a_t), t(a_prev))
    want = J.DDIMScheduler(prediction_type=prediction_type, clip_sample=clip
                           ).step(jnp.asarray(out), jnp.asarray(x),
                                  jnp.asarray(a_t), jnp.asarray(a_prev))
    close(got, want, rtol=0, atol=1e-6)


def test_add_noise_equal():
    rs = np.random.RandomState(5)
    x, n = rs.randn(3, 7).astype(np.float32), rs.randn(3, 7).astype(np.float32)
    ts = np.asarray([0, 123, 999])
    close(T.DDPMNoiser().add_noise(t(x), t(n), t(ts)),
          J.DDPMNoiser().add_noise(jnp.asarray(x), jnp.asarray(n),
                                   jnp.asarray(ts)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0.0), (5, True, 0.0),
                                            (32, False, 1.0)])
def test_timestep_embedding_equal(dim, flip, shift):
    """sin and cos of arguments t * freq up to 999 rad: XLA's and torch's
    ``exp`` may give a frequency one fp32 ulp apart, which moves the argument
    by up to 999 * 2**-23 = 1.2e-4; so 2e-4."""
    ts = np.asarray([0, 1, 17, 500, 999])
    close(T.timestep_embedding(t(ts), dim, flip, shift),
          J.timestep_embedding(jnp.asarray(ts), dim, flip, shift),
          rtol=0, atol=2e-4)


# ----------------------------- primitives -----------------------------------

@pytest.mark.parametrize("k,stride,size", [(3, 1, 6), (3, 2, 6), (3, 2, 7),
                                           (1, 1, 5)])
def test_conv2d_equal(k, stride, size):
    """Symmetric padding of k // 2 at stride 2 on even and odd inputs."""
    rs = np.random.RandomState(6)
    x = rs.randn(2, size, size, 3).astype(np.float32)
    p = {"kernel": rs.randn(k, k, 3, 5).astype(np.float32),
         "bias": rs.randn(5).astype(np.float32)}
    tp = bridge.unclip_from_seed_tpu(p, device="cpu")
    want = JU.conv2d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride)
    got = TU.conv2d(tp, t(x), stride)
    assert got.shape == want.shape
    close(got, want, rtol=0, atol=1e-5)


def test_group_norm_equal():
    rs = np.random.RandomState(7)
    x = (3 + 2 * rs.randn(2, 5, 6, 64)).astype(np.float32)
    p = {"scale": rs.randn(64).astype(np.float32),
         "bias": rs.randn(64).astype(np.float32)}
    close(TU.group_norm(tree_map(t, p), t(x), 32),
          JU.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), 32),
          rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_nearest_equals_jax_resize(dtype):
    x = np.random.RandomState(8).randn(2, 5, 3, 4).astype(np.float32)
    xt = t(x).to(dtype)
    want = jax.image.resize(jnp.asarray(xt.float().numpy()), (2, 10, 6, 4),
                            method="nearest")
    got = TU.upsample_nearest(xt)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


# ------------------------------- passes -------------------------------------

@pytest.mark.parametrize("with_class", [True, False])
def test_unet_apply_equal(tiny, with_class):
    jp, tp = tiny
    rs = np.random.RandomState(9)
    lat = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 4, 12).astype(np.float32)
    cls = rs.randn(2, 10).astype(np.float32) if with_class else None
    ts = np.asarray([17, 901])
    want = j_unet(jp["unet"], lat, ts, ctx, cls, J.TINY_UNET)
    got = T.unet_apply(tp["unet"], t(lat), t(ts), t(ctx),
                       None if cls is None else t(cls), T.TINY_UNET)
    close(got, want)


def test_unet_sd21_structure_equal(sd_like):
    tcfg, tp, inputs, want = sd_like
    close(T.unet_apply(tp, *map(t, inputs), tcfg), want)


def test_unet_bf16_pass_within_tolerance(sd_like):
    """The same pass in bf16 (weights and activations) against seed_tpu's
    fp32 output: within 5e-2 of the output's largest magnitude (about 100
    layers deep, each rounding to 2**-8)."""
    tcfg, tp, inputs, want = sd_like
    lat, ts, ctx, cls = map(t, inputs)
    bf = lambda x: x.to(torch.bfloat16)
    got = T.unet_apply(tree_map(bf, tp), bf(lat), ts, bf(ctx), bf(cls), tcfg)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-2, err


def test_unet_self_attention_takes_the_tiled_route_where_it_opens(
        sd_like, monkeypatch):
    """The UNet's attention goes through unmasked_attention. On the CPU its
    route is shut and no call reaches tiled_flash. Opened by shape alone, as
    it opens for bf16 on the card, the five level-0 self-attentions of the
    SD-like bf16 pass (256 tokens, one head of 64: two down, three up) run
    the flash forward's plain version, while level 1 (64 tokens) and every
    cross-attention (6 keys) stay on mha; the pass stays within the 5e-2
    of seed_tpu's fp32 output that the mha pass is held to."""
    from seed_tpu_torch.ops import flash_attention as TF
    tcfg, tp, inputs, want = sd_like
    lat, ts, ctx, cls = map(t, inputs)
    bf = lambda x: x.to(torch.bfloat16)
    args = (tree_map(bf, tp), bf(lat), ts, bf(ctx), bf(cls), tcfg)
    calls = []
    tiled = TF.tiled_flash
    monkeypatch.setattr(TF, "tiled_flash", lambda q, k, v, causal, scale:
                        calls.append((tuple(q.shape), tuple(k.shape), causal,
                                      scale)) or tiled(q, k, v, causal, scale))
    shut = T.unet_apply(*args)
    assert not calls
    monkeypatch.setattr(TF, "tiled_route", lambda q, k: min(
        q.shape[1], k.shape[1]) >= TF.MIN_FLASH_SEQ)
    got = T.unet_apply(*args)
    assert calls == [((2, 256, 1, 64), (2, 256, 1, 64), False, 0.125)] * 5
    assert got.dtype == torch.bfloat16 and not torch.equal(got, shut)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 5e-2, err


def test_vae_decode_equal(tiny):
    jp, tp = tiny
    lat = np.random.RandomState(10).randn(2, 8, 8, 4).astype(np.float32)
    want = j_vae(jp["vae"], lat, J.TINY_VAE)
    got = T.vae_decode(tp["vae"], t(lat), T.TINY_VAE)
    assert got.shape == (2, 8 * T.TINY_VAE.upscale, 8 * T.TINY_VAE.upscale, 3)
    close(got, want)


def test_clip_text_apply_equal():
    jp, tp = weights(J.init_clip_text, J.TINY_TEXT, seed=11)
    ids = np.asarray([[1, 5, 9, 2, 0, 0], [63, 4, 4, 4, 70, 2]])  # 70 clips
    close(T.clip_text_apply(tp, t(ids), T.TINY_TEXT),
          j_clip(jp, ids, J.TINY_TEXT))


@pytest.mark.parametrize("level,with_noise", [(0, False), (123, True)])
def test_noise_image_embeddings_equal(tiny, level, with_noise):
    jp, tp = tiny
    rs = np.random.RandomState(12)
    emb = rs.randn(2, 5).astype(np.float32)
    noise = rs.randn(2, 5).astype(np.float32) if with_noise else None
    want = J.noise_image_embeddings(jp, jnp.asarray(emb), level,
                                    None if noise is None else jnp.asarray(noise),
                                    J.TINY_UNCLIP)
    got = T.noise_image_embeddings(tp, t(emb), level,
                                   None if noise is None else t(noise),
                                   T.TINY_UNCLIP)
    assert got.shape == (2, 10)
    close(got, want, rtol=0, atol=1e-5)


# ---------------------------- the denoise loop ------------------------------

@pytest.fixture(scope="module")
def loop_inputs():
    rs = np.random.RandomState(13)
    return (rs.randn(2, 5).astype(np.float32),
            rs.randn(2, 8, 8, 4).astype(np.float32))


def test_generate_latents_zero_uncond_and_images(tiny, loop_inputs):
    """The zero-uncond CFG branch, then the VAE on the loop's latents."""
    jp, tp = tiny
    emb, lat = loop_inputs
    want = j_latents(jp, emb, lat, cfg=J.TINY_UNCLIP, num_inference_steps=3,
                     guidance_scale=7.5)
    got = T.generate_latents(tp, t(emb), t(lat), T.TINY_UNCLIP, 3, 7.5)
    close(got, want, **LOOP)
    close(T.decode_to_images(tp, got, T.TINY_UNCLIP),
          j_images(jp, want, J.TINY_UNCLIP), **LOOP)


def test_generate_latents_negative_embed_branch(tiny, loop_inputs):
    """The negative-embedding branch at a noise level with explicit embed
    noise, and an explicit prompt context in place of the cached one."""
    jp, tp = tiny
    emb, lat = loop_inputs
    rs = np.random.RandomState(14)
    neg, nz = rs.randn(2, 5).astype(np.float32), rs.randn(2, 5).astype(np.float32)
    ctx = (0.3 * rs.randn(1, 4, 12)).astype(np.float32)
    want = j_latents(jp, emb, lat, cfg=J.TINY_UNCLIP, num_inference_steps=4,
                     guidance_scale=3.0, negative_image_embeds=neg,
                     noise_level=123, embed_noise=nz, prompt_embeds=ctx)
    got = T.generate_latents(tp, t(emb), t(lat), T.TINY_UNCLIP, 4, 3.0,
                             negative_image_embeds=t(neg), noise_level=123,
                             embed_noise=t(nz), prompt_embeds=t(ctx))
    close(got, want, **LOOP)


def test_decoder_generate_equal_on_the_same_latents(tiny):
    """UnCLIPDecoder.generate, fp32, given seed_tpu's latents: torch cannot
    repeat the PRNGKey stream, so the latents are handed across."""
    jp, tp = tiny
    jdec = J.UnCLIPDecoder(jax.tree.map(jnp.asarray, jp), J.TINY_UNCLIP,
                           num_inference_steps=3, guidance_scale=5.0,
                           dtype=jnp.float32)
    tdec = T.UnCLIPDecoder(tp, T.TINY_UNCLIP, num_inference_steps=3,
                           guidance_scale=5.0, dtype=torch.float32,
                           device="cpu")
    tdec.latents = t(jdec.latents)
    emb = np.random.RandomState(15).randn(2, 5).astype(np.float32)
    got, want = tdec.generate(emb), jdec.generate(emb)
    assert got.dtype == np.float32 and got.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(got, want, **LOOP)


def test_decoder_default_bf16_deterministic(tiny):
    """The serving default (bf16, latents from the seed): [0, 1] pixels of
    8 * upscale a side, equal between calls and between decoders of one
    seed."""
    _, tp = tiny
    a = T.UnCLIPDecoder(tp, T.TINY_UNCLIP, num_inference_steps=2, device="cpu")
    b = T.UnCLIPDecoder(tp, T.TINY_UNCLIP, num_inference_steps=2, device="cpu")
    assert a.latents.dtype == torch.bfloat16
    emb = np.random.RandomState(16).randn(1, 5).astype(np.float32)
    img = a.generate(emb)
    assert img.shape == (1, 16, 16, 3) and img.dtype == np.float32
    assert 0.0 <= img.min() and img.max() <= 1.0
    np.testing.assert_array_equal(img, a.generate(emb))
    np.testing.assert_array_equal(img, b.generate(emb))


# --------------------- the UNet pass: graph or eager ------------------------

def test_generate_latents_calls_an_explicit_pass_once_a_step(tiny, loop_inputs):
    """An explicit ``unet_pass`` runs each step's CFG batch, with the
    default's result bit for bit."""
    _, tp = tiny
    emb, lat = loop_inputs
    shapes = []

    def counted(params, lat2, *args):
        shapes.append(tuple(lat2.shape))
        return TU.unet_apply(params, lat2, *args)

    want = T.generate_latents(tp, t(emb), t(lat), T.TINY_UNCLIP, 3, 7.5)
    got = T.generate_latents(tp, t(emb), t(lat), T.TINY_UNCLIP, 3, 7.5,
                             unet_pass=counted)
    assert shapes == [(4, 8, 8, 4)] * 3
    assert torch.equal(got, want)


def test_decoder_on_the_cpu_captures_nothing(tiny, monkeypatch):
    """On the CPU the decoder hands the loop ``unet_apply`` itself and
    captures no graph."""
    _, tp = tiny
    dec = T.UnCLIPDecoder(tp, T.TINY_UNCLIP, num_inference_steps=2,
                          device="cpu")
    loop, passes = TP.generate_latents, []

    def spy(*args, unet_pass, **kwargs):
        passes.append(unet_pass)
        return loop(*args, unet_pass=unet_pass, **kwargs)

    monkeypatch.setattr(TP, "generate_latents", spy)
    img = dec.generate(np.zeros((1, 5), np.float32))
    assert img.shape == (1, 16, 16, 3)
    assert passes == [TU.unet_apply] and dec.unet_graphs.graphs == {}


@pytest.mark.parametrize("device,offload,profiled,want", [
    ("cuda", False, False, True), ("cpu", False, False, False),
    ("cuda", True, False, False), ("cuda", False, True, False)])
def test_replays_unet_only_resident_on_the_card_unprofiled(
        device, offload, profiled, want):
    """Graph or eager follows from the device, the weights' residency and
    whether a profiler records, and from nothing else."""
    with (torch.autograd.profiler.profile() if profiled
          else contextlib.nullcontext()):
        assert TP.replays_unet(torch.device(device), offload) is want


# -------------------------- tokenizer round trip ----------------------------

def test_encode_to_embedding_equal():
    """TINY_TOKENIZER in fp32: the same ids, embeddings within 1e-5."""
    shapes = jax.eval_shape(lambda k: JST.init_seed_tokenizer(
        k, JST.TINY_TOKENIZER), jax.random.PRNGKey(0))
    jp = seeded(shapes, 17)
    tp = bridge.from_seed_tpu(jp, device="cpu")
    x = np.random.RandomState(18).randn(3, 28, 28, 3).astype(np.float32)
    jids, jemb = jax.jit(JST.encode_to_embedding, static_argnums=(2,))(
        jp, x, JST.TINY_TOKENIZER)
    tids, temb = TST.encode_to_embedding(tp, t(x), TST.TINY_TOKENIZER)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    close(temb, jemb, rtol=0, atol=1e-5)


# ------------------------------ entry points --------------------------------

@pytest.mark.parametrize("entry", ["init_unclip", "init_unet", "init_vae_decoder",
                                   "init_clip_text", "UnCLIPDecoder"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without CUDA the default device raises; nothing falls back to the
    CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator()
    calls = {"init_unclip": lambda: T.init_unclip(gen, T.TINY_UNCLIP),
             "init_unet": lambda: T.init_unet(gen, T.TINY_UNET),
             "init_vae_decoder": lambda: T.init_vae_decoder(gen, T.TINY_VAE),
             "init_clip_text": lambda: T.init_clip_text(gen, T.TINY_TEXT),
             "UnCLIPDecoder": lambda: T.UnCLIPDecoder({}, T.TINY_UNCLIP)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_init_unclip_shapes_match_seed_tpu():
    """The port's seeded init makes seed_tpu's tree, conv kernels in OIHW."""
    tp = T.init_unclip(torch.Generator().manual_seed(0), T.TINY_UNCLIP,
                       device="cpu")
    shapes = jax.eval_shape(lambda k: J.init_unclip(k, J.TINY_UNCLIP),
                            jax.random.PRNGKey(0))
    want = bridge.unclip_from_seed_tpu(seeded(shapes, 0), device="cpu")
    assert (jax.tree.structure(tree_map(lambda x: 0, tp))
            == jax.tree.structure(tree_map(lambda x: 0, want)))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dim() == 4:
            assert a.is_contiguous(memory_format=torch.channels_last)
