"""The port's de-tokenizer against the benchmark's plain fp32 reference
(``h100bench/reference/unclip.py``, diffusers' UNet2DConditionModel,
AutoencoderKL decoder and DDIMScheduler, CLIPTextModel on the empty prompt,
SEED's get_codebook_entry), on the
CPU at TINY_UNCLIP / TINY_TOKENIZER sizes with seeded random weights: every
leaf drawn anew, norms, biases, the image normalizer and the prompt context
included, so that no wiring fault hides behind zeros and ones.

Tolerances, fp32 on both sides. The two differ in op order only: NHWC
against NCHW convolutions, a two-pass GroupNorm and LayerNorm against
torch's, einsum against matmul attention, the noise-level embedding in
float32 against the reference's. One conv or norm rounds at about 1e-7
relative, so one UNet, VAE, text-tower or decode-half pass stays within 2e-5 of its
output's scale; the DDIM step is elementwise, but its terms reach ten times
its output (guidance 10 on unit predictions) and the port's alphas are
float32 against the reference's float64 (1e-5); the noise embedding 1e-6;
the teacher-forced loop compares each step's own pass (2e-5) and the pixels
after the clamp (1e-5).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from seed_tpu_torch.convert import __main__ as C
from seed_tpu_torch.models import seed_tokenizer as ST
from seed_tpu_torch.models import unclip as U
from seed_tpu_torch.models.unclip import pipeline as P
from seed_tpu_torch.models.unclip.schedulers import DDIMScheduler

_REF = Path(__file__).resolve().parents[1] / "h100bench" / "reference" / "unclip.py"
_spec = importlib.util.spec_from_file_location("h100bench_reference_unclip", _REF)
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

CFG = U.TINY_UNCLIP
TOK = dataclasses.replace(ST.TINY_TOKENIZER,
                          image_embed_dim=CFG.image_embed_dim)
STEPS = 2
TEXT = U.CLIPTextConfig(vocab_size=64, hidden=CFG.text_ctx_dim, layers=2,
                        heads=2, mlp_dim=32, max_len=CFG.text_ctx_len)


def spec_of(cfg=CFG, tok=TOK, steps=STEPS, guidance=10.0):
    """The reference's configuration keys (diffusers' names) of a port
    configuration."""
    u, v, s = cfg.unet, cfg.vae, cfg.scheduler
    cross = lambda a, kind: ("CrossAttn" if a else "") + kind
    return {
        "unet": {"block_out_channels": list(u.block_channels),
                 "attention_head_dim": list(u.attention_head_dim),
                 "norm_num_groups": u.norm_groups,
                 "down_block_types": [cross(a, "DownBlock2D")
                                      for a in u.attn_levels],
                 "up_block_types": [cross(a, "UpBlock2D")
                                    for a in reversed(u.attn_levels)]},
        "vae": {"norm_num_groups": v.norm_groups,
                "scaling_factor": v.scaling_factor},
        "scheduler": {"num_train_timesteps": s.num_train_timesteps,
                      "beta_schedule": s.beta_schedule,
                      "beta_start": s.beta_start, "beta_end": s.beta_end,
                      "steps_offset": s.steps_offset,
                      "set_alpha_to_one": s.set_alpha_to_one},
        "pipeline": {"num_inference_steps": steps, "guidance_scale": guidance,
                     "noise_level": 0},
        "tokenizer": {"ln_eps": 1e-6, "decode_heads": tok.decode_heads},
        "text_encoder": {"num_attention_heads": TEXT.heads,
                         "layer_norm_eps": TEXT.ln_eps},
    }


def empty_prompt(text, cfg=TEXT):
    """The port's text tower on the converter's empty-prompt ids."""
    ids = torch.full((1, cfg.max_len), C.CLIP_PAD, dtype=torch.long)
    ids[0, :2] = torch.tensor([C.CLIP_BOS, C.CLIP_EOS])
    return U.clip_text_apply(text, ids, cfg)


def _fill(tree, g):
    """Every leaf of a port tree drawn anew in place."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _fill(v, g)
            continue
        z = torch.randn(v.shape, generator=g)
        if k == "kernel":
            z /= (v.shape[0] if v.dim() == 2 else v[0].numel()) ** 0.5
        elif k == "scale":
            z = 1.0 + 0.1 * z
        elif k == "std":
            z = 0.5 + z.abs()
        elif k != "empty_prompt_embeds":
            z = 0.1 * z if k != "codebook" else 0.6 * z
        v.copy_(z)


@pytest.fixture(scope="module")
def w():
    g = torch.Generator().manual_seed(20)
    unclip = U.init_unclip(g, CFG, device="cpu")
    tok = ST.init_seed_tokenizer(g, TOK, device="cpu")
    text = U.init_clip_text(g, TEXT, device="cpu")
    _fill(unclip, g)
    _fill(tok, g)
    _fill(text, g)
    unclip["empty_prompt_embeds"] = empty_prompt(text)
    return {"tokenizer": tok, "unclip": unclip, "text": text}


def close(got, want, tol):
    """|got - want| within ``tol`` of want's largest magnitude."""
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (err, scale)


def _inputs(seed=21, B=2):
    g = torch.Generator().manual_seed(seed)
    s = CFG.latent_size
    x = torch.randn(B, s, s, 4, generator=g)
    ctx = torch.randn(B, CFG.text_ctx_len, CFG.text_ctx_dim, generator=g)
    labels = torch.randn(B, CFG.unet.class_embed_input_dim, generator=g)
    return x, torch.tensor([951, 1])[:B], ctx, labels


@pytest.mark.parametrize("with_class", [True, False])
def test_unet_pass(w, with_class):
    x, t, ctx, labels = _inputs()
    labels = labels if with_class else None
    got = U.unet_apply(w["unclip"]["unet"], x, t, ctx, labels, CFG.unet)
    want = R.unet(w["unclip"]["unet"], spec_of(), x, t, ctx, labels)
    close(got, want, 2e-5)


def test_vae_decode(w):
    z = torch.randn(1, CFG.latent_size, CFG.latent_size, 4,
                    generator=torch.Generator().manual_seed(22))
    got = U.vae_decode(w["unclip"]["vae"], z / CFG.vae.scaling_factor,
                       CFG.vae)
    want = R.vae_decode(w["unclip"]["vae"], spec_of(), z)
    side = CFG.latent_size * CFG.vae.upscale
    assert got.shape == want.shape == (1, side, side, 3)
    close(got, want, 2e-5)


@pytest.mark.parametrize("steps", [2, 20])
def test_ddim_step_with_guidance(steps):
    """The schedule's timesteps and alphas, then every step of it: the CFG
    combine at guidance 10 and the v-prediction update."""
    sched = R.ddim_schedule(spec_of(steps=steps))
    ts, a_t, a_prev = CFG.scheduler.make_tables(steps, device="cpu")
    assert [t for t, _, _ in sched] == ts.tolist()
    np.testing.assert_allclose([a for _, a, _ in sched], a_t.numpy(), rtol=1e-6)
    np.testing.assert_allclose([a for _, _, a in sched], a_prev.numpy(),
                               rtol=1e-6)
    g = torch.Generator().manual_seed(23)
    for i, (_, at, ap) in enumerate(sched):
        pred = torch.randn(2, 8, 8, 4, generator=g)
        x = torch.randn(1, 8, 8, 4, generator=g)
        pu, pc = pred.chunk(2)
        got = CFG.scheduler.step(pu + 10.0 * (pc - pu), x, a_t[i], a_prev[i])
        want = R.ddim_step(R.guided(pred, 10.0), x, at, ap)
        close(got, want, 1e-5)


def test_decode_embedding(w):
    ids = torch.randint(0, TOK.codebook_size, (3, TOK.qformer.query_len),
                        generator=torch.Generator().manual_seed(24))
    got = ST.decode_embedding(w["tokenizer"], ids, TOK)
    want = R.decode_embedding(w["tokenizer"], spec_of(), ids)
    assert got.shape == want.shape == (3, TOK.image_embed_dim)
    close(got, want, 2e-5)


@pytest.mark.parametrize("converter", [False, True])
def test_text_context(w, converter):
    """The port's empty-prompt context against the reference's text tower,
    ids clamped into the tiny vocabulary on both sides: the fixture's tower,
    and a tower of one head of 64 through the converter's own function
    (which takes heads of 64)."""
    text, spec = w["text"], spec_of()
    if converter:
        cfg = dataclasses.replace(TEXT, hidden=64, heads=1)
        text = U.init_clip_text(torch.Generator().manual_seed(28), cfg,
                                device="cpu")
        _fill(text, torch.Generator().manual_seed(29))
        spec["text_encoder"]["num_attention_heads"] = 1
        got = C.empty_prompt_embeds(text)
    else:
        got = w["unclip"]["empty_prompt_embeds"]
    want = R.text_context(text, spec)
    assert got.shape == want.shape == (1, CFG.text_ctx_len,
                                       text["final_ln"]["scale"].shape[0])
    close(got, want, 2e-5)


def test_noise_image_embeddings(w):
    emb = torch.randn(2, CFG.image_embed_dim,
                      generator=torch.Generator().manual_seed(25))
    got = U.noise_image_embeddings(w["unclip"], emb, 0, None, CFG)
    want = R.noise_image_embeddings(w["unclip"], spec_of(), emb)
    close(got, want, 1e-6)


def test_two_steps_teacher_forced_and_the_pixels(w, monkeypatch):
    """generate_latents over two steps and decode_to_images, held as the
    benchmark's check holds them: each step's guided prediction against the
    reference's at the port's own latent, each update against the
    reference's DDIM step from it, the pixels against the reference VAE on
    the port's final latent; and the reference's own ``compare`` reads
    below fp32's rounding."""
    kept = []
    step = DDIMScheduler.step

    def keep(sched, pred, x, *args):
        kept.append((x, pred))
        return step(sched, pred, x, *args)

    monkeypatch.setattr(DDIMScheduler, "step", keep)
    ids = torch.randint(0, TOK.codebook_size, (1, TOK.qformer.query_len),
                        generator=torch.Generator().manual_seed(26))
    emb = ST.decode_embedding(w["tokenizer"], ids, TOK)
    lat0 = torch.randn(1, CFG.latent_size, CFG.latent_size, 4,
                       generator=torch.Generator().manual_seed(27))
    final = P.generate_latents(w["unclip"], emb, lat0, CFG, STEPS, 10.0)
    images = P.decode_to_images(w["unclip"], final, CFG)
    spec = spec_of()
    ctx = R.text_context(w["text"], spec)
    labels = R.class_labels(w, spec, emb)
    sched = R.ddim_schedule(spec)
    assert len(kept) == STEPS and torch.equal(kept[0][0], lat0)
    outs = [x for x, _ in kept[1:]] + [final]
    for (t, at, ap), (x, pred), nxt in zip(sched, kept, outs):
        ref = R.guided_prediction(w, spec, ctx, labels, x, t)
        close(pred, ref, 2e-5)
        close(nxt, R.ddim_step(ref, x, at, ap), 2e-5)
    pixels = (R.vae_decode(w["unclip"]["vae"], spec, final) * 0.5
              + 0.5).clamp(0, 1)
    close(images, pixels, 1e-5)
    image = U.vae_decode(w["unclip"]["vae"], final / CFG.vae.scaling_factor,
                         CFG.vae)
    r = R.compare(w, spec, [{
        "codes": ids, "embedding": emb, "latents": [x for x, _ in kept],
        "predictions": [p for _, p in kept], "final": final,
        "image": image}])
    assert max(r[k] for k in ("context_err", "embed_err", "step_err",
                              "update_err", "pixel_err")) < 1e-4, r
    assert r["free_run_pixel_diff"]["max"] < 1e-4, r
