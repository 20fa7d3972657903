"""The SEED de-tokenizer (kind ``unclip``): 32 image codes -> pixels through
the port's serving path, closed loop.

The timed call is what ``/generate`` runs for each image segment of a
response: ``serving/multimodal.SeedLlamaInterface.decode_image`` on codes
[B, 32] (a numpy array, as the server hands them over), with no LLM engine
and the diffusion de-tokenizer attached (``UnCLIPDecoder``, resident, no
offload). That is ``models/seed_tokenizer.decode_embedding`` (the codebook,
``decode_task``, four ViT blocks, ``image_down``, ``distill_image_proj``)
to the unCLIP image embedding, copied to the host; then
``UnCLIPDecoder.generate``: the embedding noised at level 0 and put into a
CFG batch beside zeros, the configuration's DDIM v-prediction steps over
the decoder's fixed seeded latents, each a UNet pass at batch 2B with the
guidance combine, then the VAE decoder, the clamp to [0, 1] and the
pixels' copy to the host as float32 [B, H, W, 3].

A configuration of this kind states diffusers' own keys for ``unet``,
``vae``, ``scheduler`` and ``text_encoder``, the tokenizer's decode half
under ``tokenizer``, and the call's ``pipeline`` settings (steps, guidance,
noise level, the latents' seed). The benchmark makes every weight on the
card from ``--seed`` (the trees' layout is the port's own ``init_*``; each
leaf is drawn anew, see ``make_weights``), and computes the empty-prompt
text context once at set-up with the port's CLIP text tower and the
converter's own function. The weights, the text tower's included, go to
the program and to the reference (``reference/unclip.py``); the reference
runs its own text tower on the empty prompt, feeds that context to its UNet
and compares the program's context with it.

The check takes, from every call of the window, what the timed path made:
the embedding handed to the denoise loop, each step's latent input and
guided prediction, the final latent and the decoder's output before the
clamp. It does so by wrapping the module-level functions the path calls
(``pipeline.generate_latents``, ``DDIMScheduler.step``,
``pipeline.vae_decode``) for the cell's lifetime, never by changing the
program. It keeps ``check.calls`` of them, a uniform draw from the seed made
as the calls come (reservoir sampling), so that every other call's tensors
go back to the allocator at once; after the window it compares
``context_err``, ``embed_err``, ``step_err`` (teacher-forced, at the
program's own latents), ``update_err`` (each DDIM update from the
program's own latent and prediction) and ``pixel_err`` of those with the
reference.

Traffic: ``batch`` codes sequences a call from one caller, ``pool``
distinct ones drawn uniform over the codebook and cycled, ``profile``'s
calls profiled in a ``--trace 1`` run.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List

import numpy as np
import torch

from h100bench.core.bench import reference_module
from h100bench.core.work_unclip import detok_flops

CHECKS = ("context_err", "embed_err", "step_err", "update_err", "pixel_err")


def program_config(spec: dict):
    """(the tokenizer's config, the de-tokenizer's config) of the port."""
    from seed_tpu_torch.models.seed_tokenizer import SEED_TOKENIZER
    from seed_tpu_torch.models.unclip import (DDIMScheduler, UnCLIPConfig,
                                              UNetConfig, VAEConfig)
    u, v, s = spec["unet"], spec["vae"], spec["scheduler"]
    t, te = spec["tokenizer"], spec["text_encoder"]
    base = v["block_out_channels"][0]
    cfg = UnCLIPConfig(
        unet=UNetConfig(
            in_channels=u["in_channels"], out_channels=u["out_channels"],
            block_channels=tuple(u["block_out_channels"]),
            layers_per_block=u["layers_per_block"],
            cross_attention_dim=u["cross_attention_dim"],
            attention_head_dim=tuple(u["attention_head_dim"]),
            attn_levels=tuple(b.startswith("CrossAttn")
                              for b in u["down_block_types"]),
            norm_groups=u["norm_num_groups"],
            class_embed_input_dim=u["projection_class_embeddings_input_dim"]),
        vae=VAEConfig(
            latent_channels=v["latent_channels"], base_channels=base,
            channel_mults=tuple(c // base for c in v["block_out_channels"]),
            layers_per_block=v["layers_per_block"],
            norm_groups=v["norm_num_groups"], out_channels=v["out_channels"],
            scaling_factor=v["scaling_factor"]),
        scheduler=DDIMScheduler(
            num_train_timesteps=s["num_train_timesteps"],
            beta_schedule=s["beta_schedule"], beta_start=s["beta_start"],
            beta_end=s["beta_end"], prediction_type=s["prediction_type"],
            set_alpha_to_one=s["set_alpha_to_one"],
            steps_offset=s["steps_offset"], clip_sample=s["clip_sample"]),
        image_embed_dim=t["image_embed_dim"], latent_size=u["sample_size"],
        text_ctx_dim=te["hidden_size"],
        text_ctx_len=te["max_position_embeddings"])
    tok = dataclasses.replace(
        SEED_TOKENIZER,
        qformer=dataclasses.replace(SEED_TOKENIZER.qformer, hidden=t["hidden"],
                                    query_len=t["query_len"]),
        codebook_size=t["codebook_size"], code_dim=t["code_dim"],
        decode_depth=t["decode_depth"], decode_heads=t["decode_heads"],
        image_embed_dim=t["image_embed_dim"],
        use_qformer_image=t["use_qformer_image"])
    return tok, cfg


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@torch.no_grad()
def _redraw(tree, g: torch.Generator, codebook_std: float) -> None:
    """Every leaf drawn anew in place, in the tree's order: kernels (linear
    [in, out], conv [out, in, kh, kw]) std fan_in^-1/2, biases and image
    positions std 0.02, norm scales 1 +- 0.05, the codebook std
    ``codebook_std``. The image normalizer stays the identity, the prompt
    context as it is."""
    for path, x in _leaves(tree):
        name = path[-1]
        if path[0] in ("image_normalizer", "empty_prompt_embeds"):
            continue
        z = torch.randn(x.shape, generator=g, device=x.device)
        if name == "kernel":
            fan_in = x.shape[0] if x.dim() == 2 else x[0].numel()
            z.mul_(fan_in ** -0.5)
        elif name == "scale":
            z.mul_(0.05).add_(1.0)
        elif name == "codebook":
            z.mul_(codebook_std)
        elif name in ("bias", "pos_embed_image"):
            z.mul_(0.02)
        else:
            raise ValueError(f"no draw for the leaf {path}")
        x.copy_(z)


@torch.no_grad()
def make_weights(spec: dict, seed: int, device, dtype) -> dict:
    """{"tokenizer": the decode half, "unclip": UNet, VAE, normalizer and
    the empty-prompt context, "text": the CLIP text tower the context came
    from}, on ``device`` in ``dtype``."""
    from seed_tpu_torch.convert.__main__ import empty_prompt_embeds
    from seed_tpu_torch.models import layers as L
    from seed_tpu_torch.models.unclip import (CLIPTextConfig, init_clip_text,
                                              init_unclip)
    from seed_tpu_torch.models.vit import init_block
    tok_cfg, cfg = program_config(spec)
    t, te = spec["tokenizer"], spec["text_encoder"]
    # the port's init gives the trees' layout; every value is drawn below
    g = torch.Generator(device=device)
    h, d = t["hidden"], t["code_dim"]
    lin = lambda i, o, **kw: L.init_linear(g, i, o, dtype=dtype, device=device,
                                           **kw)
    tok = {
        "vq": {"codebook": torch.empty((t["codebook_size"], d), dtype=dtype,
                                       device=device)},
        "decode_task": {"fc1": lin(d, d), "fc2": lin(d, h)},
        "pos_embed_image": torch.empty((1, t["query_len"], h), dtype=dtype,
                                       device=device),
        "blocks_image": [init_block(g, h, 4 * h, "full", dtype, device)
                         for _ in range(t["decode_depth"])],
        "image_down": {"fc1": lin(h, 256, bias=False),
                       "fc2": lin(256, 128, bias=False),
                       "fc3": lin(128, 32, bias=False)},
        "distill_image_proj": lin(t["query_len"] * 32, t["image_embed_dim"]),
    }
    unclip = init_unclip(g, cfg, dtype, device)
    g.manual_seed(seed)
    std = float(spec["codebook_std"])
    _redraw(tok, g, std)
    _redraw(unclip, g, std)
    text = init_clip_text(g, CLIPTextConfig(
        vocab_size=te["vocab_size"], hidden=te["hidden_size"],
        layers=te["num_hidden_layers"], heads=te["num_attention_heads"],
        mlp_dim=te["intermediate_size"],
        max_len=te["max_position_embeddings"],
        ln_eps=te["layer_norm_eps"]), dtype, device)
    unclip["empty_prompt_embeds"] = empty_prompt_embeds(text).clone()
    return {"tokenizer": tok, "unclip": unclip, "text": text}


class _Keep:
    """What the timed path made, call by call, from wrapped module-level
    functions; ``restore()`` puts the functions back."""

    def __init__(self):
        import seed_tpu_torch.models.unclip.pipeline as P
        from seed_tpu_torch.models.unclip.schedulers import DDIMScheduler
        self.open: dict = {"latents": [], "predictions": []}
        gen, step, vae = P.generate_latents, DDIMScheduler.step, P.vae_decode

        def keep_loop(params, image_embeds, *args, **kwargs):
            x = gen(params, image_embeds, *args, **kwargs)
            self.open.update(embedding=image_embeds, final=x)
            return x

        def keep_step(sched, model_output, sample, *args):
            self.open["latents"].append(sample)
            self.open["predictions"].append(model_output)
            return step(sched, model_output, sample, *args)

        def keep_image(params, latents, cfg):
            y = vae(params, latents, cfg)
            self.open["image"] = y
            return y

        P.generate_latents, DDIMScheduler.step = keep_loop, keep_step
        P.vae_decode = keep_image

        def restore():
            P.generate_latents, DDIMScheduler.step = gen, step
            P.vae_decode = vae

        self.restore = restore

    def take(self) -> dict:
        out, self.open = self.open, {"latents": [], "predictions": []}
        return out


class DetokCell:
    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device, tracer):
        from seed_tpu_torch.models.unclip import UnCLIPDecoder
        from seed_tpu_torch.serving.multimodal import SeedLlamaInterface
        self.config = self.spec = config
        self.mix, self.seed = mix, seed
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.tracer = tracer
        self.batch = int(mix["batch"])
        dtype = getattr(torch, config["dtype"])
        tok_cfg, cfg = program_config(config)
        self.weights = make_weights(config, seed, self.device, dtype)
        p = config["pipeline"]
        self.service = SeedLlamaInterface(
            None, tok_params=self.weights["tokenizer"], tok_cfg=tok_cfg,
            diffusion=UnCLIPDecoder(
                self.weights["unclip"], cfg,
                num_inference_steps=p["num_inference_steps"],
                guidance_scale=p["guidance_scale"], dtype=dtype,
                seed=p["latents_seed"], offload=False, device=self.device),
            device=self.device)
        rng = np.random.default_rng(seed)
        t = config["tokenizer"]
        self.pool = rng.integers(0, t["codebook_size"], (
            int(mix["pool"]), self.batch, t["query_len"])).astype(np.int32)
        self.keep = _Keep()
        self.call = self.service.decode_image
        tracer.wrap(self, "call", "decode",
                    lambda codes: {"images": int(codes.shape[0])})
        self.calls = 0
        # the calls the check will compare: (pool index, pixels, what the
        # path made), a uniform sample of the window's calls drawn from the
        # seed as they come, so that the others' tensors go back to the
        # allocator at once
        self.kept: List[tuple] = []
        self._draw = np.random.default_rng(seed + 7)
        self.profiled = None
        self.attempted = self.failed = 0

    def warm(self) -> None:
        for i in range(2):
            self.call(self.pool[i % len(self.pool)])
        self.keep.take()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def window(self, t_start: float) -> None:
        """One caller, each call after the last has returned, until the
        window's time is up; the window ends with the last call, so the rate
        is over whole calls."""
        tr = self.tracer
        prof = self.mix.get("profile", {})
        p0 = int(prof.get("start_call", 1))
        p1 = p0 + int(prof.get("calls", 1))
        ws = time.perf_counter()
        self.setup_s = ws - t_start
        we = ws + self.seconds
        k = 0
        while time.perf_counter() < we or (tr.profiling and k < p1):
            if tr.on and k == p0:
                tr.start_profile()
            i = k % len(self.pool)
            self._sample(k, (i, self.call(self.pool[i]), self.keep.take()))
            k += 1
            if tr.profiling and k == p1:
                # the raw profile, which the tracer drops once it has read
                # its device operations: the readers of the program's spans
                # link each operation to the host op that launched it
                self.profiled = tr._prof
                tr.stop_profile()
        self.t_end = time.perf_counter()
        self.window_bounds = (ws, self.t_end)
        self.ws = ws
        self.calls = k
        self.attempted = k * self.batch

    def end_to_end(self) -> dict:
        return {"images_per_s": self.calls * self.batch
                / (self.t_end - self.ws), "setup_s": self.setup_s}

    def summary(self) -> dict:
        out = {"calls": self.calls, "images": self.calls * self.batch,
               "window_s": self.t_end - self.ws, "setup_s": self.setup_s,
               "detok_gflop_per_image": detok_flops(self.spec) / 1e9}
        if self.kept:
            _, px, made = self.kept[0]
            out["sampled_call"] = {
                "final_latent_std": float(made["final"].float().std()),
                "image_std": float(made["image"].float().std()),
                "clamped_share": float(((px <= 0) | (px >= 1)).mean())}
        return out

    def release(self) -> None:
        self.keep.restore()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self, k: int, made: tuple) -> None:
        """Reservoir sampling: after call ``k`` (from 0) the kept calls are a
        uniform draw of ``check.calls`` of the calls so far."""
        n = int(self.config["check"]["calls"])
        if k < n:
            self.kept.append(made)
            return
        j = self._draw.integers(0, k + 1)
        if j < n:
            self.kept[j] = made

    def _readings(self, control: bool = False) -> dict:
        answers = []
        for i, _, made in self.kept:
            codes = torch.as_tensor(self.pool[i], device=self.device)
            answers.append(dict(made, codes=codes))
        return reference_module("unclip").compare(
            self.weights, self.spec, answers, control=control)

    def check(self) -> list:
        r = self._readings()
        lim = self.config["check"]
        print(json.dumps({"compared": r}), flush=True)
        return [{"name": k, "value": r[k], "limit": lim[k]}
                for k in CHECKS]

    def control(self) -> dict:
        return self._readings(control=True)


def build(config, mix, seed, seconds, device, tracer) -> DetokCell:
    return DetokCell(config, mix, seed, seconds, device, tracer)
