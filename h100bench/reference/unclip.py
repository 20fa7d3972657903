"""Plain fp32 reference of the SEED de-tokenizer: 32 codes -> pixels.

What it computes, from the benchmark's own weights (the configuration's
diffusers keys say the sizes):

- the text context, ``CLIPTextModel`` (23 layers, causal, final LayerNorm,
  exact GELU) on the empty prompt: the ids ``<|startoftext|>``,
  ``<|endoftext|>``, then SD 2.1's pad id 0 to the context's length;
- the tokenizer's decode half, SEED's ``get_codebook_entry``: the codebook
  rows of the codes, ``decode_task`` (linear, tanh, linear), the image
  positions, four pre-norm ViT blocks (full qkv bias, LayerNorm eps 1e-6,
  erf GELU), ``image_down`` (three linears without bias, ReLU between) and
  ``distill_image_proj`` -> the unCLIP image embedding;
- ``StableUnCLIPImg2ImgPipeline.noise_image_embeddings``: the normalizer,
  DDPM ``add_noise`` (squaredcos_cap_v2) at the noise level, the inverse
  normalizer, and the sinusoidal noise-level embedding appended;
- diffusers' ``UNet2DConditionModel`` with ``class_embed_type`` projection
  and linear-projection transformer blocks (GEGLU), in NCHW;
- one ``DDIMScheduler`` step (v-prediction, eta 0, "leading" spacing with
  ``steps_offset``) and the classifier-free guidance combine;
- the ``AutoencoderKL`` decoder (``post_quant_conv`` and ``Decoder``).

Departures, each a property of the program under test that the reference
shares so that the comparison sees only rounding:

- the embedding's DDPM noise is zero: diffusers draws it at every noise
  level, and at level 0 it would add sqrt(1 - alphas_cumprod[0]) = 0.0064
  of a unit draw; SEED calls the pipeline at noise level 0;
- codes outside the codebook, and token ids outside a vocabulary smaller
  than CLIP's, clamp to the nearest row (at the published sizes none is);
- GroupNorm epsilon: diffusers uses 1e-6 in ``Transformer2DModel`` and in
  the VAE decoder, 1e-5 in the UNet's resnets; the program uses 1e-5
  everywhere, and so does this reference, a relative change of about
  1e-5 / var at each such norm, far below any limit of the check.

Plain PyTorch in fp32 with TF32 off, attention in blocks of query rows so
that it fits on the card beside the program. It imports nothing of the
program and reads only tensors it is handed.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0
ATTN_BLOCK_BYTES = 1 << 29      # fp32 scores of one block of query rows
GN_EPS = 1e-5


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per row of its last axis."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


class Net:
    """The reference's layers over one weight tree; ``act`` rounds every
    weight product's activation operand (identity, or ``fp8_rows`` for the
    control: linear inputs by token, conv inputs by pixel)."""

    def __init__(self, act: Callable = _same):
        self.act = act

    def linear(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        y = self.act(x) @ _f(p["kernel"])
        return y + _f(p["bias"]) if "bias" in p else y

    def conv(self, p: dict, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        """x NCHW; the kernel OIHW, padded by half its size."""
        a = self.act(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        k = p["kernel"].shape[-1]
        return F.conv2d(a, _f(p["kernel"]), _f(p["bias"]), stride, k // 2)

    @staticmethod
    def group_norm(p: dict, x: torch.Tensor, groups: int) -> torch.Tensor:
        return F.group_norm(x, groups, _f(p["scale"]), _f(p["bias"]), GN_EPS)

    @staticmethod
    def layer_norm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], _f(p["scale"]), _f(p["bias"]), eps)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [B, N, C] tokens, non-causal, in
    blocks of query rows of at most ``ATTN_BLOCK_BYTES`` of scores."""
    B, N, C = q.shape
    M, d = k.shape[1], C // heads
    q = q.view(B, N, heads, d).transpose(1, 2)
    k = k.view(B, M, heads, d).transpose(1, 2)
    v = v.view(B, M, heads, d).transpose(1, 2)
    rows = max(1, ATTN_BLOCK_BYTES // (4 * B * heads * M))
    out = []
    for a in range(0, N, rows):
        s = q[:, :, a:a + rows] @ k.transpose(-1, -2) * d ** -0.5
        out.append(s.softmax(-1) @ v)
    return torch.cat(out, 2).transpose(1, 2).reshape(B, N, C)


# -------------------------------- text context -------------------------------

CLIP_BOS, CLIP_EOS, CLIP_PAD = 49406, 49407, 0


def text_context(w: dict, spec: dict, act: Callable = _same) -> torch.Tensor:
    """The CLIP text tower on the empty prompt -> [1, T, hidden], after the
    final LayerNorm."""
    te = spec["text_encoder"]
    n = Net(act)
    eps, heads = te["layer_norm_eps"], te["num_attention_heads"]
    tokens = _f(w["token_embedding"]["embedding"])
    pos = _f(w["position_embedding"]["embedding"])
    T = pos.shape[0]
    ids = torch.full((T,), CLIP_PAD, dtype=torch.long, device=tokens.device)
    ids[0], ids[1] = CLIP_BOS, CLIP_EOS
    h = (tokens[ids.clamp(0, tokens.shape[0] - 1)] + pos)[None]
    d = h.shape[-1] // heads
    future = torch.ones(T, T, dtype=torch.bool, device=h.device).triu(1)
    split = lambda y: y.view(1, T, heads, d).transpose(1, 2)
    for lp in w["layers"]:
        a = n.layer_norm(lp["ln1"], h, eps)
        q, k, v = (split(n.linear(lp[x], a)) for x in "qkv")
        s = (q @ k.transpose(-1, -2) * d ** -0.5).masked_fill(future,
                                                              -math.inf)
        o = (s.softmax(-1) @ v).transpose(1, 2).reshape(1, T, -1)
        h = h + n.linear(lp["out"], o)
        a = n.layer_norm(lp["ln2"], h, eps)
        h = h + n.linear(lp["fc2"], F.gelu(n.linear(lp["fc1"], a)))
    return n.layer_norm(w["final_ln"], h, eps)


# ------------------------- the tokenizer's decode half -----------------------

def decode_embedding(w: dict, spec: dict, codes: torch.Tensor,
                     act: Callable = _same) -> torch.Tensor:
    """codes [B, Q] -> the unCLIP image embedding [B, image_embed_dim]."""
    t = spec["tokenizer"]
    n = Net(act)
    cb = _f(w["vq"]["codebook"])
    z = cb[codes.long().clamp(0, cb.shape[0] - 1)]
    h = n.linear(w["decode_task"]["fc2"],
                 torch.tanh(n.linear(w["decode_task"]["fc1"], z)))
    h = h + _f(w["pos_embed_image"])
    eps, heads = t["ln_eps"], t["decode_heads"]
    for blk in w["blocks_image"]:
        a = n.layer_norm(blk["norm1"], h, eps)
        q, k, v = n.linear(blk["attn"]["qkv"], a).chunk(3, dim=-1)
        h = h + n.linear(blk["attn"]["proj"], attend(q, k, v, heads))
        a = n.layer_norm(blk["norm2"], h, eps)
        h = h + n.linear(blk["mlp"]["fc2"],
                         F.gelu(n.linear(blk["mlp"]["fc1"], a)))
    d = w["image_down"]
    h = torch.relu(n.linear(d["fc1"], h))
    h = torch.relu(n.linear(d["fc2"], h))
    h = n.linear(d["fc3"], h).reshape(h.shape[0], -1)
    return n.linear(w["distill_image_proj"], h)


# ------------------------------ schedules ------------------------------------

def _betas(n: int, schedule: str, start: float = 0.0, end: float = 0.0
           ) -> np.ndarray:
    if schedule == "scaled_linear":
        return np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2
    if schedule == "squaredcos_cap_v2":
        bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - bar((i + 1) / n) / bar(i / n), 0.999)
                         for i in range(n)])
    raise ValueError(schedule)


def ddim_schedule(spec: dict) -> List[tuple]:
    """(timestep, alpha_cumprod at it, at the previous step) for each of the
    pipeline's steps, in float64."""
    s, steps = spec["scheduler"], spec["pipeline"]["num_inference_steps"]
    n = s["num_train_timesteps"]
    ac = np.cumprod(1.0 - _betas(n, s["beta_schedule"], s["beta_start"],
                                 s["beta_end"]))
    ratio = n // steps
    out = []
    for i in range(steps):
        t = (steps - 1 - i) * ratio + s["steps_offset"]
        prev = t - ratio
        a_prev = ac[prev] if prev >= 0 else (
            1.0 if s["set_alpha_to_one"] else ac[0])
        out.append((t, float(ac[t]), float(a_prev)))
    return out


def ddim_step(v: torch.Tensor, x: torch.Tensor, a_t: float,
              a_prev: float) -> torch.Tensor:
    """x_t -> x_{t-1} from a v-prediction, eta 0."""
    x0 = a_t ** 0.5 * x - (1 - a_t) ** 0.5 * v
    eps = a_t ** 0.5 * v + (1 - a_t) ** 0.5 * x
    return a_prev ** 0.5 * x0 + (1 - a_prev) ** 0.5 * eps


def guided(pred: torch.Tensor, scale: float) -> torch.Tensor:
    """The CFG combine of a [uncond; cond] batch of predictions."""
    pu, pc = pred.chunk(2)
    return pu + scale * (pc - pu)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers' ``get_timestep_embedding``, flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    a = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(a), torch.sin(a)], -1)
    return F.pad(emb, (0, dim % 2))


def noise_image_embeddings(w: dict, spec: dict, emb: torch.Tensor
                           ) -> torch.Tensor:
    """[B, D] -> [B, 2D]: the embedding noised at the pipeline's level (zero
    noise), then its noise-level embedding."""
    level = spec["pipeline"]["noise_level"]
    ac = np.cumprod(1.0 - _betas(1000, "squaredcos_cap_v2"))[level]
    norm = w["image_normalizer"]
    mean, std = _f(norm["mean"]), _f(norm["std"])
    x = (emb.float() - mean) / std * ac ** 0.5 * std + mean
    t = torch.full((emb.shape[0],), level, device=emb.device)
    return torch.cat([x, timestep_embedding(t, emb.shape[-1])], 1)


# --------------------------------- UNet --------------------------------------

def _resnet(n: Net, p: dict, x, temb, groups: int):
    h = n.conv(p["conv1"], F.silu(n.group_norm(p["norm1"], x, groups)))
    h = h + n.linear(p["time_emb_proj"], F.silu(temb))[:, :, None, None]
    h = n.conv(p["conv2"], F.silu(n.group_norm(p["norm2"], h, groups)))
    return (n.conv(p["conv_shortcut"], x) if "conv_shortcut" in p else x) + h


def _transformer(n: Net, p: dict, x, ctx, heads: int, groups: int):
    """``Transformer2DModel`` with linear projections and one
    ``BasicTransformerBlock``."""
    B, C, H, W = x.shape
    h = n.group_norm(p["norm"], x, groups).permute(0, 2, 3, 1).reshape(
        B, H * W, C)
    h = n.linear(p["proj_in"], h)
    for blk in p["blocks"]:
        for attn, norm, kv in (("attn1", "norm1", None), ("attn2", "norm2", ctx)):
            a = n.layer_norm(blk[norm], h)
            kv = a if kv is None else kv
            at = blk[attn]
            o = attend(n.linear(at["to_q"], a), n.linear(at["to_k"], kv),
                       n.linear(at["to_v"], kv), heads)
            h = h + n.linear(at["to_out"], o)
        a, gate = n.linear(blk["ff"]["proj"],
                           n.layer_norm(blk["norm3"], h)).chunk(2, -1)
        h = h + n.linear(blk["ff"]["out"], a * F.gelu(gate))
    h = n.linear(p["proj_out"], h)
    return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def unet(w: dict, spec: dict, latents: torch.Tensor, t: torch.Tensor,
         ctx: torch.Tensor, class_labels: Optional[torch.Tensor],
         act: Callable = _same) -> torch.Tensor:
    """latents [B, h, w, 4] (NHWC at the edges), timesteps [B], the text
    context [B, M, 1024], class labels [B, 2048] -> the prediction, NHWC."""
    u = spec["unet"]
    n = Net(act)
    C, G = u["block_out_channels"], u["norm_num_groups"]
    heads = u["attention_head_dim"]
    temb = timestep_embedding(t, C[0])
    te = w["time_embedding"]
    temb = n.linear(te["linear_2"], F.silu(n.linear(te["linear_1"], temb)))
    if class_labels is not None:
        ce = w["class_embedding"]
        temb = temb + n.linear(ce["linear_2"], F.silu(
            n.linear(ce["linear_1"], class_labels.float())))
    ctx = ctx.float()
    x = n.conv(w["conv_in"], latents.float().permute(0, 3, 1, 2))
    skips = [x]
    for i, blk in enumerate(w["down_blocks"]):
        cross = u["down_block_types"][i].startswith("CrossAttn")
        for j, r in enumerate(blk["resnets"]):
            x = _resnet(n, r, x, temb, G)
            if cross:
                x = _transformer(n, blk["attentions"][j], x, ctx, heads[i], G)
            skips.append(x)
        if "downsample" in blk:
            x = n.conv(blk["downsample"], x, stride=2)
            skips.append(x)
    mid = w["mid_block"]
    x = _resnet(n, mid["resnets"][0], x, temb, G)
    x = _transformer(n, mid["attentions"][0], x, ctx, heads[-1], G)
    x = _resnet(n, mid["resnets"][1], x, temb, G)
    for i, blk in enumerate(w["up_blocks"]):
        level = len(C) - 1 - i
        cross = u["up_block_types"][i].startswith("CrossAttn")
        for j, r in enumerate(blk["resnets"]):
            x = _resnet(n, r, torch.cat([x, skips.pop()], 1), temb, G)
            if cross:
                x = _transformer(n, blk["attentions"][j], x, ctx, heads[level],
                                 G)
        if "upsample" in blk:
            x = n.conv(blk["upsample"], F.interpolate(x, scale_factor=2,
                                                      mode="nearest"))
    x = n.conv(w["conv_out"], F.silu(n.group_norm(w["conv_norm_out"], x, G)))
    return x.permute(0, 2, 3, 1)


# ------------------------------ VAE decoder ----------------------------------

def vae_decode(w: dict, spec: dict, latents: torch.Tensor,
               act: Callable = _same) -> torch.Tensor:
    """Latents [B, h, w, 4] as the denoise loop leaves them (scaled) ->
    the decoder's output [B, 8h, 8w, 3] in about [-1, 1], before the
    pipeline's clamp."""
    v = spec["vae"]
    n = Net(act)
    G = v["norm_num_groups"]
    z = latents.float().permute(0, 3, 1, 2) / v["scaling_factor"]
    x = n.conv(w["conv_in"], n.conv(w["post_quant_conv"], z))

    def resnet(p, x):
        h = n.conv(p["conv1"], F.silu(n.group_norm(p["norm1"], x, G)))
        h = n.conv(p["conv2"], F.silu(n.group_norm(p["norm2"], h, G)))
        return (n.conv(p["conv_shortcut"], x) if "conv_shortcut" in p
                else x) + h

    mid = w["mid"]
    x = resnet(mid["resnets"][0], x)
    a = mid["attn"]
    B, C, H, W = x.shape
    h = n.group_norm(a["norm"], x, G).permute(0, 2, 3, 1).reshape(B, H * W, C)
    o = attend(n.linear(a["to_q"], h), n.linear(a["to_k"], h),
               n.linear(a["to_v"], h), 1)
    x = x + n.linear(a["to_out"], o).reshape(B, H, W, C).permute(0, 3, 1, 2)
    x = resnet(mid["resnets"][1], x)
    for blk in w["up_blocks"]:
        for r in blk["resnets"]:
            x = resnet(r, x)
        if "upsample" in blk:
            x = n.conv(blk["upsample"], F.interpolate(x, scale_factor=2,
                                                      mode="nearest"))
    x = n.conv(w["conv_out"], F.silu(n.group_norm(w["conv_norm_out"], x, G)))
    return x.permute(0, 2, 3, 1)


# --------------------------- the whole de-tokenize ---------------------------

def class_labels(w: dict, spec: dict, emb: torch.Tensor) -> torch.Tensor:
    """The CFG batch's class labels: zeros (uncond), then the noised
    embedding (cond)."""
    cond = noise_image_embeddings(w["unclip"], spec, emb)
    return torch.cat([torch.zeros_like(cond), cond])


def guided_prediction(w: dict, spec: dict, ctx: torch.Tensor,
                      labels: torch.Tensor, x: torch.Tensor, t: int,
                      act: Callable = _same) -> torch.Tensor:
    """One step's guided v-prediction at latent ``x`` [B, h, w, 4] and
    timestep ``t``, for the text context ``ctx`` [1, T, D] and the CFG
    batch's ``labels``."""
    B = x.shape[0]
    x = x.float()
    ctx = ctx.float().expand(2 * B, -1, -1)
    ts = torch.full((2 * B,), t, device=x.device)
    pred = unet(w["unclip"]["unet"], spec, torch.cat([x, x]), ts, ctx, labels,
                act)
    return guided(pred, spec["pipeline"]["guidance_scale"])


def generate(w: dict, spec: dict, ctx: torch.Tensor, codes: torch.Tensor,
             latents: torch.Tensor) -> torch.Tensor:
    """The free-running de-tokenize: the text context, codes [B, Q] and the
    initial latents [B, h, w, 4] -> the decoder's output before the
    pipeline's clamp."""
    labels = class_labels(w, spec, decode_embedding(w["tokenizer"], spec,
                                                    codes))
    x = latents.float()
    for t, a_t, a_prev in ddim_schedule(spec):
        x = ddim_step(guided_prediction(w, spec, ctx, labels, x, t), x, a_t,
                      a_prev)
    return vae_decode(w["unclip"]["vae"], spec, x)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative L2 error of ``a`` against ``b``, image by image."""
    a, b = a.float().flatten(1), b.float().flatten(1)
    return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())


def compare(w: dict, spec: dict, answers: list, control: bool = False
            ) -> dict:
    """The timed path's answers against the reference. ``w`` holds the
    weights: ``tokenizer``, ``unclip`` (its ``empty_prompt_embeds`` the
    context the program computed at set-up) and ``text``, the CLIP text
    tower the context came from. Each answer is a dict of one call:
    ``codes`` [B, Q]; ``embedding`` [B, D], the unCLIP embedding the program
    handed to the denoise loop; ``latents``, each step's latent input
    [B, h, w, 4] (the first is the initial latents); ``predictions``, each
    step's guided v-prediction; ``final``, the latent the loop left;
    ``image``, the decoder's output before the clamp.

    - ``context_err``: the relative L2 error of the program's text context
      against the reference's text tower on the empty prompt, which is the
      context every reference UNet pass below takes;
    - ``embed_err``: the widest relative L2 error of the embedding;
    - ``step_err``: the widest relative L2 error of a step's guided
      prediction against the reference UNet's at the program's own latent
      and embedding (teacher-forced: guidance 10 amplifies any difference
      along a free-running trajectory); 1 at least where the program ran
      another number of steps than the configuration's;
    - ``update_err``: the widest relative L2 error of a step's next latent
      (the next step's input, or the final latent after the last step)
      against the reference's DDIM step from that step's latent and the
      program's own guided prediction;
    - ``pixel_err``: the widest |difference| of the decoder's output on the
      program's final latent, over the mean |pixel| of the reference's.

    With ``control`` the reference one precision below bf16 (every
    product's activation operand rounded to fp8 e4m3, one scale a row: the
    DDIM step's latent and prediction too) is the answer, at the same
    inputs. Without it, the widest and mean difference of clamped pixels
    [0, 1] between the program's first answer and a free-running reference
    from its codes and initial latents is added as information."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            return _compare(w, spec, answers, control)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _compare(w, spec, answers, control) -> dict:
    tok, vae = w["tokenizer"], w["unclip"]["vae"]
    sched = ddim_schedule(spec)
    ctx = text_context(w["text"], spec)
    got = (text_context(w["text"], spec, fp8_rows) if control
           else w["unclip"]["empty_prompt_embeds"])
    context_err = _rel(got, ctx)
    embed_err = step_err = update_err = pixel_err = 0.0
    for ans in answers:
        emb_ref = decode_embedding(tok, spec, ans["codes"])
        labels = class_labels(w, spec, ans["embedding"])
        img_ref = vae_decode(vae, spec, ans["final"])
        if control:
            emb = decode_embedding(tok, spec, ans["codes"], fp8_rows)
            img = vae_decode(vae, spec, ans["final"], fp8_rows)
        else:
            emb, img = ans["embedding"], ans["image"]
        embed_err = max(embed_err, _rel(emb, emb_ref))
        pixel_err = max(pixel_err, float((img.float() - img_ref).abs().max()
                                         / img_ref.abs().mean()))
        xs, preds = ans["latents"], ans["predictions"]
        if len(xs) != len(sched):
            step_err = max(step_err, 1.0)   # a step missing or added
        nexts = list(xs[1:]) + [ans["final"]]
        for i, ((t, a_t, a_prev), x) in enumerate(zip(sched, xs)):
            ref = guided_prediction(w, spec, ctx, labels, x, t)
            pred = (guided_prediction(w, spec, ctx, labels, x, t, fp8_rows)
                    if control else preds[i])
            step_err = max(step_err, _rel(pred, ref))
            v, x = preds[i].float(), x.float()
            nxt = (ddim_step(fp8_rows(v), fp8_rows(x), a_t, a_prev) if control
                   else nexts[i])
            update_err = max(update_err, _rel(nxt, ddim_step(v, x, a_t,
                                                             a_prev)))
    out = {"context_err": context_err, "embed_err": embed_err,
           "step_err": step_err, "update_err": update_err,
           "pixel_err": pixel_err, "calls": len(answers)}
    if not control:
        a = answers[0]
        px = lambda y: (y.float() * 0.5 + 0.5).clamp(0, 1)
        d = (px(a["image"]) - px(generate(w, spec, ctx, a["codes"],
                                          a["latents"][0]))).abs()
        out["free_run_pixel_diff"] = {"max": float(d.max()),
                                      "mean": float(d.mean())}
    return out
