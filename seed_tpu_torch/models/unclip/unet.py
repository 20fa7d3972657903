"""UNet2DCondition of the unCLIP de-tokenizer (counterpart of
seed_tpu/models/unclip/unet.py).

The stable-diffusion-2-1-unclip denoiser: 4-channel latents, block channels
(320, 640, 1280, 1280), 2 layers per block, cross-attention dim 1024, linear
transformer projections, and ``class_embed_type="projection"``: the noised
CLIP image embedding ++ its noise-level embedding goes through a
TimestepEmbedding MLP and is ADDED to the time embedding.

Layout. Activations are NHWC tensors, as in seed_tpu, so the public edges
(latents [B, h, w, 4] in and out) and every reshape to tokens match it. A
convolution hands ``F.conv2d`` the NCHW view of an NHWC tensor, which is an
NCHW tensor in ``channels_last`` memory, and gets one back in the same
memory, so no activation is copied around a conv. Conv kernels are torch's
OIHW [out, in, kh, kw], stored ``channels_last`` too (``init_conv``, the
bridge and the converters make them so) so that cuDNN never reformats a
weight per call. Padding is symmetric by ``kh // 2`` at every stride, as
seed_tpu (and torch) pad.

GroupNorm keeps seed_tpu's op order: fp32 statistics, the variance as the
mean of squared deviations, fp32 affine, one cast back. In bf16 on the card
(``ops/group_norm.group_norm_route``) it runs the hand-written GroupNorm
kernel, which also applies the SiLU that follows 45 of a pass's 61 norms
(``silu=True``) before its one rounding; fp32 and the CPU run the plain
chain and then ``F.silu``. Attention goes through
``flash_attention.unmasked_attention``: in bf16 on the card the
self-attention of levels 0-2 (576 tokens and more) runs the tiled flash
forward kernel; the mid block's 144 tokens, every cross-attention (77
keys), fp32 and the CPU run the plain ``mha``.

Spans (``utils/metrics_logging.span``, recorded only under a profiler): one
``unet`` a pass; inside it ``resnet``, ``group_norm`` (with its fused SiLU;
the VAE's too), ``self_attention`` (attn1 with its projections),
``cross_attention`` (attn2) and ``ff`` (the GEGLU MLP).

``unet_apply`` enqueues its ~1,710 launches one by one. A resident decoder
on the card runs it so only to capture a CUDA graph, then replays that
graph each step (``pipeline.CapturedUNetPass``); it runs eagerly on the
CPU, with offloaded weights and under a profiler, where the spans above
are what a traced call is read by.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops.flash_attention import unmasked_attention
from ...ops.group_norm import (group_norm_kernel, group_norm_plain,
                               group_norm_route)
from ...utils.metrics_logging import span
from .. import layers as L
from .schedulers import timestep_embedding


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 1024
    attention_head_dim: Tuple[int, ...] = (5, 10, 20, 20)  # heads per level
    # which levels have transformer blocks (SD2.x: all but the last down /
    # first up level)
    attn_levels: Tuple[bool, ...] = (True, True, True, False)
    norm_groups: int = 32
    class_embed_input_dim: Optional[int] = 2048   # unCLIP projection input
    time_embed_dim: Optional[int] = None          # default 4*C0

    @property
    def temb_dim(self) -> int:
        return self.time_embed_dim or 4 * self.block_channels[0]


SD21_UNCLIP_UNET = UNetConfig()
TINY_UNET = UNetConfig(block_channels=(8, 16), attention_head_dim=(2, 2),
                       attn_levels=(True, False), layers_per_block=1,
                       cross_attention_dim=12, norm_groups=4,
                       class_embed_input_dim=10)


# ------------------------------- primitives --------------------------------

def conv2d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, H, W, C] -> [B, H', W', O] with p["kernel"] [O, C, kh, kw]."""
    w = p["kernel"]
    kh, kw = w.shape[2:]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), p["bias"].to(x.dtype),
                 stride, (kh // 2, kw // 2))
    return y.permute(0, 2, 3, 1)


def group_norm(p, x: torch.Tensor, groups: int, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm of x [B, H, W, C] with p["scale"], p["bias"], followed by
    SiLU where ``silu``. Where ``group_norm_route`` says so (bf16 on the
    card) one hand-written kernel does both, SiLU on the fp32 value before
    the one rounding; every other call takes the plain chain
    (``group_norm_plain``) and then ``F.silu``, bit for bit as before."""
    with span("group_norm", x):
        if group_norm_route(x, groups):
            return group_norm_kernel(x, p["scale"], p["bias"], groups, eps,
                                     silu)
        y = group_norm_plain(x, p["scale"], p["bias"], groups, eps)
        return F.silu(y) if silu else y


def upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C], each pixel repeated 2x2
    (``jax.image.resize(..., "nearest")`` at exactly 2x)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


def init_conv(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int,
              dtype=torch.float32, device="cuda"):
    fan_in = kh * kw * cin
    k = torch.randn((cout, cin, kh, kw), generator=gen, device=device) \
        / fan_in ** 0.5
    return {"kernel": k.to(dtype).contiguous(memory_format=torch.channels_last),
            "bias": torch.zeros((cout,), dtype=dtype, device=device)}


def init_gn(c: int, dtype=torch.float32, device="cuda"):
    return L.init_layer_norm(c, dtype, device)


# ------------------------------- resnet block ------------------------------

def init_resnet(gen, cin, cout, temb_dim, dtype=torch.float32, device="cuda"):
    p = {
        "norm1": init_gn(cin, dtype, device),
        "conv1": init_conv(gen, 3, 3, cin, cout, dtype, device),
        "time_emb_proj": L.init_linear(gen, temb_dim, cout, dtype=dtype,
                                       device=device),
        "norm2": init_gn(cout, dtype, device),
        "conv2": init_conv(gen, 3, 3, cout, cout, dtype, device),
    }
    if cin != cout:
        p["conv_shortcut"] = init_conv(gen, 1, 1, cin, cout, dtype, device)
    return p


def resnet_apply(p, x, temb, groups):
    with span("resnet", x):
        h = group_norm(p["norm1"], x, groups, silu=True)
        h = conv2d(p["conv1"], h)
        t = L.linear(p["time_emb_proj"], F.silu(temb))
        h = h + t[:, None, None, :].to(h.dtype)
        h = group_norm(p["norm2"], h, groups, silu=True)
        h = conv2d(p["conv2"], h)
        skip = conv2d(p["conv_shortcut"], x) if "conv_shortcut" in p else x
        return skip + h


# --------------------------- transformer block -----------------------------

def init_attention(gen, dim, kv_dim, dtype=torch.float32, device="cuda"):
    lin = lambda i, o, **kw: L.init_linear(gen, i, o, dtype=dtype,
                                           device=device, **kw)
    return {"to_q": lin(dim, dim, bias=False),
            "to_k": lin(kv_dim, dim, bias=False),
            "to_v": lin(kv_dim, dim, bias=False),
            "to_out": lin(dim, dim)}


def attention_apply(p, x, ctx, heads):
    B, N, D = x.shape
    M = ctx.shape[1]
    hd = D // heads
    q = L.linear(p["to_q"], x).reshape(B, N, heads, hd)
    k = L.linear(p["to_k"], ctx).reshape(B, M, heads, hd)
    v = L.linear(p["to_v"], ctx).reshape(B, M, heads, hd)
    o = unmasked_attention(q, k, v).reshape(B, N, D)
    return L.linear(p["to_out"], o)


def init_transformer_block(gen, dim, kv_dim, dtype=torch.float32, device="cuda"):
    return {
        "norm1": L.init_layer_norm(dim, dtype, device),
        "attn1": init_attention(gen, dim, dim, dtype, device),
        "norm2": L.init_layer_norm(dim, dtype, device),
        "attn2": init_attention(gen, dim, kv_dim, dtype, device),
        "norm3": L.init_layer_norm(dim, dtype, device),
        "ff": {"proj": L.init_linear(gen, dim, 8 * dim, dtype=dtype,   # GEGLU
                                     device=device),
               "out": L.init_linear(gen, 4 * dim, dim, dtype=dtype,
                                    device=device)},
    }


def transformer_block_apply(p, x, ctx, heads):
    h = L.layer_norm(p["norm1"], x)
    with span("self_attention", h):
        a = attention_apply(p["attn1"], h, h, heads)
    x = x + a
    h = L.layer_norm(p["norm2"], x)
    with span("cross_attention", h):
        a = attention_apply(p["attn2"], h, ctx, heads)
    x = x + a
    h = L.layer_norm(p["norm3"], x)
    with span("ff", h):
        h = L.linear(p["ff"]["proj"], h)
        a, gate = h.chunk(2, dim=-1)
        h = L.linear(p["ff"]["out"], a * L.gelu(gate))
    return x + h


def init_spatial_transformer(gen, c, kv_dim, dtype=torch.float32, device="cuda"):
    return {
        "norm": init_gn(c, dtype, device),
        "proj_in": L.init_linear(gen, c, c, dtype=dtype, device=device),
        "blocks": [init_transformer_block(gen, c, kv_dim, dtype, device)],
        "proj_out": L.init_linear(gen, c, c, dtype=dtype, device=device),
    }


def spatial_transformer_apply(p, x, ctx, heads, groups):
    B, H, W, C = x.shape
    res = x
    h = group_norm(p["norm"], x, groups)
    h = h.reshape(B, H * W, C)
    h = L.linear(p["proj_in"], h)
    for blk in p["blocks"]:
        h = transformer_block_apply(blk, h, ctx, heads)
    h = L.linear(p["proj_out"], h)
    return res + h.reshape(B, H, W, C)


# ------------------------------ UNet ---------------------------------------

@torch.no_grad()
def init_unet(gen: torch.Generator, cfg: UNetConfig = SD21_UNCLIP_UNET,
              dtype=torch.float32, device="cuda"):
    """Seeded random UNet weights on ``device`` (the card by default); ``gen``
    is a torch.Generator on that device."""
    device = resolve_device(device)
    C = cfg.block_channels
    temb = cfg.temb_dim
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)
    p: dict = {
        "conv_in": init_conv(gen, 3, 3, cfg.in_channels, C[0], dtype, device),
        "time_embedding": {"linear_1": lin(C[0], temb),
                           "linear_2": lin(temb, temb)},
        "down_blocks": [], "up_blocks": [],
        "conv_norm_out": init_gn(C[0], dtype, device),
        "conv_out": init_conv(gen, 3, 3, C[0], cfg.out_channels, dtype, device),
    }
    if cfg.class_embed_input_dim:
        p["class_embedding"] = {"linear_1": lin(cfg.class_embed_input_dim, temb),
                                "linear_2": lin(temb, temb)}

    def transformer(c):
        return init_spatial_transformer(gen, c, cfg.cross_attention_dim,
                                        dtype, device)

    n_levels = len(C)
    for i in range(n_levels):
        cin = C[max(i - 1, 0)]
        cout = C[i]
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block):
            block["resnets"].append(init_resnet(
                gen, cin if j == 0 else cout, cout, temb, dtype, device))
            if cfg.attn_levels[i]:
                block["attentions"].append(transformer(cout))
        if i < n_levels - 1:
            block["downsample"] = init_conv(gen, 3, 3, cout, cout, dtype, device)
        p["down_blocks"].append(block)

    p["mid_block"] = {
        "resnets": [init_resnet(gen, C[-1], C[-1], temb, dtype, device),
                    init_resnet(gen, C[-1], C[-1], temb, dtype, device)],
        "attentions": [transformer(C[-1])],
    }

    for i in reversed(range(n_levels)):
        cout = C[i]
        cskip_bottom = C[max(i - 1, 0)]       # channels of the deepest skip
        block = {"resnets": [], "attentions": []}
        for j in range(cfg.layers_per_block + 1):
            res_skip = cout if j < cfg.layers_per_block else cskip_bottom
            cin_prev = C[min(i + 1, n_levels - 1)] if j == 0 else cout
            block["resnets"].append(init_resnet(
                gen, cin_prev + res_skip, cout, temb, dtype, device))
            if cfg.attn_levels[i]:
                block["attentions"].append(transformer(cout))
        if i > 0:
            block["upsample"] = init_conv(gen, 3, 3, cout, cout, dtype, device)
        p["up_blocks"].append(block)
    return p


def unet_apply(params, latents: torch.Tensor, timesteps: torch.Tensor,
               encoder_hidden_states: torch.Tensor,
               class_labels: Optional[torch.Tensor] = None,
               cfg: UNetConfig = SD21_UNCLIP_UNET) -> torch.Tensor:
    """latents [B,H,W,4] NHWC, timesteps [B], ctx [B,M,kv], class_labels
    [B, class_embed_input_dim] -> noise/v prediction [B,H,W,4]."""
    with span("unet", latents):
        C = cfg.block_channels
        G = cfg.norm_groups

        temb = timestep_embedding(timesteps, C[0], flip_sin_to_cos=True,
                                  downscale_freq_shift=0.0)
        temb = temb.to(latents.dtype)
        te = params["time_embedding"]
        temb = L.linear(te["linear_2"], F.silu(L.linear(te["linear_1"], temb)))
        if class_labels is not None and "class_embedding" in params:
            ce = params["class_embedding"]
            cemb = L.linear(ce["linear_2"], F.silu(
                L.linear(ce["linear_1"], class_labels.to(temb.dtype))))
            temb = temb + cemb          # unCLIP conditioning enters here

        ctx = encoder_hidden_states
        x = conv2d(params["conv_in"], latents)
        skips = [x]
        for i, block in enumerate(params["down_blocks"]):
            heads = cfg.attention_head_dim[i]
            for j, resnet in enumerate(block["resnets"]):
                x = resnet_apply(resnet, x, temb, G)
                if block["attentions"]:
                    x = spatial_transformer_apply(block["attentions"][j], x, ctx,
                                                  heads, G)
                skips.append(x)
            if "downsample" in block:
                x = conv2d(block["downsample"], x, stride=2)
                skips.append(x)

        mid = params["mid_block"]
        x = resnet_apply(mid["resnets"][0], x, temb, G)
        x = spatial_transformer_apply(mid["attentions"][0], x, ctx,
                                      cfg.attention_head_dim[-1], G)
        x = resnet_apply(mid["resnets"][1], x, temb, G)

        n_levels = len(C)
        for bi, block in enumerate(params["up_blocks"]):
            level = n_levels - 1 - bi
            heads = cfg.attention_head_dim[level]
            for j, resnet in enumerate(block["resnets"]):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = resnet_apply(resnet, x, temb, G)
                if block["attentions"]:
                    x = spatial_transformer_apply(block["attentions"][j], x, ctx,
                                                  heads, G)
            if "upsample" in block:
                x = conv2d(block["upsample"], upsample_nearest(x))

        x = group_norm(params["conv_norm_out"], x, G, silu=True)
        return conv2d(params["conv_out"], x)
