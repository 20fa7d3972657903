"""AutoencoderKL decoder of SD 2.1 (counterpart of
seed_tpu/models/unclip/vae.py).

latent 4ch -> post_quant_conv 1x1 -> conv_in -> mid (resnet, self-attention,
resnet) -> 4 up levels of 3 resnets with a nearest 2x upsample between ->
GroupNorm -> silu -> conv_out 3ch. Channels (512, 512, 256, 128) going up;
output in [-1, 1]. NHWC activations and channels_last OIHW conv kernels, as
in ``unet``, and its ``group_norm`` (in bf16 on the card the GroupNorm
kernel, each SiLU fused into the norm before it); the mid attention (one
head of 512) goes through ``mha``. One ``vae`` span a decode (its GroupNorms
record ``group_norm`` spans inside).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ... import resolve_device
from ...ops.attention import mha
from ...utils.metrics_logging import span
from .. import layers as L
from .unet import conv2d, group_norm, init_conv, init_gn, upsample_nearest


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 4, 4)   # encoder order
    layers_per_block: int = 2                        # decoder uses +1
    norm_groups: int = 32
    out_channels: int = 3
    scaling_factor: float = 0.18215

    @property
    def upscale(self) -> int:
        """Output pixels per latent a side (8 for SD_VAE)."""
        return 2 ** (len(self.channel_mults) - 1)


SD_VAE = VAEConfig()
TINY_VAE = VAEConfig(base_channels=8, channel_mults=(1, 2), norm_groups=4)


def _init_resnet(gen, cin, cout, dtype, device):
    p = {"norm1": init_gn(cin, dtype, device),
         "conv1": init_conv(gen, 3, 3, cin, cout, dtype, device),
         "norm2": init_gn(cout, dtype, device),
         "conv2": init_conv(gen, 3, 3, cout, cout, dtype, device)}
    if cin != cout:
        p["conv_shortcut"] = init_conv(gen, 1, 1, cin, cout, dtype, device)
    return p


def _resnet(p, x, groups):
    h = group_norm(p["norm1"], x, groups, silu=True)
    h = conv2d(p["conv1"], h)
    h = group_norm(p["norm2"], h, groups, silu=True)
    h = conv2d(p["conv2"], h)
    skip = conv2d(p["conv_shortcut"], x) if "conv_shortcut" in p else x
    return skip + h


def _init_attn(gen, c, dtype, device):
    lin = lambda: L.init_linear(gen, c, c, dtype=dtype, device=device)
    return {"norm": init_gn(c, dtype, device),
            "to_q": lin(), "to_k": lin(), "to_v": lin(), "to_out": lin()}


def _attn(p, x, groups):
    B, H, W, C = x.shape
    h = group_norm(p["norm"], x, groups).reshape(B, H * W, C)
    q = L.linear(p["to_q"], h)[:, :, None, :]   # single head
    k = L.linear(p["to_k"], h)[:, :, None, :]
    v = L.linear(p["to_v"], h)[:, :, None, :]
    o = mha(q, k, v).reshape(B, H * W, C)
    return x + L.linear(p["to_out"], o).reshape(B, H, W, C)


@torch.no_grad()
def init_vae_decoder(gen: torch.Generator, cfg: VAEConfig = SD_VAE,
                     dtype=torch.float32, device="cuda"):
    """Seeded random decoder weights on ``device`` (the card by default)."""
    device = resolve_device(device)
    C = [cfg.base_channels * m for m in cfg.channel_mults]   # e.g. [128,256,512,512]
    top = C[-1]
    p = {
        "post_quant_conv": init_conv(gen, 1, 1, cfg.latent_channels,
                                     cfg.latent_channels, dtype, device),
        "conv_in": init_conv(gen, 3, 3, cfg.latent_channels, top, dtype, device),
        "mid": {"resnets": [_init_resnet(gen, top, top, dtype, device),
                            _init_resnet(gen, top, top, dtype, device)],
                "attn": _init_attn(gen, top, dtype, device)},
        "up_blocks": [],
        "conv_norm_out": init_gn(C[0], dtype, device),
        "conv_out": init_conv(gen, 3, 3, C[0], cfg.out_channels, dtype, device),
    }
    # decoder runs reversed(channel_mults): top -> ... -> base
    prev = top
    for i, c in enumerate(reversed(C)):
        block = {"resnets": []}
        for j in range(cfg.layers_per_block + 1):
            block["resnets"].append(_init_resnet(gen, prev if j == 0 else c, c,
                                                 dtype, device))
        if i < len(C) - 1:
            block["upsample"] = init_conv(gen, 3, 3, c, c, dtype, device)
        p["up_blocks"].append(block)
        prev = c
    return p


def vae_decode(params, latents: torch.Tensor,
               cfg: VAEConfig = SD_VAE) -> torch.Tensor:
    """latents [B,h,w,4] (already divided by scaling_factor) -> images
    [B, h * upscale, w * upscale, 3] in [-1, 1]."""
    with span("vae", latents):
        G = cfg.norm_groups
        x = conv2d(params["post_quant_conv"], latents)
        x = conv2d(params["conv_in"], x)
        x = _resnet(params["mid"]["resnets"][0], x, G)
        x = _attn(params["mid"]["attn"], x, G)
        x = _resnet(params["mid"]["resnets"][1], x, G)
        for block in params["up_blocks"]:
            for r in block["resnets"]:
                x = _resnet(r, x, G)
            if "upsample" in block:
                x = conv2d(block["upsample"], upsample_nearest(x))
        x = group_norm(params["conv_norm_out"], x, G, silu=True)
        return conv2d(params["conv_out"], x)
