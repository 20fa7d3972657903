"""Vision transformer (EVA-ViT-g) — counterpart of seed_tpu/models/vit.py.

Pre-norm blocks with EVA's q/v-only qkv bias, fp32 LayerNorm, patch
embedding as a reshape and one matmul. seed_tpu stacks the blocks along a
leading depth axis for ``lax.scan``; here they are a list of per-block dicts
applied in a Python loop (``bridge`` unstacks seed_tpu trees).

With ``use_flash`` the block attention goes through ``flash_attention``,
whose short-sequence route is the hand-written ``short_mha`` kernel;
``flash_exact`` selects its op-faithful epilogue.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from ..ops.attention import mha
from ..ops.flash_attention import flash_attention
from . import layers as L


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    dim: int = 1408
    depth: int = 39
    heads: int = 16
    mlp_dim: int = 6144
    qkv_bias: str = "qv"        # "qv" (EVA: q+v bias, k zero) | "full" | "none"
    act: str = "gelu"           # "gelu" (erf) | "quick_gelu" | "gelu_tanh"
    ln_eps: float = 1e-6
    channels: int = 3
    use_flash: bool = False     # block attention through flash_attention
    flash_exact: bool = False   # ... with the kernel's op-faithful epilogue

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


EVA_VIT_G = ViTConfig()  # eva_vit.py:461-474: mlp = int(1408 * 4.3637) = 6144
TINY_VIT = ViTConfig(image_size=28, patch_size=14, dim=32, depth=2, heads=2,
                     mlp_dim=64)


def _act(cfg: ViTConfig):
    if cfg.act == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if cfg.act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    return L.gelu


# ------------------------------ init --------------------------------------

def init_block(gen, dim: int, mlp_dim: int, qkv_bias: str,
               dtype=torch.float32, device="cuda"):
    attn = {"qkv": L.init_linear(gen, dim, 3 * dim, bias=(qkv_bias == "full"),
                                 dtype=dtype, device=device),
            "proj": L.init_linear(gen, dim, dim, dtype=dtype, device=device)}
    if qkv_bias == "qv":
        attn["q_bias"] = torch.zeros((dim,), dtype=dtype, device=device)
        attn["v_bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return {
        "norm1": L.init_layer_norm(dim, dtype, device),
        "attn": attn,
        "norm2": L.init_layer_norm(dim, dtype, device),
        "mlp": {"fc1": L.init_linear(gen, dim, mlp_dim, dtype=dtype, device=device),
                "fc2": L.init_linear(gen, mlp_dim, dim, dtype=dtype, device=device)},
    }


def init_vit(gen, cfg: ViTConfig, dtype=torch.float32, device="cuda"):
    patch_in = cfg.patch_size * cfg.patch_size * cfg.channels
    params = {
        "patch_embed": L.init_linear(gen, patch_in, cfg.dim, dtype=dtype,
                                     device=device),
        "cls_token": L.normal(gen, (1, 1, cfg.dim), 0.02, dtype, device),
        "pos_embed": L.normal(gen, (1, cfg.num_patches + 1, cfg.dim), 0.02,
                              dtype, device),
        "blocks": [init_block(gen, cfg.dim, cfg.mlp_dim, cfg.qkv_bias, dtype,
                              device) for _ in range(cfg.depth)],
    }
    return params


# ----------------------------- forward ------------------------------------

def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] with (di, dj, c) flattening."""
    B, H, W, C = x.shape
    gh, gw = H // patch, W // patch
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, gh * gw, patch * patch * C)


def block_apply(p, x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """Pre-norm transformer block (eva_vit.py Block.forward semantics)."""
    B, N, D = x.shape
    H, hd = cfg.heads, cfg.head_dim
    act = _act(cfg)

    h = L.layer_norm(p["norm1"], x, cfg.ln_eps)
    qkv = L.linear(p["attn"]["qkv"], h)
    if "q_bias" in p["attn"] and "bias" not in p["attn"]["qkv"]:
        # EVA: bias on q and v only, k bias fixed at zero (eva_vit.py:136-139)
        bias = torch.cat([p["attn"]["q_bias"],
                          torch.zeros_like(p["attn"]["q_bias"]),
                          p["attn"]["v_bias"]])
        qkv = qkv + bias.to(qkv.dtype)
    # strided views of the fused projection; the kernel reads them in place
    q, k, v = (t.reshape(B, N, H, hd) for t in qkv.split(D, dim=-1))
    if cfg.use_flash:
        o = flash_attention(q, k, v, exact=cfg.flash_exact)
    else:
        o = mha(q, k, v)
    x = x + L.linear(p["attn"]["proj"], o.reshape(B, N, D))

    h = L.layer_norm(p["norm2"], x, cfg.ln_eps)
    h = L.linear(p["mlp"]["fc2"], act(L.linear(p["mlp"]["fc1"], h)))
    return x + h


def blocks_apply(blocks: List[dict], x: torch.Tensor,
                 cfg: ViTConfig) -> torch.Tensor:
    for p in blocks:
        x = block_apply(p, x, cfg)
    return x


def vit_apply(params, images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """images [B, H, W, C] (already resized + normalized) -> [B, N+1, dim].
    Patch embed, prepend cls, add pos embed, blocks. No
    final norm: the caller applies ln_vision."""
    patches = patchify(images, cfg.patch_size)
    x = L.linear(params["patch_embed"], patches)
    B = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.dim)
    x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(x.dtype)
    return blocks_apply(params["blocks"], x, cfg)
