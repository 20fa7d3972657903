"""SEED-2 visual tokenizer: image -> 32 discrete causal token ids -> unCLIP
image embedding (counterpart of seed_tpu/models/seed_tokenizer.py).

encode: image [B,224,224,3] -> EVA-ViT-g -> ln_vision -> causal Q-Former
  (32 queries) -> encode_task (768 -> 768 -> tanh -> 32) -> fp32 VQ argmin
  over the 8192 x 32 codebook -> int32 ids [B, 32]
decode_embedding: ids [B, 32] -> codebook -> decode_task (32 -> 32 -> tanh
  -> 768) -> + pos_embed_image -> 4 ViT blocks -> distill head -> the unCLIP
  image embedding [B, 1024].
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from ..ops.quantization import VIT_TARGETS, quantize_tree
from ..utils.metrics_logging import span
from . import layers as L
from . import quantizer as VQ
from .qformer import QFormerConfig, SEED_QFORMER, init_qformer, qformer_apply
from .vit import (EVA_VIT_G, TINY_VIT, ViTConfig, blocks_apply, init_block,
                  init_vit, vit_apply)
from .. import resolve_device


@dataclass(frozen=True)
class SeedTokenizerConfig:
    vit: ViTConfig = EVA_VIT_G
    qformer: QFormerConfig = SEED_QFORMER
    codebook_size: int = 8192
    code_dim: int = 32
    decode_depth: int = 4          # qformer_quantizer.py:177 decode_depth=4
    decode_heads: int = 12
    image_embed_dim: int = 1024    # unCLIP CLIP-ViT-H image embedding dim
    with_recon_blocks: bool = False  # stage-2 training's recon_s path
    # distill head variant (qformer_quantizer.py:172 use_qformer_image):
    # False = image_down MLP (released-checkpoint inference path);
    # True = 1-token Reverse Q-Former (the stage-2 training default)
    use_qformer_image: bool = False

    @property
    def hidden(self) -> int:
        return self.qformer.hidden

    @property
    def reverse_qformer(self) -> QFormerConfig:
        """1 reverse token cross-attending to the 32 decoded features."""
        return dataclasses.replace(self.qformer, query_len=1,
                                   encoder_width=self.hidden, with_text=False)


SEED_TOKENIZER = SeedTokenizerConfig()
TINY_TOKENIZER = SeedTokenizerConfig(
    vit=TINY_VIT,
    qformer=QFormerConfig(hidden=32, layers=2, heads=2, intermediate=64,
                          encoder_width=TINY_VIT.dim, query_len=8),
    codebook_size=64, code_dim=8, decode_depth=2, decode_heads=2,
    image_embed_dim=16)


def _decode_block_cfg(cfg: SeedTokenizerConfig) -> ViTConfig:
    # plain timm-style blocks: full qkv bias, mlp_ratio 4.0, ln eps 1e-6
    return ViTConfig(dim=cfg.hidden, depth=cfg.decode_depth,
                     heads=cfg.decode_heads, mlp_dim=cfg.hidden * 4,
                     qkv_bias="full", ln_eps=1e-6)


@torch.no_grad()
def init_seed_tokenizer(gen: torch.Generator,
                        cfg: SeedTokenizerConfig = SEED_TOKENIZER,
                        dtype=torch.float32, device="cuda"):
    """Seeded random tokenizer weights on ``device`` (the card by default).
    ``gen`` is a torch.Generator on that device."""
    device = resolve_device(device)
    h = cfg.hidden
    lin = lambda i, o, **kw: L.init_linear(gen, i, o, dtype=dtype,
                                           device=device, **kw)
    params = {
        "vit": init_vit(gen, cfg.vit, dtype, device),
        "ln_vision": L.init_layer_norm(cfg.vit.dim, dtype, device),
        "qformer": init_qformer(gen, cfg.qformer, dtype, device),
        "encode_task": {"fc1": lin(h, h), "fc2": lin(h, cfg.code_dim)},
        "vq": VQ.init_codebook(gen, cfg.codebook_size, cfg.code_dim, dtype,
                               device),
        "decode_task": {"fc1": lin(cfg.code_dim, cfg.code_dim),
                        "fc2": lin(cfg.code_dim, h)},
        "pos_embed_image": torch.zeros((1, cfg.qformer.query_len, h),
                                       dtype=dtype, device=device),
        "blocks_image": [init_block(gen, h, h * 4, "full", dtype, device)
                         for _ in range(cfg.decode_depth)],
    }
    if cfg.use_qformer_image:
        params["reverse_qformer"] = init_qformer(gen, cfg.reverse_qformer,
                                                 dtype, device)
        params["distill_image_proj"] = lin(h, cfg.image_embed_dim)
    else:
        params["image_down"] = {"fc1": lin(h, 256, bias=False),
                                "fc2": lin(256, 128, bias=False),
                                "fc3": lin(128, 32, bias=False)}
        params["distill_image_proj"] = lin(cfg.qformer.query_len * 32,
                                           cfg.image_embed_dim)
    if cfg.with_recon_blocks:
        # stage 2's recon_s path: 4 blocks that rebuild the frozen Q-Former
        # features (blip2_qformer_codebook_all_image.py:236-243)
        params["pos_embed"] = torch.zeros((1, cfg.qformer.query_len, h),
                                          dtype=dtype, device=device)
        params["blocks"] = [init_block(gen, h, h * 4, "full", dtype, device)
                            for _ in range(cfg.decode_depth)]
    return params


def quantize_for_serving(params, cfg: SeedTokenizerConfig):
    """bf16/fp32 tokenizer -> W8A8 int8 encoder serving variant.

    Quantizes the four hot matmuls of every EVA-ViT block to int8 weights
    (per-output-channel absmax) and flips ``cfg.vit.w8a8`` so block_apply
    routes them through the int8 tensor cores (``layers.linear_w8a8``).
    Q-Former, VQ distances, norms and the decode path are untouched, so
    token-id drift comes only from the ViT features. Composes with
    :func:`serving_fast_config`. Returns (quantized_params, new_cfg)."""
    new = dict(params)
    new["vit"] = quantize_tree(params["vit"], VIT_TARGETS)
    return new, dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, w8a8=True))


def serving_fast_config(cfg: SeedTokenizerConfig) -> SeedTokenizerConfig:
    """The serving-mode encode levers on ``cfg.vit``: block attention through
    the short-sequence kernel's fast epilogue, and tanh GELU."""
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, use_flash=True,
                                     act="gelu_tanh"))


# ------------------------------ encode -------------------------------------

def encode_features(params, images: torch.Tensor,
                    cfg: SeedTokenizerConfig) -> torch.Tensor:
    """image -> continuous pre-VQ features z [B, Q, code_dim]."""
    feats = vit_apply(params["vit"], images, cfg.vit)
    feats = L.layer_norm(params["ln_vision"], feats)   # blip2.py:179 fp32 LN
    q = qformer_apply(params["qformer"], feats, cfg.qformer)
    h = torch.tanh(L.linear(params["encode_task"]["fc1"], q))
    return L.linear(params["encode_task"]["fc2"], h)


def encode(params, images: torch.Tensor,
           cfg: SeedTokenizerConfig = SEED_TOKENIZER) -> torch.Tensor:
    """images [B, H, W, 3] (preprocessed) -> token ids int32 [B, Q]."""
    with span("tokenizer.encode", images, images=images.shape[0]):
        z = encode_features(params, images, cfg)
        return VQ.nearest_codes(params["vq"]["codebook"], z)


# ------------------------------ decode -------------------------------------

def distill_head(params, h: torch.Tensor,
                 cfg: SeedTokenizerConfig) -> torch.Tensor:
    """Decoded features [B, Q, hidden] -> unCLIP image embedding
    [B, image_embed_dim], through the Reverse Q-Former
    (use_qformer_image=True) or the image_down MLP (False)."""
    if cfg.use_qformer_image:
        rev = qformer_apply(params["reverse_qformer"], h, cfg.reverse_qformer)
        return L.linear(params["distill_image_proj"], rev[:, 0])
    h = torch.relu(L.linear(params["image_down"]["fc1"], h))
    h = torch.relu(L.linear(params["image_down"]["fc2"], h))
    h = L.linear(params["image_down"]["fc3"], h)
    h = h.reshape(h.shape[0], -1)
    return L.linear(params["distill_image_proj"], h)


def decode_embedding(params, indices: torch.Tensor,
                     cfg: SeedTokenizerConfig = SEED_TOKENIZER) -> torch.Tensor:
    """token ids [B, Q] -> unCLIP image embedding [B, image_embed_dim]
    (Blip2QformerQuantizer.get_codebook_entry, :309-338)."""
    z_q = VQ.lookup(params["vq"], indices)
    h = torch.tanh(L.linear(params["decode_task"]["fc1"], z_q))
    h = L.linear(params["decode_task"]["fc2"], h)
    h = h + params["pos_embed_image"].to(h.dtype)
    h = blocks_apply(params["blocks_image"], h, _decode_block_cfg(cfg))
    return distill_head(params, h, cfg)


def encode_to_embedding(params, images: torch.Tensor,
                        cfg: SeedTokenizerConfig = SEED_TOKENIZER
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images -> (ids [B, Q], unCLIP image embedding [B, image_embed_dim]):
    the fused round trip of offline pre-tokenization and reconstruction
    eval."""
    ids = encode(params, images, cfg)
    return ids, decode_embedding(params, ids, cfg)
