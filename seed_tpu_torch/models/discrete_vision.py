"""Discrete vision model, the reference's experimental alternative tokenizer
(counterpart of seed_tpu/models/discrete_vision.py;
MultiModalLLM/src/tokenizer/discrete_vision_model/modeling.py).

- ``dvm_loss`` (DiscreteVisionModel, modeling.py:52-139): a frozen CLIP
  vision tower with its projection gives ``last_hidden_state`` (the
  reconstruction target) and ``image_embeds`` (the contrastive target). A
  small transformer quant encoder maps the hidden states to a 32-d code
  space, VectorQuantizer2 (beta 0.25, legacy=False, :76) discretizes, and a
  quant decoder reconstructs the hidden states. The decoded CLS goes back
  through the tower's own post-LN and projection (tie_projection, :83-85)
  and is pulled toward ``image_embeds`` by a CLIP-style symmetric cross
  entropy over embeddings that are NOT l2-normalized, with ``logit_scale``
  (init 2.6592) multiplying the logits directly, never exponentiated
  (:125-139).
- ``dvm_clip_embed_loss`` (DiscreteVisionModelFroClipEmbed, :240-300):
  quantizes the pooled CLIP image embedding itself, expanded to
  ``num_token`` latent tokens by one linear (SimpleEmbedEncoder :303-330)
  or by 1-D patches and a transformer (CLIPEmbedEncoder :142-203), with the
  straight-through or the Norm-EMA codebook (quantizer.py:239-329);
  loss = quant + rec.

The quant encoder and decoder are lists of the ViT's full-bias pre-LN
blocks (HF CLIPEncoderLayer math). The frozen tower runs under
``torch.no_grad``; the tied head's parameters are detached, so gradient
reaches ``predict_state`` through the head but the head gets none.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from . import layers as L
from . import quantizer as Q
from . import vit as V


@dataclass(frozen=True)
class DVMConfig:
    # frozen tower width and targets (CLIP-ViT-H with projection)
    hidden: int = 1280          # tower last_hidden_state dim
    proj_dim: int = 1024        # tower image_embeds dim
    # quant encoder / decoder stacks (CLIPEncoder equivalents)
    depth: int = 4
    heads: int = 16
    mlp_dim: int = 5120
    # codebook
    n_codes: int = 8192
    code_dim: int = 32
    beta: float = 0.25
    # loss scales (modeling.py:59-61)
    scale_rec: float = 1.0
    scale_quant: float = 1.0
    scale_contrastive: float = 1.0

    @property
    def block_cfg(self) -> V.ViTConfig:
        # HF CLIPEncoderLayer: pre-LN, full qkv bias, quick_gelu, eps 1e-5
        return V.ViTConfig(dim=self.hidden, depth=self.depth,
                           heads=self.heads, mlp_dim=self.mlp_dim,
                           qkv_bias="full", act="quick_gelu", ln_eps=1e-5)


TINY_DVM = DVMConfig(hidden=32, proj_dim=16, depth=2, heads=2, mlp_dim=64,
                     n_codes=64, code_dim=8)


def _blocks(gen, n: int, dim: int, mlp_dim: int, dtype, device):
    return [V.init_block(gen, dim, mlp_dim, "full", dtype, device)
            for _ in range(n)]


def init_dvm(gen, cfg: DVMConfig, dtype=torch.float32, device="cuda"):
    """Seeded random weights on ``device`` (the card by default)."""
    lin = lambda i, o: L.init_linear(gen, i, o, dtype=dtype, device=device)
    return {
        "quant_encoder": _blocks(gen, cfg.depth, cfg.hidden, cfg.mlp_dim,
                                 dtype, device),
        "encode_task": lin(cfg.hidden, cfg.code_dim),
        "vq": Q.init_codebook(gen, cfg.n_codes, cfg.code_dim, dtype, device),
        "decode_task": lin(cfg.code_dim, cfg.hidden),
        "quant_decoder": _blocks(gen, cfg.depth, cfg.hidden, cfg.mlp_dim,
                                 dtype, device),
        # modeling.py:81: a plain parameter, applied linearly (never exp'd)
        "logit_scale": torch.tensor(2.6592, dtype=dtype, device=device),
    }


def dvm_encode(params, rec_target: torch.Tensor, cfg: DVMConfig
               ) -> torch.Tensor:
    """Tower hidden states [B, N, hidden] -> code ids [B, N]."""
    h = V.blocks_apply(params["quant_encoder"], rec_target, cfg.block_cfg)
    z = L.linear(params["encode_task"], h)
    return Q.nearest_codes(params["vq"]["codebook"], z.float())


def dvm_decode(params, indices: torch.Tensor, cfg: DVMConfig) -> torch.Tensor:
    """Code ids [B, N] -> reconstructed tower hidden states [B, N, hidden]."""
    h = L.linear(params["decode_task"], Q.lookup(params["vq"], indices))
    return V.blocks_apply(params["quant_decoder"], h, cfg.block_cfg)


def clip_contrastive_loss(logit_scale: torch.Tensor, embed_x: torch.Tensor,
                          embed_y: torch.Tensor,
                          axis_name: Optional[str] = None) -> torch.Tensor:
    """Symmetric CE over unnormalized embeds with a linear logit scale
    (modeling.py:125-139: no l2norm, no exp). ``axis_name`` (a mesh axis or
    a process group) gathers both embeds from its ranks first, so every rank
    contrasts the global batch; each rank's block keeps its gradient
    (``parallel.comm.all_gather``)."""
    if axis_name is not None:
        from ..parallel.comm import all_gather
        embed_x = all_gather(embed_x, axis_name, tiled=True)
        embed_y = all_gather(embed_y, axis_name, tiled=True)
    logits = logit_scale.float() * (embed_x.float() @ embed_y.float().T)
    diag = torch.arange(logits.shape[0], device=logits.device)
    loss_x = -torch.log_softmax(logits, -1)[diag, diag].mean()
    loss_y = -torch.log_softmax(logits.T, -1)[diag, diag].mean()
    return (loss_x + loss_y) / 2.0


def _detached(tree):
    return {k: v.detach() for k, v in tree.items()}


def dvm_loss(params, tower_params, tower_head, images: torch.Tensor,
             cfg: DVMConfig, tower_cfg: V.ViTConfig,
             axis_name: Optional[str] = None):
    """DiscreteVisionModel.forward (modeling.py:96-123).

    ``tower_params`` / ``tower_head``: the frozen CLIP vision tower
    (``vit_apply``) and its ln_post + projection
    (``init_clip_vision_projection``), whose head the decode side shares
    (tie_projection, :83-85). Returns (total loss, metrics)."""
    with torch.no_grad():
        hidden = V.vit_apply(tower_params, images, tower_cfg)
        cls = L.layer_norm(tower_head["ln_post"], hidden[:, 0],
                           tower_cfg.ln_eps)
        iti_target = L.linear(tower_head["proj"], cls)            # [B, P]
    rec_target = hidden                                           # [B, N, D]

    h = V.blocks_apply(params["quant_encoder"], rec_target, cfg.block_cfg)
    z = L.linear(params["encode_task"], h)
    vq = Q.quantize(params["vq"], z, beta=cfg.beta, legacy=False)

    h = L.linear(params["decode_task"], vq.quantized)
    predict_state = V.blocks_apply(params["quant_decoder"], h, cfg.block_cfg)

    # tie_projection: the decoded CLS re-enters the tower's own head, whose
    # parameters are frozen with the tower (modeling.py:89-94); gradient
    # still flows through the head into predict_state
    pooled = L.layer_norm(_detached(tower_head["ln_post"]),
                          predict_state[:, 0], tower_cfg.ln_eps)
    predict_embed = L.linear(_detached(tower_head["proj"]), pooled)

    loss_rec = (predict_state.float() - rec_target.float()).square().mean()
    loss_iti = clip_contrastive_loss(params["logit_scale"], predict_embed,
                                     iti_target, axis_name)
    total = (cfg.scale_rec * loss_rec + cfg.scale_quant * vq.loss
             + cfg.scale_contrastive * loss_iti)
    return total, {"loss_rec": loss_rec, "loss_quant": vq.loss,
                   "loss_iti": loss_iti, "indices": vq.indices}


# ---- FroClipEmbed variant: quantize the pooled CLIP embedding ------------

@dataclass(frozen=True)
class ClipEmbedDVMConfig:
    embed_dim: int = 1024       # pooled CLIP image_embeds dim
    num_token: int = 16         # latent tokens the embed expands into
    code_dim: int = 32
    n_codes: int = 8192
    beta: float = 0.25
    encoder: str = "simple"     # "simple" (linear) | "transformer" (1-D patch)
    act: str = "no"             # SimpleEmbedEncoder act_type (:311-314)
    quantizer: str = "st"       # "st" (VectorQuantizer2) | "norm_ema"
    # transformer encoder / decoder geometry (CLIPEmbedEncoder path)
    hidden: int = 256
    depth: int = 2
    heads: int = 4
    mlp_dim: int = 1024
    scale_rec: float = 1.0
    scale_quant: float = 1.0

    @property
    def patch(self) -> int:
        # CLIPEmbedEmbeddings (:152): the 1024-d embed is the "image",
        # num_token patches of it
        return self.embed_dim // self.num_token

    @property
    def block_cfg(self) -> V.ViTConfig:
        return V.ViTConfig(dim=self.hidden, depth=self.depth,
                           heads=self.heads, mlp_dim=self.mlp_dim,
                           qkv_bias="full", act="quick_gelu", ln_eps=1e-5)


def init_clip_embed_dvm(gen, cfg: ClipEmbedDVMConfig, dtype=torch.float32,
                        device="cuda"):
    """Seeded random weights on ``device`` (the card by default)."""
    lin = lambda i, o, bias=True: L.init_linear(gen, i, o, bias=bias,
                                                dtype=dtype, device=device)
    if cfg.encoder == "simple":
        # SimpleEmbedEncoder / Decoder (:303-360): one linear each way
        enc = {"linear": lin(cfg.embed_dim, cfg.hidden * cfg.num_token)}
        dec = {"linear": lin(cfg.hidden * cfg.num_token, cfg.embed_dim)}
    else:
        # CLIPEmbedEmbeddings: conv1d (kernel = stride = patch, no bias)
        # over the embed == patch reshape + linear; a learned position
        # embedding. CLIPEmbedDecoder (:206-237): blocks + flat projection.
        enc = {"patch": lin(cfg.patch, cfg.hidden, bias=False),
               "pos": L.normal(gen, (1, cfg.num_token, cfg.hidden), 0.02,
                               dtype, device),
               "blocks": _blocks(gen, cfg.depth, cfg.hidden, cfg.mlp_dim,
                                 dtype, device)}
        dec = {"blocks": _blocks(gen, cfg.depth, cfg.hidden, cfg.mlp_dim,
                                 dtype, device),
               "proj": lin(cfg.num_token * cfg.hidden, cfg.embed_dim)}
    if cfg.quantizer == "norm_ema":
        vq = Q.init_ema_codebook(gen, cfg.n_codes, cfg.code_dim, device)
    else:
        vq = Q.init_codebook(gen, cfg.n_codes, cfg.code_dim, dtype, device)
    return {"quant_encoder": enc,
            "encode_task": lin(cfg.hidden, cfg.code_dim),
            "vq": vq,
            "decode_task": lin(cfg.code_dim, cfg.hidden),
            "quant_decoder": dec}


def _embed_encode(params, clip_embed: torch.Tensor, cfg: ClipEmbedDVMConfig):
    B = clip_embed.shape[0]
    if cfg.encoder == "simple":
        h = L.linear(params["linear"], clip_embed)
        h = h.reshape(B, cfg.num_token, cfg.hidden)
        return L.gelu(h) if cfg.act == "gelu" else h
    patches = clip_embed.reshape(B, cfg.num_token, cfg.patch)
    h = L.linear(params["patch"], patches) + params["pos"].to(clip_embed.dtype)
    return V.blocks_apply(params["blocks"], h, cfg.block_cfg)


def _embed_decode(params, h: torch.Tensor, cfg: ClipEmbedDVMConfig):
    B = h.shape[0]
    if cfg.encoder == "simple":
        if cfg.act == "gelu":
            h = L.gelu(h)
        return L.linear(params["linear"], h.reshape(B, -1))
    h = V.blocks_apply(params["blocks"], h, cfg.block_cfg)
    return L.linear(params["proj"], h.reshape(B, -1))


def dvm_clip_embed_loss(params, clip_embed: torch.Tensor,
                        cfg: ClipEmbedDVMConfig):
    """DiscreteVisionModelFroClipEmbed.forward (modeling.py:276-300).

    clip_embed [B, embed_dim]: the frozen pooled CLIP image embedding.
    Returns (loss, metrics with the reconstructed embedding, the code ids
    and the pre-quantization z, which ``norm_ema_update`` takes)."""
    target = clip_embed.float().detach()
    h = _embed_encode(params["quant_encoder"], clip_embed, cfg)
    z = L.linear(params["encode_task"], h)
    if cfg.quantizer == "norm_ema":
        vq = Q.norm_ema_quantize(params["vq"], z, beta=cfg.beta)
    else:
        vq = Q.quantize(params["vq"], z, beta=cfg.beta, legacy=False)
    h = L.linear(params["decode_task"], vq.quantized)
    predict = _embed_decode(params["quant_decoder"], h, cfg)
    loss_rec = (predict.float() - target).square().mean()
    total = cfg.scale_quant * vq.loss + cfg.scale_rec * loss_rec
    return total, {"loss_rec": loss_rec, "loss_quant": vq.loss,
                   "predict_embed": predict, "indices": vq.indices, "z": z}
