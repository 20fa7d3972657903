"""SEED tokenizer training, stages 1 and 2 (counterpart of
seed_tpu/train/tokenizer_training.py).

Stage 1, the causal Q-Former (blip2_qformer_casual.py): a frozen EVA-ViT,
then the Q-Former's 32 queries; the vision projection of the last query
against the text projection of the text CLS in a label-smoothed InfoNCE
(ITC), image-text matching with similarity-weighted hard negatives (ITM),
and a captioning LM loss through the decoder-mode Q-Former.

Stage 2, codebook distillation (blip2_qformer_codebook_all_image.py:208-328):
frozen ViT and Q-Former; encode_task -> VQ -> decode_task, 4 recon blocks
that rebuild the Q-Former features (cosine), and an image-distill head
regressed onto the frozen CLIP-ViT-H embedding (MSE). Loss = 5 vq +
2 recon + 0.5 distill.

The losses are functions (params, batch, rng) -> loss for
``train.Trainer``. seed_tpu stops the gradient at the frozen towers; here
they run under ``torch.no_grad()``, so their forward records no graph, and
the trainer takes gradients of the leaves its optimizer trains only
(``masked_trainable`` with the ``STAGE*_TRAINABLE`` patterns). ``rng`` is a
``torch.Generator`` on the batch's device: it draws ITM's hard negatives,
as ``jax.random.categorical`` does in seed_tpu (the draws differ; the
logits they are drawn from are ``itm_negative_logits``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..models import layers as L
from ..models import quantizer as VQ
from ..models.qformer import (lm_head_apply, qformer_apply,
                              qformer_caption_apply, qformer_text_apply)
from ..models.seed_tokenizer import (SeedTokenizerConfig, _decode_block_cfg,
                                     distill_head)
from ..models.vit import blocks_apply, vit_apply
from ..parallel.local import bincount
from .losses import cosine_recon_loss, cross_entropy, info_nce, mse_loss

# trainable-path patterns: they pick both the leaves the optimizer trains
# (optim.masked_trainable) and the leaves a checkpoint keeps. Segment
# anchored, so "vit/blocks" does not match stage 2's "blocks" recon stack.
# Stage 1 trains the Q-Former, ln_vision and the projection / ITM / LM heads
# (only the ViT forward is frozen, blip2_qformer_casual.py:121-124).
STAGE1_TRAINABLE = r"(^|/)(qformer|ln_vision|head|itm_head|lm_head)(/|$)"
STAGE2_TRAINABLE = (r"^(encode_task|decode_task|vq|pos_embed|blocks|"
                    r"pos_embed_image|blocks_image|image_down|"
                    r"reverse_qformer|distill_image_proj)(/|$)")

ITM_TEMP = 0.07     # sharpness of the hard-negative draws (:219-241)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


# --------------------------- stage 1 ---------------------------------------

@dataclass(frozen=True)
class Stage1Config:
    tokenizer: SeedTokenizerConfig
    embed_dim: int = 256          # vision / text projection dim (blip2.py)
    label_smoothing: float = 0.1
    init_temp: float = 0.07


def init_stage1_head(gen, cfg: Stage1Config, dtype=torch.float32,
                     device="cuda"):
    h = cfg.tokenizer.hidden
    return {
        "vision_proj": L.init_linear(gen, h, cfg.embed_dim, dtype=dtype,
                                     device=device),
        "text_proj": L.init_linear(gen, h, cfg.embed_dim, dtype=dtype,
                                   device=device),
        "temp": torch.tensor(cfg.init_temp, dtype=torch.float32, device=device),
    }


def init_itm_head(gen, cfg: Stage1Config, dtype=torch.float32, device="cuda"):
    """Binary image-text-matching head (blip2_qformer_casual.py:204-272)."""
    return L.init_linear(gen, cfg.tokenizer.hidden, 2, dtype=dtype,
                         device=device)


def _vision(tok_params, images, cfg: Stage1Config) -> torch.Tensor:
    """The frozen EVA-ViT, recording no graph (a no-grad forward,
    blip2_qformer_casual.py:121-122), then the trainable ln_vision."""
    with torch.no_grad():
        feats = vit_apply(tok_params["vit"], images, cfg.tokenizer.vit)
    return L.layer_norm(tok_params["ln_vision"], feats)


def _contrastive(tok, head, feats, text_ids, text_pad, cfg: Stage1Config):
    """Unit image (last query) and text (CLS) features of ITC."""
    tcfg = cfg.tokenizer
    q = qformer_apply(tok["qformer"], feats, tcfg.qformer)
    img_f = _unit(L.linear(head["vision_proj"], q[:, -1]))
    t = qformer_text_apply(tok["qformer"], text_ids, tcfg.qformer, text_pad)
    txt_f = _unit(L.linear(head["text_proj"], t[:, 0]))
    return img_f, txt_f


def stage1_features(tok_params, head, images, text_ids, text_pad,
                    cfg: Stage1Config):
    return _contrastive(tok_params, head, _vision(tok_params, images, cfg),
                        text_ids, text_pad, cfg)


def stage1_loss(params, batch, rng, cfg: Stage1Config) -> torch.Tensor:
    """ITC alone. params: {"tokenizer", "head"}; batch: {"images" [B,H,W,3],
    "text_ids" [B,T], "text_pad" [B,T]}."""
    img_f, txt_f = stage1_features(params["tokenizer"], params["head"],
                                   batch["images"], batch["text_ids"],
                                   batch.get("text_pad"), cfg)
    temp = params["head"]["temp"].clamp(0.001, 0.5)
    return info_nce(img_f, txt_f, temp, label_smoothing=cfg.label_smoothing)


def itm_negative_logits(img_f: torch.Tensor, txt_f: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The logits ITM draws its hard negatives from (:219-241): per image a
    text and per text an image, with probability softmax(sim / 0.07) over
    the batch, the matching pair masked to -inf. Gradient-free."""
    img_f, txt_f = img_f.detach().float(), txt_f.detach().float()
    sim = img_f @ txt_f.T                        # [B, B], rows: image -> text
    diag = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
    masked = sim.masked_fill(diag, float("-inf"))
    return masked / ITM_TEMP, masked.T / ITM_TEMP


def _categorical(rng: Optional[torch.Generator], logits: torch.Tensor
                 ) -> torch.Tensor:
    """One draw per row of softmax(logits) by the Gumbel-max trick, as
    jax.random.categorical draws."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=rng, device=logits.device)
    return (logits - torch.log(-torch.log(u.clamp_min(tiny)))).argmax(-1)


def stage1_itm_loss(tok_params, itm_head, images, text_ids, text_pad,
                    cfg: Stage1Config, rng=None, sim_feats=None,
                    negatives=None) -> torch.Tensor:
    """ITM with in-batch hard negatives (blip2_qformer_casual.py:204-272);
    see ``_itm_from_feats``."""
    return _itm_from_feats(tok_params, itm_head,
                           _vision(tok_params, images, cfg), text_ids,
                           text_pad, cfg, rng, sim_feats, negatives)


def _itm_from_feats(tok_params, itm_head, feats, text_ids, text_pad,
                    cfg: Stage1Config, rng=None, sim_feats=None,
                    negatives: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                    ) -> torch.Tensor:
    """ITM from the ln_vision features. With ``sim_feats`` = (img_f, txt_f) the
    negatives are drawn from ``itm_negative_logits`` with ``rng``; without
    it they are rolled (the cheap variant). ``negatives`` = (text index per
    image, image index per text) fixes them instead."""
    tcfg = cfg.tokenizer
    B = feats.shape[0]
    if negatives is not None:
        neg_txt_idx, neg_img_idx = negatives
    elif sim_feats is not None:
        to_txt, to_img = itm_negative_logits(*sim_feats)
        neg_txt_idx = _categorical(rng, to_txt)
        neg_img_idx = _categorical(rng, to_img)
    else:
        ar = torch.arange(B, device=feats.device)
        neg_txt_idx, neg_img_idx = ar.roll(1), ar.roll(-1)
    neg_pad = text_pad[neg_txt_idx] if text_pad is not None else None

    def joint_last_query(img_feats, t_ids, t_pad):
        h = qformer_apply(tok_params["qformer"], img_feats, tcfg.qformer,
                          text_ids=t_ids, text_pad=t_pad)
        return L.linear(itm_head, h[:, tcfg.qformer.query_len - 1])  # (:252)

    logits = torch.cat([
        joint_last_query(feats, text_ids, text_pad),
        joint_last_query(feats, text_ids[neg_txt_idx], neg_pad),
        joint_last_query(feats[neg_img_idx], text_ids, text_pad)], 0).float()
    labels = torch.cat([torch.ones(B, dtype=torch.long, device=feats.device),
                        torch.zeros(2 * B, dtype=torch.long,
                                    device=feats.device)])
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None]).mean()


def _lm_labels(text_ids, text_pad):
    if text_pad is None:
        return text_ids
    return torch.where(text_pad.bool(), text_ids, torch.full_like(text_ids, -100))


def stage1_caption_loss(tok_params, lm_head, images, text_ids, text_pad,
                        cfg: Stage1Config) -> torch.Tensor:
    """Captioning LM loss through the decoder-mode Q-Former
    (blip2_qformer_casual.py:275-296)."""
    return _caption_from_feats(tok_params, lm_head,
                               _vision(tok_params, images, cfg), text_ids,
                               text_pad, cfg)


def _caption_from_feats(tok_params, lm_head, feats, text_ids, text_pad,
                        cfg: Stage1Config) -> torch.Tensor:
    qcfg = cfg.tokenizer.qformer
    hidden = qformer_caption_apply(tok_params["qformer"], feats, text_ids,
                                   qcfg, text_pad)
    logits = lm_head_apply(lm_head,
                           tok_params["qformer"]["embeddings"]["word_embeddings"],
                           hidden, qcfg)
    return cross_entropy(logits[:, :-1], _lm_labels(text_ids, text_pad)[:, 1:])


def stage1_total_loss(params, batch, rng, cfg: Stage1Config,
                      w_itc: float = 1.0, w_itm: float = 1.0,
                      w_lm: float = 1.0, negatives=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """ITC + ITM + captioning LM in one forward, the frozen ViT once
    (blip2_qformer_casual.py:199-296). params: {"tokenizer", "head",
    "itm_head", "lm_head"}; batch: {"images", "text_ids", "text_pad"}.
    ``negatives`` fixes ITM's negatives (see ``_itm_from_feats``). Returns
    (loss, {"itc", "itm", "lm"})."""
    tok = params["tokenizer"]
    images, text_ids = batch["images"], batch["text_ids"]
    text_pad = batch.get("text_pad")
    feats = _vision(tok, images, cfg)
    img_f, txt_f = _contrastive(tok, params["head"], feats, text_ids,
                                text_pad, cfg)
    temp = params["head"]["temp"].clamp(0.001, 0.5)
    loss_itc = info_nce(img_f, txt_f, temp,
                        label_smoothing=cfg.label_smoothing)
    loss_itm = _itm_from_feats(tok, params["itm_head"], feats, text_ids,
                               text_pad, cfg, rng, sim_feats=(img_f, txt_f),
                               negatives=negatives)
    loss_lm = _caption_from_feats(tok, params["lm_head"], feats, text_ids,
                                  text_pad, cfg)
    total = w_itc * loss_itc + w_itm * loss_itm + w_lm * loss_lm
    return total, {"itc": loss_itc, "itm": loss_itm, "lm": loss_lm}


# --------------------------- stage 2 ---------------------------------------

@dataclass(frozen=True)
class Stage2Config:
    tokenizer: SeedTokenizerConfig
    w_embed: float = 5.0          # loss weights (:322-328)
    w_recon: float = 2.0
    w_distill: float = 0.5
    vq_beta: float = 0.25


def stage2_loss(params, batch, rng, cfg: Stage2Config
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """params: the full tokenizer tree (``with_recon_blocks=True``); batch:
    {"images" [B,H,W,3], "clip_embeds" [B, image_embed_dim], the frozen
    CLIP-ViT-H targets}. Returns (loss, {"vq", "recon", "distill",
    "codebook_usage"}); the ViT, ln_vision and Q-Former are frozen."""
    tcfg = cfg.tokenizer
    with torch.no_grad():
        feats = vit_apply(params["vit"], batch["images"], tcfg.vit)
        feats = L.layer_norm(params["ln_vision"], feats)
        query_out = qformer_apply(params["qformer"], feats, tcfg.qformer)

    h = torch.tanh(L.linear(params["encode_task"]["fc1"], query_out))
    z = L.linear(params["encode_task"]["fc2"], h)
    quant, indices, vq_loss = VQ.quantize(params["vq"], z, beta=cfg.vq_beta)

    up = torch.tanh(L.linear(params["decode_task"]["fc1"], quant))
    up = L.linear(params["decode_task"]["fc2"], up)

    # recon_s: the recon blocks rebuild the frozen Q-Former features
    rec = up + params["pos_embed"].to(up.dtype)
    rec = blocks_apply(params["blocks"], rec, _decode_block_cfg(tcfg))
    loss_recon = cosine_recon_loss(rec, query_out)

    # the image-distill head (:246-285): Reverse Q-Former or image_down
    img = up + params["pos_embed_image"].to(up.dtype)
    img = blocks_apply(params["blocks_image"], img, _decode_block_cfg(tcfg))
    loss_distill = mse_loss(distill_head(params, img, tcfg),
                            batch["clip_embeds"])

    total = (cfg.w_embed * vq_loss + cfg.w_recon * loss_recon
             + cfg.w_distill * loss_distill)
    # the share of the codebook this batch hits
    hits = bincount(indices, params["vq"]["codebook"].shape[0])
    metrics = {"vq": vq_loss, "recon": loss_recon, "distill": loss_distill,
               "codebook_usage": (hits > 0).float().mean()}
    return total, metrics


def stage2_loss_scalar(params, batch, rng, cfg: Stage2Config) -> torch.Tensor:
    return stage2_loss(params, batch, rng, cfg)[0]
