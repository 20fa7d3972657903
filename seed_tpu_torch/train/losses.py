"""Training losses (counterpart of seed_tpu/train/losses.py).

- next-token cross entropy with -100 label masking, fp32 log-softmax
- label-smoothed InfoNCE contrastive loss, over the global batch of a
  mesh axis when given one
- cosine reconstruction + distillation MSE of the tokenizer's stage 2
"""
from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits [B,N,V], labels [B,N].

    A label outside [0, V) makes the loss NaN, as seed_tpu's out-of-bounds
    ``take_along_axis`` fill does (a model whose vocabulary is smaller than
    the data's ids, such as TINY_LLAMA on image ids); the gather itself
    stays in bounds, so the card never reads past the logits."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    inside = (safe >= 0) & (safe < logits.shape[-1])
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = torch.gather(logp, -1, safe.clamp(0, logits.shape[-1] - 1)[..., None])
    tok = torch.where(inside, tok[..., 0], torch.full_like(tok[..., 0], float("nan")))
    return -(tok * valid).sum() / valid.sum().clamp_min(1)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted LM loss (labels default to input_ids)."""
    labels = input_ids if labels is None else labels
    return cross_entropy(logits[:, :-1], labels[:, 1:])


def info_nce(image_feat: torch.Tensor, text_feat: torch.Tensor, temp,
             axis_name: Optional[str] = None,
             label_smoothing: float = 0.1) -> torch.Tensor:
    """Bidirectional contrastive loss: image_feat/text_feat [B, D],
    L2-normalized. With ``axis_name`` (a mesh axis or a process group) the
    features of every rank are gathered, so each rank contrasts its B
    examples against the global batch (concat_all_gather of the reference);
    each rank's block keeps its gradient (``parallel.comm.all_gather``)."""
    if axis_name is not None:
        from ..parallel.comm import all_gather, index_of
        all_img = all_gather(image_feat, axis_name, tiled=True)
        all_txt = all_gather(text_feat, axis_name, tiled=True)
        my = index_of(axis_name)
    else:
        all_img, all_txt, my = image_feat, text_feat, 0
    B = image_feat.shape[0]
    sim_i2t = (image_feat @ all_txt.T) / temp             # [B, G]
    sim_t2i = (text_feat @ all_img.T) / temp
    G = all_txt.shape[0]
    onehot = torch.zeros(B, G, device=image_feat.device)
    onehot[torch.arange(B), my * B + torch.arange(B)] = 1.0
    smoothed = onehot * (1 - label_smoothing) + label_smoothing / G

    def ce(sim):
        logp = torch.log_softmax(sim.float(), dim=-1)
        return -(smoothed * logp).sum(dim=-1).mean()

    return 0.5 * (ce(sim_i2t) + ce(sim_t2i))


def cosine_recon_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """mean(1 - cos_sim) over tokens."""
    pn = pred / (torch.linalg.vector_norm(pred, dim=-1, keepdim=True) + 1e-8)
    tn = target / (torch.linalg.vector_norm(target, dim=-1, keepdim=True) + 1e-8)
    return (1.0 - (pn * tn).sum(dim=-1)).mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred.float() - target.float()).square().mean()
