"""Training losses (counterpart of seed_tpu/train/losses.py).

- next-token cross entropy with -100 label masking, fp32 log-softmax
- label-smoothed InfoNCE contrastive loss, on one device
- cosine reconstruction + distillation MSE of the tokenizer's stage 2
"""
from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    """Mean CE over non-ignored positions. logits [B,N,V], labels [B,N]."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tok = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -(tok * valid).sum() / valid.sum().clamp_min(1)


def next_token_loss(logits: torch.Tensor, input_ids: torch.Tensor,
                    labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shifted LM loss (labels default to input_ids)."""
    labels = input_ids if labels is None else labels
    return cross_entropy(logits[:, :-1], labels[:, 1:])


def info_nce(image_feat: torch.Tensor, text_feat: torch.Tensor, temp,
             axis_name: Optional[str] = None,
             label_smoothing: float = 0.1) -> torch.Tensor:
    """Bidirectional contrastive loss over the local batch:
    image_feat/text_feat [B, D], L2-normalized. The all-gather across
    devices that seed_tpu does under a named mesh axis belongs to the
    parallel slice of the port; ``axis_name`` raises until it lands."""
    if axis_name is not None:
        raise NotImplementedError(
            "info_nce: the cross-device gather (axis_name) is not ported; "
            "it comes with seed_tpu_torch's parallel modules")
    B = image_feat.shape[0]
    sim_i2t = (image_feat @ text_feat.T) / temp
    sim_t2i = (text_feat @ image_feat.T) / temp
    onehot = torch.eye(B, device=image_feat.device)
    smoothed = onehot * (1 - label_smoothing) + label_smoothing / B

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
