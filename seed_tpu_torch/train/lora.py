"""LoRA adapters, functional style (counterpart of seed_tpu/train/lora.py).

Reference recipe: r=16, alpha=32, adapters on all 7 projection matrices
(q/k/v/o/gate/up/down), with embed_tokens / lm_head / norm scales fully
trainable (``split_trainable``) so the new image-token rows can learn.

Adapters live in a parallel tree keyed by the path of the kernel they adapt;
the train step merges ``kernel + (alpha/r) * A @ B`` before the forward, so
gradients are taken with respect to the adapter tree only and the base tree
stays frozen (and can stay bf16). The port's LLaMA keeps its layers in a
list, so a name reads ``layers/3/q_proj/kernel`` where seed_tpu's stacked
tree has ``layers/q_proj/kernel`` with a leading [L] axis
(``bridge.lora_from_seed_tpu`` carries one into the other).
"""
from __future__ import annotations

import re
from typing import Any

import torch

from ..utils.tree import leaves_with_path, map_with_path, path_str

DEFAULT_TARGETS = r"(q_proj|k_proj|v_proj|o_proj|gate_proj|up_proj|down_proj)/kernel$"
DEFAULT_SAVE = r"(embed_tokens|lm_head|input_layernorm|post_attention_layernorm|/norm)/"


def init_lora(gen: torch.Generator, params, r: int = 16, alpha: int = 32,
              targets: str = DEFAULT_TARGETS, dtype=torch.float32):
    """Build the adapter tree: for every matched [in, out] kernel, A [in, r]
    (gaussian * 0.02, drawn from ``gen`` on its device) and B [r, out]
    (zeros: adapters start as the identity), each on its kernel's device.

    The returned tree holds only tensors; alpha / r is a 0-d fp32 leaf."""
    pat = re.compile(targets)
    adapters = {}
    device = None
    for name, leaf in leaves_with_path(params):
        if pat.search(name) and leaf.dim() >= 2:
            *batch, d_in, d_out = leaf.shape
            device = leaf.device
            # a meta tree (sizing, no allocation) gets meta adapters
            a = torch.randn((*batch, d_in, r), generator=gen,
                            device="meta" if device.type == "meta"
                            else gen.device) * 0.02
            adapters[name] = {
                "a": a.to(device=device, dtype=dtype),
                "b": torch.zeros((*batch, r, d_out), dtype=dtype, device=device),
            }
    return {"adapters": adapters,
            "scale": torch.tensor(alpha / r, dtype=torch.float32, device=device)}


def apply_lora(params, lora) -> Any:
    """Return params with adapters merged: fp32 merge, cast back to the
    kernel's dtype; unmatched leaves are passed on, not copied. The scale is
    a fixed hyperparameter and carries no gradient."""
    if lora is None:
        return params
    scale = lora["scale"].detach()
    adapters = lora["adapters"]

    def merge(path, leaf):
        ad = adapters.get(path_str(path))
        if ad is None:
            return leaf
        delta = torch.matmul(ad["a"].float(), ad["b"].float()) * scale
        return (leaf.float() + delta).to(leaf.dtype)

    return map_with_path(merge, params)


@torch.no_grad()
def merge_lora_weights(params, lora):
    """Permanent merge for export (merge_and_unload equivalent)."""
    return apply_lora(params, lora)


def split_trainable(params, patterns: str = DEFAULT_SAVE):
    """Split a param tree into (trainable, frozen) by path regex.

    Returns (trainable_tree, frozen_tree, combine_fn) where the trees have
    the full structure with None at complementary leaves."""
    pat = re.compile(patterns)

    def pick(want_trainable):
        return map_with_path(
            lambda p, leaf: leaf if bool(pat.search(path_str(p))) == want_trainable
            else None, params)

    def combine(tr, fr):
        if isinstance(fr, dict):
            return {k: combine(tr[k], v) for k, v in fr.items()}
        if isinstance(fr, (list, tuple)):
            return [combine(t, f) for t, f in zip(tr, fr)]
        return tr if tr is not None else fr

    return pick(True), pick(False), combine
