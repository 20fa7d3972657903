"""Carry seed_tpu weights across to seed_tpu_torch.

``from_seed_tpu`` takes a seed_tpu param tree whose leaves are numpy arrays
(``jax.tree.map(np.asarray, params)``, done by the caller: this module does
not import JAX) and returns the port's tree of tensors:

- linear kernels keep seed_tpu's [in, out] layout, which the port uses too
  (seed_tpu/models/layers.py conventions), so leaves copy over unchanged;
- int8 leaves {"kernel_q" int8 [in, out], "scale" [out]} copy over as they
  are, and ``layers.linear`` reads them the same way;
- the stacked [L, ...] block trees that seed_tpu scans over (``blocks``,
  ``blocks_image``, the LLaMA ``layers``; seed_tpu/models/vit.py:136-142)
  become lists of per-block dicts, which the port loops over. The Q-Former's
  ``layers`` is already a list in seed_tpu and stays one;
- bfloat16 leaves (numpy arrays of ml_dtypes' bfloat16) become
  torch.bfloat16 bit for bit.

``lora_from_seed_tpu`` does the same for a LoRA adapter tree
(seed_tpu/train/lora.py), whose adapters are keyed by the path of the kernel
they adapt.

``unclip_from_seed_tpu`` carries an unCLIP de-tokenizer tree
(seed_tpu/models/unclip): its ``blocks`` and CLIP ``layers`` are Python
lists in seed_tpu, not stacked trees, and stay lists; its conv kernels go
from seed_tpu's HWIO to torch's OIHW (``convs_to_oihw``), as those of the
Inception-v3 tree of FID and the Inception Score do.

``dvm_from_seed_tpu`` carries a discrete vision model tree
(seed_tpu/models/discrete_vision.py), whose quant encoder and decoder are
stacked block trees under names of their own.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import resolve_device

STACKED_KEYS = ("blocks", "blocks_image", "layers")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _depth(t):
    """Leading size of the first leaf that is not None (None if none is)."""
    if isinstance(t, dict):
        for v in t.values():
            d = _depth(v)
            if d is not None:
                return d
        return None
    return None if t is None else np.asarray(t).shape[0]


def _unstack(tree: dict) -> list:
    """{name: [L, ...]} (nested) -> [{name: [...]} for each of the L blocks]."""
    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return None if t is None else np.asarray(t)[i]

    return [take(tree, i) for i in range(_depth(tree))]


def from_seed_tpu(tree: Any, device="cuda") -> Any:
    """seed_tpu param tree (numpy leaves) -> seed_tpu_torch param tree on
    ``device`` (the card by default). None leaves (seed_tpu's
    ``filter_tree`` of a checkpoint) stay None; a stacked tree whose leaves
    are all None becomes None."""
    device = resolve_device(device)

    def walk(t, key=None):
        if isinstance(t, dict):
            if key in STACKED_KEYS:
                return ([walk(b) for b in _unstack(t)]
                        if _depth(t) is not None else None)
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return None if t is None else _tensor(t, device)

    return walk(tree)


def lora_from_seed_tpu(lora: Any, device="cuda") -> Any:
    """seed_tpu adapter tree (numpy leaves) -> the port's, on ``device``.

    seed_tpu names an adapter after its kernel's path in the stacked tree
    (``layers/q_proj/kernel``, A [L, in, r], B [L, r, out]); the port's
    layers are a list, so that adapter becomes L adapters named
    ``layers/{i}/q_proj/kernel`` with A [in, r], B [r, out]. Adapters of
    kernels outside a stacked tree (2-D A and B) keep their names."""
    device = resolve_device(device)
    adapters = {}
    for name, ad in lora["adapters"].items():
        a, b = np.asarray(ad["a"]), np.asarray(ad["b"])
        parts = name.split("/")
        stacked = [i for i, part in enumerate(parts) if part in STACKED_KEYS]
        if a.ndim == 2 or not stacked:
            adapters[name] = {"a": _tensor(a, device), "b": _tensor(b, device)}
            continue
        at = stacked[0] + 1
        for i in range(a.shape[0]):
            layer_name = "/".join(parts[:at] + [str(i)] + parts[at:])
            adapters[layer_name] = {"a": _tensor(a[i], device),
                                    "b": _tensor(b[i], device)}
    return {"adapters": adapters, "scale": _tensor(lora["scale"], device)}


def convs_to_oihw(tree: Any) -> Any:
    """Every 4-D ``kernel`` leaf of ``tree`` (a conv kernel in seed_tpu's
    HWIO [kh, kw, in, out]) as torch's OIHW [out, in, kh, kw], stored
    channels_last (O, kh, kw, in in memory), the layout the port's convs
    take without a copy. Linear kernels (2-D) are left as they are."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "kernel" and isinstance(v, torch.Tensor) and v.dim() == 4:
                v = v.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
            out[k] = convs_to_oihw(v)
        return out
    if isinstance(tree, (list, tuple)):
        return [convs_to_oihw(v) for v in tree]
    return tree


def unclip_from_seed_tpu(tree: Any, device="cuda") -> Any:
    """seed_tpu unCLIP tree (numpy leaves) -> the port's, on ``device``."""
    return convs_to_oihw(from_seed_tpu(tree, device))


DVM_STACKED_KEYS = ("quant_encoder", "quant_decoder")


def dvm_from_seed_tpu(tree: Any, device="cuda") -> Any:
    """seed_tpu discrete vision model tree (numpy leaves) -> the port's, on
    ``device``. ``quant_encoder`` / ``quant_decoder`` of ``init_dvm`` are
    stacked blocks and become lists of blocks; those of
    ``init_clip_embed_dvm`` hold their blocks under ``blocks``, which
    ``from_seed_tpu`` unstacks already."""
    tree = dict(tree)
    stacked = {k: tree.pop(k) for k in DVM_STACKED_KEYS
               if k in tree and "attn" in tree[k]}
    out = from_seed_tpu(tree, device)
    for k, blocks in stacked.items():
        out[k] = from_seed_tpu({"blocks": blocks}, device)["blocks"]
    return out
