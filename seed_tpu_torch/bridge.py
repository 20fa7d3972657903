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


def _unstack(tree: dict) -> list:
    """{name: [L, ...]} (nested) -> [{name: [...]} for each of the L blocks]."""
    def depth(t):
        return depth(next(iter(t.values()))) if isinstance(t, dict) \
            else np.asarray(t).shape[0]

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    return [take(tree, i) for i in range(depth(tree))]


def from_seed_tpu(tree: Any, device="cuda") -> Any:
    """seed_tpu param tree (numpy leaves) -> seed_tpu_torch param tree on
    ``device`` (the card by default)."""
    device = resolve_device(device)

    def walk(t, key=None):
        if isinstance(t, dict):
            if key in STACKED_KEYS:
                return [walk(b) for b in _unstack(t)]
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v) for v in t]
        return _tensor(t, device)

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
