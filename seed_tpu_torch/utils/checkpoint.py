"""Checkpoint save/restore (counterpart of seed_tpu/utils/checkpoint.py).

The same directory layout as seed_tpu: one directory per checkpoint
(``step_N``, ``best``) under a manager's directory, with retention of the
newest ``max_to_keep`` steps. seed_tpu stores through orbax; here a
checkpoint directory holds one ``tree.pt`` written by ``torch.save`` (tensors
moved to the CPU first) and read back with ``torch.load(weights_only=True)``,
which unpickles tensors and plain containers only.

``filter_tree`` / ``merge_tree`` are the trainable-params-only filter and its
lenient inverse.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Any, Optional, Tuple

import torch

from .. import resolve_device
from .tree import leaves_with_path, map_with_path, path_str, tree_map

TREE_FILE = "tree.pt"


def save_checkpoint(path: str, tree: Any, force: bool = True) -> None:
    """Write ``tree`` (tensors, numbers, None, in dicts and lists) to the
    directory ``path``. An existing checkpoint is replaced when ``force``."""
    path = os.path.abspath(path)
    target = os.path.join(path, TREE_FILE)
    if os.path.exists(target) and not force:
        raise FileExistsError(f"checkpoint exists: {path}")
    os.makedirs(path, exist_ok=True)
    host = tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
                    else x, tree)
    tmp = target + f".{os.getpid()}.tmp"
    torch.save(host, tmp)
    os.replace(tmp, target)     # a reader never sees a half-written file


def restore_checkpoint(path: str, template: Optional[Any] = None,
                       device="cuda") -> Any:
    """Read the tree saved at ``path``. With a ``template`` every tensor
    lands on its template leaf's device, and a leaf whose shape or dtype
    differs from the template's raises; without one, tensors land on
    ``device`` (the card by default)."""
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, TREE_FILE), map_location="cpu",
                      weights_only=True)
    if template is None:
        dev = resolve_device(device)
        return tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                        else x, tree)

    def place(p, want, got):
        if not isinstance(want, torch.Tensor):
            return got
        if (not isinstance(got, torch.Tensor) or got.shape != want.shape
                or got.dtype != want.dtype):
            raise ValueError(f"restore_checkpoint: {path_str(p)} is "
                             f"{getattr(got, 'shape', got)!s} "
                             f"{getattr(got, 'dtype', '')}, the template has "
                             f"{tuple(want.shape)} {want.dtype}")
        return got.to(want.device)

    return map_with_path(place, template, tree)


def filter_tree(tree: Any, pattern: str) -> Any:
    """Keep only leaves whose path matches ``pattern`` (others -> None)."""
    pat = re.compile(pattern)
    return map_with_path(
        lambda p, leaf: leaf if pat.search(path_str(p)) else None, tree)


def merge_tree(base: Any, overlay: Any) -> Any:
    """Path-keyed lenient merge: overlay leaves replace base leaves at the
    same tree path; overlay paths missing from base are ignored, base paths
    missing from overlay keep their value, None overlay leaves are skipped.
    A leaf whose shape differs from the base's raises."""
    by_path = dict(leaves_with_path(overlay))

    def pick(p, b):
        o = by_path.get(path_str(p))
        if o is None:
            return b
        if tuple(o.shape) != tuple(b.shape):
            raise ValueError(f"merge_tree: shape mismatch at {path_str(p)}: "
                             f"{tuple(b.shape)} (base) vs {tuple(o.shape)} "
                             "(overlay)")
        return o

    return map_with_path(pick, base)


class CheckpointManager:
    """Step-numbered checkpoints with retention + best-metric tracking."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.dir, exist_ok=True)

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, name)))
        return sorted(out)

    def save(self, step: int, tree: Any, is_best: bool = False) -> str:
        path = os.path.join(self.dir, f"step_{step}")
        save_checkpoint(path, tree)
        if is_best:
            save_checkpoint(os.path.join(self.dir, "best"), tree)
        steps = self._step_dirs()
        while len(steps) > self.max_to_keep:
            _, victim = steps.pop(0)
            shutil.rmtree(victim, ignore_errors=True)
        return path

    def latest_step(self) -> Optional[int]:
        steps = self._step_dirs()
        return steps[-1][0] if steps else None

    def restore_latest(self, template=None, device="cuda"
                       ) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        return step, restore_checkpoint(path, template, device)
