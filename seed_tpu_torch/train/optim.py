"""Optimizers and LR schedules (counterpart of seed_tpu/train/optim.py).

seed_tpu builds its optimizer from optax; the port writes the same update by
hand so that it follows optax 0.2.x and not torch.optim's habits:

- the clip leaves gradients alone while ``norm < clip`` and otherwise scales
  them by ``clip / norm`` (no epsilon in the denominator);
- Adam moments take the parameter's dtype; bias correction divides each
  moment by ``1 - b**count`` (computed in fp32, cast to the moment's dtype);
  the update is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``;
- the schedule is read at the step count BEFORE it is incremented, so a
  warm-up schedule gives lr(0) = 0 and the first step changes nothing.

An optimizer is a pair of pure functions over trees of tensors, as in
optax: ``init(params) -> state`` and
``update(grads, state, params) -> (updates, new_state)``; the caller adds
``updates`` to ``params``. A ``None`` leaf is a leaf the optimizer does not
own (see ``masked_trainable``): it takes no gradient, holds no moments and
gets no update. ``Optimizer.trains`` (a predicate on the path string, None
= every leaf) tells the train step which leaves need gradients at all.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..parallel.local import whole
from ..utils.tree import leaves, map_with_path, path_str, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Any]
    trains: Optional[Callable[[str], bool]] = None


def cosine_with_floor(base_lr: float, warmup_steps: int, total_steps: int,
                      min_lr_ratio: float = 0.0, num_cycles: float = 0.5):
    """transformers-style cosine schedule with a floor.

    lr(p) = base * max(min_ratio,
                       0.5 * ((1+r) + (1-r) * cos(pi * 2*cycles * p)))"""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return base_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        r = min_lr_ratio
        cos = 0.5 * ((1 + r) + (1 - r) * math.cos(math.pi * 2.0 * num_cycles * progress))
        return base_lr * max(r, cos)

    return schedule


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0, warmup_start_lr: float = -1.0):
    """LAVIS LinearWarmupCosineLRScheduler."""
    init = warmup_start_lr if warmup_start_lr >= 0 else base_lr

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return init + (base_lr - init) * step / max(1.0, warmup_steps)
        progress = step / max(1.0, total_steps)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * progress))

    return schedule


def warmup_step_decay(base_lr: float, warmup_steps: int,
                      steps_per_epoch: int, min_lr: float = 0.0,
                      decay_rate: float = 1.0, warmup_start_lr: float = -1.0):
    """LAVIS LinearWarmupStepLRScheduler: linear warmup over epoch 0 (clamped
    at base_lr past ``warmup_steps``), then a per-epoch exponential step
    decay ``max(min_lr, base * rate**epoch)``; one global step drives both
    through ``steps_per_epoch``."""
    init = warmup_start_lr if warmup_start_lr >= 0 else base_lr

    def schedule(step) -> float:
        step = float(step)
        epoch = math.floor(step / max(1.0, steps_per_epoch))
        if epoch < 1:
            return min(base_lr,
                       init + (base_lr - init) * step / max(1.0, warmup_steps))
        return max(min_lr, base_lr * decay_rate ** epoch)

    return schedule


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed in fp32; a plain
    tensor also when the leaves are DTensors (a sharded state)."""
    total = None
    for x in leaves(tree):
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return whole(total).sqrt()


def _decays(path, p: torch.Tensor) -> bool:
    """True = apply weight decay. Excludes 1-d params (norm scales, biases)
    and embeddings."""
    name = path_str(path)
    return p.dim() >= 2 and "bias" not in name and "embedding" not in name


def adamw(schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-5, weight_decay: float = 0.0,
          clip_norm: Optional[float] = 1.0, params: Any = None) -> Optimizer:
    """AdamW with global-norm clipping and no-decay groups.

    Defaults match the LLM pretrain recipe (adam beta2 0.95, eps 1e-5,
    max_grad_norm 1.0). As in seed_tpu, the no-decay groups apply only when
    ``params`` is given; without it every leaf decays."""
    masked_decay = params is not None

    def init(params):
        zeros = lambda p: torch.zeros_like(p)
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm:
            norm = global_norm(grads)
            if not bool(norm < clip_norm):
                grads = tree_map(
                    lambda g: (g / norm.to(g.dtype)) * clip_norm, grads)
        count = state["count"] + 1
        mu = tree_map(lambda g, m: ((1 - b1) * g + b1 * m).to(m.dtype),
                      grads, state["mu"])
        nu = tree_map(lambda g, v: ((1 - b2) * g ** 2 + b2 * v).to(v.dtype),
                      grads, state["nu"])
        # 1 - b**count in fp32, then cast: in bf16 b**count rounds to 1
        c1 = torch.tensor(1 - b1 ** count, dtype=torch.float32)
        c2 = torch.tensor(1 - b2 ** count, dtype=torch.float32)
        lr = schedule(state["count"])

        def leaf_update(path, m, v, p):
            m_hat = m / c1.to(device=m.device, dtype=m.dtype)
            v_hat = v / c2.to(device=v.device, dtype=v.dtype)
            u = m_hat / (torch.sqrt(v_hat) + eps)
            if weight_decay and (not masked_decay or _decays(path, p)):
                u = u + weight_decay * p
            return (-lr * u).to(p.dtype)

        updates = map_with_path(leaf_update, mu, nu, params)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` in p's dtype, leaf by leaf; a leaf whose update is None is
    handed back as it is (the same tensor)."""
    return tree_map(lambda p, u: p if u is None else (p + u).to(p.dtype),
                    params, updates)


def masked_trainable(tx: Optimizer, params: Any, trainable_pattern: str) -> Optimizer:
    """No update for params NOT matching ``trainable_pattern``.

    A zero gradient alone does not pin a frozen leaf: AdamW's decoupled
    weight decay still shrinks it. Frozen leaves never reach ``tx`` (they are
    None in the trees it sees, so they carry no moments and stay out of the
    clip's norm) and their update is None: ``apply_updates`` hands them back
    untouched, where seed_tpu adds an update of exactly zero. ``trains``
    tells the train step to take no gradient of them; gradients given for
    them anyway are ignored. ``params`` is taken for seed_tpu's signature;
    which leaves train follows from the paths alone."""
    pat = re.compile(trainable_pattern)
    trains = lambda name: bool(pat.search(name))
    keep = lambda tree: map_with_path(
        lambda p, x: x if trains(path_str(p)) else None, tree)

    def init(params):
        return tx.init(keep(params))

    def update(grads, state, params):
        updates, state = tx.update(keep(grads), state, keep(params))
        return updates, state

    return Optimizer(init, update, trains)


def learnable_image_embeddings_only(tx: Optimizer, old_vocab_size: int,
                                    vocab_size: Optional[int] = None) -> Optimizer:
    """Restrict embed_tokens / lm_head updates to the NEW image-token rows.

    The frozen rows of the RAW gradients are zeroed before ``tx`` (so the
    clip and the Adam moments see what the reference's gradient hook leaves)
    and the final update is masked again (decoupled weight decay cannot
    shrink frozen rows either):

    - ``embed_tokens/embedding`` [V, D]: rows outside
      [old_vocab_size, vocab_size) get a zero update;
    - ``lm_head/kernel`` [D, V]: the same mask on the last axis;
    - every other leaf passes through untouched.

    ``vocab_size`` bounds the trainable region so vocab-padding rows stay
    pinned too; None = no upper bound."""
    def row_mask(n, device):                  # True = trainable row
        idx = torch.arange(n, device=device)
        keep = idx >= old_vocab_size
        if vocab_size is not None:
            keep &= idx < vocab_size
        return keep

    def mask_updates(updates):
        def apply(path, u):
            name = path_str(path)
            zero = torch.zeros((), dtype=u.dtype, device=u.device)
            if name.endswith("embed_tokens/embedding"):
                return torch.where(row_mask(u.shape[-2], u.device)[:, None], u, zero)
            if name.endswith("lm_head/kernel"):
                return torch.where(row_mask(u.shape[-1], u.device)[None, :], u, zero)
            return u
        return map_with_path(apply, updates)

    def update(grads, state, params):
        updates, state = tx.update(mask_updates(grads), state, params)
        return mask_updates(updates), state

    return Optimizer(tx.init, update, tx.trains)
