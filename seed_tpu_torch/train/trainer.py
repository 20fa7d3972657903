"""The training loop on one device (counterpart of seed_tpu/train/trainer.py).

One trainer for the LLM and the tokenizer stages: a loss function over a
tree of trainable tensors, an optimizer (train/optim.py), gradient
accumulation over micro-batches, and full-state checkpoints. Which leaves
train is decided by the tree handed to the trainer; frozen trees are closed
over by the loss. seed_tpu shards the state over a mesh; meshes, partition
rules and shardings belong to the parallel modules of the port and are not
part of this signature.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..utils.tree import leaves_with_path, map_with_path, path_str, tree_map
from .optim import Optimizer, apply_updates, global_norm


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


@dataclass
class TrainerConfig:
    grad_accum: int = 1
    log_every: int = 50


def make_train_step(loss_fn: Callable[..., Any],   # (params, batch, rng) -> loss
                    optimizer: Optimizer, grad_accum: int = 1):
    """Build a (state, batch, rng) -> (state, metrics) step.

    ``loss_fn`` returns a scalar, or (scalar, dict of scalar metrics) whose
    metrics join the step's. Gradients are taken of the leaves the optimizer
    trains (``optimizer.trains``; every leaf when it is None); the others
    are handed to the loss as they are and get no gradient, so a frozen
    tower costs no gradient memory (seed_tpu takes its gradient, zero under
    stop_gradient, and drops it in the optimizer).

    With grad_accum > 1, ``batch`` leaves have a leading
    [grad_accum, micro_batch, ...] layout; each micro-batch's loss and
    gradients are taken in turn, gradients are summed in fp32, and losses,
    metrics and gradients are averaged over the micro-batches. ``rng`` goes
    to every loss call as it is (a torch.Generator advances by itself;
    seed_tpu folds the micro-batch index into a key). Metrics: the mean
    ``loss``, the loss's own metrics and the ``grad_norm`` before clipping.
    The state is not modified; a new one is returned."""
    trains = optimizer.trains or (lambda name: True)

    def single_grads(params, batch, rng):
        live = map_with_path(
            lambda p, x: x.detach().requires_grad_() if trains(path_str(p))
            else x, params)
        owned = [(name, x) for name, x in leaves_with_path(live)
                 if trains(name)]
        out = loss_fn(live, batch, rng)
        loss, aux = out if isinstance(out, tuple) else (out, {})
        found = dict(zip((name for name, _ in owned), torch.autograd.grad(
            loss, [x for _, x in owned], allow_unused=True)))
        # a leaf the loss does not touch (LoRA's fixed scale) has gradient 0

        def grad(p, x):
            name = path_str(p)
            if not trains(name):
                return None
            return torch.zeros_like(x) if found[name] is None else found[name]
        aux = {k: v.detach().float() for k, v in aux.items()}
        return loss.detach(), aux, map_with_path(grad, live)

    def step(state: TrainState, batch, rng) -> Tuple[TrainState, Dict]:
        if grad_accum == 1:
            loss, aux, grads = single_grads(state.params, batch, rng)
        else:
            loss, aux, grads = None, None, None
            for i in range(grad_accum):
                micro = tree_map(lambda x: x[i], batch)
                l_i, a_i, g_i = single_grads(state.params, micro, rng)
                g_i = tree_map(lambda g: g.float(), g_i)
                loss = l_i.float() if loss is None else loss + l_i
                aux = a_i if aux is None else {k: aux[k] + a_i[k] for k in aux}
                grads = g_i if grads is None else tree_map(
                    lambda a, g: a + g, grads, g_i)
            loss = loss / grad_accum
            aux = {k: v / grad_accum for k, v in aux.items()}
            grads = tree_map(lambda g: g / grad_accum, grads)

        with torch.no_grad():
            updates, new_opt = optimizer.update(grads, state.opt_state,
                                                state.params)
            new_params = apply_updates(state.params, updates)
            metrics = {"loss": loss, **aux, "grad_norm": global_norm(grads)}
        return TrainState(state.step + 1, new_params, new_opt), metrics

    return step


class Trainer:
    """Owns the train state on one device and iterates a host data stream."""

    def __init__(self, loss_fn: Callable, params: Any, optimizer: Optimizer,
                 cfg: TrainerConfig = TrainerConfig(), device="cuda"):
        self.cfg = cfg
        self.optimizer = optimizer
        self.device = resolve_device(device)
        params = tree_map(lambda p: p.detach().to(self.device), params)
        self.state = TrainState(0, params, optimizer.init(params))
        self._step = make_train_step(loss_fn, optimizer, cfg.grad_accum)

    def step(self, batch, rng=None) -> Dict[str, torch.Tensor]:
        batch = tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)
        self.state, metrics = self._step(self.state, batch, rng)
        return metrics

    # -------- full-state checkpointing (params + opt moments + step) -------

    def _state_dict(self):
        return {"step": self.state.step, "params": self.state.params,
                "opt_state": self.state.opt_state}

    def save_state(self, mgr, is_best: bool = False) -> str:
        """Save the full TrainState through a CheckpointManager, so that an
        interrupted run restarts warm (AdamW moments and the schedule's
        step)."""
        return mgr.save(int(self.state.step), self._state_dict(),
                        is_best=is_best)

    def restore_state(self, mgr) -> Optional[int]:
        """Restore the latest full TrainState onto this trainer's device;
        returns the restored step (None if the directory holds no
        checkpoint)."""
        step, restored = mgr.restore_latest(self._state_dict())
        if step is None:
            return None
        self.state = TrainState(int(restored["step"]), restored["params"],
                                restored["opt_state"])
        return step

    def train(self, data_iter, num_steps: int, rng=None,
              log_fn: Optional[Callable] = None) -> Dict[str, float]:
        t0 = time.time()
        last = {}
        for i in range(num_steps):
            batch = next(data_iter)
            metrics = self.step(batch, rng)
            if log_fn and (i % self.cfg.log_every == 0 or i == num_steps - 1):
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = (i + 1) / (time.time() - t0)
                log_fn(int(self.state.step), m)
            last = metrics
        return {k: float(v) for k, v in last.items()}
