"""The training loop (counterpart of seed_tpu/train/trainer.py).

One trainer for the LLM and the tokenizer stages: a loss function over a
tree of trainable tensors, an optimizer (train/optim.py), gradient
accumulation over micro-batches, and full-state checkpoints. Which leaves
train is decided by the tree handed to the trainer; frozen trees are closed
over by the loss.

Without a mesh the state lives on one device. With one
(``Trainer(..., mesh=mesh, rules=rules)``, parallel/), the parameters and
the optimizer moments are DTensors laid out by the same partition specs
(``parallel.make_param_specs``, seed_tpu's rules), the optimizer's step
count is a replicated number, and each rank hands ``step`` its slice of the
batch (``parallel.shard_batch``), which the step lays out over (data, fsdp)
(the micro-batch axis under ``grad_accum``). The loss then runs on DTensors:
its value is the one of the global batch, as under seed_tpu's ``jit``, and
the gradients are reduced to the parameters' shards. Checkpoints hold full
trees, written by rank 0, so a state saved at one mesh shape restores into
any other (or into a trainer without a mesh).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import resolve_device
from ..parallel.local import whole
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
                    optimizer: Optimizer, grad_accum: int = 1,
                    mesh=None):
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
    The state is not modified; a new one is returned.

    With a ``mesh`` the params and the batch are DTensors (``Trainer``); the
    step runs under ``implicit_replication`` (a plain tensor the loss makes
    is replicated), each gradient is redistributed to its parameter's
    layout (partial sums reduced to the shards), and the loss and metrics
    come back as plain tensors."""
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
            g = found[name]
            if g is None:
                return torch.zeros_like(x)
            if mesh is not None and g.placements != x.placements:
                g = g.redistribute(x.device_mesh, x.placements)
            return g
        aux = {k: whole(v.detach()).float() for k, v in aux.items()}
        return whole(loss.detach()), aux, map_with_path(grad, live)

    def step(state: TrainState, batch, rng) -> Tuple[TrainState, Dict]:
        if mesh is None:
            return run(state, batch, rng)
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return run(state, batch, rng)

    def run(state: TrainState, batch, rng) -> Tuple[TrainState, Dict]:
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
    """Owns the train state (on one device, or sharded over a mesh) and
    iterates a data stream."""

    def __init__(self, loss_fn: Callable, params: Any, optimizer: Optimizer,
                 cfg: TrainerConfig = TrainerConfig(), device="cuda",
                 mesh=None, rules=None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.device = resolve_device(device)
        self.mesh, self.rules = mesh, rules
        params = tree_map(lambda p: p.detach().to(self.device), params)
        if mesh is not None:
            from ..parallel.partition import shard_params
            params = shard_params(params, mesh, rules)
        self.state = TrainState(0, params, optimizer.init(params))
        self._step = make_train_step(loss_fn, optimizer, cfg.grad_accum,
                                     mesh)

    @property
    def is_main(self) -> bool:
        """True on the rank that logs and writes (rank 0; always without a
        mesh)."""
        return self.mesh is None or torch.distributed.get_rank() == 0

    def _batch(self, batch):
        """A batch on this trainer's device; under a mesh, the rank's slice
        as a DTensor laid out over (data, fsdp) (dim 1 under grad_accum)."""
        batch = tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import DTensor
        from ..parallel.mesh import BATCH_AXES, compute_mesh
        from ..parallel.partition import P, placements
        spec = P(None, BATCH_AXES) if self.cfg.grad_accum > 1 else P(BATCH_AXES)
        cmesh, place = compute_mesh(self.mesh), placements(self.mesh, spec)
        return tree_map(lambda x: DTensor.from_local(x, cmesh, place,
                                                     run_check=False), batch)

    def step(self, batch, rng=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (under a mesh: this rank's slice
        of the global batch)."""
        self.state, metrics = self._step(self.state, self._batch(batch), rng)
        return metrics

    # -------- full-state checkpointing (params + opt moments + step) -------

    def _state_dict(self):
        return {"step": self.state.step, "params": self.state.params,
                "opt_state": self.state.opt_state}

    def save_tree(self, mgr, step: int, tree: Any, is_best: bool = False) -> str:
        """``mgr.save`` of ``tree`` with its DTensors gathered to full
        values, written by rank 0 only; the other ranks wait for it."""
        if self.mesh is None:
            return mgr.save(step, tree, is_best=is_best)
        from ..parallel.local import full_tree
        tree = full_tree(tree)
        path = mgr.save(step, tree, is_best=is_best) if self.is_main else ""
        torch.distributed.barrier()
        return path

    def save_state(self, mgr, is_best: bool = False) -> str:
        """Save the full TrainState through a CheckpointManager, so that an
        interrupted run restarts warm (AdamW moments and the schedule's
        step). Under a mesh the files hold the full tree."""
        return self.save_tree(mgr, int(self.state.step), self._state_dict(),
                              is_best=is_best)

    def restore_state(self, mgr) -> Optional[int]:
        """Restore the latest full TrainState onto this trainer's device (its
        layout under a mesh, whatever the mesh that saved it); returns the
        restored step (None if the directory holds no checkpoint)."""
        step, restored = mgr.restore_latest(self._state_dict())
        if step is None:
            return None
        if self.mesh is not None:
            from ..parallel.partition import shard_params
            restored = {k: (v if k == "step" else
                            shard_params(v, self.mesh, self.rules))
                        for k, v in restored.items()}
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
