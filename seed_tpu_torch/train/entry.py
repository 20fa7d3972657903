"""What the two training entry points share (``train_llm`` and
``train_tokenizer``): the feed from the background data thread, the step
log, and the rounds of training, evaluation and checkpoints between save
points (the loop of scripts/train_llm.py and scripts/train_tokenizer.py)."""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..utils.checkpoint import CheckpointManager
from ..utils.tree import tree_map


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def rank_device(device: torch.device) -> torch.device:
    """Join torchrun's process group when its environment is set (RANK,
    WORLD_SIZE, MASTER_ADDR, LOCAL_RANK; nccl on ``cuda:{LOCAL_RANK}``, gloo
    on the CPU) unless one is up already; returns the device of this rank.
    Without either, the device as given (one process, no group)."""
    import torch.distributed as dist
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    if dist.is_initialized() and device.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def train_mesh(device: torch.device, tp: int = 1):
    """seed_tpu's ``auto_mesh(tp=tp)`` over the ranks of the process group
    (fsdp over the rest), or None without a group; ``tp`` > 1 then raises."""
    import torch.distributed as dist
    if not dist.is_initialized():
        if tp != 1:
            raise ValueError(f"--tp {tp} shards over {tp} ranks or more: run "
                             f"under torchrun --nproc_per_node N (N a multiple "
                             f"of {tp})")
        return None
    from ..parallel import auto_mesh
    return auto_mesh(tp=tp, device_type=device.type)


class Feed:
    """Iterates the batches of a background producer (``data.Prefetcher``)
    and times how long the training loop waits for each (``waits``).

    A producer may compute its batches on the card, on a CUDA stream of its
    own, and finish them before handing them over; their tensors are then
    marked as used on the consumer's stream too (``record_stream``), so the
    allocator does not hand their memory to the producer's next batch while
    the step still reads it."""

    def __init__(self, source: Iterator, device: torch.device):
        self.source = source
        self.device = device
        self.waits: List[float] = []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.source)
        self.waits.append(time.perf_counter() - t0)
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            tree_map(lambda x: x.record_stream(stream)
                     if isinstance(x, torch.Tensor) and x.is_cuda else None,
                     batch)
        return batch


class StepLog:
    """Prints ``step N: k=v ...`` lines, as the scripts do, and keeps each
    line's metrics with the host time it was written (``records``)."""

    def __init__(self):
        self.records: List[Dict[str, Any]] = []

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        print(f"step {step}: " + " ".join(f"{k}={v:.4f}"
                                          for k, v in metrics.items()),
              flush=True)
        self.records.append({"step": step, "time": time.perf_counter(),
                             **metrics})


def train_rounds(args, trainer, feed: Feed, log: StepLog,
                 run_eval: Callable[[], Optional[Tuple[float, Dict]]],
                 higher_is_better: bool,
                 deploy_tree: Callable[[], Any]) -> Dict[str, Any]:
    """Train from the saved state (``--resume``) or from step 0 to
    ``args.steps`` in rounds of ``args.save_steps``. After each round:
    ``run_eval`` (None, or the score that picks the best checkpoint and the
    metrics to log), the full train state under ``<output>/state`` and
    ``deploy_tree()`` under ``<output>`` (also as ``best`` when the score
    is the best so far). Under a mesh rank 0 logs and writes. Returns the
    run's record."""
    mgr = CheckpointManager(args.output)
    state_mgr = CheckpointManager(os.path.join(args.output, "state"),
                                  max_to_keep=2)
    say = log if trainer.is_main else None   # rank 0 logs (under a mesh)
    start0, resumed = 0, None
    if args.resume:
        resumed = trainer.restore_state(state_mgr)
        if resumed is not None:
            start0 = resumed
            if say:
                print(f"resumed from step {resumed}", flush=True)
    best, evals, round_starts = None, [], []
    for start in range(start0, args.steps, args.save_steps):
        n = min(args.save_steps, args.steps - start)
        round_starts.append(time.perf_counter())
        trainer.train(feed, n, rng=generator(trainer.device, args.seed + start),
                      log_fn=say)
        scored = run_eval()
        is_best = False
        if scored is not None:
            score, metrics = scored
            is_best = best is None or (score > best if higher_is_better
                                       else score < best)
            best = score if is_best else best
            if say:
                say(int(trainer.state.step), metrics)
            evals.append({"step": int(trainer.state.step), **metrics})
        trainer.save_state(state_mgr)                       # operational
        trainer.save_tree(mgr, int(trainer.state.step), deploy_tree(),
                          is_best=is_best)
    if say:
        print("training done", flush=True)
    return {"step": int(trainer.state.step), "resumed_from": resumed,
            "log": log.records, "evals": evals, "data_waits_s": feed.waits,
            "round_starts": round_starts}

