"""Training observability: smoothed meters, JSON-lines logs, the profiler
(counterpart of seed_tpu/utils/metrics_logging.py).

The LAVIS logging layer (lavis/common/logger.py MetricLogger and
SmoothedValue with their cross-process sync; runner_base.py:681-692's
log.txt JSON lines), plus what the reference lacks: a ``torch.profiler``
trace around training steps and device-synchronized step timing.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch


def build_logger(logger_name: str, logger_dir: str):
    """Serving / demo logger with a daily-rotating file shared by every
    logger (gradio_demo/utils.py:10-49 build_logger): one
    TimedRotatingFileHandler(when='D', utc=True) per process, on the root,
    so every module's records land in the same file."""
    import logging
    import logging.handlers
    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S")
    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO)
    root.handlers[0].setFormatter(formatter)
    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)
    if not any(isinstance(h, logging.handlers.TimedRotatingFileHandler)
               for h in root.handlers):
        os.makedirs(logger_dir, exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(
            os.path.join(logger_dir, logger_name + ".log"),
            when="D", utc=True)
        fh.setFormatter(formatter)
        root.addHandler(fh)
    return logger


def _process_group():
    """True when torch.distributed has a process group of more than one."""
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


class SmoothedValue:
    """Windowed median / average meter (logger.py SmoothedValue)."""

    def __init__(self, window: int = 20):
        self.deque = collections.deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.deque.append(float(value))
        self.total += float(value) * n
        self.count += n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(1, self.count)

    def synchronize_between_processes(self):
        """Sum (count, total) over the processes of the process group
        (``all_reduce``); nothing to do without one."""
        if not _process_group():
            return
        import torch.distributed as dist
        dev = ("cuda" if dist.get_backend() == "nccl" else "cpu")
        t = torch.tensor([self.count, self.total], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t)
        self.count, self.total = int(t[0].item()), float(t[1].item())


class MetricLogger:
    def __init__(self, delimiter: str = "  ", window: int = 20,
                 log_file: Optional[str] = None):
        self.meters: Dict[str, SmoothedValue] = collections.defaultdict(
            lambda: SmoothedValue(window))
        self.delimiter = delimiter
        self.log_file = log_file

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(
            f"{name}: {m.median:.4f} ({m.global_avg:.4f})"
            for name, m in self.meters.items())

    def write_json_line(self, **extra):
        """Append a log.txt-style JSON line (runner_base.py:681-692)."""
        if not self.log_file:
            return
        rec = {k: m.global_avg for k, m in self.meters.items()}
        rec.update(extra)
        os.makedirs(os.path.dirname(self.log_file) or ".", exist_ok=True)
        with open(self.log_file, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = "", total: Optional[int] = None):
        """Wrap an iterable with periodic prints of the smoothed metrics."""
        start = time.time()
        step_t = SmoothedValue(print_freq)
        last = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            now = time.time()
            step_t.update(now - last)
            last = now
            if i % print_freq == 0 or (total and i == total - 1):
                eta = (total - i) * step_t.global_avg if total else float("nan")
                print(f"{header} [{i}{'/' + str(total) if total else ''}] "
                      f"eta {eta:.0f}s  t/step {step_t.median:.3f}s  {self}",
                      flush=True)
        print(f"{header} done in {time.time() - start:.1f}s", flush=True)


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block (the CPU, and the card when there is
    one); on exit the Chrome trace is written to
    ``log_dir/trace_<pid>_<n>.json``. Yields the profiler (None when not
    ``enabled``)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("trace_"))
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Wall-clock step timing that waits for the device's queued work."""

    def __init__(self):
        self.t0 = None

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self, sync=None) -> float:
        """Seconds since ``start``. ``sync``: a device (or a tensor on it)
        whose queued work is waited for first; None waits for nothing."""
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) else \
                torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - self.t0
