"""Spans, the profiled slice and what is read from it.

Spans are recorded from the benchmark's own files, around the program's
calls, and only in a ``--trace 1`` run: each wrapped call is synchronised
on entry and on exit, so a span holds the call's device work, and is
marked in the profiler's trace (``record_function``) so that idle gaps can
be named by the span open at the time.

The device-event reading follows ``profile_port.py`` (device-side events
only: kernels, copies and memsets, never the host-side ops that launched
them) but reads each event's interval, so that busy time is the union of
the intervals in which any device operation ran, not the sum of kernel
times.
"""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch


@dataclass
class Span:
    name: str
    t0: float               # host perf_counter seconds, after a sync
    t1: float
    info: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int


@dataclass
class Profile:
    """What the profiler saw over one slice of the window."""
    t0: float                       # host clock, synchronised
    t1: float
    ops: List[DeviceOp]             # kernels, copies, memsets
    marks: List[Tuple[str, int, int]]   # (span name, start_ns, end_ns)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[int, int]]:
        iv = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in self.ops)
        out: List[List[int]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_seconds(self, match: Callable[[str], bool]) -> float:
        return sum(o.dur_ns for o in self.ops if match(o.name)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        tot: Dict[str, int] = defaultdict(int)
        for o in self.ops:
            tot[o.name[:120]] += o.dur_ns
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest device-idle gaps inside the traced operations, each
        named by the innermost benchmark span open at its middle."""
        iv = self.busy_intervals()
        gaps = [(b0 - a1, a1, b0) for (_, a1), (b0, _) in zip(iv, iv[1:])]
        gaps.sort(reverse=True)
        out = []
        for width, a, b in gaps[:n]:
            mid = (a + b) // 2
            open_ = [m for m in self.marks if m[1] <= mid <= m[2]]
            name = (min(open_, key=lambda m: m[2] - m[1])[0] if open_
                    else "host, outside any benchmark span")
            out.append([name, width / 1e9])
        return out


class Tracer:
    """Records spans of wrapped calls; inert unless ``on``."""

    PREFIX = "h100bench:"

    def __init__(self, on: bool):
        self.on = on
        self.spans: List[Span] = []
        self.profiles: List[Profile] = []
        self._prof = None
        self._t0 = 0.0

    def wrap(self, obj, attr: str, name: str,
             info: Optional[Callable[..., dict]] = None) -> None:
        """Replace ``obj.attr`` by a synchronised, recorded call when on."""
        if not self.on:
            return
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            meta = info(*args, **kwargs) if info else {}
            with self.span(name, **meta):
                return fn(*args, **kwargs)

        setattr(obj, attr, traced)

    def span(self, name: str, **meta):
        return _SpanCtx(self, name, meta)

    # ------------------------------ profiler ---------------------------------

    def start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop_profile(self) -> None:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)
        ops, marks = read_events(self._prof, self.PREFIX)
        self.profiles.append(Profile(self._t0, t1, ops, marks))
        self._prof = None

    @property
    def profiling(self) -> bool:
        return self._prof is not None


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _SpanCtx:
    def __init__(self, tracer: Tracer, name: str, meta: dict):
        self.tr, self.name, self.meta = tracer, name, meta

    def __enter__(self):
        _sync()
        self.rf = torch.profiler.record_function(Tracer.PREFIX + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        t1 = time.perf_counter()
        self.rf.__exit__(*exc)
        self.tr.spans.append(Span(self.name, self.t0, t1, self.meta))
        return False


_DEVICE_KINDS = ("kernel", "memcpy", "memset")


def _ns(e, name: str) -> int:
    """An event's time in ns, from whichever accessor this torch has."""
    if hasattr(e, name + "_ns"):
        return int(getattr(e, name + "_ns")())
    return int(getattr(e, name + "_us")() * 1000)


def _is_device_op(e, prefix: str) -> bool:
    """A kernel, copy or memset: not a device-side mark of a host range."""
    if hasattr(e, "activity_type"):
        kind = str(e.activity_type()).lower()
        return any(k in kind for k in _DEVICE_KINDS)
    if hasattr(e, "is_user_annotation") and e.is_user_annotation():
        return False
    return not e.name().startswith(prefix)


def read_events(prof, prefix: str):
    """(device operations, benchmark span marks) of a finished profile, from
    the profiler's raw events (a whole slice can hold 10^5 of them, too many
    for the per-event Python objects of ``prof.events()``)."""
    from torch.autograd import DeviceType
    ops, marks = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            dur = _ns(e, "duration")
            if dur > 0 and _is_device_op(e, prefix):
                ops.append(DeviceOp(name, _ns(e, "start"), dur))
        elif name.startswith(prefix):
            start = _ns(e, "start")
            marks.append((name[len(prefix):], start,
                          start + _ns(e, "duration")))
    if not ops:
        raise RuntimeError("the profiler saw no device operation")
    return ops, marks
