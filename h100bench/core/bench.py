"""The harness: finds a cell's pieces by name and runs it once.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``h100bench/configs/<config>.json``: sizes, deployment, check limits;
  its ``kind`` names ``h100bench/models/<kind>.py`` (builds and drives the
  port) and ``h100bench/reference/<kind>.py`` (the plain fp32 reference);
- ``h100bench/traffic/<traffic>.json``: the mix, read by ``core/traffic.py``
  or, where it names ``"generator": "<name>"``, by
  ``h100bench/generators/<name>.py``;
- ``h100bench/metrics/<metric>.py``: ``read(run) -> float | None``.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
GENERATORS = BENCH / "generators"
# modules that must not be loaded in a measured process (top-level names,
# compared whole: the port's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "seed_tpu")


def cache_env(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, so
    that only a cell's first run there builds. The port's own kernels build
    into ``build/seed_tpu_torch/`` of the checkout."""
    build = root / "build" / "h100bench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ.setdefault("USE_FLAX", "0")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def data(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def _load(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str):
    return _load(BENCH / "models" / f"{kind}.py", f"h100bench_kind_{kind}")


def reference_module(kind: str):
    return _load(BENCH / "reference" / f"{kind}.py", f"h100bench_ref_{kind}")


def open_loop(mix: dict):
    """The open-loop generator of a mix: ``open_loop(mix, seed, seconds,
    vocab, max_len) -> [core.traffic.Request]`` of the module that its
    ``"generator"`` names, or of ``core/traffic.py``."""
    name = mix.get("generator")
    if name is None:
        from . import traffic
        return traffic.open_loop
    return _load(GENERATORS / f"{name}.py",
                 "h100bench_gen_" + name.replace(".", "_").replace("-", "_")
                 ).open_loop


def metric_reader(name: str):
    mod = _load(BENCH / "metrics" / f"{name}.py",
                "h100bench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def metrics_for(manifest: dict, section: str, wname: str) -> List[dict]:
    """The metrics of ``section`` that cell ``wname`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or wname in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What a per-layer reader sees of a finished window."""
    cell: object                 # the kind's cell: spec, counts, window
    spans: list                  # core.trace.Span
    profile: object              # core.trace.Profile of the traced slice
    window: tuple                # (start, end), host perf_counter seconds

    def in_window(self, name_prefix: str = "") -> list:
        a, b = self.window
        return [s for s in self.spans if s.name.startswith(name_prefix)
                and s.t0 >= a and s.t1 <= b]

    def in_profile(self, name_prefix: str = "") -> list:
        a, b = self.profile.t0, self.profile.t1
        return [s for s in self.spans if s.name.startswith(name_prefix)
                and s.t0 >= a and s.t1 <= b]


def run_cell(manifest: dict, wname: str, seed: int, seconds: float,
             trace: bool, t_start: float, device: str = "cuda",
             config: Optional[dict] = None, mix: Optional[dict] = None,
             patch=None) -> dict:
    """One run of cell ``wname``: set-up, the window, the check. Returns the
    result line's object (without printing it). ``config`` / ``mix``
    replace the cell's files (tests at tiny sizes); ``patch(cell)`` runs
    after set-up (tests that break the timed path)."""
    import torch
    from .trace import Tracer
    w = workload(manifest, wname)
    config = config or data("configs", w["config"])
    mix = mix or data("traffic", w["traffic"])
    kind = kind_module(config["kind"])
    tracer = Tracer(trace)
    cell = kind.build(config, mix, seed, seconds, device, tracer)
    cell.warm()
    if patch is not None:
        patch(cell)
    cell.window(t_start)
    out_metrics = {}
    if trace:
        run = Run(cell, tracer.spans, tracer.profiles[-1], cell.window_bounds)
        for m in metrics_for(manifest, "per_layer", wname):
            v = metric_reader(m["name"])(run)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = cell.end_to_end()
        for m in metrics_for(manifest, "end_to_end", wname):
            out_metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = device_info(device, trace, tracer)
    summary = cell.summary()
    print(json.dumps({"summary": summary}), flush=True)
    cell.release()
    checks = cell.check()
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": cell.attempted,
              "failed": cell.failed, "metrics": out_metrics, "device": dev}
    if trace:
        p = tracer.profiles[-1]
        result["breakdown"] = {"device_ops": p.top_ops(10),
                               "idle_gaps": p.idle_gaps(10)}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return result


def readings(manifest: dict, wname: str, seed: int, seconds: float,
             mix: Optional[dict] = None, check: bool = True,
             control: bool = False, config: Optional[dict] = None,
             device: str = "cuda") -> dict:
    """One untraced run inside this process, for the sweep and the control
    readings: the end-to-end metrics, the run's summary, and (``check``) the
    compared numbers and (``control``) the control's readings."""
    import gc
    import torch
    from .trace import Tracer
    w = workload(manifest, wname)
    config = config or data("configs", w["config"])
    mix = mix or data("traffic", w["traffic"])
    cell = kind_module(config["kind"]).build(config, mix, seed, seconds,
                                             device, Tracer(False))
    cell.warm()
    cell.window(now())
    out = {"seed": seed, "metrics": cell.end_to_end(),
           "summary": cell.summary()}
    if device == "cuda":
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    cell.release()
    if check:
        out["checks"] = {c["name"]: c["value"] for c in cell.check()}
    if control:
        out["control"] = cell.control()
    del cell
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return out


def device_info(device: str, trace: bool, tracer) -> dict:
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1,
         "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    if trace:
        p = tracer.profiles[-1]
        d["busy_s"] = p.busy_s()
        d["window_s"] = p.window_s
    return d


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def now() -> float:
    return time.perf_counter()
