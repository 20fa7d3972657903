"""Run one cell of the port's benchmark once.

    python3 h100bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration and traffic
files under ``h100bench/``), makes the weights and inputs on the card from
the seed, warms up the cell's shapes, measures for ``--seconds``, checks the
timed path's outputs against the plain fp32 reference, and prints the result
as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Earlier lines
say what the run saw (the card and its power limit, request counts, how
late the generator ran).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench.core import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench.cache_env()
    manifest = bench.load_manifest()
    w = bench.workload(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(json.dumps({"card": bench.power_limit(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    result = bench.run_cell(manifest, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_START)
    bad = bench.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the measured process: {bad}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
