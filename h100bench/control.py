"""Readings that set a cell's check limits, on the card, in one process.

    python3 h100bench/control.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds <s>

For each seed, one untraced run of the cell at its own load (set-up, the
window, the check): the numbers the check compares, as the sound program
gives them (the lower readings). For each control seed also the control's
readings on the same sample: the plain reference computed one precision
below the configuration's (every matrix product's activation operand
rounded to fp8 e4m3), put in the program's place, its first token at a
greedy position and a draw from its own nucleus at a sampled one (the
upper readings). One JSON line per seed, then the largest lower and the
smallest upper reading of each number.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100bench.core import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    bench.cache_env()
    manifest = bench.load_manifest()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    lower, upper = {}, {}
    for seed in seeds:
        row = bench.readings(manifest, args.workload, seed, args.seconds,
                             control=seed in ctrl)
        print(json.dumps(row), flush=True)
        for k, v in row["checks"].items():
            lower[k] = max(lower.get(k, v), v)
        for k, v in row.get("control", {}).items():
            upper[k] = min(upper.get(k, v), v)
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": upper, "card": bench.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
