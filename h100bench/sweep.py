"""Find the knee of an open-loop cell: run it at a list of offered rates.

    python3 h100bench/sweep.py --workload <name> --rates 3,4,5,6 \\
        --seconds <s> --seed <n>

One untraced run per rate in one process (set-up, the window; no check),
each printing the end-to-end metrics and the run's summary: requests in
the window, how many finished, the queue left at the close. The highest
rate whose queue does not grow through the window is the knee; a cell's
fixed rate is set once from it and written into its traffic file.
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench.cache_env()
    manifest = bench.load_manifest()
    w = bench.workload(manifest, args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(bench.data("traffic", w["traffic"]), rate_per_s=rate)
        row = bench.readings(manifest, args.workload, args.seed, args.seconds,
                             mix=mix, check=False)
        print(json.dumps({"rate_per_s": rate, **row}), flush=True)
    print(json.dumps({"card": bench.power_limit()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
