"""The readings that the check's limits are set from, at a cell's own
size on the card: for each seed, one run of the cell (the program's
numbers, the lower readings) and its control judged on the same kept
states by the same check, `check.judge` or the one the configuration
names (``checks/<name>.py``): the reference with TF32 matrix products in
the program's place, the upper readings.  The benchmark's runs never
run it.

    python3 slambench/control.py --workload mid40_replay --seeds 1,2,3 --seconds 30

prints one JSON line a seed: ``{"seed", "program": {number: reading},
"tf32": {number: reading}}``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from slambench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    harness.env_caches(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    manifest = harness.load_manifest(harness.ROOT)
    cell = harness.cell_of(manifest, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, t0, manifest=manifest,
                               controls=("tf32",))
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": {k: c["value"] for k, c in out["checks"].items()},
                          "tf32": out["_controls"]["tf32"], "metrics": out["metrics"],
                          "ate_m": out["_ate_m"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
