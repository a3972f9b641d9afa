"""A probe on the card, not a cell: the ``mid40`` site with loop closure
on, run through `harness.run_cell` from a bench directory made for it,
against the same stream with loop closure off.

    python3 slambench/tests/loop_probe.py --loop 1 --seed <n> --seconds 30 [--trace 1]
        [--inline 1]

The loop configuration is ``configs/mid40.json`` with the port's
``loop_closure`` scenario's scaled time parameters (``eval/scenarios.py``:
keyframes of 30 frames every 10, a minimum separation of 5, cell
revisit 50), the service on its worker thread (``if_loop_service_async``
1; ``--inline 1``: on the frame thread, 0), and the scenario's
trajectory, whose axes and yaw return to the start; ``--loop 0`` runs
the same site and stream with loop closure off.  The run's check is ``tests/loop/loop_odometry.py`` (loop on) or
the default one (off), under ``mid40_replay``'s limits.  Prints one JSON
line: the result line's numbers, and the loop service's outputs at the
replay window's close (`Records.outputs`, the result's ``"_outputs"``).  The bench directory
is ``.slambench_work/loop_probe`` in the checkout.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from slambench import harness  # noqa: E402
from slambench.tests.tiny import LOOP_FILES  # noqa: E402

LOOP = {"if_enable_loop_closure": 1, "if_loop_service_async": 1,
        "scans_of_each_keyframe": 30, "scans_between_two_keyframe": 10,
        "minimum_keyframe_differen": 5}
RETURNING = {"lin_hz": [0.05, 0.05, 0.05], "yaw_hz": 0.05, "pitch_hz": 0.05}


def make_bench(work: Path, inline: bool = False) -> tuple:
    """(bench directory, manifest) with the cells ``mid40_loop_replay``
    (the service inline where asked) and ``mid40_noloop_replay``."""
    shutil.rmtree(work, ignore_errors=True)
    bench = work / "slambench"
    for sub in ("configs", "traffic", "limits", "checks"):
        (bench / sub).mkdir(parents=True)
    shutil.copytree(harness.HERE / "metrics", bench / "metrics")
    shutil.copy(LOOP_FILES / "loop_keyframes.py", bench / "metrics")
    shutil.copy(LOOP_FILES / "loop_odometry.py", bench / "checks")
    shutil.copy(harness.HERE / "traffic" / "replay.json", bench / "traffic")
    base = harness.load_config("mid40")
    base["site"]["trajectory"] = dict(base["site"]["trajectory"], **RETURNING)
    loop = copy.deepcopy(base)
    loop["slam"] = dict(loop["slam"], common={"threshold_cell_revisit": 50},
                        loop_closure=dict(LOOP, if_loop_service_async=int(not inline)))
    loop["check"] = "loop_odometry"
    limits = harness.load_limits("mid40_replay")
    cells = []
    for name, doc, extra in (("mid40_loop", loop, {"touched_unadmitted": 0.0,
                                                   "keyframes_short": 0.0}),
                             ("mid40_noloop", base, {})):
        (bench / "configs" / f"{name}.json").write_text(json.dumps(doc))
        (bench / "limits" / f"{name}_replay.json").write_text(json.dumps(dict(limits, **extra)))
        cells.append({"name": f"{name}_replay", "config": name, "traffic": "replay",
                      "chips": 1, "why": "probe"})
    manifest = harness.load_manifest(ROOT)
    manifest["workloads"] = cells
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [c["name"] for c in cells] if "mid40_replay" in m["workloads"] \
                else []
    manifest["per_layer"].append({
        "name": "loop_keyframes", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "loop service", "moves": "frames_per_s",
        "workloads": ["mid40_loop_replay"]})
    return bench, manifest


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loop", type=int, choices=(0, 1), required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--inline", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.env_caches(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("loop_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench, manifest = make_bench(ROOT / ".slambench_work" / "loop_probe", bool(args.inline))
    cell = manifest["workloads"][0 if args.loop else 1]
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                           bench=bench, manifest=manifest)
    outputs = out["_outputs"]
    programs = outputs.get("frame_program", [])
    print(json.dumps({
        "cell": cell["name"], "seed": args.seed, "trace": args.trace, "inline": args.inline,
        "correct": out["correct"], "attempted": out["attempted"], "capped": out["capped"],
        "checks": {k: c["value"] for k, c in out["checks"].items()},
        "metrics": {k: m["value"] for k, m in out["metrics"].items()},
        "device": out["device"], "breakdown": out.get("breakdown"),
        "loop_service": outputs.get("loop_service"),
        "captures": [{k: p[k] for k in ("kind", "loop_closure", "launches", "pass_kernels")}
                     for p in programs],
        "ate_m": out["_ate_m"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
