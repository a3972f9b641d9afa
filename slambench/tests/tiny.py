"""A CPU-sized bench directory for the tests: a small configuration of
one head or three, replay and live traffic, the bench's own metric
readers, and a manifest over them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
#: the tiny recording's frames after the warm-up
REPLAY_FRAMES = 6

SMALL_CAPS = {
    "max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
    "max_corner_ds": 256, "max_surface_ds": 1024,
    "map_corner_capacity": 4096, "map_surf_capacity": 16384,
    "hist_corner_capacity": 128, "hist_surf_capacity": 512,
    "history_window": 16,
}


def tiny_config(heads: int) -> dict:
    slam = {"capacity": SMALL_CAPS, "mapping": {"init_accumulate_frames": 3},
            "optimization": {"icp_maximum_iteration": 5, "full_iterations": 3}}
    if heads > 1:
        slam["common"] = {"if_motion_deblur": 0, "piecewise_number": 2}
    return {"name": f"tiny{heads}", "source": "test", "reduced": [], "slam": slam,
            "site": {"scene": {"seed": 0}, "points_per_head": 3000,
                     "heads_yaw_deg": [-30.0, 0.0, 30.0][:heads] if heads > 1 else [0.0]},
            "replay_frames": REPLAY_FRAMES}


def make_bench(tmp: Path) -> tuple[Path, dict]:
    """(bench directory, manifest) with cells tiny1_replay, tiny3_replay,
    tiny1_live."""
    bench = Path(tmp) / "slambench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    for heads in (1, 3):
        (bench / "configs" / f"tiny{heads}.json").write_text(json.dumps(tiny_config(heads)))
    common = {"warmup_frames": 6, "start_registered": 2, "check_samples": 2,
              "trace_after_frames": 1, "trace_frames": 2}
    (bench / "traffic" / "replay.json").write_text(json.dumps(
        dict(common, mode="replay", in_flight=2)))
    (bench / "traffic" / "live.json").write_text(json.dumps(
        dict(common, mode="live", rate_hz=4.0)))
    manifest = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cells = [("tiny1_replay", "tiny1", "replay"), ("tiny3_replay", "tiny3", "replay"),
             ("tiny1_live", "tiny1", "live")]
    manifest["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                             for n, c, t in cells]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, _, t in cells
                              if any(w.endswith("_" + t) for w in m["workloads"])]
    limits = {"pose_gap_m": 0.0, "map_gap_m": 0.0, "feature_gap_m": 0.0}
    for n, _, _ in cells:
        (bench / "limits" / f"{n}.json").write_text(json.dumps(limits))
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench, manifest
