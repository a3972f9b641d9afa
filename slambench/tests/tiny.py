"""A CPU-sized bench directory for the tests: a small configuration of
one head or three, replay and live traffic, the bench's own metric
readers and checks, and a manifest over them; and a loop-closure cell
added to it by new files alone (`add_loop_cell`)."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
#: the loop-closure cell's check (``loop_odometry``) and metric (``loop_keyframes``)
LOOP_FILES = Path(__file__).resolve().parent / "loop"
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
    if (BENCH / "checks").is_dir():
        shutil.copytree(BENCH / "checks", bench / "checks")
    else:
        (bench / "checks").mkdir()
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


def loop_config(async_service: bool = False) -> dict:
    """One head with loop closure on, at the CPU sizes of the port's
    ``loop_closure`` scenario (``eval/scenarios.py``, ``small``), its
    keyframes cut to the tiny stream (4 frames every 2), on a
    trajectory whose axes and yaw return to the start; its check is
    ``loop_odometry``."""
    cfg = tiny_config(1)
    cfg.update(name="tiny_loop", check="loop_odometry")
    cfg["slam"]["common"] = {"if_motion_deblur": 0, "piecewise_number": 1,
                             "threshold_cell_revisit": 50}
    cfg["slam"]["loop_closure"] = {
        "if_enable_loop_closure": 1, "if_loop_service_async": int(async_service),
        "scans_of_each_keyframe": 4, "scans_between_two_keyframe": 2,
        "minimum_keyframe_differen": 2, "avail_ratio_plane": 0.005, "avail_ratio_line": 0.0}
    cfg["site"].update(points_per_head=3072, trajectory={
        "lin_hz": [0.05, 0.05, 0.05], "yaw_hz": 0.05, "pitch_hz": 0.05})
    return cfg


def add_loop_cell(bench: Path, manifest: dict, async_service: bool = False) -> dict:
    """Add the cell ``tiny_loop_replay`` (`loop_config` under replay
    traffic) by new files and manifest entries alone: the configuration,
    its check, its limits, and the per-layer metric ``loop_keyframes``
    (read from the loop service's outputs).  Returns the cell."""
    name = "tiny_loop_replay"
    (bench / "configs" / "tiny_loop.json").write_text(json.dumps(loop_config(async_service)))
    shutil.copy(LOOP_FILES / "loop_odometry.py", bench / "checks" / "loop_odometry.py")
    shutil.copy(LOOP_FILES / "loop_keyframes.py", bench / "metrics" / "loop_keyframes.py")
    (bench / "limits" / f"{name}.json").write_text(json.dumps(
        {"pose_gap_m": 0.0, "map_gap_m": 0.0, "touched_unadmitted": 0.0, "keyframes_short": 0.0}))
    cell = {"name": name, "config": "tiny_loop", "traffic": "replay", "chips": 1,
            "why": "test"}
    manifest["workloads"].append(cell)
    for m in manifest["end_to_end"]:
        if m["name"] == "frames_per_s":
            m["workloads"].append(name)
    manifest["per_layer"].append({
        "name": "loop_keyframes", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "loop service", "moves": "frames_per_s",
        "workloads": [name]})
    return cell
