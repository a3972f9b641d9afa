"""The JAX package's benchmark scenarios (``loam_livox_tpu/eval/
scenarios.py``) that the port runs, on the synthetic stream.

`scenario_config` returns ``(SlamConfig, runner kwargs)``; `run_scenario`
drives `OdometryPipeline` over the simulator and scores the trajectory,
and with loop closure the loop and its payoff.  All five scenarios are
ported: ``odometry_only``, ``full_mapping`` (cell matching),
``largescale_realtime``, ``loop_closure`` (keyframes, scene alignment,
pose graph, in the orientation-rich world) and ``mid100_trilidar``
(three-head front end).

    python -m loam_livox_tpu_torch.eval.scenarios [names] [--set NS/KEY=VALUE]
        [--device cpu] [--small] [--frames N]

prints one JSON line a scenario (default: all), with the JAX package's
``--set`` overrides (``loam_livox_tpu/eval/scenarios.py:273-300``,
repeatable, applied to every scenario; an integer, else a float, else a
string); on the card unless ``--device`` says otherwise; ``--small``
runs the CPU-scale CI variants and ``--frames`` cuts each stream.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List

import numpy as np

from ..core.config import SlamConfig, largescale_profile

#: CPU-scale capacities of the CI variants (``small=True``), as in the
#: JAX package
SMALL_CAPS = {
    "max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
    "max_corner_ds": 256, "max_surface_ds": 1024,
    "map_corner_capacity": 4096, "map_surf_capacity": 16384,
    "hist_corner_capacity": 128, "hist_surf_capacity": 512,
    "history_window": 16,
}

SCENARIOS = ("odometry_only", "full_mapping", "largescale_realtime",
             "loop_closure", "mid100_trilidar")

def scenario_config(name: str, small: bool = False):
    """(SlamConfig, runner kwargs) of a scenario; ``small=True`` is the
    CPU-scale CI variant (tests/test_scenarios_ci.py)."""
    if name == "odometry_only":
        # Mid-40 short sequence, odometry only
        cfg = SlamConfig().replace(
            common={"if_motion_deblur": 0, "piecewise_number": 1},
            mapping={"init_accumulate_frames": 10},
            capacity={"max_raw_points": 8192, "map_surf_capacity": 32768,
                      "map_corner_capacity": 8192},
        )
        kw = {"frames": 40, "points": 8192}
    elif name == "full_mapping":
        # Mid-40 odometry and mapping with motion deblur and cell matching
        cfg = SlamConfig().replace(
            mapping={"init_accumulate_frames": 20, "matching_mode": 1})
        kw = {"frames": 60, "points": 10000}
    elif name == "mid100_trilidar":
        # three heads through the multi-LiDAR front end, two pieces a frame
        cfg = SlamConfig().replace(
            common={"if_motion_deblur": 0, "piecewise_number": 2},
            capacity={"max_raw_points": 8192})
        kw = {"frames": 30, "points": 8192, "sensors": 3}
    elif name == "largescale_realtime":
        # coarse resolutions, realtime profile, an outdoor-scale scene
        cfg = largescale_profile().replace(mapping={"init_accumulate_frames": 20})
        kw = {"frames": 60, "points": 10000,
              "scene": {"half_extent": 45.0, "half_extent_z": 8.0,
                        "n_pillars": 14, "n_ridges": 24},
              "traj_scale": 4.0}
    elif name == "loop_closure":
        # the shipped loop gates unchanged (similarity 0.94 / 0.65, ratios
        # 0.05 / 0.03, alignment score 0.20); only the time parameters are
        # scaled to a 17 s run: cell revisit 50 frames, keyframes 30 / 10.
        # Deblur off, 1 cm noise, an orientation-rich 56 m world, and a
        # trajectory whose axes and yaw return to the start at 10 s.
        cfg = SlamConfig().replace(
            common={"if_motion_deblur": 0, "piecewise_number": 1,
                    "threshold_cell_revisit": 50},
            mapping={"init_accumulate_frames": 10},
            loop_closure={"if_enable_loop_closure": 1, "scans_of_each_keyframe": 30,
                          "scans_between_two_keyframe": 10, "minimum_keyframe_differen": 5})
        kw = {"frames": 170, "points": 10000, "noise": 0.01, "scene_kind": "rich",
              "scene": {"half_extent": 28.0, "half_extent_z": 5.0, "n_rot_boxes": 28,
                        "n_rocks": 48, "n_ridges": 14},
              "traj": {"lin_hz": np.array([0.05, 0.05, 0.05]), "yaw_hz": 0.05,
                       "pitch_hz": 0.05}}
    else:
        raise KeyError(name)
    if small:
        cfg = cfg.replace(
            capacity=SMALL_CAPS,
            mapping={"init_accumulate_frames": 6},
            optimization={"icp_maximum_iteration": 5, "full_iterations": 3},
        )
        kw = dict(kw, points=3072, frames=min(kw["frames"], 24))
        if name == "loop_closure":
            # keyframes that complete within 40 frames, and admission
            # ratios that a CPU-scale point budget can pass: the machinery
            # runs, the shipped gates do not close a loop here; the default
            # room instead of the rich world
            cfg = cfg.replace(loop_closure={
                "scans_of_each_keyframe": 12, "scans_between_two_keyframe": 6,
                "minimum_keyframe_differen": 2, "avail_ratio_plane": 0.005,
                "avail_ratio_line": 0.0})
            kw = dict(kw, frames=40, noise=0.005)
            kw.pop("scene")
            kw.pop("scene_kind")
    return cfg, kw


def simulators(cfg: SlamConfig, kw: Dict):
    """One simulator a head (``kw['sensors']``, default 1), seeded 0, 1,
    ...: each with its own scene from that seed (``scene_kind`` "rich":
    the orientation-rich world, else a room), all on one trajectory
    (``traj`` overrides its fields) whose standstill ramp covers the
    init-accumulation window."""
    from ..io.simulator import ConvexScene, LivoxSimulator, SimConfig, Trajectory

    make_scene = (ConvexScene.random_rich_world if kw.get("scene_kind") == "rich"
               else ConvexScene.random_room)
    sims = []
    for s in range(kw.get("sensors", 1)):
        rng = np.random.default_rng(s)
        scene = make_scene(rng, **kw["scene"]) if "scene" in kw else None
        traj = Trajectory(ramp_t0=0.1 * cfg.mapping.init_accumulate_frames + 0.2)
        traj.lin_amp = traj.lin_amp * kw.get("traj_scale", 1.0)
        for attr, val in kw.get("traj", {}).items():
            setattr(traj, attr, val)
        sims.append(LivoxSimulator(SimConfig(points_per_frame=kw["points"], seed=s,
                                             noise_std=kw.get("noise", 0.005)),
                                   scene=scene, traj=traj))
    return sims


def multi_head_frame(pipe, parts) -> None:
    """One raw frame of every head (``parts``: each head's ``(xyz,
    intensity, t0)``) through the multi-LiDAR front end and each merged
    piece's source voxel filter (`OdometryPipeline.head_frames`), then one
    odometry step a piece: on the frame program 1 + P graph launches."""
    from ..core.types import to_device

    nr = pipe.cfg.capacity.max_raw_points
    xyz = np.zeros((len(parts), nr, 3), np.float32)
    inten = np.zeros((len(parts), nr), np.float32)
    mask = np.zeros((len(parts), nr), bool)
    for s, (x, it, _) in enumerate(parts):
        m = min(len(x), nr)
        xyz[s, :m], inten[s, :m], mask[s, :m] = x[:m], it[:m], True
    dev = pipe.device
    for fr in pipe.head_frames(to_device(xyz, dev), to_device(inten, dev),
                               to_device(mask, dev), parts[0][2]):
        pipe.process_feature_frame(fr)


def run_scenario(name: str, frames: int | None = None, small: bool = False,
                 overrides: Dict | None = None, device=None) -> Dict:
    """Run a scenario on the simulator; returns frames/s, aligned and raw
    ATE, the accepted trajectory rows, whether a loop closed and, when
    one did, its payoff (`eval.loop_payoff.score_loop_payoff`).  On the
    card unless ``device`` says otherwise."""
    from ..runtime.pipeline import OdometryPipeline
    from .ate import ate_rmse
    from .loop_payoff import score_loop_payoff

    cfg, kw = scenario_config(name, small=small)
    if overrides:
        cfg = cfg.replace(**overrides)
    n = frames or kw["frames"]
    sims = simulators(cfg, kw)
    pipe = OdometryPipeline(cfg, device=device)
    t0 = time.perf_counter()
    for i in range(n):
        if len(sims) == 1:
            pipe.process_raw(*sims[0].frame(i))
        else:
            multi_head_frame(pipe, [sim.frame(i) for sim in sims])
    pipe.flush()
    wall = time.perf_counter() - t0
    est = pipe.trajectory.positions_array()
    gt = np.stack([sims[0].gt_pose_at(t)[1] for t in pipe.trajectory.times])
    closer = pipe.loop_closer
    return {
        "scenario": name,
        "frames": n,
        "fps": n / wall,
        "ate_aligned": ate_rmse(est, gt),
        "ate_raw": ate_rmse(est, gt, align=False),
        "accepted": int(sum(pipe.trajectory.accepted)),
        "rows": len(est),
        "loop_closed": bool(closer is not None and closer.closed),
        "keyframes": len(closer.keyframes) if closer is not None else 0,
        **score_loop_payoff(closer, pipe.trajectory.times, sims[0].gt_pose_at),
    }


def parse_overrides(args: List[str]):
    """``(names, overrides, options)`` from the command line: ``--set
    NS/KEY=VALUE`` as the JAX package parses it (``NS.KEY`` too; the value
    an int, else a float, else a string), ``--device``, ``--small`` and
    ``--frames``; every other word names a scenario."""
    overrides: Dict = {}
    names, opts = [], {"device": None, "small": False, "frames": None}
    i = 0
    while i < len(args):
        if args[i] == "--set":
            path, val = args[i + 1].split("=", 1)
            ns, key = path.replace(".", "/").split("/", 1)
            try:
                v: object = int(val)
            except ValueError:
                try:
                    v = float(val)
                except ValueError:
                    v = val
            overrides.setdefault(ns, {})[key] = v
            i += 2
        elif args[i] in ("--device", "--frames"):
            opts[args[i][2:]] = args[i + 1] if args[i] == "--device" else int(args[i + 1])
            i += 2
        elif args[i] == "--small":
            opts["small"] = True
            i += 1
        else:
            names.append(args[i])
            i += 1
    return names, overrides, opts


if __name__ == "__main__":
    import sys

    names, overrides, opts = parse_overrides(sys.argv[1:])
    for nm in names or list(SCENARIOS):
        print(json.dumps(run_scenario(nm, frames=opts["frames"], small=opts["small"],
                                      overrides=overrides or None, device=opts["device"]),
                         default=float), flush=True)
