"""Ranks of a `torch.distributed` gloo group for the port's multi-rank
tests (tests/test_torch_parallel.py, tests/test_torch_parallel_mode.py).

`launch` spawns ``world`` processes that meet at a ``FileStore`` in the
test's own directory (no TCP port, so parallel test workers cannot
collide), runs one task on every rank and returns each rank's output
arrays.  This module holds no tests and imports nothing of JAX, so a
spawned rank starts with PyTorch alone.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, workdir: str, task: str, params: dict) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        inputs = dict(np.load(os.path.join(workdir, "inputs.npz")))
        out = TASKS[task](inputs, **params)
        np.savez(os.path.join(workdir, f"out{rank}.npz"), **out)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(task: str, world: int, workdir, inputs: dict | None = None,
           timeout: float = 120.0, **params) -> list:
    """Run ``task`` on ``world`` gloo ranks; returns each rank's output
    dict.  A rank that fails, or a group that outlives ``timeout``
    seconds, raises."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):
        if name == "store" or name.startswith("out"):
            os.remove(os.path.join(workdir, name))
    np.savez(os.path.join(workdir, "inputs.npz"), **(inputs or {}))
    ctx = mp.start_processes(_rank_main, args=(world, workdir, task, params), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{task} on {world} ranks outlived {timeout} s")
    return [dict(np.load(os.path.join(workdir, f"out{r}.npz"))) for r in range(world)]


# ---- tasks: (inputs, **params) -> {name: array} ------------------------------

def _knn(inputs, k: int, radius: float):
    """The sharded kNN three ways: every query and no radius; the first
    ``count`` queries within ``radius``; two lanes with their counts."""
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.parallel.sharded import knn_sharded

    t = {n: torch.from_numpy(a) for n, a in inputs.items()}
    mesh = make_mesh()
    full = knn_sharded(t["q"], t["ref"], t["mask"], mesh, k=k)
    part = knn_sharded(t["q"], t["ref"], t["mask"], mesh, k=k,
                       query_count=int(inputs["count"]), max_radius=radius)
    lanes = knn_sharded(t["q"].reshape(2, -1, 3), t["ref"], t["mask"], mesh, k=k,
                        query_count=t["lane_counts"], max_radius=radius)
    return {f"{name}_{x}": v.numpy() for name, pair in
            (("full", full), ("part", part), ("lanes", lanes)) for x, v in zip("di", pair)}


def _psum(inputs, deterministic: bool):
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.parallel.sharded import normal_system_psum

    r, J, w = (torch.from_numpy(inputs[n]) for n in ("r", "J", "w"))
    H, g, c = normal_system_psum(lambda ids: (r[ids], J[ids], w[ids]),
                                 torch.arange(r.shape[0]), make_mesh(),
                                 deterministic=deterministic)
    return {"H": H.numpy(), "g": g.numpy(), "c": c.numpy()}


def _pose_graph(inputs, iterations: int, cg_iterations: int):
    from loam_livox_tpu_torch.loop.pose_graph import PoseGraph, optimize_pose_graph_sharded
    from loam_livox_tpu_torch.parallel.mesh import make_mesh

    g = PoseGraph(*(torch.from_numpy(inputs[f]) for f in PoseGraph._fields))
    q, t, cost = optimize_pose_graph_sharded(g, make_mesh(), iterations=iterations,
                                             cg_iterations=cg_iterations)
    return {"q": q.numpy(), "t": t.numpy(), "cost": cost.numpy()}


def _registration(inputs, iterations: int):
    from loam_livox_tpu_torch.core.types import PointBatch
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.parallel.sharded_registration import sharded_registration

    def batch(prefix):
        xyz = torch.from_numpy(inputs[f"{prefix}_xyz"])
        return PointBatch(xyz=xyz, time=torch.zeros(xyz.shape[0]),
                          mask=torch.from_numpy(inputs[f"{prefix}_mask"]))

    q, t, costs = sharded_registration(batch("frame"), batch("map"),
                                       torch.from_numpy(inputs["q_last"]),
                                       torch.from_numpy(inputs["t_last"]), make_mesh(),
                                       iterations=iterations, deterministic=True)
    return {"q": q.numpy(), "t": t.numpy(), "costs": costs.numpy()}


def _layout(inputs, cfg: dict, frames: int):
    """A few frames through the product pipeline; the rank's slices, the
    gathered state and the slices of that state resharded."""
    from loam_livox_tpu_torch.core.config import from_dict
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig
    from loam_livox_tpu_torch.parallel.layout import gather_state, shard_state
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(from_dict(cfg), device="cpu")
    sim = LivoxSimulator(SimConfig(points_per_frame=3000, seed=1))
    for i in range(frames):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    whole = pipe.state
    again, _ = shard_state(whole, pipe.mesh)
    regathered = gather_state(again, pipe._axes, pipe.mesh)
    return {"slice_map_surface": pipe._state.map_surface.xyz.numpy(),
            "slice_hist_surf": pipe._state.hist_surf_xyz.numpy(),
            "whole_map_surface": whole.map_surface.xyz.numpy(),
            "whole_hist_surf": whole.hist_surf_xyz.numpy(),
            "regathered_equal": np.array(all(
                torch.equal(a, b) for a, b in zip(
                    (regathered.map_surface.xyz, regathered.hist_surf_xyz,
                     regathered.map_corners.mask),
                    (whole.map_surface.xyz, whole.hist_surf_xyz, whole.map_corners.mask))))}


def _pipeline(inputs, cfg: dict, frames: int, seed: int, ramp: float, nudge: bool = False,
              init: int = 0):
    """The product pipeline over a simulator stream: the trajectory,
    the accept flags and every tensor of the final state, gathered."""
    from loam_livox_tpu_torch.core.config import from_dict
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(from_dict(cfg), device="cpu")
    return run_stream(pipe, LivoxSimulator(SimConfig(points_per_frame=3000, seed=seed),
                                           traj=Trajectory(ramp_t0=ramp)),
                      frames, nudge, init)


def run_stream(pipe, sim, frames: int, nudge: bool = False, init: int = 0) -> dict:
    """``frames`` simulator frames through ``pipe`` (with ``nudge``, the
    frames after the first ``init`` moved one float32 ulp); the
    trajectory, accept flags, ground truth and final state's tensors."""
    for i in range(frames):
        xyz, inten, t0 = sim.frame(i)
        if nudge and i >= init:
            xyz = np.nextafter(np.asarray(xyz, np.float32), np.float32(np.inf))
        pipe.process_raw(xyz, inten, t0)
    pipe.flush()
    return {"positions": pipe.trajectory.positions_array(),
            "accepted": np.asarray(pipe.trajectory.accepted),
            "gt": np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times]),
            **state_arrays(pipe.state)}


def state_arrays(st) -> dict:
    """Every tensor and number of an odometry state, by dotted name."""
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if isinstance(v, (torch.Tensor, int, float)):
            out[f"state.{name}"] = np.asarray(v)
        elif isinstance(v, tuple):
            for f, x in zip(v._fields, v):
                if isinstance(x, (torch.Tensor, int, float)):
                    out[f"state.{name}.{f}"] = np.asarray(x)
    return out


def _cli(inputs, argv: list):
    """The command line on every rank, in the group this rank is in
    (as under a launcher); rank 0 prints."""
    import contextlib
    import io

    from loam_livox_tpu_torch.cli import run_odometry

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_odometry.main(argv)
    return {"rc": np.array(rc), "stdout": np.array(buf.getvalue())}


def _scenario(inputs, name: str, frames: int, mesh_devices: int, auto_schedule: int = 1):
    """A small scenario on the CPU (`eval.scenarios.run_scenario`)."""
    from loam_livox_tpu_torch.eval.scenarios import run_scenario

    out = run_scenario(name, frames=frames, small=True, device="cpu",
                       overrides={"parallel": {"mesh_devices": mesh_devices},
                                  "capacity": {"auto_schedule": auto_schedule}})
    return {k: np.array(v) for k, v in out.items()
            if isinstance(v, (bool, int, float, str))}


def _scaling(inputs):
    """`eval.scaling` at this group's size, tiny shapes."""
    from loam_livox_tpu_torch.eval.scaling import measure_pipeline_scaling, measure_scaling

    k = measure_scaling(device="cpu", n_query=128, n_ref=2048, k=3, reps=2)
    caps = {"max_raw_points": 2048, "max_corner": 128, "max_surface": 512,
            "max_corner_ds": 128, "max_surface_ds": 512, "map_corner_capacity": 2048,
            "map_surf_capacity": 8192, "hist_corner_capacity": 128,
            "hist_surf_capacity": 512, "history_window": 8}
    p = measure_pipeline_scaling(device="cpu", frames=3, warmup=2, points_per_frame=1024,
                                 caps=caps)
    return {"plain_time_s": np.array(k["plain_time_s"]),
            "sharded_time_s": np.array(list(k["times_s"].values())),
            "sizes": np.array([int(x) for x in k["times_s"]]),
            "fps_keys": np.array(sorted(p["fps"])), "fps": np.array([p["fps"][x] for x in
                                                                     sorted(p["fps"])]),
            "overhead": np.array(k.get("sharded_overhead_x", -1.0))}


def _resume(inputs, cfg: dict, frames: int, split: int, ckpt: str):
    """Product mode saved after ``split`` frames and resumed on every rank,
    against the run straight through: equal rows and state, by rank."""
    from loam_livox_tpu_torch.core.config import from_dict
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.runtime.checkpoint import load_pipeline, save_pipeline
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    c = from_dict(cfg)
    sim = LivoxSimulator(SimConfig(points_per_frame=3000, seed=3), traj=Trajectory(ramp_t0=0.5))
    raw = [sim.frame(i) for i in range(frames)]
    whole = OdometryPipeline(c, device="cpu")
    for f in raw[:split]:
        whole.process_raw(*f)
    save_pipeline(whole, ckpt)
    for f in raw[split:]:
        whole.process_raw(*f)
    whole.flush()
    second = load_pipeline(ckpt, c, device="cpu", mesh=make_mesh())
    for f in raw[split:]:
        second.process_raw(*f)
    second.flush()
    a, b = state_arrays(whole.state), state_arrays(second.state)
    return {"rows_whole": whole.trajectory.positions_array()[-(frames - split):],
            "rows_second": second.trajectory.positions_array(),
            "fields": np.array(len(a)), "slices": np.array(second._axes is not None),
            "state_equal": np.array(a.keys() == b.keys()
                                    and all(np.array_equal(a[k], b[k]) for k in a))}


TASKS = {"scenario": _scenario, "resume": _resume, "scaling": _scaling, "knn": _knn, "psum": _psum, "pose_graph": _pose_graph, "cli": _cli,
         "registration": _registration, "layout": _layout, "pipeline": _pipeline}
