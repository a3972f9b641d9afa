"""Scaling of the sharded path over a product mesh (the counterpart of
``loam_livox_tpu/eval/scaling.py``).

A JAX program sees every mesh size at once; a `torch.distributed` rank
sees only its own group.  So each function measures at the mesh it is
given (every rank calls it) against the plain unsharded work in the
same process; records of several world sizes come from several
launches.  At one rank the record is the sharded path's overhead over
the plain one (``sharded_overhead_x``), as the JAX function reports it
at one device.
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np
import torch

from ..ops.knn_fused import knn_fused
from ..parallel.mesh import Mesh, make_mesh
from ..parallel.sharded import knn_sharded, normal_system_psum


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bench(fn, device, n: int = 10) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / n


def _kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def measure_scaling(mesh: Optional[Mesh] = None, device="cuda", n_query: int = 4096,
                    n_ref: int = 65536, k: int = 5, reps: int = 10) -> dict:
    """One correspondence search and normal-equation reduction, sharded
    over ``mesh`` (default: the world group) and plain, timed on
    ``device``."""
    mesh = mesh or make_mesh()
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q = t(rng.uniform(-20, 20, (n_query, 3)).astype(np.float32))
    ref = t(rng.uniform(-20, 20, (n_ref, 3)).astype(np.float32))
    mask = torch.ones(n_ref, dtype=torch.bool, device=device)
    r_all = t(rng.normal(size=(n_query, 3)).astype(np.float32))
    J_all = t(rng.normal(size=(n_query, 3, 6)).astype(np.float32))
    w_all = t(rng.uniform(0, 1, n_query).astype(np.float32))
    ids = torch.arange(n_query, device=device)

    def plain():
        d, _ = knn_fused(q, ref, mask, k=k)
        sw = torch.sqrt(w_all)
        Jw, rw = J_all * sw[:, None, None], r_all * sw[:, None]
        return (d, torch.einsum("nij,nik->jk", Jw, Jw), torch.einsum("nij,ni->j", Jw, rw),
                (rw * rw).sum())

    def sharded():
        d, _ = knn_sharded(q, ref, mask, mesh, k=k)
        return d, normal_system_psum(lambda i: (r_all[i], J_all[i], w_all[i]), ids, mesh)

    plain_t = _bench(plain, device, reps)
    sharded_t = _bench(sharded, device, reps)
    out = {"device_kind": _kind(device), "n_query": n_query, "n_ref": n_ref,
           "plain_time_s": plain_t, "times_s": {str(mesh.size): sharded_t}}
    if mesh.size == 1:
        out["sharded_overhead_x"] = sharded_t / plain_t
    return out


def measure_pipeline_scaling(mesh: Optional[Mesh] = None, device="cuda", frames: int = 20,
                             warmup: int = 6, points_per_frame: int = 3072,
                             caps: Optional[dict] = None) -> dict:
    """Steady-state frames/s of the product pipeline (what the command
    line's ``--mesh N`` runs) at ``mesh`` and of the plain pipeline
    (key ``"0"``), on the same frames."""
    from ..core.config import SlamConfig
    from ..io.simulator import LivoxSimulator, SimConfig, Trajectory
    from ..runtime.pipeline import OdometryPipeline

    mesh = mesh or make_mesh()
    caps = caps or {
        "max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
        "max_corner_ds": 256, "max_surface_ds": 1024,
        "map_corner_capacity": 4096, "map_surf_capacity": 16384,
        "hist_corner_capacity": 128, "hist_surf_capacity": 512,
        "history_window": 16,
    }
    cfg = SlamConfig().replace(
        capacity=caps, mapping={"init_accumulate_frames": 4},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3})
    sim = LivoxSimulator(SimConfig(points_per_frame=points_per_frame, seed=0),
                         traj=Trajectory(ramp_t0=0.6))
    raw = [sim.frame(i) for i in range(warmup + frames)]
    fps = {}
    for key, m in (("0", None), (str(mesh.size), mesh)):
        pipe = OdometryPipeline(cfg, device=device, mesh=m)
        for i in range(warmup):
            pipe.process_raw(*raw[i])
        pipe.flush()
        _sync(pipe.device)
        t0 = time.perf_counter()
        for i in range(warmup, warmup + frames):
            pipe.process_raw(*raw[i])
        pipe.flush()
        _sync(pipe.device)
        fps[key] = frames / (time.perf_counter() - t0)
    out = {"device_kind": _kind(device), "frames": frames, "fps": fps}
    if mesh.size == 1:
        out["sharded_overhead_x"] = fps["0"] / fps["1"]
    return out


def main(argv=None) -> None:
    """One record a launch, printed by rank 0: ``python -m
    loam_livox_tpu_torch.eval.scaling [--pipeline] [--device cpu]`` under
    a launcher (torchrun).  On the cards (NCCL, one card a rank) unless
    ``--device cpu`` asks for gloo ranks on the CPU; without a card and
    without it, it raises."""
    import argparse

    from ..core.types import resolve_device
    from ..parallel.mesh import initialize_multihost

    ap = argparse.ArgumentParser(description=main.__doc__.split("\n\n")[0])
    ap.add_argument("--pipeline", action="store_true",
                    help="frames/s of the pipeline instead of one search and sum")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(None if args.device == "cuda" else "cpu")
    mesh = initialize_multihost(backend="nccl" if dev.type == "cuda" else "gloo")
    if mesh.backend == "nccl":
        dev = torch.device("cuda", mesh.rank)
    run = measure_pipeline_scaling if args.pipeline else measure_scaling
    out = run(mesh, device=dev)
    if mesh.rank == 0:
        print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
