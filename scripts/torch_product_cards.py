#!/usr/bin/env python3
"""Product mode of the PyTorch port across several cards (NCCL), held
against the plain single-card pipeline on the same frames.

    torchrun --standalone --nproc-per-node 4 scripts/torch_product_cards.py [--frames 40]

(``--device cpu`` runs the same on CPU ranks under gloo, a rehearsal.)

Every rank runs the main path's configuration (default capacities,
registration after 10 frames) in product mode on its own card: the
state kept as the rank's slices, the matching buffer's kNN sharded over
the ranks and merged (`loam_livox_tpu_torch.parallel`).  Then rank 0
runs the plain pipeline on its card over the same frames, and every
rank times the sharded kNN and normal-equation step against the plain
one (`eval.scaling.measure_scaling`).  Rank 0 prints one JSON line: the
card (nvidia-smi's name and power limit), frames/s of both runs,
whether the trajectories (times, positions, quaternions, accept flags)
are equal bit for bit, the kernel's launches, and the scaling record.
It exits nonzero when the rows differ.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def rows(pipe) -> dict:
    tr = pipe.trajectory
    return {"times": np.asarray(tr.times), "positions": tr.positions_array(),
            "quaternions": np.asarray(tr.quaternions), "accepted": np.asarray(tr.accepted)}


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, frames, device, mesh=None):
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg, device=device, mesh=mesh)
    sync(device)
    t0 = time.perf_counter()
    for f in frames:
        pipe.process_raw(*f)
    pipe.flush()
    sync(device)
    return pipe, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args()

    import torch.distributed as dist

    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.eval.scaling import measure_scaling
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.ops import build
    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.parallel.mesh import initialize_multihost

    cards = args.device == "cuda"
    mesh = initialize_multihost(backend="nccl" if cards else "gloo")
    dev = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", mesh.rank))) if cards
           else torch.device("cpu"))
    if mesh.rank == 0 and cards:
        build.compile_all(["knn_fused"])
    dist.barrier()
    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 10},
                               parallel={"mesh_devices": mesh.size})
    if not cards:           # CPU-scale capacities for the rehearsal
        cfg = cfg.replace(capacity={"max_raw_points": 16384, "map_corner_capacity": 1024,
                                    "map_surf_capacity": 4096})
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * 10 + 0.2))
    frames = [sim.frame(i) for i in range(args.frames)]

    kf.launches = 0
    product, wall_p = run(cfg, frames, dev, mesh)
    launches = kf.launches
    scaling = measure_scaling(mesh, device=dev, reps=20)
    record = None
    if mesh.rank == 0:
        plain, wall_1 = run(cfg.replace(parallel={"mesh_devices": 1}), frames, dev)
        a, b = rows(product), rows(plain)
        equal = {k: bool(np.array_equal(a[k], b[k])) for k in a}
        card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60).stdout.strip().splitlines() if cards else ["cpu"])
        record = {"ranks": mesh.size, "backend": mesh.backend, "cards": card,
                  "frames": args.frames, "product_fps": args.frames / wall_p,
                  "plain_fps": args.frames / wall_1, "rows_equal_plain": equal,
                  "accepted": int(a["accepted"].sum()), "knn_fused_launches_rank0": launches,
                  "loop_iterations": product.loop_iterations, "scaling": scaling}
        print(json.dumps(record), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0 if record is None or all(record["rows_equal_plain"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
