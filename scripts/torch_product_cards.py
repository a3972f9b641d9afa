#!/usr/bin/env python3
"""Product mode of the PyTorch port across several cards (NCCL), on the
frame program and on the plain program, held against one card.

    torchrun --standalone --nproc-per-node 4 scripts/torch_product_cards.py \
        [--frames 40] [--subsample 0]

(``--device cpu`` runs the plain programs on CPU ranks under gloo, a
rehearsal: the frame program runs on the card only.)

Every rank runs the main path's configuration (the configured
capacities, unscheduled as product mode runs; registration after 10
frames; ``--subsample`` the residual-block cap, 0 off) in product mode
on its own card: on the frame program (one CUDA
graph launch a frame: the rank's slices gathered into the whole static
state, the steps with the sharded kNN inside the ICP loop's WHILE
bodies, its candidates exchanged by `ops.peer_gather`'s kernel, this
rank's rows copied back), then on the plain
program (``program = None``), each bit-equal to the other, state
tensors included, on every rank.  Then rank 0 runs one card alone on the
frame program and on the plain program over the same frames, and every
rank times the sharded kNN and normal-equation step against the plain
one (`eval.scaling.measure_scaling`).  Rank 0 prints one JSON line: the
cards (nvidia-smi's name and power limit), frames/s of the four runs,
whether the rows (times, positions, quaternions, accept flags) are
equal bit for bit between them, the graph launches and the ICP-exit
reads, and the scaling record.  It exits nonzero when any rows or
states differ.
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


def run(cfg, frames, device, mesh=None, plain=False):
    """The frames through a new pipeline (``plain``: the plain program);
    returns it, its seconds, its host syncs and graph counts."""
    from loam_livox_tpu_torch.runtime import pipeline as P

    pipe = P.OdometryPipeline(cfg, device=device, mesh=mesh)
    if plain:
        pipe.program = None
    sync(device)
    P.reset_host_syncs()
    t0 = time.perf_counter()
    for f in frames:
        pipe.process_raw(*f)
    pipe.flush()
    sync(device)
    return pipe, time.perf_counter() - t0, P.host_syncs(), P.graph_counts()


def states_equal(a, b) -> bool:
    """Every tensor of two odometry states equal (the threefry key too)."""
    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, tuple):
            return [x for part in tree for x in leaves(part)]
        return []

    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--subsample", type=int, default=0,
                    help="optimization/subsample_residuals (0: off)")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    args = ap.parse_args()

    import torch.distributed as dist

    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.eval.scaling import measure_scaling
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.ops import build
    from loam_livox_tpu_torch.parallel.mesh import initialize_multihost

    cards = args.device == "cuda"
    mesh = initialize_multihost(backend="nccl" if cards else "gloo")
    dev = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", mesh.rank))) if cards
           else torch.device("cpu"))
    if mesh.rank == 0 and cards:
        build.compile_all(["knn_fused", "debounce", "graph_cond", "threefry", "peer_gather",
                           "voxel_centroid"])
    dist.barrier()
    # product mode runs unscheduled, so the one-card runs do too
    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 10},
                               capacity={"auto_schedule": 0},
                               parallel={"mesh_devices": mesh.size},
                               optimization={"subsample_residuals": args.subsample})
    if not cards:           # CPU-scale capacities for the rehearsal
        from loam_livox_tpu_torch.eval.scenarios import SMALL_CAPS

        cfg = cfg.replace(capacity={**SMALL_CAPS, "max_raw_points": 16384, "auto_schedule": 0,
                                    "map_corner_capacity": 1024, "map_surf_capacity": 4096})
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * 10 + 0.2))
    frames = [sim.frame(i) for i in range(args.frames)]

    runs = {}
    runs["product"] = run(cfg, frames, dev, mesh)
    runs["product_plain"] = run(cfg, frames, dev, mesh, plain=True)
    same = states_equal(runs["product"][0].state, runs["product_plain"][0].state)
    scaling = (measure_scaling(mesh, device=dev, reps=20) if cards else
               measure_scaling(mesh, device=dev, n_query=256, n_ref=4096, reps=2))
    flags = [None] * mesh.size
    dist.all_gather_object(flags, same)
    record = None
    if mesh.rank == 0:
        one = cfg.replace(parallel={"mesh_devices": 1})
        runs["one_card"] = run(one, frames, dev)
        runs["one_card_plain"] = run(one, frames, dev, plain=True)
        ref = rows(runs["one_card_plain"][0])
        equal = {label: all(np.array_equal(rows(r[0])[k], ref[k]) for k in ref)
                 for label, r in runs.items()}
        card = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60).stdout.strip().splitlines() if cards else ["cpu"])
        record = {"ranks": mesh.size, "backend": mesh.backend, "cards": card,
                  "frames": args.frames, "subsample_residuals": args.subsample,
                  **{f"{label}_fps": args.frames / r[1] for label, r in runs.items()},
                  "rows_equal_one_card_plain": equal,
                  "states_equal_graph_plain_by_rank": flags,
                  "one_card_states_equal": states_equal(runs["one_card"][0].state,
                                                        runs["one_card_plain"][0].state),
                  "graph_launches": {label: r[3]["graph_launch"] for label, r in runs.items()},
                  "icp_exit_reads": {label: r[2]["icp_exit"] for label, r in runs.items()},
                  "on_frame_program": {label: r[0].program is not None
                                       for label, r in runs.items()},
                  "accepted": int(ref["accepted"].sum()),
                  "loop_iterations": runs["product"][0].loop_iterations, "scaling": scaling}
        print(json.dumps(record), flush=True)
    ok = record is None or (all(record["rows_equal_one_card_plain"].values()) and all(flags)
                            and record["one_card_states_equal"])
    sys.stdout.flush()
    # every collective is done (rank 0's one-card runs need none): leave
    # without the group's teardown, which with the candidates' symmetric
    # buffers alive was seen to hang on 4 cards after every result was
    # printed
    os._exit(0 if ok else 1)


if __name__ == "__main__":
    sys.exit(main())
