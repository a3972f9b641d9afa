"""Frames/s of a few paths of the port through two checkouts on one card,
in turns (baseline, this, this, baseline, ``--rounds`` times), so that
the two are compared on the same card within one call.

    python scripts/torch_rows_in_turns.py --baseline DIR [--frames 20] [--rounds 1]
                                          [--rows a,b] [--out FILE]

``DIR`` is an earlier checkout of the repo (``git archive <commit> | tar
-x -C DIR``).  Each turn is a child process with its checkout first on
``sys.path``; it simulates the frames, pads them onto the card, and runs
each row through a fresh ``OdometryPipeline`` after a 12-frame warm-up
of the same configuration (the kernels' first launches):

    main_fixed        ``SlamConfig()`` at the configured capacities, the
                      frame program where the checkout has one
    main_fixed_plain  the same through the plain program (``program =
                      None``; the same as ``main_fixed`` in a checkout
                      without a frame program)
    dense             the ``dense`` correspondence engine, on the frame
                      program where the checkout runs it there, else the
                      plain program
    dense_plain       the same through the plain program
    grid              the ``grid`` engine, likewise
    grid_plain        the same through the plain program
    main_fixed_plain_branched
                      ``main_fixed_plain`` with the matching-buffer update
                      branched on the host (one read of its flags a
                      step, the branch taken alone), where the checkout
                      computes both and selects: what that select costs
    racing            the shipped racing profile (``realtime_racing_profile``:
                      3 raw frames x 3 pieces a group, the motion guard
                      on) at the configured capacities, one graph launch
                      a raced group where the checkout has one
    racing_plain      the same through the plain program
    chunked           ``main_fixed`` in chunks of 8 frames
                      (``parallel/dispatch_chunk``), one graph launch a
                      chunk where the checkout has one
    chunked_plain     the same through the plain program
    full_mapping      the ``full_mapping`` scenario's configuration (cell
                      matching, 8,192 cells x 32 points) with registration
                      after 10 frames, on the same stream; one graph
                      launch a frame where the checkout runs cell
                      matching on the frame program
    full_mapping_plain  the same through the plain program
    loop_closure      the ``loop_closure`` scenario's configuration (the
                      loop service on its worker) with registration after
                      10 frames, on the same stream (keyframes complete
                      from frame 29; the service is shut down after the
                      flush); one graph launch a frame where the checkout
                      runs loop closure on the frame program
    loop_closure_plain  the same through the plain program
    velodyne          VLP-16 sweeps (``chip_smoke.velodyne_sweeps``) through
                      the Velodyne front end at the configured capacities,
                      one graph launch a sweep where the checkout runs the
                      Velodyne front end on the frame program
    velodyne_plain    the same through the plain program
    mid100_trilidar   the ``mid100_trilidar`` scenario's three heads of
                      8,192 points (registration after 10 steps), through
                      ``scenarios.multi_head_frame``: 1 + 2 graph launches
                      a frame where the checkout has the heads and step
                      keys
    mid100_trilidar_plain  the same through the plain program
    subsampled        ``main_fixed`` with residual subsampling at the
                      reference's 200-block cap (``optimization/
                      subsample_residuals``), one graph launch a frame
                      where the checkout draws from the state's threefry
                      key on the frame program
    subsampled_plain  the same through the plain program
    subsampled_racing ``racing`` with residual subsampling at 200
    subsampled_racing_plain  the same through the plain program
    product           ``main_fixed`` in product mode on an NCCL group of
                      one rank (a ``FileStore`` under the checkout's
                      ``_build/``), one graph launch a frame where the
                      checkout runs product mode on the frame program
    product_plain     the same through the plain program

A row's time runs from the pipeline's construction to its flush, graph
captures included.  Prints one JSON line a turn and a summary line with
the card's name and power limit; ``--out`` also writes them to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


ROWS = ("main_fixed", "main_fixed_plain", "dense", "grid", "main_fixed_plain_branched",
        "racing", "racing_plain", "chunked", "chunked_plain", "full_mapping",
        "full_mapping_plain", "loop_closure", "loop_closure_plain", "dense_plain",
        "grid_plain", "velodyne", "velodyne_plain", "mid100_trilidar",
        "mid100_trilidar_plain", "subsampled", "subsampled_plain", "subsampled_racing",
        "subsampled_racing_plain", "product", "product_plain")
#: the rows run in product mode (one NCCL rank)
PRODUCT = ("product", "product_plain")


def child(root: str, n_frames: int, labels) -> dict:
    sys.path.insert(0, root)
    import torch

    from loam_livox_tpu_torch.core import config as C
    from loam_livox_tpu_torch.core.types import to_device
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.runtime import pipeline as P
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    import loam_livox_tpu_torch
    if not loam_livox_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {loam_livox_tpu_torch.__file__}, not {root}'s package")
    dev = torch.device("cuda")
    cfg = C.SlamConfig().replace(mapping={"init_accumulate_frames": 10},
                                 capacity={"auto_schedule": 0})
    n_raw = cfg.capacity.max_raw_points
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * 10 + 0.2))
    frames = []
    for i in range(n_frames + 12):
        xyz, inten, t0 = sim.frame(i)
        pts = np.zeros((n_raw, 3), np.float32)
        it = np.zeros(n_raw, np.float32)
        m = np.zeros(n_raw, bool)
        pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
        frames.append((to_device(pts, dev), to_device(it, dev), t0, to_device(m, dev)))

    def raw(pipe, frame):
        pts, inten, t, m = frame
        pipe.process_raw(pts, inten, t, mask=m)

    def run(cfg_row, plain, batch, feed=raw, mesh=None):
        torch.cuda.synchronize()
        P.reset_host_syncs()
        t0 = time.perf_counter()
        pipe = OdometryPipeline(cfg_row, device=dev, mesh=mesh)
        if plain:
            pipe.program = None
        for frame in batch:
            feed(pipe, frame)
        pipe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if pipe.loop_closer is not None:
            pipe.loop_closer.shutdown()
        return wall, pipe

    dense = cfg.replace(optimization={"correspondence": "dense"})
    grid = cfg.replace(optimization={"correspondence": "grid"})
    rows = {"main_fixed": (cfg, False), "main_fixed_plain": (cfg, True),
            "dense": (dense, False), "dense_plain": (dense, True),
            "grid": (grid, False), "grid_plain": (grid, True),
            "main_fixed_plain_branched": (cfg, True)}
    racing = C.realtime_racing_profile().replace(mapping={"init_accumulate_frames": 10},
                                                 capacity={"auto_schedule": 0})
    chunked = cfg.replace(parallel={"dispatch_chunk": 8})
    rows.update(racing=(racing, False), racing_plain=(racing, True),
                chunked=(chunked, False), chunked_plain=(chunked, True))
    sub = {"subsample_residuals": 200}
    rows.update(subsampled=(cfg.replace(optimization=sub), False),
                subsampled_plain=(cfg.replace(optimization=sub), True),
                subsampled_racing=(racing.replace(optimization=sub), False),
                subsampled_racing_plain=(racing.replace(optimization=sub), True),
                product=(cfg, False), product_plain=(cfg, True))
    mesh = None
    if set(PRODUCT) & set(labels):
        import torch.distributed as dist

        from loam_livox_tpu_torch.parallel.mesh import make_mesh

        store = os.path.join(root, "loam_livox_tpu_torch", "_build", f"store-{os.getpid()}")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                                world_size=1)
        mesh = make_mesh(1)
    from loam_livox_tpu_torch.eval import scenarios as S

    for name in ("full_mapping", "loop_closure"):
        scenario = S.scenario_config(name)[0].replace(mapping={"init_accumulate_frames": 10})
        rows.update({name: (scenario, False), f"{name}_plain": (scenario, True)})
    # VLP-16 sweeps (the checkout's `chip_smoke.velodyne_sweeps`) and
    # three-head frames (the ``mid100_trilidar`` scenario's simulators,
    # registration after 10 steps), each with its own feed
    from chip_smoke import on_device, velodyne_config, velodyne_sweeps

    velodyne = velodyne_config(C, {"auto_schedule": 0})
    mid100, kw = S.scenario_config("mid100_trilidar")
    mid100 = mid100.replace(mapping={"init_accumulate_frames": 10})
    inputs = {}
    if {"velodyne", "velodyne_plain"} & set(labels):
        inputs["velodyne"] = (on_device(velodyne_sweeps(n_frames + 12)[0],
                                        velodyne.capacity.max_raw_points, dev), raw)
    if {"mid100_trilidar", "mid100_trilidar_plain"} & set(labels):
        sims = S.simulators(mid100, kw)
        inputs["mid100_trilidar"] = ([[sim.frame(i) for sim in sims]
                                      for i in range(n_frames + 12)], S.multi_head_frame)
    rows.update(velodyne=(velodyne, False), velodyne_plain=(velodyne, True),
                mid100_trilidar=(mid100, False), mid100_trilidar_plain=(mid100, True))
    out = {"root": root, "has_frame_program": hasattr(OdometryPipeline(cfg, device=dev),
                                                       "program")}
    from loam_livox_tpu_torch.runtime import odometry as O
    selected = getattr(O, "update_matching", None)

    def branched(state, upd, cfg_row):
        """The update taken alone, chosen by one host read a step."""
        flags = [upd.rebuild] + ([] if upd.append is None else [upd.append])
        rebuild, *append = torch.stack(flags).tolist()
        if rebuild:
            map_c, map_s, grid_c, grid_s = O.rebuilt_matching(state, cfg_row)
            return state._replace(map_corners=map_c, map_surface=map_s,
                                  grid_corners=grid_c, grid_surface=grid_s)
        if append and append[0]:
            map_c, map_s = O.appended_matching(state, upd)
            return state._replace(map_corners=map_c, map_surface=map_s)
        return state

    for label, (cfg_row, plain) in rows.items():
        if label not in labels:
            continue
        if label.endswith("_branched"):
            if selected is None:
                continue            # the checkout branches on the host already
            O.update_matching = branched
        batch, feed = inputs.get(label.removesuffix("_plain"), (frames, raw))
        on_mesh = mesh if label in PRODUCT else None
        try:
            run(cfg_row, plain, batch[:12], feed, on_mesh)
            wall, pipe = run(cfg_row, plain, batch[:n_frames], feed, on_mesh)
        finally:
            if selected is not None:
                O.update_matching = selected
        out[label] = {"fps": n_frames / wall, "wall_s": wall,
                      "iterations": int(sum(pipe.iterations)),
                      "accepted": int(sum(pipe.trajectory.accepted)),
                      "graph_launches": P.graph_counts()["graph_launch"]}
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="an earlier checkout of the repo")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat baseline, this, this, baseline this many times")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help="the rows to run, comma-separated (default all)")
    ap.add_argument("--out", help="also write the lines to this file")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.frames, args.rows.split(","))))
        return 0
    if not args.baseline:
        ap.error("--baseline is required")
    if not set(args.rows.split(",")) <= set(ROWS):
        ap.error(f"--rows: each of {', '.join(ROWS)}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    lines = []
    for turn, root in enumerate([args.baseline, HERE, HERE, args.baseline] * args.rounds):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              os.path.abspath(root), "--frames", str(args.frames),
                              "--rows", args.rows],
                             capture_output=True, text=True, cwd=os.path.abspath(root))
        if res.returncode != 0:
            sys.stderr.write(res.stderr[-4000:])
            raise SystemExit(f"turn {turn} ({root}) failed")
        line = json.loads(res.stdout.strip().splitlines()[-1])
        line["turn"] = turn
        lines.append(line)
        print(json.dumps(line), flush=True)
    summary = {"card": card, "frames": args.frames, "rounds": args.rounds}
    base = [line for line in lines if line["root"] == os.path.abspath(args.baseline)]
    this = [line for line in lines if line["root"] != os.path.abspath(args.baseline)]
    for label in args.rows.split(","):
        summary[label] = {
            "baseline_fps": [line[label]["fps"] for line in base if label in line],
            "this_fps": [line[label]["fps"] for line in this if label in line]}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for line in lines + [summary]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
