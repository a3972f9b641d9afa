"""Run the odometry and mapping pipeline from the command line, the
counterpart of ``loam_livox_tpu/cli/run_odometry.py`` (the reference's
roslaunch entry points: load a YAML profile, apply per-launch overrides,
start the nodes).

Data sources:
* ``--source sim``        the synthetic Livox rosette stream (io.simulator)
* ``--source pcd:<dir>``  a directory of per-frame .pcd files named in
                          frame order, read by the native prefetch queue
* ``--source bag:<file>[:<topic>]``  a ROS1 bag (format 2.0):
                          sensor_msgs/PointCloud2 or
                          livox_ros_driver/CustomMsg, no ROS needed
* ``--source lvx:<file>`` a Livox .lvx capture (regrouped to 0.1 s frames)

The flags, their defaults and ``--set`` are the JAX command line's, plus
``--device`` (default ``cuda``; ``cpu`` runs the plain versions of the
kernels on the CPU).  ``--mesh N`` with N > 1 runs the product mode
(`runtime.pipeline`, `parallel`) over N ranks, one process a device,
under a launcher that sets the group's environment (NCCL on the cards,
gloo with ``--device cpu``); rank 0 prints and writes the outputs:

    torchrun --nproc-per-node 2 -m loam_livox_tpu_torch.cli.run_odometry \
        --mesh 2 --device cpu --source sim --frames 20

``--follow`` prints one JSON line a trajectory row as the
rows reach the host, which then happens after every raw frame (one
``drain`` read a frame).  The last line is a JSON summary: the JAX
command line's keys, and the device, the host reads of device values by
place (`runtime.pipeline.host_syncs`), the ICP loop passes, the
``knn_fused`` kernel's launches from Python (2 a pass on the plain
program) and its runs counted on the card (2 a pass on either program,
plus the loop service's launches, counted apart), and the frame
program's graph launches and captures (one launch a dispatch unit).

Examples:
    python -m loam_livox_tpu_torch.cli.run_odometry --profile realtime --frames 100
    python -m loam_livox_tpu_torch.cli.run_odometry --source bag:capture.bag \\
        --save-poses poses.txt --save-map map.json --log-dir logs --device cpu
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", help="YAML config (reference schema)")
    p.add_argument("--profile",
                   choices=["precision", "realtime", "realtime_racing", "largescale"],
                   default="precision")
    p.add_argument("--caps", choices=["default", "bounded"], default="default",
                   help="capacity preset: 'bounded' sizes the buffers for bounded "
                        "scenes (core/config.py bounded_scene_caps; not for large worlds)")
    p.add_argument("--source", default="sim",
                   help="'sim', 'pcd:<dir>', 'bag:<file>[:<topic>]', or 'lvx:<file>'")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--piecewise", type=int, default=None,
                   help="override common/piecewise_number")
    p.add_argument("--loop-closure", action="store_true")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--save-poses", default=None,
                   help="write the trajectory (reference OutputPoses format)")
    p.add_argument("--save-map", default=None,
                   help="write the plane cell map as reference-format JSON")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="parallel/mesh_devices: N > 1 runs the product mode over the N "
                        "ranks of a launcher such as torchrun")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--follow", action="store_true",
                   help="stream one JSON line per trajectory row to stdout "
                        "({frame, t, q, accepted}) as the rows reach the host")
    p.add_argument("--set", action="append", default=[], metavar="NS/KEY=V",
                   help="override one config field, e.g. "
                        "loop_closure/minimum_keyframe_differen=20 (repeatable)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: 'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_config(args):
    from ..core import config as C

    cfg = {"precision": C.precision_profile,
           "realtime": C.realtime_profile,
           "realtime_racing": C.realtime_racing_profile,
           "largescale": C.largescale_profile}[args.profile]()
    if args.caps == "bounded":
        cfg = cfg.replace(capacity=C.bounded_scene_caps())
    if args.config:
        cfg = C.load_yaml(args.config, base=cfg)
    overrides = {}
    if args.piecewise is not None:
        overrides.setdefault("common", {})["piecewise_number"] = args.piecewise
    if args.loop_closure:
        overrides.setdefault("loop_closure", {})["if_enable_loop_closure"] = 1
    if args.mesh is not None:
        overrides.setdefault("parallel", {})["mesh_devices"] = args.mesh
    for item in args.set:
        try:
            path, val = item.split("=", 1)
            ns, key = path.replace(".", "/").split("/", 1)
        except ValueError:
            raise SystemExit(f"--set expects NS/KEY=VALUE, got {item!r}")
        cur = getattr(getattr(cfg, ns), key)   # raises on an unknown field
        typ = type(cur)
        overrides.setdefault(ns, {})[key] = typ(float(val)) if typ in (int, float) else val
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def frame_stream(args, cfg):
    """(xyz, intensity, stamp) of each raw frame of the source."""
    if args.source == "sim":
        from ..io.simulator import LivoxSimulator, SimConfig

        sim = LivoxSimulator(SimConfig(seed=args.seed))
        for i in range(args.frames):
            yield sim.frame(i)
    elif args.source.startswith("pcd:"):
        from ..io import native

        d = args.source[4:]
        if not glob.glob(os.path.join(d, "*.pcd")):
            raise SystemExit(f"no .pcd files under {d}")
        for i, (xyz, inten) in enumerate(native.pcd_dir_stream(d)):
            if i >= args.frames:
                break
            if inten is None:
                inten = np.ones(len(xyz), np.float32)
            yield xyz, inten, i * 0.1
    elif args.source.startswith("bag:"):
        from ..io.rosbag import bag_frame_stream

        spec = args.source[4:]
        # 'bag:file.bag' or 'bag:file.bag:/livox/lidar'
        path, topic = spec.split(":", 1) if ":" in spec else (spec, None)
        for i, frame in enumerate(bag_frame_stream(path, topic)):
            if i >= args.frames:
                break
            yield frame
    elif args.source.startswith("lvx:"):
        from ..io.lvx import LvxReader

        for i, frame in enumerate(LvxReader(args.source[4:]).frames()):
            if i >= args.frames:
                break
            yield frame
    else:
        raise SystemExit(f"unknown source {args.source!r}")


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)

    from ..ops import knn_fused
    from ..runtime import pipeline as P

    mesh = own_group = None
    if cfg.parallel.mesh_devices > 1:
        import torch.distributed as dist

        from ..parallel.mesh import initialize_multihost

        own_group = not dist.is_initialized()     # else the caller's group
        mesh = initialize_multihost(backend="gloo" if args.device == "cpu" else None)
    lead = mesh is None or mesh.rank == 0
    if not lead:
        args.follow, args.quiet = False, True
        args.save_poses = args.log_dir = None
    P.reset_host_syncs()
    knn_fused.launches = 0
    pipe = P.OdometryPipeline(cfg, device=args.device, log_dir=args.log_dir, mesh=mesh)
    knn_fused.runs.reset()          # the kernel's runs on the card from here on
    pipe.eager_drain = args.follow
    followed = 0

    def emit_follow():
        nonlocal followed
        tr = pipe.trajectory
        while followed < len(tr.positions):
            print(json.dumps({
                "frame": followed,
                "t": [round(float(v), 6) for v in tr.positions[followed]],
                "q": [round(float(v), 6) for v in tr.quaternions[followed]],
                "accepted": bool(tr.accepted[followed]),
            }), flush=True)
            followed += 1

    t0 = time.perf_counter()
    n = 0
    for xyz, inten, stamp in frame_stream(args, cfg):
        pipe.process_raw(xyz, inten, stamp)
        n += 1
        if args.follow:
            emit_follow()
        if not args.quiet and n % 10 == 0 and pipe.trajectory.positions:
            print(f"frame {n}: t_w={np.round(pipe.trajectory.positions[-1], 3).tolist()}",
                  file=sys.stderr)
    pipe.flush()
    if args.follow:
        emit_follow()
    if pipe.device.type == "cuda":
        import torch

        torch.cuda.synchronize(pipe.device)
    wall = time.perf_counter() - t0

    if args.save_poses:
        from ..io.serialization import save_poses_txt

        save_poses_txt(args.save_poses, np.asarray(pipe.trajectory.positions),
                       np.asarray(pipe.trajectory.quaternions))
    if args.save_map:
        from ..runtime.checkpoint import export_reference_map

        state = pipe.state          # every rank takes part in the gather
        if lead:
            export_reference_map(state, args.save_map)
    pipe.logger.close()
    if pipe.loop_closer is not None:
        pipe.loop_closer.shutdown()
    if own_group:
        import torch.distributed as dist

        dist.destroy_process_group()
    if not lead:
        return 0

    summary = {
        "frames": n,
        "mesh_devices": int(cfg.parallel.mesh_devices),
        "wall_s": round(wall, 3),
        "fps": round(n / wall, 3) if wall > 0 else None,
        "accepted": int(sum(pipe.trajectory.accepted)),
        "steps": len(pipe.trajectory.accepted),
        "loop_closed": bool(pipe.loop_closer and pipe.loop_closer.closed),
        "device": str(pipe.device),
        "host_syncs": P.host_syncs(),
        "icp_loop_passes": pipe.loop_iterations,
        "knn_fused_launches": knn_fused.launches,
        "knn_fused_runs": knn_fused.runs.read(),
        "loop_knn_fused_launches": (pipe.loop_closer.counts["knn_fused"]
                                    if pipe.loop_closer is not None else 0),
        "graphs": P.graph_counts(),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
