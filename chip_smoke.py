#!/usr/bin/env python3
"""Drive the PyTorch port (``loam_livox_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Phases, each printing one JSON line; any failure exits nonzero:

1. card      the GPU's name and power limit (nvidia-smi);
2. build     every CUDA kernel of the main path, from ``csrc/`` (one nvcc
             per source, all started together), with ptxas's registers
             and spills;
3. kernel    each kernel against its plain PyTorch version at the main
             path's shapes (corners 512 x 16,384 within sqrt(2) m;
             surfaces 2,048 x 65,536 within sqrt(50) m; full buffers,
             5 % prefixes, and 200 queries at the main path's 1.6 %
             fill), bit for bit, with the wrapper's time, the kernel's
             alone (profiler), the plain version's, a ``torch.cdist`` +
             ``topk`` yardstick and the bound of `ops.knn_fused.search_work`.
             ``--baseline DIR`` (an earlier checkout) times its kernel in
             turns with this one's on the same inputs;
4. reference the port on the card against the port on the CPU (the path
             the CPU tests hold against the JAX package) on a small
             stream: aligned ATE within 0.05 m, accepted counts within 2;
5. main      ``OdometryPipeline`` on the card at the default capacities:
             40 simulator frames of 10,000 points, motion deblur, history
             matching, registration after 10 frames.  Frames/s, accepted
             frames, aligned ATE against the simulator's ground truth,
             host syncs a frame; the launch counters are reset just
             before and read just after, and ``knn_fused`` must have
             launched exactly twice per ICP iteration;
6. kernels   one line per kernel: launches on the main path, its time,
             the plain version's, the bound and the yardstick, measured
             on the matching buffer and queries the main path ended on.

The line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, no sparsity) at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 8          # 3 subtractions, 3 multiplications, 2 additions


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events),
    after two warm-up calls."""
    import torch

    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device time per call of the ``knn_fused`` kernels that ``fn``
    launches (torch.profiler's kernel records), after two warm-up calls:
    the kernel alone, whatever the wrapper around it does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "knn_fused" in e.key)
    if us <= 0:
        raise AssertionError("the profiler saw no knn_fused kernel")
    return us / reps / 1e3


def in_turns(timer, new, old, reps):
    """(new, old) means of ``timer`` taken in the order old, new, new, old."""
    o1, n1, n2, o2 = (timer(f, reps) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def compare_kernel(q, ref, mask, n_q, radius, base=None, reps=20):
    """Kernel vs plain on one input: bit-equality, times, bound.  With
    ``base`` (an earlier version's wrapper module), its wrapper and
    kernel are timed in turns with this one's on the same inputs."""
    import torch

    from loam_livox_tpu_torch.ops import build
    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.ops.knn import knn

    def runner(mod):
        op = mod.build_ref_operand(ref, mask)
        return lambda: mod.knn_fused(q, ref, mask, k=5, ref_op=op, query_count=n_q,
                                     max_radius=radius)

    dp, ip = knn(q, ref, mask, k=5, query_count=n_q, max_radius=radius)

    def check(mod):
        d, i = runner(mod)()
        torch.cuda.synchronize()
        err, mismatches = float((d - dp).abs().max()), int((i != ip).sum())
        if err != 0.0 or mismatches or not torch.equal(d, dp):
            raise AssertionError(f"{mod.__name__} disagrees with plain: max_abs_err {err}, "
                                 f"index mismatches {mismatches}")
        return dict(max_abs_err=err, index_mismatches=mismatches)

    out = check(kf)
    new = runner(kf)
    if base:
        check(base)
        old = runner(base)
        out["ms"], out["baseline_ms"] = in_turns(time_ms, new, old, reps)
        out["kernel_ms"], out["baseline_kernel_ms"] = in_turns(device_ms, new, old, reps)
    else:
        out["ms"] = time_ms(new, reps)
        out["kernel_ms"] = device_ms(new, reps)
    out["plain_ms"] = time_ms(lambda: knn(q, ref, mask, k=5, query_count=n_q,
                                         max_radius=radius), max(3, reps // 5))

    def library():
        dist = torch.cdist(q, ref).masked_fill(~mask[None], float("inf"))
        return torch.topk(dist, 5, dim=1, largest=False)

    out["library_ms"] = time_ms(library, max(3, reps // 5))
    op = kf.build_ref_operand(ref, mask)
    pairs, bytes_ = kf.search_work(q, n_q, op, radius)
    t_ops, t_bytes = pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES
    out.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               pairs=pairs, queries=int(n_q), refs=int(mask.sum()),
               ptxas_k5=ptxas_report(build.build_logs.get("knn_fused", "")),
               launch_k5=kf.launch_shape(5, op.ref4.shape[0]))
    return out


def synthetic_map(rng, m, leaf, fill, device):
    """A voxel-sorted matching buffer of capacity m in a 24 m room, its
    first ``fill`` share valid, and points near it to query."""
    import torch

    from loam_livox_tpu_torch.core.types import PointBatch
    from loam_livox_tpu_torch.ops.voxel import voxel_downsample

    raw = torch.from_numpy(rng.uniform(-12, 12, (3 * m, 3)).astype(np.float32)).to(device)
    b = voxel_downsample(PointBatch(raw, torch.zeros(3 * m, device=device),
                                    torch.ones(3 * m, dtype=torch.bool, device=device)),
                         leaf, capacity=m)
    mask = b.mask.clone()
    mask[int(fill * m):] = False
    return b.xyz, mask


# the kernel phase's inputs: (search, query rows, query_count, buffer
# capacity, voxel leaf, valid share of the buffer, radius)
KERNEL_INPUTS = (
    ("corners", 512, 512, 16384, 0.1, 1.0, 2.0 ** 0.5),
    ("corners", 512, 512, 16384, 0.1, 0.05, 2.0 ** 0.5),
    ("surfaces", 2048, 2048, 65536, 0.4, 1.0, 50.0 ** 0.5),
    ("surfaces", 2048, 2048, 65536, 0.4, 0.05, 50.0 ** 0.5),
    ("surfaces, main-path fill", 2048, 200, 65536, 0.4, 0.016, 50.0 ** 0.5),
)


def kernel_phase(dev, base=None) -> float:
    """Every input of KERNEL_INPUTS through `compare_kernel`, one JSON
    line each; returns the worst absolute error."""
    import torch

    rng = np.random.default_rng(0)
    worst = 0.0
    for label, nq, count, m, leaf, fill, radius in KERNEL_INPUTS:
        ref, mask = synthetic_map(rng, m, leaf, fill, dev)
        valid = torch.nonzero(mask).flatten()
        pick = valid[torch.from_numpy(rng.integers(0, len(valid), nq)).to(dev)]
        noise = torch.from_numpy(rng.normal(0, 0.3, (nq, 3)).astype(np.float32)).to(dev)
        q = (ref[pick] + noise).contiguous()
        r = compare_kernel(q, ref, mask, torch.tensor(count, device=dev), radius, base)
        worst = max(worst, r["max_abs_err"])
        emit("kernel", kernel="knn_fused", search=label, fill=fill, **r)
    return worst


def load_baseline(root: str):
    """The wrapper module ``ops.knn_fused`` of the port package in an
    earlier checkout at ``root``, imported as ``baseline_port`` beside
    this one (the package's modules import each other relatively, and
    it builds its kernel into its own ``_build/``)."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "loam_livox_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("baseline_port.ops.knn_fused")


def ptxas_report(log: str, k: int = 5) -> dict:
    """Registers, spills and static shared memory of the K=k kernel, from
    nvcc's ``-Xptxas -v`` log."""
    import re

    lines = log.splitlines()
    for n, ln in enumerate(lines):
        if "Compiling entry function" in ln and f"ILi{k}E" in ln:
            block = []
            for x in lines[n + 1:]:
                if "Compiling entry function" in x:
                    break
                block.append(x)
            text = " ".join(block)
            nums = {key: re.search(pat, text) for key, pat in (
                ("registers", r"Used (\d+) registers"),
                ("spill_stores", r"(\d+) bytes spill stores"),
                ("spill_loads", r"(\d+) bytes spill loads"),
                ("static_smem", r"(\d+) bytes smem"))}
            return {key: int(m.group(1)) for key, m in nums.items() if m}
    return {}


def simulate(n_frames, points, init, seed=0):
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory

    sim = LivoxSimulator(SimConfig(points_per_frame=points, seed=seed),
                         traj=Trajectory(ramp_t0=0.1 * init + 0.2))
    return sim, [sim.frame(i) for i in range(n_frames)]


def run_stream(cfg, sim, frames, device):
    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg, device=device)
    for xyz, inten, t0 in frames:
        pipe.process_raw(xyz, inten, t0)
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    if not np.all(np.isfinite(est)) or est.shape != (len(frames), 3):
        raise AssertionError(f"bad trajectory {est.shape}")
    return pipe, ate_rmse(est, gt), int(sum(pipe.trajectory.accepted))


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier checkout of the repo: time its knn_fused beside this one's")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from loam_livox_tpu_torch.core.config import SlamConfig
        from loam_livox_tpu_torch.ops import build
        from loam_livox_tpu_torch.ops import knn_fused as kf
        from loam_livox_tpu_torch.runtime import pipeline as P
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    build.compile_all(["knn_fused"])
    emit("build", seconds=time.perf_counter() - t0, sources=["knn_fused.cu"],
         ptxas_k5=ptxas_report(build.build_logs.get("knn_fused", "")),
         launch_k5_surfaces=kf.launch_shape(5, 65536))
    base = load_baseline(args.baseline) if args.baseline else None

    # 3. each kernel against its plain version at the main path's shapes
    worst_err = kernel_phase(dev, base)

    # 4. the port on the card against the port on the CPU
    small = SlamConfig().replace(
        capacity={"max_raw_points": 16384, "max_corner": 256, "max_surface": 1024,
                  "max_corner_ds": 256, "max_surface_ds": 1024,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096,
                  "hist_corner_capacity": 128, "hist_surf_capacity": 512,
                  "history_window": 16},
        mapping={"init_accumulate_frames": 6},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3})
    sim, frames = simulate(16, 10000, 6)
    _, ate_gpu, acc_gpu = run_stream(small, sim, frames, dev)
    _, ate_cpu, acc_cpu = run_stream(small, sim, frames, "cpu")
    ok = abs(ate_gpu - ate_cpu) < 0.05 and abs(acc_gpu - acc_cpu) <= 2
    emit("reference", frames=len(frames), ate_gpu=ate_gpu, ate_cpu=ate_cpu,
         accepted_gpu=acc_gpu, accepted_cpu=acc_cpu, ok=ok)
    if not ok:
        raise AssertionError("the card's run departs from the CPU reference")

    # 5. the main path: default capacities, 40 frames of 10,000 points
    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 10})
    n = 40
    sim, frames = simulate(n + 5, 10000, 10)
    run_stream(cfg, sim, frames[:12], dev)          # warm-up: first registrations
    torch.cuda.synchronize()
    kf.launches = 0
    P.reset_host_syncs()
    t0 = time.perf_counter()
    pipe, ate, accepted = run_stream(cfg, sim, frames[:n], dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kf.launches
    syncs = P.host_syncs()
    iters = sum(pipe.iterations)
    emit("main", frames=n, fps=n / wall, wall_s=wall, accepted=accepted, ate_aligned=ate,
         icp_iterations=iters, knn_fused_launches=launches,
         host_syncs_per_frame=sum(syncs.values()) / n,
         host_syncs={k: v / n for k, v in syncs.items()},
         map_surface_fill=int(pipe.state.map_surface.mask.sum()),
         map_corner_fill=int(pipe.state.map_corners.mask.sum()))
    if launches != 2 * iters or launches <= 0:
        raise AssertionError(f"knn_fused launched {launches} times for {iters} ICP iterations")
    if not (ate < 0.35 and accepted >= n // 2):
        raise AssertionError(f"main path off: ATE {ate}, accepted {accepted}/{n}")

    # 6. the kernel line, timed on the buffer and queries the main path ended on
    from loam_livox_tpu_torch.core.types import to_device
    from loam_livox_tpu_torch.frontend.livox import extract_frame
    from loam_livox_tpu_torch.registration import residuals as res
    from loam_livox_tpu_torch.registration.icp import refine_blur
    from loam_livox_tpu_torch.runtime.odometry import input_downsample

    st = pipe.state
    xyz, inten, t = frames[n - 1]
    n_raw = cfg.capacity.max_raw_points
    pts = np.zeros((n_raw, 3), np.float32)
    it = np.zeros(n_raw, np.float32)
    msk = np.zeros(n_raw, bool)
    pts[:len(xyz)], it[:len(xyz)], msk[:len(xyz)] = xyz, inten, True
    _, _, fr = extract_frame(to_device(pts, dev), to_device(it, dev), to_device(msk, dev),
                             t, cfg.feature_extraction, cfg.capacity)
    _, surf_in = input_downsample(P.source_downsample(fr, cfg), cfg)
    s = refine_blur(surf_in.time, fr.time_min, fr.time_max, True)
    qs = res.transform_points_incre(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                                    torch.zeros(3, device=dev), surf_in.xyz, s,
                                    st.q_w, st.t_w, True).contiguous()
    r = compare_kernel(qs, st.map_surface.xyz, st.map_surface.mask,
                       surf_in.mask.sum(dtype=torch.int32), 50.0 ** 0.5, base, reps=50)
    worst_err = max(worst_err, r["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, main-path buffer", **r)

    # torch's own count of synchronising calls over three more frames of
    # the same run (a cross-check of the audit in runtime/pipeline.py)
    import collections
    import warnings

    P.reset_host_syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        for xyz, inten, t in frames[n:n + 3]:
            pipe.process_raw(xyz, inten, t)
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message) and "prototype" not in str(w.message))
    emit("sync_check", frames=3, counted_per_frame=sum(P.host_syncs().values()) / 3,
         torch_sync_warnings_per_frame=sum(where.values()) / 3,
         by_line={k: v / 3 for k, v in sorted(where.items())})

    # where a frame's time goes: torch.profiler over the last two frames
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for xyz, inten, t in frames[n + 3:]:
            pipe.process_raw(xyz, inten, t)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    ka = prof.key_averages()
    kernels_ka = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_ka) / 2e3
    launches_api = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                          "cudaLaunchKernelExC"))
    prof_iters = pipe.iterations[-2:]
    # the profiler slows the host, not the card: set the device time per
    # ICP iteration against the unprofiled main run's frame time
    busy_per_iter = 2 * busy_ms / max(sum(prof_iters), 1)
    idle_main = 1 - busy_per_iter * (iters / n) / (wall * 1e3 / n)

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)[:8]
        return [[e.key[:60], getattr(e, attr) / 2e3, e.count / 2] for e in rows]

    emit("profile", frames=2, iterations=prof_iters, wall_ms_per_frame_profiled=wall_ms,
         device_busy_ms_per_frame=busy_ms, device_busy_ms_per_icp_iteration=busy_per_iter,
         device_idle_share_main_estimate=idle_main,
         kernel_launches_per_frame=launches_api / 2,
         kernel_launches_per_icp_iteration=launches_api / max(sum(prof_iters), 1),
         top_kernels_self_device_ms_per_frame=top(kernels_ka, "self_device_time_total"),
         top_self_cpu_ms_per_frame=top(ka, "self_cpu_time_total"))

    kernels = [{
        "name": "knn_fused", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/knn_fused.cu",
        "replaces": "loam_livox_tpu/ops/pallas/knn_fused.py:305",
        "launches": launches, "max_abs_err": worst_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}]
    emit("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
