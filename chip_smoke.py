#!/usr/bin/env python3
"""Drive the PyTorch port (``loam_livox_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits nonzero:

1. card      the GPU's name and power limit (nvidia-smi);
2. build     every CUDA kernel of the main path, from ``csrc/`` (one nvcc
             per source, all started together);
3. kernel    each kernel against its plain PyTorch version at the main
             path's shapes (corners 512 x 16,384 within sqrt(2) m;
             surfaces 2,048 x 65,536 within sqrt(50) m; full buffers and
             5 % prefixes), with its time beside the plain version's and
             a ``torch.cdist`` + ``topk`` yardstick;
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


def knn_work(q, n_q, op, radius):
    """Distance evaluations the kernel's skipping leaves for these inputs
    (valid query prefix x 256-reference groups not skipped), and the
    bytes it must move (queries, valid reference rows and boxes read
    once, the k-lists written once)."""
    import torch

    from loam_livox_tpu_torch.ops import knn_fused as kf

    tile = 128
    n_q = int(n_q)
    n_ref = int(op.n_ref)
    qv = q[:n_q]
    n_tiles = -(-n_q // tile)
    pad = n_tiles * tile - n_q
    inf = torch.full((pad, 3), float("inf"), device=q.device)
    lo = torch.cat([qv, inf]).reshape(n_tiles, tile, 3).amin(1)
    hi = torch.cat([qv, -inf]).reshape(n_tiles, tile, 3).amax(1)
    counts = torch.clamp(n_q - torch.arange(n_tiles, device=q.device) * tile, max=tile)
    n_groups = -(-n_ref // kf.GROUP)
    glo, ghi = op.boxes[:n_groups, 0:3], op.boxes[:n_groups, 4:7]
    gap = torch.clamp(torch.maximum(glo[None] - hi[:, None], lo[:, None] - ghi[None]), min=0)
    near = (glo[None, :, 0] <= ghi[None, :, 0])
    if radius is not None:
        near = near & ((gap * gap).sum(-1) <= radius ** 2)
    pairs = int((near.sum(1) * counts).sum()) * kf.GROUP
    bytes_ = n_q * 12 + n_ref * 16 + n_groups * 32 + n_q * 5 * 8
    return pairs, bytes_


def compare_kernel(q, ref, mask, n_q, radius, reps=20):
    """Kernel vs plain on one input: errors, times, bound."""
    import torch

    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.ops.knn import BIG, knn

    op = kf.build_ref_operand(ref, mask)
    d, i = kf.knn_fused(q, ref, mask, k=5, ref_op=op, query_count=n_q, max_radius=radius)
    dp, ip = knn(q, ref, mask, k=5, query_count=n_q, max_radius=radius)
    torch.cuda.synchronize()
    live = dp < 0.5 * BIG
    if not torch.equal(d < 0.5 * BIG, live):
        raise AssertionError("kernel and plain disagree on which neighbours exist")
    err = float((d[live] - dp[live]).abs().max()) if live.any() else 0.0
    rel = float(((d[live] - dp[live]).abs() / dp[live].clamp(min=1e-12)).max()) if live.any() else 0.0
    # Indices must agree wherever the k-th neighbour is inside the gate,
    # except at near-ties (equal distances within 1e-5 relative).
    in_gate = live[:, -1]
    differ = (i != ip) & in_gate[:, None]
    tie = (d - dp).abs() <= 1e-5 * dp.abs().clamp(min=1e-12)
    if rel > 1e-5 or bool((differ & ~tie).any()):
        raise AssertionError(f"kernel disagrees with plain: rel {rel}, "
                             f"index mismatches {int(differ.sum())}")
    ms = time_ms(lambda: kf.knn_fused(q, ref, mask, k=5, ref_op=op,
                                      query_count=n_q, max_radius=radius), reps)
    # the kernel alone, without the wrapper's merge over chunks
    n_chunks = op.ref4.shape[0] // kf.CHUNK
    part_d = torch.empty((n_chunks, 5, q.shape[0]), device=q.device)
    part_i = torch.empty((n_chunks, 5, q.shape[0]), dtype=torch.int32, device=q.device)
    counts = torch.stack([op.n_ref, n_q.to(torch.int32)]).contiguous()
    launch = kf._library()
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = time_ms(lambda: launch(
        q.data_ptr(), q.shape[0], op.ref4.data_ptr(), op.boxes.data_ptr(),
        op.ref4.shape[0], counts.data_ptr(), float(radius) ** 2, 5,
        part_d.data_ptr(), part_i.data_ptr(), stream), reps)
    plain_ms = time_ms(lambda: knn(q, ref, mask, k=5, query_count=n_q,
                                   max_radius=radius), max(3, reps // 5))

    def library():
        dist = torch.cdist(q, ref).masked_fill(~mask[None], float("inf"))
        return torch.topk(dist, 5, dim=1, largest=False)

    library_ms = time_ms(library, max(3, reps // 5))
    pairs, bytes_ = knn_work(q, n_q, op, radius)
    bound_ms = 1e3 * max(pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES)
    return dict(max_abs_err=err, max_rel_err=rel, index_mismatches=int(differ.sum()),
                ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms,
                bound_by=("operations" if pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS
                          >= bytes_ / PEAK_BYTES else "bytes"),
                pairs=pairs, queries=int(n_q), refs=int(op.n_ref))


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
    import torch

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
    ptxas = [ln.strip() for ln in build.build_logs.get("knn_fused", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=["knn_fused.cu"],
         ptxas_k5=ptxas[6:8] if len(ptxas) >= 8 else ptxas)

    # 3. each kernel against its plain version at the main path's shapes
    rng = np.random.default_rng(0)
    worst_err = 0.0
    for label, nq, m, leaf, radius in (("corners", 512, 16384, 0.1, 2.0 ** 0.5),
                                       ("surfaces", 2048, 65536, 0.4, 50.0 ** 0.5)):
        for fill in (1.0, 0.05):
            ref, mask = synthetic_map(rng, m, leaf, fill, dev)
            valid = torch.nonzero(mask).flatten()
            pick = valid[torch.from_numpy(rng.integers(0, len(valid), nq)).to(dev)]
            q = (ref[pick] + torch.randn((nq, 3), device=dev) * 0.3).contiguous()
            r = compare_kernel(q, ref, mask, torch.tensor(nq, device=dev), radius)
            worst_err = max(worst_err, r["max_abs_err"])
            emit("kernel", kernel="knn_fused", search=label, fill=fill, **r)

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
                       surf_in.mask.sum(dtype=torch.int32), 50.0 ** 0.5, reps=50)
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
