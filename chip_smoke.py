#!/usr/bin/env python3
"""Drive the PyTorch port (``loam_livox_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--baseline DIR]

Phases, each printing JSON lines; any failure exits nonzero:

1. card       the GPU's name and power limit (nvidia-smi);
2. build      every CUDA kernel of the paths, from ``csrc/`` (one nvcc
              per source, all started together: ``knn_fused``, the split
              ``debounce``, ``graph_cond``, the ICP loop's condition
              and the frame graph's assembly, ``threefry``, the
              threefry key's split and keep-mask draw, and the voxel
              filter's ``voxel_centroid``), with ptxas's registers
              and spills and the CUDA driver and runtime versions; and
              the native I/O library (host code,
              ``native/native_io.cpp`` with g++) into the same ``_build/``;
3. kernel     each kernel against its plain PyTorch version at the
              paths' shapes (corners 512 x 16,384 within sqrt(2) m;
              surfaces 2,048 x 65,536 within sqrt(50) m; full buffers,
              5 % prefixes, 200 queries at the main path's 1.6 % fill;
              and the racing path's lane axis, 9 lanes of each search,
              full, 5 % and uneven per-lane counts with an empty lane;
              and the scene alignment's finest plane search, 8,192
              queries against 8,192 voxel-sorted rows of the committed
              loop artifact's closing keyframes within sqrt(50) m),
              bit for bit, with the wrapper's time, the kernel's alone
              (profiler; calls queued behind a spin kernel, timed by
              CUDA events, where the profiler records no kernel), the plain version's, a ``torch.cdist`` +
              ``topk`` yardstick and the bound of
              `ops.knn_fused.search_work`.  ``--baseline DIR`` (an
              earlier checkout) times its kernel in turns with this
              one's on the inputs without a lane axis.  Then the loop
              gates over ``scripts/loop_unscaled_state.npz`` on the card
              and on the CPU: the same pair (keyframes 0 / 19) must
              close, scores within 0.02, under the 0.20 gate, and the
              card's solve passes `payoff_verdict` against the
              keyframes' recorded true positions;
4. reference  the port on the card against the port on the CPU (the path
              the CPU tests hold against the JAX package) on small
              streams of the main, precision and racing paths, the
              ``full_mapping`` CI variant (cell matching), a CPU-scale
              ``mid100_trilidar`` (3 heads of 8,192 points, 12 frames) and
              8 Velodyne sweeps: aligned ATE within 0.05 m, accepted rows
              within 2 (main) or 3;
5. main       ``OdometryPipeline`` on the card at the shipped default,
              ``SlamConfig()`` with the capacity schedule on (the six
              fill-driven buffers start at 1/16 and grow as their fills
              demand): 40 simulator frames of 10,000 points, motion
              deblur, history matching, registration after 10 frames,
              each frame one CUDA graph launch of the frame program
              (`runtime.frame_program`, one graph a capacity tier).
              Frames/s, accepted frames, aligned ATE against the
              simulator's ground truth, host syncs a frame, the tier
              ladder (the raw frame of each growth and the final scale)
              and the ``schedule`` syncs, the ``graphs`` (keys, capture
              seconds, whether a growth freed them) and the kernels'
              runs, counted on the card by the kernels themselves; the
              counters are reset just before and read just after: one
              graph launch a frame, one capture a key, no kernel
              launched from Python, ``knn_fused`` run twice an ICP pass,
              the debounce once a frame, the loop condition once a pass
              and once before each WHILE node, the switch condition
              once before each SWITCH node (each kernel its own counter;
              passes + 2 x steps a frame together), the ICP
              passes counted on the card equal to the rows' iterations,
              and no ICP-exit or admission read;
              frames/s over the first 20 frames too.  Then
              ``main_plain``: the same first 20 frames through the plain
              program on the card, rows and state bit-equal to the
              frame program's after 20 frames, or it fails; and
              ``main_fixed``: the first 20 frames at the configured
              capacities (``auto_schedule`` 0), the row the earlier
              slices' main path ran.  Then the debounce kernel against
              its plain version, bit for bit, on every main-path frame's
              candidate table and on seeded tables of 1 to 32,768 slots
              (random, strictly alternating kinds, the longest chain of
              one-step hops, one kept, empty and overfull; 16,384 and
              32,768 slots past one block's shared memory, the kernel's
              global-memory form), timed on the path's last table and
              on the longest chain at 4,096, 16,384 and 32,768 slots; the
              front end at ``max_splits`` 16,384 on the card against the
              CPU's, and the registration's kNN searcher over 2,000,000
              rows (past the kernel's largest operand: one launch a row
              block, merged) against the plain search, bit for bit, with
              each block's kernel alone, the bound of
              `ops.knn_fused.search_work` and ``torch.cdist`` + ``topk``
              over the same rows (``repair`` lines); the loop condition kernel at each
              outcome and on lane axes of up to 1,100 lanes, and the
              switch index at each outcome (rebuild, append, neither),
              against their plain versions, with their times and bounds;
              the threefry keep mask (one lane and 9 lanes of the main
              path's corner + surface residual blocks) and split (a key
              into 2 and into 9) against their plain versions, bit for
              bit, with their times and bounds; the voxel filter's
              kernel (``voxel_centroid``) against its plain version
              (``ops.voxel.centroids_plain``, three
              ``index_put_(accumulate=True)`` sums) with ``torch.equal``
              on the seeded inputs of VOXEL_CASES, and timed at the main
              path's sizes (16,384, 49,152 and 131,072 rows: VOXEL_TIMED);
              ``--baseline DIR`` times the earlier checkout's debounce
              and loop condition in turns with these; and the floor of
              a kernel node in a CUDA graph (``node_floor``: an empty
              one-thread kernel, 64 nodes a graph, replayed).  Then the
              kernel on the buffer and queries the main path ended on,
              at the main path's first tier (the buffer before the first
              growth, 1,024 / 4,096 rows, and the next frame's queries),
              and at a shard's input (the buffer split evenly into the
              fewest ranks whose second shard holds valid rows: that
              shard, a nonzero base, against the plain version, and
              the shards' searches merged as product mode merges its
              ranks, bit-equal to the whole buffer's), torch's
              sync-debug count against the host-sync audit
              (``sync_check``), and a torch.profiler breakdown;
6. path       the other rows of bench.py (bench.py:129-137) through
              ``process_raw`` at full width, 20 raw frames of 10,000
              points padded on the card beforehand: the shipped precision
              and realtime profiles (3 pieces a frame, on the frame
              program: three WHILE nodes a graph), realtime racing
              (3 raw frames x 3 pieces a group, one graph launch a raced
              group: one 9-lane WHILE node and 9 SWITCH nodes) and
              chunked dispatch (8 frames, one graph launch a chunk: the
              frame's captured pieces placed 8 times), each with the
              schedule on as the JAX package runs them, then each
              through the plain program on the card (``racing_plain``,
              ``chunked_plain``), rows, iterations, loop passes and every
              state tensor bit-equal to the graph row's; on every graph
              row the state read after its first unit is unchanged at
              its end.  Frames/s, registrations (trajectory rows)/s, ATE,
              accepted rows, ICP iterations, launches (2 per ICP loop
              pass: a piece's iterations, a raced group's batched loop),
              raced and fallen-back groups, host syncs a frame by place,
              the tier ladder and final scale of every row;
              ``sync_check`` on the precision and racing paths, and the
              lane-axis kernel on the racing path's own buffer.  The
              main path's configuration with the ``grid`` and the
              ``dense`` engine (20 frames each, on the frame program,
              one graph launch a frame), which never run ``knn_fused``,
              each with its ``_plain`` twin (the same 20 frames through
              the plain program: rows, iterations, passes and every
              state tensor, the bucket grids included, bit-equal);
              product mode on an NCCL group of one
              rank (``product``: the main path's first 20 frames at the
              configured capacities, since product mode runs unscheduled,
              on the frame program, one graph launch a frame, rows
              bit-equal to ``main_fixed``'s, and ``product_plain``: the
              same frames through the plain product program, bit-equal),
              residual subsampling at the reference's 200-block cap on
              the frame program (``subsampled``: ``main_fixed``'s
              configuration and 20 frames; ``subsampled_racing``: the
              racing profile, 12 frames in groups of 3), each with its
              bit-equal ``_plain`` twin, and `eval.scaling.measure_scaling` at
              that one rank (``scaling``: the sharded kNN and sum against
              the plain ones at 4,096 x 65,536).  Then, at
              full width, the ``full_mapping`` scenario (60 frames of
              10,000 points, cell matching, 8,192 cells x 32 points, on
              the frame program, its rebuild body gathering 262,144 rows;
              ATE < 0.40 m, >= 30 accepted; ``sync_check``; the kernel on
              its cell-gathered buffer) and ``full_mapping_plain`` (its
              first 30 frames through the plain program, rows and every
              state tensor, cell maps included, bit-equal to the frame
              program's after 30 frames), ``mid100_trilidar`` (30 frames of 3
              heads x 8,192 points, 2 pieces a frame, on the frame
              program: one launch of the heads key and one of the step
              key a piece, 1 + 2 a frame; ATE < 0.75 m, >= 30 of 60
              accepted) and ``mid100_trilidar_plain`` (the same 30
              frames, bit-equal), and 20 VLP-16 sweeps (16 x 720 points)
              along a known trajectory through ``process_raw`` with
              ``lidar_type`` velodyne, on the frame program, at the
              configured capacities (every sweep within 0.10 m of the
              truth) and, as ``velodyne_scheduled``, with the schedule
              on (aligned ATE < 0.35 m, every sweep accepted), and 12
              sweeps in chunks of 4 (``velodyne_chunked``) and in racing
              groups of 3 (``velodyne_racing``; aligned ATE < 0.35 m, at
              least half accepted), each with its ``_plain`` twin over
              the same sweeps, bit-equal; every graph row reads 0
              ``icp_exit`` and 0 ``admit`` and runs one launch a unit
              (`graph_row`); then the ``loop_closure`` scenario
              at its own configuration (170 frames of 10,000 points in
              the rich world, the loop service on its worker thread and
              CUDA stream, the odometry on the frame program): frames/s,
              ATE, the loop's pair, score, keyframes (and those dropped
              from the waiting list) and payoff, the worker's ms a
              keyframe by stage, frame-time percentiles with the worker
              busy and idle, the odometry's and the loop's kernel
              launches apart, and the card's eigh against the host's on
              the run's own rotations (aligned ATE < 0.45 m and the loop
              closed, or it fails); and ``loop_closure_plain`` (its first
              40 frames, two keyframes, through the plain program: rows,
              state and the loop service's entries, touched keys and
              keyframe records' keys and poses, bit-equal);
7. cli        the command line on the card (``python -m
              loam_livox_tpu_torch.cli.run_odometry``, a child process):
              24 simulator frames (seed 0, 10,000 points) written as a
              Livox CustomMsg bag (bz2), replayed at the default
              (precision) profile with registration after 10 frames, with
              ``--loop-closure``, ``--follow``, ``--save-poses``,
              ``--save-map`` and ``--log-dir``, on the frame program (one
              graph launch a raw frame, no ICP-exit or admission read,
              the kernel's runs counted on the card in the child's
              summary): frames/s, registrations/s, aligned ATE (<
              0.35 m), accepted rows (>= half), host syncs a frame by
              place (``drain`` and ``log`` included); the follow lines
              equal the pose file, one ``mapping`` line a raw frame, the
              plane cell map loads back with cells in it.  Then, in this process, resume on the
              card: 12 frames straight (registration after 4, the
              schedule on), saved right after the last growth within the
              first 8 frames (``capacity_scale.txt``); `load_pipeline` at
              that tier and the rest again, bit-equal (rows and state
              tensors);
              the loop
              artifact's dumps (written by the replays of phase 3) on the
              card against the CPU's, and the card's service through
              `save_loop_state` / `load_loop_state` with equal values;
8. scenario   ``largescale_realtime`` at full size (its own configuration
              and stream: 60 frames of 10,000 points in the 45 m world,
              the realtime profile, the schedule on) under its golden
              (aligned ATE < 1.30 m, at least half its 180 rows
              accepted), with its tier ladder;
9. kernels    one line listing every kernel (``knn_fused``, ``debounce``,
              ``graph_cond``, ``threefry_keep_mask``, ``threefry_split``,
              ``peer_gather``, the candidates' exchange of product mode):
              runs on the main path (the keep mask's on the
              ``subsampled`` path, the only one that draws; counted on the
              card by each kernel, one atomic add a run, so the frame
              program's replays count) and on every path (``knn_fused``'s
              ``launches_by_path``, the others' ``runs_by_path``), its time, the plain version's, the bound,
              the graph-node floor (``node_floor_ms``), with
              ``--baseline`` the earlier checkout's times, the switch
              index's times and the two condition kernels' runs apart
              under ``graph_cond``,
              and, for ``knn_fused``, the yardstick on the main path's
              buffer, the lane axis's on the racing path's, and its time
              on the ``full_mapping`` buffer, at the scene alignment's
              input, at the shard's input and on the main path's first
              tier.

The line before the last is the card's name and power limit as
nvidia-smi prints them; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a CUDA device, or without the package beside it, it exits
nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, no sparsity) at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FLOPS_PER_PAIR = 8          # 3 subtractions, 3 multiplications, 2 additions
# 32-bit integer operations of one threefry-2x32 block (2 key additions,
# 20 rounds of add, rotate (2 shifts and an or) and xor, 5 injections of
# 3 additions), and of one keep-mask draw besides (the count's addition,
# xor, shift, or, subtraction, max, comparison and and); counted against
# the float32 rate, the table's non-tensor rate
THREEFRY_OPS_PER_BLOCK = 2 + 20 * 5 + 5 * 3
THREEFRY_OPS_PER_DRAW = THREEFRY_OPS_PER_BLOCK + 8


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields, "t_s": time.perf_counter() - T_START}),
          flush=True)


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


def queued_ms(fn, reps: int) -> float:
    """Mean device time per call of ``fn`` over ``reps`` calls queued
    behind a spin kernel, so that the card runs them back to back and
    never waits on the host (CUDA events), after two warm-up calls.  For
    a wrapper that launches one kernel a call, this is the kernel's time
    with the gaps between launches.  The spin lengthens until the host
    has queued every call before the card reaches the first."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    for _ in range(8):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise AssertionError("the host could not queue the calls ahead of the card")


#: how `device_ms` times a kernel: "profiler" (torch.profiler's kernel
#: records), or "queued events" (`queued_ms`) once the profiler has
#: recorded no knn_fused kernel in three tries: CUPTI's activity tracing
#: does not deliver records on every host
KERNEL_TIMER = {"by": "profiler"}


def device_ms(fn, reps: int, name: str = "knn_fused") -> float:
    """Mean device time per call of the kernels named ``name`` that ``fn``
    launches, after two warm-up calls: the kernel alone, whatever the
    wrapper around it does, from torch.profiler's kernel records, or
    from `queued_ms` where the profiler records none (KERNEL_TIMER)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if KERNEL_TIMER["by"] == "profiler":
        fn()
        fn()
        for _ in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key]
            us = sum(e.self_device_time_total for e in rows)
            if us > 0:
                return us / reps / 1e3
        KERNEL_TIMER["by"] = "queued events"
        emit("kernel_timer", by=KERNEL_TIMER["by"],
             why=f"the profiler recorded no {name} kernel in three tries")
    return queued_ms(fn, reps)


def in_turns(timer, new, old, reps):
    """(new, old) means of ``timer`` taken in the order old, new, new, old."""
    o1, n1, n2, o2 = (timer(f, reps) for f in (old, new, new, old))
    return (n1 + n2) / 2, (o1 + o2) / 2


def kernel_times(new, old, reps, name) -> dict:
    """The wrapper's time (``ms``, CUDA events) and the kernel's alone
    (``kernel_ms``, `device_ms` of the kernels named ``name``) of the
    call ``new``; with ``old`` (an earlier version's call on the same
    inputs) both in turns with its times (``baseline_ms``,
    ``baseline_kernel_ms``)."""
    def kernel(fn, r):
        return device_ms(fn, r, name=name)

    if old is None:
        out = dict(ms=time_ms(new, reps), kernel_ms=kernel(new, reps))
    else:
        out = dict(zip(("ms", "baseline_ms"), in_turns(time_ms, new, old, reps)))
        by = KERNEL_TIMER["by"]
        out["kernel_ms"], out["baseline_kernel_ms"] = in_turns(kernel, new, old, reps)
        if KERNEL_TIMER["by"] != by:    # the timer changed midway: all four again
            out["kernel_ms"], out["baseline_kernel_ms"] = in_turns(kernel, new, old, reps)
    out["kernel_ms_by"] = KERNEL_TIMER["by"]
    return out


def compare_kernel(q, ref, mask, n_q, radius, base=None, reps=20):
    """Kernel vs plain on one input: bit-equality, times, bound.  ``q``
    may carry a lane axis (L, Q, 3) with ``n_q`` an (L,) tensor.  With
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
    if base:
        check(base)
    out.update(kernel_times(runner(kf), runner(base) if base else None, reps, "knn_fused"))
    out["plain_ms"] = time_ms(lambda: knn(q, ref, mask, k=5, query_count=n_q,
                                         max_radius=radius), max(3, reps // 5))

    def library():
        dist = torch.cdist(q, ref.expand(q.shape[:-2] + ref.shape))
        return torch.topk(dist.masked_fill(~mask, float("inf")), 5, dim=-1, largest=False)

    out["library_ms"] = time_ms(library, max(3, reps // 5))
    op = kf.build_ref_operand(ref, mask)
    pairs, bytes_ = kf.search_work(q, n_q, op, radius)
    t_ops, t_bytes = pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES
    out.update(bound_ms=1e3 * max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               pairs=pairs, queries=torch.as_tensor(n_q).reshape(-1).tolist(),
               lanes=q.shape[0] if q.dim() == 3 else None, refs=int(mask.sum()),
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


# the kernel phase's inputs: (search, lanes (None: no lane axis), query
# rows, query_count ("uneven": a count a lane, one of them 0), buffer
# capacity, voxel leaf, valid share of the buffer, radius)
KERNEL_INPUTS = (
    ("corners", None, 512, 512, 16384, 0.1, 1.0, 2.0 ** 0.5),
    ("corners", None, 512, 512, 16384, 0.1, 0.05, 2.0 ** 0.5),
    ("surfaces", None, 2048, 2048, 65536, 0.4, 1.0, 50.0 ** 0.5),
    ("surfaces", None, 2048, 2048, 65536, 0.4, 0.05, 50.0 ** 0.5),
    ("surfaces, main-path fill", None, 2048, 200, 65536, 0.4, 0.016, 50.0 ** 0.5),
    # the racing path's lane axis: 9 lanes (3 raw frames x 3 pieces)
    ("corners, 9 lanes", 9, 512, 512, 16384, 0.1, 1.0, 2.0 ** 0.5),
    ("corners, 9 lanes", 9, 512, 512, 16384, 0.1, 0.05, 2.0 ** 0.5),
    ("corners, 9 lanes, uneven counts", 9, 512, "uneven", 16384, 0.1, 0.05, 2.0 ** 0.5),
    ("surfaces, 9 lanes", 9, 2048, 2048, 65536, 0.4, 1.0, 50.0 ** 0.5),
    ("surfaces, 9 lanes", 9, 2048, 2048, 65536, 0.4, 0.05, 50.0 ** 0.5),
    ("surfaces, 9 lanes, uneven counts", 9, 2048, "uneven", 65536, 0.4, 0.05, 50.0 ** 0.5),
)


def kernel_phase(dev, base=None) -> float:
    """Every input of KERNEL_INPUTS through `compare_kernel`, one JSON
    line each; returns the worst absolute error.  The earlier version
    (``base``) has no lane axis, so it times only the inputs without."""
    import torch

    rng = np.random.default_rng(0)
    worst = 0.0
    for label, lanes, nq, count, m, leaf, fill, radius in KERNEL_INPUTS:
        ref, mask = synthetic_map(rng, m, leaf, fill, dev)
        valid = torch.nonzero(mask).flatten()
        shape = (nq,) if lanes is None else (lanes, nq)
        pick = valid[torch.from_numpy(rng.integers(0, len(valid), shape)).to(dev)]
        noise = torch.from_numpy(rng.normal(0, 0.3, shape + (3,)).astype(np.float32)).to(dev)
        q = (ref[pick] + noise).contiguous()
        if count == "uneven":
            counts = rng.integers(1, nq + 1, lanes)
            counts[lanes // 2] = 0
            n_q = torch.from_numpy(counts.astype(np.int32)).to(dev)
        else:
            n_q = torch.tensor(count if lanes is None else [count] * lanes,
                               dtype=torch.int32, device=dev)
        r = compare_kernel(q, ref, mask, n_q, radius, base if lanes is None else None)
        worst = max(worst, r["max_abs_err"])
        emit("kernel", kernel="knn_fused", search=label, fill=fill, **r)
    return worst


def load_baseline(root: str):
    """The kernel wrapper modules ``ops.knn_fused``, ``ops.debounce`` and
    ``ops.graph_cond`` of the port package in an earlier checkout at
    ``root``, imported as ``baseline_port`` beside this one (the
    package's modules import each other relatively, and it builds its
    kernels into its own ``_build/``); a module the checkout lacks is
    None."""
    import importlib
    import importlib.util
    import types

    pkg = os.path.join(os.path.abspath(root), "loam_livox_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = mod
    spec.loader.exec_module(mod)

    def wrapper(name):
        path = os.path.join(pkg, "ops", f"{name}.py")
        return importlib.import_module(f"baseline_port.ops.{name}") if os.path.exists(path) \
            else None

    return types.SimpleNamespace(**{k: wrapper(k) for k in ("knn_fused", "debounce",
                                                           "graph_cond")})


def ptxas_report(log: str, k: int | None = 5, name: str | None = None) -> dict:
    """Registers, spills and static shared memory of the K=k kernel (with
    ``k`` None, of the source's first kernel, or of the first whose
    symbol holds ``name``), from nvcc's ``-Xptxas -v`` log."""
    import re

    lines = log.splitlines()
    for n, ln in enumerate(lines):
        if "Compiling entry function" in ln and (k is None or f"ILi{k}E" in ln) \
                and (name is None or name in ln):
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


def vlp16_sweep(origin=(0.0, 0.0, 0.0), n_az=720, room=8.0, pillar=True,
                seed=0) -> np.ndarray:
    """A VLP-16 sweep (16 rings x ``n_az`` azimuths, ring by ring) from a
    sensor at ``origin`` (no rotation) inside a square room of half-size
    ``room``, floor 1.2 m below and ceiling 1.8 m above the room's centre,
    with, optionally, a vertical plate 0.72 m wide, 3 m from the centre
    at azimuth 0.5 rad.  The azimuths sit half a step off the +-pi seam
    and carry a seeded jitter of up to a quarter step: on an even grid
    some points lie exactly on the half- and quarter-turn tests of the
    sweep time, where one ulp of atan2 (the card's against the CPU's)
    decides."""
    o = np.asarray(origin, np.float64)
    rv = np.deg2rad(np.linspace(-15, 15, 16))[:, None]
    step = 2 * np.pi / n_az
    az = (-np.pi + step * (np.arange(n_az) + 0.5)
          + np.random.default_rng(seed).uniform(-0.25, 0.25, (16, n_az)) * step)
    d = np.stack(np.broadcast_arrays(np.cos(az) * np.cos(rv), np.sin(az) * np.cos(rv),
                                     np.sin(rv)), axis=-1).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        walls = [room * np.sign(d[:, 0]), room * np.sign(d[:, 1]),
                 np.where(d[:, 2] < 0, -1.2, 1.8)]
        r = np.min([np.where(d[:, k] != 0, (walls[k] - o[k]) / d[:, k], np.inf)
                    for k in range(3)], axis=0)
        if pillar:
            n = np.array([np.cos(0.5), np.sin(0.5), 0.0])
            t = (3.0 - o @ n) / (d @ n)
            hit = o + t[:, None] * d
            side = np.abs(hit[:, 0] * -n[1] + hit[:, 1] * n[0])
            r = np.where((t > 0) & (side < 3.0 * np.tan(0.12)), np.minimum(r, t), r)
    return (d * r[:, None]).astype(np.float32)


def simulate(n_frames, points, init, seed=0):
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory

    sim = LivoxSimulator(SimConfig(points_per_frame=points, seed=seed),
                         traj=Trajectory(ramp_t0=0.1 * init + 0.2))
    return sim, [sim.frame(i) for i in range(n_frames)]


def on_device(frames, n_raw, dev):
    """Raw frames padded to ``n_raw`` points and moved to the card
    beforehand, as bench.py:113-124 does: (points, intensities, time,
    mask) for ``process_raw(..., mask=)``."""
    from loam_livox_tpu_torch.core.types import to_device

    out = []
    for xyz, inten, t0 in frames:
        pts = np.zeros((n_raw, 3), np.float32)
        it = np.zeros(n_raw, np.float32)
        m = np.zeros(n_raw, bool)
        pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
        out.append((to_device(pts, dev), to_device(it, dev), t0, to_device(m, dev)))
    return out


def feed(pipe, frames):
    for frame in frames:
        pipe.process_raw(*frame[:3], mask=frame[3] if len(frame) > 3 else None)


def rows_per_frame(cfg) -> int:
    from loam_livox_tpu_torch.runtime.pipeline import piece_count

    return 1 if cfg.common.odom_mode == 0 else piece_count(cfg)


def run_feed(cfg, frames, device, feed_one=None, split=None, plain=False):
    """The frames through a new pipeline, ``feed_one(pipe, frame)`` each
    (default `process_raw` of a raw frame); returns the pipeline.  With
    ``split``, the card is synchronised after that many frames, the
    seconds since the call are kept in ``pipe.split_wall_s`` and a copy
    of the state then in ``pipe.split_state``.  With ``plain``, the
    pipeline runs the plain program where it would run the frame
    program.  On the frame program, the state read after the first
    dispatch unit (a raw frame, a chunk or a group) must be unchanged at
    the end, or it fails (``pipe.state_read_held``)."""
    import torch

    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    feed_one = feed_one or (lambda pipe, frame: feed(pipe, [frame]))
    t0 = time.perf_counter()
    pipe = OdometryPipeline(cfg, device=device)
    if plain:
        pipe.program = None
    unit = max(pipe.frame_batch, pipe.dispatch_chunk)
    for frame in frames[:unit]:
        feed_one(pipe, frame)
    held = pipe.state if pipe.program is not None else None
    kept = clone_state(held)
    rest = frames[unit:]
    if split is not None:
        for frame in frames[unit:split]:
            feed_one(pipe, frame)
        torch.cuda.synchronize()
        pipe.split_wall_s = time.perf_counter() - t0
        pipe.split_state = clone_state(pipe.state)
        rest = frames[split:]
    for frame in rest:
        feed_one(pipe, frame)
    pipe.flush()
    pipe.state_read_held = None
    if held is not None:
        a, b = state_tensors(held), state_tensors(kept)
        changed = [k for k in a if not (torch.equal(a[k], b[k])
                                        if isinstance(a[k], torch.Tensor) else a[k] == b[k])]
        if changed:
            raise AssertionError(f"a state read after the first unit changed under the "
                                 f"next units: {changed}")
        pipe.state_read_held = True
    return pipe


def run_stream(cfg, sim, frames, device, split=None, plain=False):
    """The frames through a new pipeline (`run_feed`); returns (pipeline,
    aligned ATE, accepted trajectory rows)."""
    from loam_livox_tpu_torch.eval.ate import ate_rmse

    pipe = run_feed(cfg, frames, device, split=split, plain=plain)
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    rows = len(frames) * rows_per_frame(cfg)
    if not np.all(np.isfinite(est)) or est.shape != (rows, 3):
        raise AssertionError(f"bad trajectory {est.shape}, expected ({rows}, 3)")
    return pipe, ate_rmse(est, gt), int(sum(pipe.trajectory.accepted))


# where each place of the host-sync audit (runtime/pipeline.py) lives
AUDIT_FILES = {
    "icp_exit": "loam_livox_tpu_torch/registration/icp.py",
    "admit": "loam_livox_tpu_torch/runtime/odometry.py",
    "drain": "loam_livox_tpu_torch/runtime/pipeline.py",
    "log": "loam_livox_tpu_torch/runtime/pipeline.py",
    "schedule": "loam_livox_tpu_torch/runtime/capacity_schedule.py",
    "resume": "loam_livox_tpu_torch/runtime/checkpoint.py",
}


def schedule_info(pipe) -> dict:
    """A pipeline's capacity schedule: whether it ran, its growths as
    (dispatch units run, new scale): raw frames on the sequential paths,
    chunks, raced groups, or feature frames of a multi-head run; and the
    scale it ended at."""
    s = pipe.scheduler
    return {"scheduled": s is not None, "ladder": [list(g) for g in pipe.ladder],
            "final_scale": s.scale if s is not None else None}


def clone_state(state):
    """A copy of an odometry state's tensors (the frame program updates
    its state in place)."""
    import torch

    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(clone_state(x) for x in state))
    return state


def reset_counts(kf, P) -> None:
    """Zero every kernel wrapper's launch count and its kernel's run
    counter on the card, the host-sync places and the frame program's
    graph counters."""
    from loam_livox_tpu_torch.ops import debounce as DB
    from loam_livox_tpu_torch.ops import graph_cond as GC
    from loam_livox_tpu_torch.ops import peer_gather as PG
    from loam_livox_tpu_torch.ops import threefry as TF
    from loam_livox_tpu_torch.ops import voxel_centroid as VC

    kf.launches = DB.launches = GC.launches = TF.split_launches = TF.mask_launches = 0
    PG.launches = VC.launches = 0
    for counter in (kf.runs, DB.runs, GC.runs, GC.switch_runs, TF.split_runs, TF.mask_runs,
                    PG.runs, VC.runs):
        counter.reset()
    P.reset_host_syncs()


def kernel_runs(kf) -> dict:
    """Each kernel's runs since `reset_counts`, counted on the card by the
    kernel itself (one atomic add a run: launches from Python and runs
    in graph replays alike), and the wrappers' launches from Python."""
    from loam_livox_tpu_torch.ops import debounce as DB
    from loam_livox_tpu_torch.ops import graph_cond as GC
    from loam_livox_tpu_torch.ops import peer_gather as PG
    from loam_livox_tpu_torch.ops import threefry as TF
    from loam_livox_tpu_torch.ops import voxel_centroid as VC

    return ({"knn_fused": kf.runs.read(), "debounce": DB.runs.read(),
             "loop_cond": GC.runs.read(), "switch_cond": GC.switch_runs.read(),
             "threefry_split": TF.split_runs.read(), "threefry_keep_mask": TF.mask_runs.read(),
             "peer_gather": PG.runs.read(), "voxel_centroid": VC.runs.read()},
            {"knn_fused": kf.launches, "debounce": DB.launches, "graph_cond": GC.launches,
             "threefry_split": TF.split_launches, "threefry_keep_mask": TF.mask_launches,
             "peer_gather": PG.launches, "voxel_centroid": VC.launches})


#: each graph row's kernel runs counted on the card, by path (the
#: ``kernels`` line's ``runs_by_path``)
RUNS_BY_PATH = {}


def graph_row(label, pipe, n_frames, kf, syncs, graphs, wall=None, service_runs=0,
              heads=0, service_filters=0) -> dict:
    """A row on the frame program: its graphs (one a shape key: its kind
    (a raw frame, a chunk, a racing group, a feature-frame step or a
    multi-head front end), the tier's capacities, frames, debounce runs,
    steps, WHILE and SWITCH nodes a launch, capture seconds, the device
    memory the capture took, launches, whether still held) and the
    kernels' runs, counted on the card.  Fails unless every dispatch unit
    was one graph launch (a raw frame, a chunk, a raced group, each frame
    of a fallen-back group; with ``heads`` S > 0 a multi-head frame: one
    front-end launch and one step launch a piece), each key was captured
    once, no kernel was launched from Python, the runs are what the
    replays hold (``knn_fused`` twice an ICP pass under its engine and
    never under ``grid`` or ``dense``, the debounce once a Livox head's
    raw frame and never in the Velodyne front end, the loop condition
    once a pass and once before each WHILE node, the switch condition
    once before each SWITCH node, the threefry split once a pass, once a
    step and twice a racing group, the keep mask once a pass with
    residual subsampling and never without, the candidates' exchange
    twice a pass under a product mesh with ``knn_fused``, the voxel
    filter's kernel once a filter: each launch's filters outside its
    conditional bodies, a rebuild body's once a rebuild the card counted
    (`FrameProgram.rebuilds`), and the loop service's), the ICP passes counted on
    the card equal the rows' iterations (sequential units: one lane a
    loop), every
    held key's graph pool holds memory (its segments found in the
    allocator's snapshot; a chunk places its frame key's), and neither
    the ICP exit nor the admission read the host (the front ends have no
    host read left).  With ``wall``, the frames/s without the captures'
    seconds too.  ``service_runs``: the loop service's ``knn_fused``
    launches (from Python on its worker, one run each), which the kernel
    counts with the replays'; ``service_filters`` its voxel filters."""
    from loam_livox_tpu_torch.core.accounting import GRAPH_KINDS
    from loam_livox_tpu_torch.registration.icp import resolve_correspondence_engine

    cfg = pipe.cfg
    runs, from_python = kernel_runs(kf)
    keys = pipe.program.summary()
    passes = pipe.loop_iterations
    fused = resolve_correspondence_engine(cfg.optimization, True) == "pallas"
    subsampled = int(cfg.optimization.subsample_residuals) > 0
    expected = {"knn_fused": 2 * passes * fused + service_runs,
                "debounce": sum(k["launches"] * k["debounces"] for k in keys),
                "loop_cond": passes + sum(k["launches"] * k["whiles"] for k in keys),
                "switch_cond": sum(k["launches"] * k["switches"] for k in keys),
                "threefry_split": passes + sum(k["launches"] * k["splits"] for k in keys),
                "threefry_keep_mask": passes * subsampled,
                "peer_gather": 2 * passes * fused * (pipe.mesh is not None)}
    rebuild_filters = {k["rebuild_filters"] for k in keys if k["switches"]}
    expected["voxel_centroid"] = (sum(k["launches"] * k["filters"] for k in keys)
                                  + pipe.program.rebuilds() * max(rebuild_filters, default=0)
                                  + service_filters)
    by_kind = {kind: sum(k["launches"] for k in keys if k["kind"] == kind)
               for kind in GRAPH_KINDS}
    units = dict.fromkeys(GRAPH_KINDS, 0)
    if heads:
        units.update(heads=n_frames, step=len(pipe.trajectory.times))
    elif pipe.dispatch_chunk > 1:
        units["chunk"] = -(-n_frames // pipe.dispatch_chunk)
    elif pipe.frame_batch > 1:
        raced = sum(k["launches"] * k["frames"] for k in keys if k["kind"] == "group")
        units.update(frame=n_frames - raced, group=pipe.raced_groups)
    else:
        units["frame"] = n_frames
    debounces = n_frames * max(heads, 1) * (cfg.common.lidar_type == "livox")
    capture_s = sum(k["capture_s"] for k in keys)
    out = {"graphs": keys, "graph_counts": graphs, "kernel_runs": runs,
           "capture_s": capture_s, "launches_by_kind": by_kind,
           "graph_pool_mb": sum(k["pool_mb"] for k in keys if k["held"]),
           "graph_device_mb": sum(k["device_mb"] for k in keys if k["held"])}
    if wall is not None:
        out["fps_without_captures"] = n_frames / (wall - capture_s)
    reads = {p: syncs.get(p, 0) for p in ("icp_exit", "admit")}
    sequential = by_kind["group"] == 0
    if (runs != expected or any(from_python.values()) or by_kind != units
            or expected["debounce"] != debounces
            or graphs["graph_launch"] != sum(by_kind.values())
            or graphs["graph_capture"] != len(keys) or any(reads.values())
            or (sequential and passes != sum(pipe.iterations))
            or any(k["switches"] != k["steps"] for k in keys) or len(rebuild_filters) > 1
            or any(k["pool_mb"] <= 0 for k in keys if k["held"] and k["kind"] != "chunk")):
        raise AssertionError(f"{label}: frame program off: kernel runs {runs} against "
                             f"{expected}, launches from Python {from_python}, launches "
                             f"by kind {by_kind} against {units}, debounces {debounces}, "
                             f"graphs {graphs}, passes {passes} against "
                             f"{sum(pipe.iterations)}, reads {reads}")
    RUNS_BY_PATH[label] = runs
    return out


def assert_runs_equal(label, pipe, ref, n_frames=None) -> dict:
    """Fail unless ``pipe``'s rows (times, positions, quaternions,
    accepted), ICP iterations and loop passes (and, without ``n_frames``,
    every state tensor) equal ``ref``'s, a plain-program run of the same
    frames, bit for bit; ``n_frames`` compares ``pipe``'s first rows with
    the state ``pipe`` kept after them (``split_state``).  Returns what
    it compared."""
    import torch

    rows = len(ref.trajectory.times)
    keys = ("times", "positions", "quaternions", "accepted")
    rows_equal = (all(np.array_equal(np.asarray(getattr(ref.trajectory, k)),
                                     np.asarray(getattr(pipe.trajectory, k)[:rows]))
                      for k in keys)
                  and ref.iterations == pipe.iterations[:rows])
    state = pipe.split_state if n_frames is not None else pipe.state
    a, b = state_tensors(ref.state), state_tensors(state)
    differ = [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                   else a[k] == b[k])]
    passes = ({} if n_frames is not None else
              {"loop_iterations": (pipe.loop_iterations, ref.loop_iterations),
               "raced_loop_iterations": (pipe.raced_loop_iterations,
                                         ref.raced_loop_iterations)})
    passes_equal = all(x == y for x, y in passes.values())
    if not rows_equal or differ or not passes_equal:
        raise AssertionError(f"{label}: the frame program departs from the plain program: "
                             f"rows equal {rows_equal}, state fields differing {differ}, "
                             f"passes {passes}")
    return {"rows_bit_equal": rows_equal, "state_fields_differing": differ,
            "state_fields": len(a), "passes_equal": passes_equal}


def debounce_inputs(cfg, frame, dev):
    """The debounce's arguments on a host raw frame ``(xyz, intensity,
    t0)``, as the front end builds them (recorded from its call)."""
    from loam_livox_tpu_torch.core.types import to_device
    from loam_livox_tpu_torch.frontend import livox

    xyz, inten, t = frame[:3]
    n_raw = cfg.capacity.max_raw_points
    pts = np.zeros((n_raw, 3), np.float32)
    it = np.zeros(n_raw, np.float32)
    msk = np.zeros(n_raw, bool)
    pts[:len(xyz)], it[:len(xyz)], msk[:len(xyz)] = xyz, inten, True
    seen = []
    real = livox.debounce
    livox.debounce = lambda *a: seen.append(a) or real(*a)
    try:
        livox.extract_frame(to_device(pts, dev), to_device(it, dev), to_device(msk, dev), t,
                            cfg.feature_extraction, cfg.capacity)
    finally:
        livox.debounce = real
    return seen[0]


def compare_small_kernel(name, kernel, plain, args, bytes_, ops, reps=200,
                         base_kernel=None) -> dict:
    """A kernel with a plain version of the same contract on the same
    inputs: bit-equality, the wrapper's time, the kernel's alone, the
    plain version's, and the bound (bytes over the memory rate or scalar
    operations over the float32 rate, the larger).  With ``base_kernel``
    (an earlier version's wrapper of the same contract), it is held to
    the plain version too and timed in turns with this one."""
    import torch

    def check(fn):
        got, want = fn(*args), plain(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max())
                  for a, b in zip(got, want))
        if err != 0.0 or not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} disagrees with its plain version: max_abs_err {err}")
        return err

    out = dict(max_abs_err=check(kernel))
    if base_kernel is not None:
        check(base_kernel)
    out.update(kernel_times(lambda: kernel(*args),
                            None if base_kernel is None else lambda: base_kernel(*args),
                            reps, name))
    t_bytes, t_ops = bytes_ / PEAK_BYTES, ops / PEAK_FP32_FLOPS
    out.update(plain_ms=time_ms(lambda: plain(*args), max(3, reps // 10)),
               bound_ms=1e3 * max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", library_ms=None)
    return out


def debounce_tables(rng, ns, n):
    """Seeded debounce inputs ``(cand_idx, cand_is_edge, n, n_valid, gap)``
    as host arrays at ``ns`` slots over ``n`` points: random candidate
    sets (empty to overfull, random and strictly alternating kinds), a
    chain of ns one-step hops (each candidate just past ``gap`` of the
    one before, so every slot is kept and the chain is the longest), in
    one kind and alternating, every candidate within ``gap`` of the first
    (one kept), and an empty table."""
    out = []
    for trial in range(8):
        k = int(rng.integers(0, min(n, ns) + 1)) if trial < 6 else min(n, ns)
        idx = np.sort(rng.choice(n, size=k, replace=False))
        cand = np.full(ns, n, np.int64)
        cand[:k] = idx
        edge = np.zeros(ns, bool)
        edge[:k] = (np.arange(k) % 2 == 1) if trial % 3 == 2 else rng.random(k) < rng.random()
        out.append((cand, edge, n, int(rng.integers(0, n + 1)), int(rng.integers(0, 80))))
    gap = 3
    hops = np.arange(ns, dtype=np.int64) * (gap + 1)
    out.append((hops, np.zeros(ns, bool), int(hops[-1]) + 2, int(hops[-1]) + 1, gap))
    out.append((hops, np.arange(ns) % 2 == 0, int(hops[-1]) + 2, int(hops[-1]) + 1, gap))
    out.append((np.arange(ns, dtype=np.int64), np.zeros(ns, bool), ns + 1, ns, ns))
    out.append((np.full(ns, n, np.int64), np.zeros(ns, bool), n, 0, gap))
    return out


#: the table sizes of the debounce's seeded inputs: one thread's worth,
#: just below and past one warp, the shipped 512, past one block of
#: 1,024 threads, a table of 4,096 (4 slots a thread, ~74 KB of shared
#: memory), and two past one block's shared memory (the kernel's global
#: form: ~0.3 and ~0.6 MB of tables)
DEBOUNCE_SLOTS = (1, 31, 33, 512, 1000, 1025, 4096, 16384, 32768)


def debounce_phase(cfg, frames, dev) -> dict:
    """The debounce kernel bit for bit against its plain version on the
    candidate table of every one of ``frames`` (host raw frames, as the
    front end builds them) and on `debounce_tables` at each of
    DEBOUNCE_SLOTS; returns the counts held."""
    import torch

    from loam_livox_tpu_torch.ops import debounce as DB

    cases = [debounce_inputs(cfg, f, dev) for f in frames]
    rng = np.random.default_rng(10)
    for ns in DEBOUNCE_SLOTS:
        for cand, edge, n, n_valid, gap in debounce_tables(rng, ns, int(rng.integers(8, 16385))):
            cases.append((torch.from_numpy(cand).to(dev), torch.from_numpy(edge).to(dev), n,
                          torch.tensor(n_valid, device=dev), gap))
    runs = DB.runs.read()
    for k, args in enumerate(cases):
        (s_k, n_k), (s_p, n_p) = DB.debounce(*args), DB.debounce_plain(*args)
        if not (torch.equal(s_k, s_p) and torch.equal(n_k, n_p)):
            raise AssertionError(f"debounce disagrees with its plain version on table {k} "
                                 f"({args[0].shape[0]} slots)")
    kernel_runs = DB.runs.read() - runs
    global_form = [ns for ns in DEBOUNCE_SLOTS if DB.scratch_bytes(ns, cases[0][0].device)]
    if kernel_runs != len(cases) or global_form != [16384, 32768]:
        raise AssertionError(f"debounce: {kernel_runs} kernel runs for {len(cases)} tables, "
                             f"global form at {global_form} slots")
    return {"frame_tables": len(frames), "seeded_tables": len(cases) - len(frames),
            "slots": list(DEBOUNCE_SLOTS), "global_form_slots": global_form,
            "kernel_runs": kernel_runs}


#: the voxel filter's seeded inputs (`voxel_inputs`)
VOXEL_CASES = ("mid40_source", "mid100_merged", "rebuild", "overflow", "coarse",
               "last_voxel_3", "last_voxel_5", "all_masked")
#: the inputs timed: the main path's sizes (a Mid-40 source, 16,384 rows;
#: a Mid-100 merged cloud, 49,152; the rebuild's history source, 131,072)
VOXEL_TIMED = ("mid40_source", "mid100_merged", "rebuild")


def _surfaces(rng, n: int, planes: int = 6, extent: float = 12.0) -> np.ndarray:
    """``n`` float32 points on ``planes`` random planes of 2 ``extent`` m,
    with 1 cm of noise: a 0.4 m voxel holds a handful, as on a scan."""
    out = np.empty((n, 3))
    which = rng.integers(0, planes, n)
    for p in range(planes):
        axes, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        sel = which == p
        uv = rng.uniform(-extent, extent, (int(sel.sum()), 2))
        out[sel] = rng.uniform(-extent, extent, 3) + uv @ axes[:2]
    return (out + rng.normal(scale=0.01, size=out.shape)).astype(np.float32)


def voxel_inputs(name: str):
    """``(xyz, time, mask, leaf, capacity, with_time)`` host arrays of one
    voxel-filter input, seeded by its place in VOXEL_CASES:

    * ``mid40_source``: a Livox head's 10,000 points padded to 16,384;
    * ``mid100_merged``: three such heads merged, 49,152 rows;
    * ``rebuild``: the history source (64 frames of 2,048 slots, each
      frame's first 0-400 valid), no time channel;
    * ``overflow``: ~16,000 occupied voxels into 2,048 slots;
    * ``coarse``: a 2 m leaf over a 6 m cube, hundreds of points a voxel;
    * ``last_voxel_k``: the last voxel holds k points with distinct
      times, ahead of 40 masked rows (its segment in the plain version
      is 32 rows or more);
    * ``all_masked``: no valid point."""
    rng = np.random.default_rng(VOXEL_CASES.index(name))
    if name == "mid40_source":
        xyz, mask = _surfaces(rng, 16384), np.arange(16384) < 10000
        leaf, cap, with_time = 0.4, 16384, True
    elif name == "mid100_merged":
        xyz, mask = _surfaces(rng, 3 * 16384), np.tile(np.arange(16384) < 10000, 3)
        leaf, cap, with_time = 0.4, 3 * 16384, True
    elif name == "rebuild":
        xyz = _surfaces(rng, 64 * 2048)
        mask = (np.arange(2048)[None] < rng.integers(0, 401, 64)[:, None]).reshape(-1)
        leaf, cap, with_time = 0.4, 65536, False
    elif name == "overflow":
        xyz = rng.uniform(-12, 12, (16384, 3)).astype(np.float32)
        mask = rng.uniform(size=16384) < 0.95
        leaf, cap, with_time = 0.4, 2048, True
    elif name == "coarse":
        xyz = rng.uniform(-3, 3, (16384, 3)).astype(np.float32)
        mask = np.arange(16384) < 12000
        leaf, cap, with_time = 2.0, 4096, True
    elif name.startswith("last_voxel_"):
        k = int(name.rsplit("_", 1)[1])
        grid = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4)), -1).reshape(-1, 3)
        others = (grid * 0.5 + 0.25).astype(np.float32)           # one point a voxel
        last = np.array([20.1, 0.1, 0.1], np.float32) + rng.uniform(0, 0.3, (k, 3))
        xyz = np.concatenate([others, last.astype(np.float32),
                              rng.uniform(-5, 5, (40, 3)).astype(np.float32)])
        mask = np.arange(xyz.shape[0]) < others.shape[0] + k
        perm = rng.permutation(xyz.shape[0])
        xyz, mask = xyz[perm], mask[perm]
        leaf, cap, with_time = 0.5, 1024, True
    elif name == "all_masked":
        xyz, mask = _surfaces(rng, 4096), np.zeros(4096, bool)
        leaf, cap, with_time = 0.4, 512, True
    else:
        raise KeyError(name)
    n = xyz.shape[0]
    time = (rng.uniform(0.0, 0.1, n) if with_time else np.zeros(n)).astype(np.float32)
    return xyz, time, mask, leaf, cap, with_time


def sorted_input(name: str, dev):
    """A seeded input (`voxel_inputs`) on ``dev`` and its keys sorted as
    the filter sorts them: ``(batch, leaf, capacity, with_time, key_s,
    order)``."""
    import torch

    from loam_livox_tpu_torch.core.types import PointBatch
    from loam_livox_tpu_torch.ops import voxel as V

    xyz, time, mask, leaf, cap, with_time = voxel_inputs(name)
    batch = PointBatch(*(torch.from_numpy(a).to(dev) for a in (xyz, time, mask)))
    key = torch.where(batch.mask, V.voxel_keys(batch.xyz, leaf),
                      torch.full_like(batch.mask, V._INVALID_KEY, dtype=torch.int64))
    key_s, order = torch.sort(key, stable=True)
    return batch, leaf, cap, with_time, key_s, order


def voxel_phase(dev) -> dict:
    """The voxel filter's kernel against its plain version: the card's
    filter (`ops.voxel.voxel_downsample`) twice and
    `ops.voxel.centroids_plain` on each of VOXEL_CASES, bit for bit
    (``torch.equal``), one run a filter; then, at each of VOXEL_TIMED,
    one ``kernel`` line through `compare_small_kernel` (the wrapper with
    the segment ids it is handed, the kernel alone, the plain version
    from the sorted keys on, and the bound: each contributing row's key,
    order entry, xyz and time and each slot's outputs at the memory
    rate).  Returns the timed inputs' results, the first with the cases
    held."""
    import torch

    from loam_livox_tpu_torch.ops import voxel as V
    from loam_livox_tpu_torch.ops import voxel_centroid as VC

    held = {}
    for name in VOXEL_CASES:
        batch, leaf, cap, with_time, key_s, order = sorted_input(name, dev)
        runs = VC.runs.read()
        got = V.voxel_downsample(batch, leaf, capacity=cap, with_time=with_time)
        again = V.voxel_downsample(batch, leaf, capacity=cap, with_time=with_time)
        want = V.centroids_plain(key_s, order, batch.xyz, batch.time, cap, with_time)
        torch.cuda.synchronize()
        runs = VC.runs.read() - runs
        if runs != 2 or not all(torch.equal(a, b) and torch.equal(a, c)
                                for a, b, c in zip(got, want, again)):
            raise AssertionError(f"voxel_centroid disagrees with its plain version on {name} "
                                 f"({runs} runs for 2 filters)")
        held[name] = {"rows": int(batch.xyz.shape[0]), "capacity": cap,
                      "voxels": int(want.mask.sum())}
    out = {}
    for name in VOXEL_TIMED:
        batch, leaf, cap, with_time, key_s, order = sorted_input(name, dev)
        _, counts = torch.unique(V.voxel_keys(batch.xyz[batch.mask], leaf), sorted=True,
                                 return_counts=True)
        rows = int(counts[:cap].sum())
        n_bytes = rows * (8 + 8 + 12 + 4 * with_time) + cap * (12 + 4 + 1)
        out[name] = r = compare_small_kernel(
            "voxel_centroid",
            lambda k, o, x, t: VC.centroids(k, V.segment_ids(k), o, x, t, cap, with_time,
                                            V._INVALID_KEY),
            lambda k, o, x, t: V.centroids_plain(k, o, x, t, cap, with_time),
            (key_s, order, batch.xyz, batch.time), bytes_=n_bytes, ops=4 * rows)
        r.update(rows=int(batch.xyz.shape[0]), contributing_rows=rows, capacity=cap,
                 voxels=int(counts[:cap].numel()), with_time=with_time)
        emit("kernel", kernel="voxel_centroid", search=name, **r)
    out[VOXEL_TIMED[0]]["held"] = held
    return out


def front_end_past_shared(frame, dev) -> dict:
    """The Livox front end at ``max_splits`` 16,384 (the debounce's global
    form) on a host raw frame, on the card against the CPU: the split
    table, kept count and the first piece's features equal, bit for
    bit."""
    import torch

    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.core.types import to_device
    from loam_livox_tpu_torch.frontend import livox

    cfg = SlamConfig().replace(capacity={"max_splits": 16384})
    xyz, inten, t = frame[:3]
    n_raw = cfg.capacity.max_raw_points
    pts, it, msk = (np.zeros((n_raw, 3), np.float32), np.zeros(n_raw, np.float32),
                    np.zeros(n_raw, bool))
    pts[:len(xyz)], it[:len(xyz)], msk[:len(xyz)] = xyz, inten, True
    out = {}
    for where in ("cpu", dev):
        seen = []
        real = livox.debounce
        livox.debounce = lambda *a: seen.append(real(*a)) or seen[-1]
        try:
            _, _, frames = livox.extract_frame(*(to_device(a, where) for a in (pts, it, msk)), t,
                                               cfg.feature_extraction, cfg.capacity)
        finally:
            livox.debounce = real
        out[str(where)] = seen[0], frames[0]
    (s_c, k_c), fr_c = out["cpu"]
    (s_g, k_g), fr_g = out[str(dev)]
    equal = {"splits": torch.equal(s_g.cpu(), s_c), "kept": int(k_g) == int(k_c)}
    for name in ("corners", "surface"):
        a, b = getattr(fr_g, name), getattr(fr_c, name)
        equal[name] = torch.equal(a.mask.cpu(), b.mask) and torch.equal(a.xyz.cpu(), b.xyz)
    if not all(equal.values()):
        raise AssertionError(f"the front end at 16,384 splits departs from the CPU's: {equal}")
    return {"slots": int(s_c.shape[0]), "kept": int(k_c), "equal": equal}


def split_search(dev, m=2_000_000, n_q=256) -> dict:
    """The registration's kNN searcher over ``m`` rows, past the kernel's
    largest operand (`ops.knn_fused.max_ref_rows`): one kernel launch a
    row block, the blocks merged, against the plain search of the whole
    buffer, bit for bit; with the searcher's time and the plain
    version's."""
    import torch

    from loam_livox_tpu_torch.core.types import PointBatch
    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.ops.knn import knn
    from loam_livox_tpu_torch.registration import icp

    rng = np.random.default_rng(21)
    xyz = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    mask = rng.random(m) < 0.3
    q = (xyz[rng.integers(0, m, n_q)] + rng.normal(0, 0.5, (n_q, 3))).astype(np.float32)
    ref = PointBatch(xyz=torch.from_numpy(xyz).to(dev), time=torch.zeros(m, device=dev),
                     mask=torch.from_numpy(mask).to(dev))
    q = torch.from_numpy(q).to(dev)
    count = torch.tensor(n_q - 16, dtype=torch.int32, device=dev)
    search = icp._searcher("pallas", ref, None, 5, 2.0, 1024)
    runs = kf.runs.read()
    d, i = search(q, count)
    blocks = kf.runs.read() - runs
    dp, ip = knn(q, ref.xyz, ref.mask, k=5, query_count=n_q - 16, max_radius=2.0)
    err = float((d.double() - dp.double()).abs().max())
    ok = torch.equal(d, dp) and torch.equal(i, ip) and blocks == -(-m // kf.max_ref_rows(5))
    if not ok:
        raise AssertionError(f"the split search departs from the plain search: blocks "
                             f"{blocks}, max_abs_err {err}")
    # each block's kernel alone (calls queued behind a spin kernel, timed by
    # CUDA events: the profiler recorded none at these operands), the bound
    # of the whole search (`ops.knn_fused.search_work` over one operand of
    # all the rows), and torch.cdist + topk over the same rows (a 2 GB
    # distance matrix)
    rows = kf.max_ref_rows(5)
    block_ms = []
    for lo in range(0, m, rows):
        b = slice(lo, min(lo + rows, m))
        op = kf.build_ref_operand(ref.xyz[b], ref.mask[b])
        block_ms.append(queued_ms(
            lambda b=b, op=op: kf.knn_fused(q, ref.xyz[b], ref.mask[b], k=5, ref_op=op,
                                            query_count=count, max_radius=2.0), 5))
    pairs, bytes_ = kf.search_work(q, count, kf.build_ref_operand(ref.xyz, ref.mask), 2.0)
    t_ops, t_bytes = pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS, bytes_ / PEAK_BYTES

    def library():
        dist = torch.cdist(q[:n_q - 16], ref.xyz)
        return torch.topk(dist.masked_fill(~ref.mask, float("inf")), 5, dim=-1, largest=False)

    return {"rows": m, "queries": n_q, "max_rows": rows, "blocks": blocks,
            "max_abs_err": err, "beyond_first_block": bool((i >= rows).any()),
            "ms": time_ms(lambda: search(q, count), 5),
            "kernel_ms_by_block": block_ms, "kernel_ms": sum(block_ms),
            "kernel_ms_by": "queued events", "pairs": pairs,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "plain_ms": time_ms(lambda: knn(q, ref.xyz, ref.mask, k=5, query_count=n_q - 16,
                                            max_radius=2.0), 2),
            "library_ms": time_ms(library, 3)}


def node_floor(nodes=64, reps=20) -> dict:
    """The floor of a kernel node in a CUDA graph: an empty one-thread
    kernel captured ``nodes`` times into one graph, replayed.  Per node:
    the kernel alone with the kernel lines' timer (profiler records, or
    calls queued behind a spin kernel where the profiler records none;
    KERNEL_TIMER is left as it is), and the replay's time over its nodes
    (CUDA events, the gaps between nodes included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from loam_livox_tpu_torch.ops import graph_cond as GC

    GC.empty_kernel()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(nodes):
            GC.empty_kernel()
    g.replay()
    torch.cuda.synchronize()
    kernel_ms, by = None, KERNEL_TIMER["by"]
    if by == "profiler":
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    g.replay()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "empty_kernel" in e.key)
            if us > 0:
                kernel_ms = us / reps / nodes / 1e3
                break
    if kernel_ms is None:
        by = "queued events"
        kernel_ms = queued_ms(g.replay, reps) / nodes
    return dict(nodes=nodes, kernel_ms=kernel_ms, kernel_ms_by=by,
                node_ms=time_ms(g.replay, reps) / nodes)


def sync_check(label, pipe, frames):
    """torch's own count of synchronising calls (sync-debug warnings, by
    source line) over ``frames`` fed to ``pipe``, against the audit's
    count by place (`runtime.pipeline.host_syncs`)."""
    import collections
    import warnings

    import torch

    from loam_livox_tpu_torch.runtime import pipeline as P

    P.reset_host_syncs()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        feed(pipe, frames)
        torch.cuda.set_sync_debug_mode("default")
    where = collections.Counter(
        f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message) and "prototype" not in str(w.message))
    audit = P.host_syncs()
    by_file = collections.Counter()
    for line, count in where.items():
        by_file[line.rsplit(":", 1)[0]] += count
    expected = collections.Counter()
    for k, v in audit.items():
        expected[AUDIT_FILES[k]] += v
    expected = +expected
    n = len(frames)
    emit("sync_check", path=label, frames=n, counted_per_frame=sum(audit.values()) / n,
         torch_sync_warnings_per_frame=sum(where.values()) / n,
         audit={k: v / n for k, v in audit.items()},
         by_line={k: v / n for k, v in sorted(where.items())},
         match=by_file == expected)


def surface_queries(state, frame, cfg, dev):
    """The surface ICP queries of a host raw frame ``(xyz, intensity,
    t0)`` at the state's pose (with deblur, as the path applies it) and
    their count."""
    import torch

    from loam_livox_tpu_torch.core.types import to_device
    from loam_livox_tpu_torch.frontend.livox import extract_frame
    from loam_livox_tpu_torch.registration import residuals as res
    from loam_livox_tpu_torch.registration.icp import refine_blur
    from loam_livox_tpu_torch.runtime.odometry import input_downsample
    from loam_livox_tpu_torch.runtime.pipeline import source_downsample

    xyz, inten, t = frame[:3]
    n_raw = cfg.capacity.max_raw_points
    pts = np.zeros((n_raw, 3), np.float32)
    it = np.zeros(n_raw, np.float32)
    msk = np.zeros(n_raw, bool)
    pts[:len(xyz)], it[:len(xyz)], msk[:len(xyz)] = xyz, inten, True
    _, _, (fr,) = extract_frame(to_device(pts, dev), to_device(it, dev), to_device(msk, dev),
                                t, cfg.feature_extraction, cfg.capacity)
    _, surf_in = input_downsample(source_downsample(fr, cfg), cfg)
    deblur = bool(cfg.common.if_motion_deblur)
    s = refine_blur(surf_in.time, fr.time_min, fr.time_max, deblur)
    qs = res.transform_points_incre(torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev),
                                    torch.zeros(3, device=dev), surf_in.xyz, s,
                                    state.q_w, state.t_w, deblur).contiguous()
    return qs, surf_in.mask.sum(dtype=torch.int32)


def velodyne_config(C, capacity=None):
    """VLP-16 sweeps through the Velodyne front end: registration from
    the second sweep, motion deblur off (a synthetic sweep is taken from
    one pose)."""
    cfg = C.SlamConfig().replace(common={"lidar_type": "velodyne", "if_motion_deblur": 0},
                                 feature_extraction={"scan_line": 16},
                                 mapping={"init_accumulate_frames": 1})
    return cfg.replace(capacity=capacity) if capacity else cfg


def velodyne_sweeps(n):
    """``n`` VLP-16 sweeps along a known trajectory (3 cm and 2 cm a sweep
    along x and y): host frames for `feed`, and the true positions."""
    truth = np.array([[0.03 * i, 0.02 * i, 0.0] for i in range(n)])
    frames = []
    for i, o in enumerate(truth):
        pts = vlp16_sweep(origin=o)
        frames.append((pts, np.zeros(len(pts), np.float32), 0.1 * i))
    return frames, truth


def run_velodyne(cfg, frames, truth, device, plain=False):
    """(pipeline, aligned ATE, accepted rows) of the sweeps (`run_feed`)."""
    from loam_livox_tpu_torch.eval.ate import ate_rmse

    pipe = run_feed(cfg, frames, device, plain=plain)
    est = pipe.trajectory.positions_array()
    if not np.all(np.isfinite(est)) or est.shape != truth.shape:
        raise AssertionError(f"bad Velodyne trajectory {est.shape}")
    return pipe, ate_rmse(est, truth), int(sum(pipe.trajectory.accepted))


def path_line(label, pipe, n_frames, wall, ate, accepted, launches, syncs, kernel=True,
              heads=0, **extra):
    """Emit a ``path`` line; fail unless the kernel launched twice per
    ICP loop pass (with ``kernel`` false, the ``grid`` and ``dense``
    engines: never, over a run that made loop passes), or, on the frame
    program, unless `graph_row` holds (``heads``: a multi-head row's head
    count).  Returns the kernel's launches (on the frame program, its
    runs counted on the card)."""
    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.runtime import pipeline as P

    on_graphs = pipe.program is not None and bool(pipe.program.summary())
    if on_graphs:
        extra.update(graph_row(label, pipe, n_frames, kf, syncs, P.graph_counts(), wall,
                               heads=heads),
                     state_read_held=getattr(pipe, "state_read_held", None))
        launches = extra["kernel_runs"]["knn_fused"]
    rows = len(pipe.trajectory.times)
    emit("path", path=label, frames=n_frames, rows=rows, fps=n_frames / wall,
         registrations_per_s=rows / wall, wall_s=wall, ate_aligned=ate, accepted=accepted,
         icp_iterations=sum(pipe.iterations), loop_iterations=pipe.loop_iterations,
         knn_fused_launches=launches,
         host_syncs_per_frame=sum(syncs.values()) / n_frames,
         host_syncs={k: v / n_frames for k, v in syncs.items()},
         map_corner_fill=int(pipe.state.map_corners.mask.sum()),
         map_surface_fill=int(pipe.state.map_surface.mask.sum()),
         map_surface_capacity=pipe.state.map_surface.capacity,
         schedule=schedule_info(pipe), **extra)
    if on_graphs:
        return launches
    expected = 2 * pipe.loop_iterations if kernel else 0
    if launches != expected or pipe.loop_iterations <= 0:
        raise AssertionError(f"{label}: knn_fused launched {launches} times for "
                             f"{pipe.loop_iterations} ICP loop passes")
    return launches


def path_row(label, pipe, n_path, wall, ate, acc, kf, P, **extra) -> int:
    """Emit a bench.py row's ``path`` line (a row on the frame program
    with `graph_row`'s fields); fail unless its ICP passes are the rows'
    iterations on the sequential paths, ``knn_fused`` ran twice a pass
    (a raced group's batched loop once, plus its fallen-back frames'),
    and ATE and accepted rows meet the golden.  Returns the kernel's
    launches (runs on the frame program)."""
    launches = kf.launches
    syncs = P.host_syncs()
    rows = len(pipe.trajectory.times)
    fallback_iters = pipe.loop_iterations - pipe.raced_loop_iterations
    graph = ({} if pipe.program is None else
             graph_row(label, pipe, n_path, kf, syncs, P.graph_counts(), wall))
    if graph:
        launches = graph["kernel_runs"]["knn_fused"]
    emit("path", path=label, frames=n_path, rows=rows, fps=n_path / wall,
         registrations_per_s=rows / wall, wall_s=wall, ate_aligned=ate,
         accepted=acc, icp_iterations=sum(pipe.iterations),
         loop_iterations=pipe.loop_iterations, knn_fused_launches=launches,
         raced_groups=pipe.raced_groups, fallback_groups=pipe.fallback_groups,
         raced_loop_iterations=pipe.raced_loop_iterations,
         fallback_iterations=fallback_iters,
         host_syncs_per_frame=sum(syncs.values()) / n_path,
         host_syncs={k: v / n_path for k, v in syncs.items()},
         map_surface_fill=int(pipe.state.map_surface.mask.sum()),
         map_surface_capacity=pipe.state.map_surface.capacity,
         schedule=schedule_info(pipe), state_read_held=pipe.state_read_held,
         **graph, **extra)
    # each ICP pass searches corners and surfaces once: a piece's
    # iterations on the sequential paths, the batched loop of a raced
    # group plus the iterations of fallen-back frames on racing
    if pipe.raced_groups == 0 and pipe.loop_iterations != sum(pipe.iterations):
        raise AssertionError(f"{label}: loop passes differ from the rows' iterations")
    if launches != 2 * pipe.loop_iterations or launches <= 0:
        raise AssertionError(f"{label}: knn_fused launched {launches} times for "
                             f"{pipe.loop_iterations} ICP loop passes")
    if not (ate < 0.35 and acc >= rows // 2):
        raise AssertionError(f"{label} path off: ATE {ate}, accepted {acc}/{rows}")
    return launches


def shard_input(q, ref, mask, n_q, radius):
    """The kernel at a shard's input: the buffer split evenly into the
    fewest ranks (a power of two) whose second shard holds the tail of
    the valid prefix, and that shard (a nonzero base) against the plain
    version; then every shard searched on its own, the indices moved by
    their bases and merged by (distance, index) as
    `parallel.sharded.knn_sharded` merges the ranks' candidates, against
    the whole buffer's search, bit for bit."""
    import torch

    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.ops.knn import finish
    from loam_livox_tpu_torch.parallel.sharded import merge_candidates

    m, fill = ref.shape[0], int(mask.sum())
    world = 2
    while m // world >= fill:
        world *= 2
    rows = m // world
    out = compare_kernel(q, ref[rows:2 * rows], mask[rows:2 * rows], n_q, radius, reps=50)
    ds, idx = [], []
    for r in range(world):
        d, i = kf.knn_fused(q, ref[r * rows:(r + 1) * rows], mask[r * rows:(r + 1) * rows],
                            k=5, query_count=n_q, max_radius=radius)
        ds.append(d)
        idx.append(i + r * rows)
    d, i = merge_candidates(torch.cat(ds, -1), torch.cat(idx, -1), 5)
    d, i = finish(d, i.to(torch.int64), None)
    d0, i0 = kf.knn_fused(q, ref, mask, k=5, query_count=n_q, max_radius=radius)
    merged_equal = bool(torch.equal(d, d0) and torch.equal(i, i0))
    out.update(world=world, shard=1, base=rows, shard_rows=rows,
               shard_valid=int(mask[rows:2 * rows].sum()), merged_equal_unsharded=merged_equal)
    if not merged_equal:
        raise AssertionError("the merged shards' search departs from the whole buffer's")
    return out


def tier_input(cfg, frames, dev) -> dict:
    """The kernel on the main path's first tier: a scheduled pipeline fed
    frame by frame until the frame after which it grows; the buffer it
    held before that frame (capacities at 1/``schedule_start_scale``) and
    that frame's surface queries at the pose it held, against the plain
    version."""
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg, device=dev)
    start = pipe.scheduler.scale
    for frame in frames:
        st, cfg_t = clone_state(pipe.state), pipe.cfg_active
        feed(pipe, [frame])
        if pipe.scheduler.scale != start:
            break
    qs, n_qs = surface_queries(st, frame, cfg_t, dev)
    out = compare_kernel(qs, st.map_surface.xyz, st.map_surface.mask, n_qs, 50.0 ** 0.5,
                         reps=50)
    out.update(scale=start, frames_before_growth=pipe.ladder[0][0] if pipe.ladder else None,
               corner_capacity=st.map_corners.capacity, surface_capacity=st.map_surface.capacity)
    return out


def engine_path(label, cfg, sim, frames, n, dev, kf, P):
    """The main path's configuration with another correspondence engine,
    on the frame program: a warm-up over the first 12 frames, then ``n``
    frames counted, then the same ``n`` frames through the plain program
    on the card (``{label}_plain``), bit-equal: rows, iterations, passes
    and every state tensor, the bucket grids under ``grid`` included.
    The ``grid`` and ``dense`` engines never run ``knn_fused``.  Returns
    the graph row's and the plain row's ``knn_fused`` launches."""
    import torch

    run_stream(cfg, sim, frames[:12], dev)
    out = []
    for plain in (False, True):
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe, ate, accepted = run_stream(cfg, sim, frames[:n], dev, plain=plain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = pipe.state
        extra = {}
        if st.grid_surface is not None:
            extra = dict(grid_surface_buckets=int((st.grid_surface.keys != 2 ** 31 - 1).sum()),
                         grid_surface_slots=int(st.grid_surface.slot_mask.sum()))
        if plain:
            held = assert_runs_equal(label, graph_pipe, pipe)
            extra.update({f"{k}_to_{label}": v for k, v in held.items()})
        else:
            graph_pipe = pipe
        out.append(path_line(f"{label}_plain" if plain else label, pipe, n, wall, ate,
                             accepted, kf.launches, P.host_syncs(), kernel=False,
                             correspondence=cfg.optimization.correspondence, **extra))
        if not (ate < 0.35 and accepted >= n // 2):
            raise AssertionError(f"{label} path off: ATE {ate}, accepted {accepted}/{n}")
    return out


def product_phase(cfg, sim, frames, n, dev, kf, P, main_rows, store_dir) -> tuple:
    """Product mode on one card: an NCCL group of one rank (a communicator
    takes a card once), the main path's frames through `OdometryPipeline`
    with the mesh, on the frame program (``product``: one graph launch a
    frame, the rank's slices gathered into the whole static state, the
    steps with the sharded kNN inside the WHILE bodies, this rank's rows
    copied back; `graph_row` holds), held bit for bit to the plain
    single-device run's rows (``main_rows``: times, positions,
    quaternions, accept flags), and, as ``product_plain``, the same
    frames through the plain product program (the state kept as the
    rank's slices and gathered for each step), rows, iterations, passes
    and every state tensor bit-equal to the graph's.  Then, with the
    group up, the candidates' exchange (`ops.peer_gather`) against its
    plain version (an all-gather and the merge) at the main path's
    surface queries, one lane and 9.  Returns both rows' ``knn_fused``
    launches by label and the exchange's records by lanes."""
    import torch
    import torch.distributed as dist

    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.parallel.mesh import make_mesh, set_active_mesh

    os.makedirs(store_dir, exist_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(store_dir, "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        out, graph_pipe = {}, None
        for plain in (False, True):
            label = "product_plain" if plain else "product"
            # made before the counts are reset: the rank's device is named
            # cuda:0, so the frame program warms its kernels up again
            pipe = P.OdometryPipeline(cfg, device=dev, mesh=mesh)
            if plain:
                pipe.program = None
            torch.cuda.synchronize()
            reset_counts(kf, P)
            t0 = time.perf_counter()
            feed(pipe, frames[:n])
            pipe.flush()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tr = pipe.trajectory
            rows = {"times": np.asarray(tr.times), "positions": tr.positions_array(),
                    "quaternions": np.asarray(tr.quaternions),
                    "accepted": np.asarray(tr.accepted)}
            equal = {k: bool(np.array_equal(rows[k], main_rows[k])) for k in rows}
            extra = {}
            if plain:
                held = assert_runs_equal("product", graph_pipe, pipe)
                extra = {f"{k}_to_product": v for k, v in held.items()}
            else:
                graph_pipe = pipe
            gt = np.stack([sim.gt_pose_at(t)[1] for t in tr.times])
            out[label] = path_line(
                label, pipe, n, wall, ate_rmse(rows["positions"], gt),
                int(rows["accepted"].sum()), kf.launches, P.host_syncs(),
                mesh_backend=mesh.backend, mesh_size=mesh.size,
                rows_equal_main_fixed=equal, sliced_fields=sum(a is not None for a in pipe._axes),
                **extra)
            if not all(equal.values()):
                raise AssertionError(f"{label} departs from the plain single-device run: {equal}")
        from loam_livox_tpu_torch.ops import peer_gather as PG

        rng_p = np.random.default_rng(7)
        n_q, k = cfg.capacity.max_surface_ds, 5
        r_peer = {}
        for lanes in (1, 9):
            d = torch.from_numpy(rng_p.uniform(0, 50, (lanes, n_q, k)).astype(np.float32)).to(dev)
            i = torch.from_numpy(rng_p.integers(0, 65536, (lanes, n_q, k)).astype(np.int32)).to(dev)
            rows = lanes * n_q
            r_peer[lanes] = compare_small_kernel(
                "peer_gather", lambda d, i: PG.peer_gather(d, i, mesh, k),
                lambda d, i: PG.peer_gather_plain(d, i, mesh, k), (d, i),
                bytes_=2 * rows * k * 8, ops=rows * mesh.size * k * k)
            emit("kernel", kernel="peer_gather", search=f"{lanes} lane(s) of {n_q} queries x "
                 f"{k}, {mesh.size} rank", **r_peer[lanes])
        # the sharded search and normal-equation sum at one rank against
        # the plain ones (eval/scaling.py): the product mode's overhead
        from loam_livox_tpu_torch.eval.scaling import measure_scaling

        emit("scaling", **measure_scaling(mesh, device=dev, reps=20))
        return out, r_peer
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()


def subsampled_rows(label, cfg, sim, frames, n, dev, kf, P) -> dict:
    """Residual subsampling on the frame program: the frames through a new
    pipeline (``label``, `path_row`'s checks and `graph_row`'s: the keep
    mask once an ICP pass, no ICP-exit read, one graph launch a unit),
    then through the plain program on the card (``{label}_plain``), rows,
    iterations, passes and every state tensor, the threefry key
    included, bit-equal.  Returns both rows' ``knn_fused`` launches."""
    import torch

    out, graph_pipe = {}, None
    for plain in (False, True):
        name = f"{label}_plain" if plain else label
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe, ate, acc = run_stream(cfg, sim, frames[:n], dev, plain=plain)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        extra = {"subsample_residuals": int(cfg.optimization.subsample_residuals)}
        if plain:
            held = assert_runs_equal(label, graph_pipe, pipe)
            extra.update({f"{k}_to_{label}": v for k, v in held.items()})
        else:
            graph_pipe = pipe
        out[name] = path_row(name, pipe, n, wall, ate, acc, kf, P, **extra)
    return out


ARTIFACT = os.path.join(HERE, "scripts", "loop_unscaled_state.npz")


def artifact_config(C):
    """The configuration of the run that made ``scripts/loop_unscaled_state.npz``
    (``make_cfg`` of ``scripts/loop_unscaled.py``), with the service inline."""
    return C.SlamConfig().replace(
        common={"if_motion_deblur": 0, "piecewise_number": 1},
        mapping={"init_accumulate_frames": 10},
        loop_closure={"if_enable_loop_closure": 1, "minimum_keyframe_differen": 20,
                      "if_loop_service_async": 0},
        capacity={"cell_capacity": 16384})


def replay_artifact(C, device, dump_dir=None):
    """The artifact's 20 keyframes one at a time through a fresh
    `LoopCloser`'s gate scan on ``device``, writing its alignment pairs
    and the loop's files to ``dump_dir``; returns the service."""
    from loam_livox_tpu_torch.core import accounting
    from loam_livox_tpu_torch.interop import loop_state_from_npz
    from loam_livox_tpu_torch.runtime.loop_service import LoopCloser

    saved = loop_state_from_npz(ARTIFACT, device)
    cfg = artifact_config(C).replace(loop_closure={"map_alignment_if_dump_matching_result": 1})
    closer = LoopCloser(cfg, device=device, dump_dir=dump_dir)
    with accounting.charged_to(closer.counts):
        for rec in saved.keyframes:
            closer.keyframes.append(rec)
            if not closer.closed:
                closer._scan_for_loop()
    return closer


def artifact_payoff(closer) -> dict:
    """`payoff_verdict` of a replayed solve against the keyframes' true
    positions recorded beside the artifact (``loop_unscaled_out.json``),
    as tests/test_torch_loop_replay.py judges it on the CPU."""
    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.eval.loop_payoff import payoff_verdict

    with open(os.path.join(HERE, "scripts", "loop_unscaled_out.json")) as f:
        out = json.load(f)
    gt = np.asarray(out["kf_gt_positions"], np.float64)
    kt = np.stack([k.t.cpu().numpy() for k in closer.keyframes])
    n = min(len(gt), len(kt))
    payoff = dict(out["payoff"], ate_kf_raw_before_loop=ate_rmse(kt[:n], gt[:n], align=False),
                  ate_kf_raw_after_loop=ate_rmse(closer.result.t_opt[:n], gt[:n], align=False))
    return dict(payoff_verdict(payoff), **payoff)


def alignment_kernel(dev):
    """The kernel at the scene alignment's finest-scale plane search of
    the artifact's closing pair: keyframe 0's plane snapshot (the
    historical side, the queries) and keyframe 19's (the current side,
    the rows), each voxel-filtered at 0.1 m into 8,192 slots, within
    √50 m."""
    from loam_livox_tpu_torch.core.types import PointBatch
    from loam_livox_tpu_torch.interop import loop_state_from_npz
    from loam_livox_tpu_torch.ops.voxel import voxel_downsample

    import torch

    saved = loop_state_from_npz(ARTIFACT, "cpu")

    def filtered(xyz):
        pts = torch.from_numpy(xyz).to(dev)
        return voxel_downsample(PointBatch(pts, torch.zeros(len(xyz), device=dev),
                                           torch.ones(len(xyz), dtype=torch.bool, device=dev)),
                                0.1, capacity=8192)

    q, ref = filtered(saved.keyframes[0].snap_plane), filtered(saved.keyframes[19].snap_plane)
    return compare_kernel(q.xyz, ref.xyz, ref.mask, q.mask.sum(dtype=torch.int32),
                          50.0 ** 0.5, reps=20)


#: the loop service's stages as `time_loop_worker` times them: the name
#: each is called by in runtime/loop_service.py
WORKER_STAGES = {"describe": "describe_keyframe", "snapshot": "_host_points",
                 "alignment": "align_keyframes", "pose_graph": "optimize_pose_graph"}


def time_loop_worker(LS):
    """Wrap the loop service's stages to time them on the worker (each
    wrapper synchronises the worker's stream): one row a processed
    keyframe, in ms; ``scan`` is the rest (the similarity scan and the
    gates).  Returns (rows, restore)."""
    import torch

    rows, cur = [], {}
    originals = {name: getattr(LS, name) for name in WORKER_STAGES.values()}
    process = LS.LoopCloser.process_keyframe

    def timed(label, fn):
        def run(*args, **kw):
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.current_stream().synchronize()
            cur[label] = cur.get(label, 0.0) + (time.perf_counter() - t) * 1e3
            return out
        return run

    def process_timed(self, rec, m):
        cur.clear()
        t = time.perf_counter()
        process(self, rec, m)
        torch.cuda.current_stream().synchronize()
        total = (time.perf_counter() - t) * 1e3
        parts = {k: cur.get(k, 0.0) for k in WORKER_STAGES}
        rows.append(dict(total=total, scan=total - sum(parts.values()), **parts))

    for label, name in WORKER_STAGES.items():
        setattr(LS, name, timed(label, originals[name]))
    LS.LoopCloser.process_keyframe = process_timed

    def restore():
        for name, fn in originals.items():
            setattr(LS, name, fn)
        LS.LoopCloser.process_keyframe = process

    return rows, restore


def record_rotations(KF):
    """Keep the (directions, mask) of every canonical rotation the loop
    service's descriptors solve (`loop.keyframe._alignment_rotation`).
    Returns (records, restore)."""
    records = []
    real = KF._alignment_rotation

    def keep(vecs, mask):
        records.append((vecs, mask))
        return real(vecs, mask)

    KF._alignment_rotation = keep

    def restore():
        KF._alignment_rotation = real

    return records, restore


def eigh_on_card(KF, records) -> dict:
    """The card's eigh (cuSOLVER) against the host's (LAPACK, the port's
    choice) on the run's own moment matrices: how often each of the two
    leading eigenvectors comes out with the other sign, and the
    similarity of the plane image drawn with the card's rotation to the
    one drawn with the host's (1 where the signs agree; a mirror lowers
    it)."""
    import torch

    flips0 = flips1 = differ = 0
    sims = []
    for vecs, mask in records:
        m = torch.einsum("n,ni,nj->ij", mask.to(torch.float32), vecs, vecs)
        vh = torch.linalg.eigh(m.cpu())[1].flip(-1)
        vc = torch.linalg.eigh(m)[1].flip(-1).cpu()
        flips0 += int(float(vh[:, 0] @ vc[:, 0]) < 0)
        flips1 += int(float(vh[:, 1] @ vc[:, 1]) < 0)

        def rot(v):
            return torch.stack([v[:, 0], v[:, 1], torch.linalg.cross(v[:, 0], v[:, 1])],
                               dim=1).to(vecs.device)

        img_h = KF._hist_image(vecs, mask, rot(vh))[0]
        img_c = KF._hist_image(vecs, mask, rot(vc))[0]
        differ += int(not torch.equal(img_h, img_c))
        sims.append(float(KF.max_similarity(img_c, img_h)))
    return {"rotations": len(records), "e0_sign_differs": flips0, "e1_sign_differs": flips1,
            "plane_images_differ": differ,
            "min_similarity_card_vs_host_rotation": min(sims) if sims else None}


def record_loop_entries(LS):
    """Wrap `LoopCloser.on_frame` to keep every entry a service is handed,
    by service: (frame index, the keys of its touched cells, ``EMPTY_KEY``
    elsewhere, and the keyframe record it completed or None).  The records
    are the service's own, read at the end: a record the next units
    overwrote would show.  Returns (entries, restore)."""
    import torch

    from loam_livox_tpu_torch.map.cell_map import EMPTY_KEY

    entries, real = {}, LS.LoopCloser.on_frame

    def on_frame(self, cell_full, touched, q_w, t_w, frame_idx):
        keys = torch.where(touched, cell_full.keys, torch.full_like(cell_full.keys, EMPTY_KEY))
        rec = real(self, cell_full, touched, q_w, t_w, frame_idx)
        entries.setdefault(id(self), []).append((frame_idx, keys, rec))
        return rec

    LS.LoopCloser.on_frame = on_frame

    def restore():
        LS.LoopCloser.on_frame = real

    return entries, restore


def assert_loop_entries_equal(label, entries, ref) -> dict:
    """Fail unless the loop service's entries ``entries`` (cut to the
    frames of ``ref``, a plain-program run's) equal ``ref``'s: frame
    indices, touched keys, and each completed keyframe's member keys,
    pose and ending frame, bit for bit."""
    import torch

    n = ref[-1][0] + 1 if ref else 0
    got = [e for e in entries if e[0] < n]
    keyframes = 0
    equal = len(got) == len(ref)
    for (fa, ka, ra), (fb, kb, rb) in zip(got, ref):
        equal = equal and fa == fb and torch.equal(ka, kb) and (ra is None) == (rb is None)
        if equal and ra is not None:
            keyframes += 1
            equal = (ra.ending_frame_idx == rb.ending_frame_idx
                     and all(torch.equal(getattr(ra, f), getattr(rb, f))
                             for f in ("keys", "q", "t")))
    if not equal or not keyframes:
        raise AssertionError(f"{label}: the loop service's entries depart from the plain "
                             f"program's ({len(got)} against {len(ref)} entries, "
                             f"{keyframes} keyframes equal)")
    return {"loop_entries_equal": equal, "loop_entries": len(ref), "keyframes_equal": keyframes}


def loop_path(S, P, kf, dev, host_frames, split=40) -> tuple:
    """The ``loop_closure`` scenario at its own configuration, nothing cut:
    170 frames of 10,000 points in the 56 m rich world, the service on
    its worker thread and stream; on the frame program (one graph launch
    a frame, `graph_row`).  Each frame's time ends with the frame
    stream's synchronisation.  After ``split`` frames a copy of the state
    is kept (``pipe.split_state``, its seconds left out of the wall
    time).  Returns (the path line's fields, the pipeline, the service's
    entries (`record_loop_entries`))."""
    import torch

    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.eval.loop_payoff import payoff_verdict, score_loop_payoff
    from loam_livox_tpu_torch.loop import keyframe as KF
    from loam_livox_tpu_torch.runtime import loop_service as LS

    cfg, kw = S.scenario_config("loop_closure")
    n = kw["frames"]
    sim = S.simulators(cfg, kw)[0]
    frames = on_device(host_frames, cfg.capacity.max_raw_points, dev)
    worker_rows, restore = time_loop_worker(LS)
    rotations, restore_kf = record_rotations(KF)
    entries, restore_entries = record_loop_entries(LS)
    try:
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe = P.OdometryPipeline(cfg, device=dev)
        closer = pipe.loop_closer
        frame_ms, busy = [], []
        split_s = 0.0
        for i, frame in enumerate(frames):
            # busy: the worker was processing a keyframe at the frame's
            # start or end, or finished one in between
            was_busy, done = closer.busy, len(closer.keyframes)
            t = time.perf_counter()
            feed(pipe, [frame])
            torch.cuda.current_stream(dev).synchronize()
            frame_ms.append((time.perf_counter() - t) * 1e3)
            busy.append(was_busy or closer.busy or len(closer.keyframes) != done)
            if i + 1 == split:
                t = time.perf_counter()
                pipe.split_state = clone_state(pipe.state)
                split_s = time.perf_counter() - t
        pipe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - split_s
    finally:
        restore()
        restore_kf()
        restore_entries()
    launches, syncs = kf.launches, P.host_syncs()
    graph = {}
    if pipe.program is not None:
        graph = graph_row("loop_closure", pipe, n, kf, syncs, P.graph_counts(), wall,
                          service_runs=closer.counts["knn_fused"],
                          service_filters=closer.counts["voxel_centroid"])
        launches = graph["kernel_runs"]["knn_fused"] - closer.counts["knn_fused"]
    closer.shutdown()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    if not np.all(np.isfinite(est)) or est.shape != (n, 3):
        raise AssertionError(f"bad loop_closure trajectory {est.shape}")
    payoff = score_loop_payoff(closer, pipe.trajectory.times, sim.gt_pose_at)
    ms, busy = np.asarray(frame_ms), np.asarray(busy)

    def pct(sel):
        x = ms[sel]
        return ({"n": int(sel.sum()), "p50": float(np.percentile(x, 50)),
                 "p99": float(np.percentile(x, 99)), "max": float(x.max())} if len(x) else None)

    res = closer.result
    parts = ("describe", "snapshot", "scan", "alignment", "pose_graph", "total")
    out = dict(
        frames=n, rows=len(est), fps=n / wall, wall_s=wall, ate_aligned=ate_rmse(est, gt),
        ate_raw=ate_rmse(est, gt, align=False), accepted=int(sum(pipe.trajectory.accepted)),
        loop_closed=closer.closed, his=res.his_idx if res else None,
        cur=res.cur_idx if res else None, icp_score=res.icp_score if res else None,
        keyframes=len(closer.keyframes), dropped_keyframes=closer.dropped_keyframes,
        payoff=payoff, payoff_verdict=payoff_verdict(payoff) if payoff else None,
        worker_ms_per_keyframe=worker_rows,
        worker_ms_mean=({k: float(np.mean([r[k] for r in worker_rows])) for k in parts}
                        if worker_rows else None),
        icp_iterations=sum(pipe.iterations), loop_iterations=pipe.loop_iterations,
        knn_fused_launches=launches, loop_knn_fused_launches=closer.counts["knn_fused"],
        loop_service_counts=dict(closer.counts),
        host_syncs_per_frame=sum(syncs.values()) / n,
        host_syncs={k: v / n for k, v in syncs.items()},
        frame_ms_all=pct(np.ones(n, bool)), frame_ms_worker_busy=pct(busy),
        frame_ms_worker_idle=pct(~busy), eigh_card_vs_host=eigh_on_card(KF, rotations),
        gate_trace=closer.gate_trace, **graph)
    if launches != 2 * pipe.loop_iterations or launches <= 0:
        raise AssertionError(f"loop_closure: knn_fused launched {launches} times for "
                             f"{pipe.loop_iterations} ICP loop passes")
    return out, pipe, entries.get(id(closer), [])


def loop_plain(S, P, kf, dev, host_frames, n, graph_pipe, graph_entries) -> None:
    """``loop_closure_plain``: the first ``n`` frames of the
    ``loop_closure`` path through the plain program on the card (the
    service on its worker, as there), held bit-equal to the frame
    program's run (`assert_runs_equal` with its ``split_state``) and its
    loop service's entries (`assert_loop_entries_equal`)."""
    import torch

    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.runtime import loop_service as LS

    cfg, kw = S.scenario_config("loop_closure")
    sim = S.simulators(cfg, kw)[0]
    frames = on_device(host_frames[:n], cfg.capacity.max_raw_points, dev)
    entries, restore = record_loop_entries(LS)
    try:
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe = P.OdometryPipeline(cfg, device=dev)
        pipe.program = None
        feed(pipe, frames)
        pipe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        restore()
    pipe.loop_closer.shutdown()
    held = assert_runs_equal("loop_closure", graph_pipe, pipe, n)
    held.update(assert_loop_entries_equal("loop_closure", graph_entries,
                                          entries.get(id(pipe.loop_closer), [])))
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    path_line("loop_closure_plain", pipe, n, wall, ate_rmse(est, gt),
              int(sum(pipe.trajectory.accepted)), kf.launches, P.host_syncs(),
              keyframes=len(pipe.loop_closer.keyframes),
              dropped_keyframes=pipe.loop_closer.dropped_keyframes,
              **{f"{k}_to_loop_closure": v for k, v in held.items()})


def loop_fps_in_turns(host_frames, dev, card, rounds=2) -> dict:
    """With ``--baseline``: the ``loop_closure`` path's frames/s and frame
    times with the worker busy and idle (p50 / p99), the earlier
    checkout's package (loaded by `load_baseline`) against this one's, in
    turns on this card: (baseline, this, this, baseline) ``rounds``
    times, after an untimed 20-frame run of each (library loads,
    allocator growth).  Each package runs the scenario at its own
    configuration on the same frames, padded on the card beforehand;
    each frame's time ends with the frame stream's synchronisation, and
    each run's with one after its flush."""
    import importlib

    import torch

    def run(pkg, frames):
        S = importlib.import_module(f"{pkg}.eval.scenarios")
        Pk = importlib.import_module(f"{pkg}.runtime.pipeline")
        cfg, _ = S.scenario_config("loop_closure")
        Pk.reset_host_syncs()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipe = Pk.OdometryPipeline(cfg, device=dev)
        closer = pipe.loop_closer
        frame_ms, busy = [], []
        for frame in frames:
            # each frame timed to the frame stream's synchronisation, the
            # worker busy as `loop_path` counts it
            was_busy, done = closer.busy, len(closer.keyframes)
            t_f = time.perf_counter()
            feed(pipe, [frame])
            torch.cuda.current_stream(dev).synchronize()
            frame_ms.append((time.perf_counter() - t_f) * 1e3)
            busy.append(was_busy or closer.busy or len(closer.keyframes) != done)
        pipe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        ms, busy = np.asarray(frame_ms), np.asarray(busy)

        def pct(sel):
            return ({"n": int(sel.sum()), "p50": float(np.percentile(ms[sel], 50)),
                     "p99": float(np.percentile(ms[sel], 99))} if sel.any() else None)

        row = {"package": pkg, "fps": len(frames) / wall, "wall_s": wall,
               "accepted": int(sum(pipe.trajectory.accepted)), "loop_closed": closer.closed,
               "iterations": int(sum(pipe.iterations)),
               "frame_ms_worker_busy": pct(busy), "frame_ms_worker_idle": pct(~busy),
               "dropped_keyframes": closer.dropped_keyframes,
               "graph_launches": Pk.graph_counts().get("graph_launch"),
               "host_syncs": Pk.host_syncs(),
               "feature_cell_maps": pipe.state.cell_planes is not None}
        closer.shutdown()
        return row

    cfg, _ = importlib.import_module("loam_livox_tpu_torch.eval.scenarios").scenario_config(
        "loop_closure")
    frames = on_device(host_frames, cfg.capacity.max_raw_points, dev)
    this, base = "loam_livox_tpu_torch", "baseline_port"
    for pkg in (base, this):
        run(pkg, frames[:20])
    rows = [run(pkg, frames) for _ in range(rounds) for pkg in (base, this, this, base)]
    fps = {k: [r["fps"] for r in rows if r["package"] == k] for k in (base, this)}
    return {"frames": len(frames), "runs": rows,
            "fps_mean": {k: float(np.mean(v)) for k, v in fps.items()},
            "fps_spread": {k: float(np.ptp(v)) for k, v in fps.items()}, "card": card}


def write_bag(path, n_frames, init):
    """``n_frames`` simulator frames (seed 0, 10,000 points) as a Livox
    CustomMsg bag in bz2 chunks (reflectivity 0-255, as a driver writes
    it); returns the simulator for its ground truth."""
    from loam_livox_tpu_torch.io.rosbag import BagWriter, encode_livox_custommsg

    sim, frames = simulate(n_frames, 10000, init)
    with BagWriter(path, compression="bz2") as w:
        for xyz, inten, t0 in frames:
            w.write("/livox/lidar", "livox_ros_driver/CustomMsg", t0,
                    encode_livox_custommsg(t0, xyz, np.clip(inten * 255.0, 0, 255)))
    return sim, frames


def cli_phase(C, P, kf, dev, out_dir, card) -> int:
    """The command line as a user runs it, in a child process on the card:
    a 24-frame bag through the default (precision) profile with loop
    closure on (so the state keeps the plane cell map that ``--save-map``
    writes) and ``--follow``, a pose file, a map and logs.  Returns the kernel's
    launches in the child, which counts from 0 and prints them in its
    summary."""
    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.io.serialization import load_cell_map_json, load_poses_txt

    n, init = 24, 10
    d = os.path.join(out_dir, "cli")
    os.makedirs(d, exist_ok=True)
    bag = os.path.join(d, "sim.bag")
    sim, frames = write_bag(bag, n, init)
    poses, mapf, logs = (os.path.join(d, x) for x in ("poses.txt", "map.json", "logs"))
    cmd = [sys.executable, "-m", "loam_livox_tpu_torch.cli.run_odometry",
           "--source", f"bag:{bag}", "--frames", str(n), "--save-poses", poses,
           "--save-map", mapf, "--log-dir", logs, "--follow", "--quiet", "--loop-closure",
           "--set", f"mapping/init_accumulate_frames={init}"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the command line failed:\n{proc.stderr[-3000:]}")
    out = [json.loads(x) for x in proc.stdout.splitlines() if x.startswith("{")]
    summary, follow = out[-1], out[:-1]
    est, q = load_poses_txt(poses)
    # a row's time: its frame's start plus its piece's share of the 0.1 s
    # frame (the pose file carries no stamps; pieces split the frame by index)
    per = len(est) // n
    times = [frames[i // per][2] + 0.1 * (i % per) / per for i in range(len(est))]
    gt = np.stack([sim.gt_pose_at(t)[1] for t in times])
    ate = ate_rmse(est, gt)
    with open(os.path.join(logs, "mapping.log")) as f:
        mapping_lines = len(f.read().splitlines())
    cells = load_cell_map_json(mapf, device=dev)
    follow_ok = (len(follow) == len(est)
                 and np.allclose([f["t"] for f in follow], est, rtol=0, atol=1e-6)
                 and np.allclose([f["q"] for f in follow], q, rtol=0, atol=1e-6))
    syncs, graphs = summary["host_syncs"], summary["graphs"]
    passes, service = summary["icp_loop_passes"], summary["loop_knn_fused_launches"]
    # on the frame program: one graph launch a raw frame, the kernel's runs
    # counted on the card (2 a pass, plus the loop service's launches)
    runs = summary["knn_fused_runs"]
    launches = runs - service
    emit("path", path="cli", command=" ".join(cmd[1:]), frames=summary["frames"],
         rows=summary["steps"], fps=summary["fps"],
         registrations_per_s=summary["steps"] / summary["wall_s"], wall_s=summary["wall_s"],
         process_wall_s=wall, ate_aligned=ate, accepted=summary["accepted"],
         host_syncs_per_frame=sum(syncs.values()) / n,
         host_syncs={k: v / n for k, v in syncs.items()}, follow_lines=len(follow),
         follow_equal_pose_file=follow_ok, mapping_lines=mapping_lines,
         map_cells=int(cells.n_cells()), device=summary["device"], knn_fused_launches=launches,
         knn_fused_runs=runs, knn_fused_launches_from_python=summary["knn_fused_launches"],
         loop_knn_fused_launches=service, loop_closed=summary["loop_closed"],
         loop_iterations=passes, graphs=graphs, card=card)
    if not (summary["frames"] == n and follow_ok and ate < 0.35 and launches == 2 * passes > 0
            and summary["knn_fused_launches"] == 0 and graphs["graph_launch"] == n
            and graphs["launch_frame"] == n and graphs["graph_capture"] >= 1
            and syncs["icp_exit"] == syncs["admit"] == 0
            and summary["accepted"] >= summary["steps"] // 2 and mapping_lines == n
            and int(cells.n_cells()) > 0
            and summary["device"].startswith("cuda") and syncs["drain"] == n
            and syncs["log"] == n):
        raise AssertionError(f"the command line's run is off: ATE {ate}, {summary}, "
                             f"follow {follow_ok}, mapping lines {mapping_lines}, "
                             f"map cells {int(cells.n_cells())}")
    return launches


def state_tensors(state) -> dict:
    """Every field of an odometry state by dotted name (tensors, the
    threefry key among them, and numbers)."""
    out = {}
    for name in state._fields:
        v = getattr(state, name)
        if hasattr(v, "_fields"):
            out.update({f"{name}.{f}": getattr(v, f) for f in v._fields})
        else:
            out[name] = v
    return out


def resume_phase(C, dev, out_dir, card) -> None:
    """Resume on the card (precision profile, default capacities with the
    capacity schedule on, registration after 4 frames): 12 frames
    straight, checkpointed with `save_pipeline` (which flushes, as the
    split run must) right after the schedule's last growth within the
    first 8 frames, where the straight run's countdown to its next check
    stands at 4 as a loaded pipeline's does (at frame 8 when nothing grew
    by then); against a new pipeline from `load_pipeline`, at the saved
    tier, fed the rest: every trajectory row of those frames and every
    state tensor at the end bit-equal."""
    import torch

    from loam_livox_tpu_torch.runtime.checkpoint import load_pipeline, save_pipeline
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = C.precision_profile().replace(mapping={"init_accumulate_frames": 4})
    _, frames = simulate(12, 10000, 4)
    t0 = time.perf_counter()
    whole = OdometryPipeline(cfg, device=dev)
    ckpt = os.path.join(out_dir, "resume_ckpt")
    split = None
    for i, frame in enumerate(frames[:8]):
        feed(whole, [frame])
        grew = bool(whole.ladder) and whole.ladder[-1][0] == i + 1
        if grew or (i == 7 and split is None):
            save_pipeline(whole, ckpt)
            split, split_rows = i + 1, len(whole.trajectory.times)
            split_scale, countdown = whole.scheduler.scale, whole._sched_countdown
    with open(os.path.join(ckpt, "capacity_scale.txt")) as f:
        saved_scale = int(f.read())
    feed(whole, frames[8:])
    whole.flush()
    second = load_pipeline(ckpt, cfg, device=dev)
    loaded_scale = second.scheduler.scale
    feed(second, frames[split:])
    second.flush()
    torch.cuda.synchronize()
    keys = ("times", "positions", "quaternions", "accepted")
    rows_equal = all(np.array_equal(np.asarray(getattr(second.trajectory, k)),
                                    np.asarray(getattr(whole.trajectory, k)[split_rows:]))
                     for k in keys)
    a, b = state_tensors(second.state), state_tensors(whole.state)
    differ = [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                   else a[k] == b[k])]
    rows = len(second.trajectory.times)
    emit("resume", frames=12, split_at=split, rows_after_split=rows, rows_equal=rows_equal,
         state_fields=len(a), state_fields_differing=differ, scale_at_split=split_scale,
         saved_scale=saved_scale, loaded_scale=loaded_scale, countdown_at_split=countdown,
         ladder=schedule_info(whole)["ladder"], resumed_ladder=schedule_info(second)["ladder"],
         final_scale=whole.scheduler.scale, accepted=int(sum(whole.trajectory.accepted)),
         seconds=time.perf_counter() - t0, card=card)
    if not (rows_equal and not differ and rows == 3 * (12 - split) and split_rows == 3 * split
            and saved_scale == loaded_scale == split_scale and countdown == 4):
        raise AssertionError(f"the resumed run departs from the straight one: {differ}")


def loop_files_phase(C, dev, out_dir, card_closer, card) -> None:
    """The artifact replay's dumps on the card against the CPU's (the same
    files; keyframe clouds byte-equal; the moved cloud, the loop edge and
    the optimised poses within 0.05 m and 0.01 of a quaternion, the
    tolerance of the replayed solve in tests/test_torch_loop_replay.py;
    the chain's edges within 1e-4), and the card's service through
    `save_loop_state` / `load_loop_state` with equal values."""
    import torch

    from loam_livox_tpu_torch.io.serialization import load_g2o, load_pcd, load_poses_txt
    from loam_livox_tpu_torch.runtime.checkpoint import load_loop_state, save_loop_state

    g, c = (os.path.join(out_dir, f"loop_{w}") for w in ("gpu", "cpu"))
    names = sorted(os.listdir(g))
    problems = [] if names == sorted(os.listdir(c)) else ["file lists differ"]
    pairs = sorted({x.split("_")[0] for x in names if x.endswith("_pair.json")})
    worst = {"c_pcd_m": 0.0, "chain_edge": 0.0, "loop_edge": 0.0, "poses_opm": 0.0}
    for i in pairs:
        for s in ("a", "b"):
            with open(os.path.join(g, f"{i}_{s}.pcd"), "rb") as f1, \
                    open(os.path.join(c, f"{i}_{s}.pcd"), "rb") as f2:
                if f1.read() != f2.read():
                    problems.append(f"{i}_{s}.pcd differs")
        a, b = load_pcd(os.path.join(g, f"{i}_c.pcd"))[0], load_pcd(os.path.join(c, f"{i}_c.pcd"))[0]
        worst["c_pcd_m"] = max(worst["c_pcd_m"], float(np.abs(a - b).max()))
    (tg, qg, eg), (tc, qc, ec) = (load_g2o(os.path.join(d, "loop.g2o")) for d in (g, c))
    if not (np.array_equal(tg, tc) and np.array_equal(qg, qc) and len(eg) == len(ec)):
        problems.append("loop.g2o vertices or edge counts differ")
    for k, (x, y) in enumerate(zip(eg, ec)):
        err = max(np.abs(x["t"] - y["t"]).max(), np.abs(x["q_wxyz"] - y["q_wxyz"]).max())
        key = "loop_edge" if k == len(eg) - 1 else "chain_edge"
        worst[key] = max(worst[key], float(err))
    for name in ("poses_ori.txt", "poses_opm.txt"):
        (t1, q1), (t2, q2) = (load_poses_txt(os.path.join(d, name)) for d in (g, c))
        if name == "poses_ori.txt" and not (np.array_equal(t1, t2) and np.array_equal(q1, q2)):
            problems.append("poses_ori.txt differs")
        if name == "poses_opm.txt":
            worst["poses_opm"] = float(max(np.abs(t1 - t2).max(), np.abs(q1 - q2).max()))
    if (worst["c_pcd_m"] >= 0.05 or worst["loop_edge"] >= 0.05 or worst["poses_opm"] >= 0.05
            or worst["chain_edge"] >= 1e-4):
        problems.append(f"dumps apart: {worst}")

    path = os.path.join(out_dir, "loop_state_card.npz")
    save_loop_state(card_closer, path)
    back = load_loop_state(path, artifact_config(C), device=dev)

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    def members(keys):
        k = host(keys)
        return np.unique(k[k != 2 ** 31 - 1])

    for a, b in zip(back.keyframes, card_closer.keyframes):
        same = (np.array_equal(members(a.keys), members(b.keys))
                and np.array_equal(host(a.q), host(b.q)) and np.array_equal(host(a.t), host(b.t))
                and all(np.array_equal(host(x), host(y)) for x, y in zip(a.descriptor,
                                                                         b.descriptor))
                and all(np.array_equal(getattr(a, s), getattr(b, s))
                        for s in ("snap_line", "snap_plane", "snap_full")))
        if not same:
            problems.append(f"keyframe {a.ending_frame_idx} changed through the state file")
            break
    r1, r2 = back.result, card_closer.result
    if not (len(back.keyframes) == len(card_closer.keyframes) == 20 and back.closed
            and (r1.his_idx, r1.cur_idx, r1.icp_score) == (r2.his_idx, r2.cur_idx, r2.icp_score)
            and np.array_equal(r1.t_opt, r2.t_opt)):
        problems.append("the loop state file does not round-trip")
    back.shutdown()
    emit("loop_files", pairs=len(pairs), files=names, worst=worst, problems=problems,
         card_dump_reads=card_closer.counts["dump"], card=card)
    if problems:
        raise AssertionError(f"the card's loop files: {problems}")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", metavar="DIR",
                    help="an earlier checkout of the repo: time its knn_fused, debounce and "
                    "loop condition kernels and its loop_closure path beside this one's")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        from loam_livox_tpu_torch.core import config as C
        from loam_livox_tpu_torch.ops import build
        from loam_livox_tpu_torch.ops import knn_fused as kf
        from loam_livox_tpu_torch.runtime import pipeline as P
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}", file=sys.stderr)
        return 1
    # the loop_closure and largescale_realtime streams are made on the host
    # by two child processes while the earlier phases run (170 and 60
    # frames of ray casting take minutes); leaving the block terminates
    # the children
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(2) as pool:
        return run_phases(args, C, build, kf, P, pool.apply_async(scenario_frames,
                                                                   ("loop_closure",)),
                          pool.apply_async(scenario_frames, ("largescale_realtime",)))


def scenario_frames(name):
    """A scenario's raw frames as the simulator makes them (host arrays)."""
    from loam_livox_tpu_torch.eval import scenarios as S

    cfg, kw = S.scenario_config(name)
    sim = S.simulators(cfg, kw)[0]
    return [sim.frame(i) for i in range(kw["frames"])]


def run_phases(args, C, build, kf, P, loop_sim, large_sim) -> int:
    import torch

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    card = card_line()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 2. build
    t0 = time.perf_counter()
    build.compile_all(["knn_fused", "debounce", "graph_cond", "threefry", "peer_gather",
                       "voxel_centroid"])
    t1 = time.perf_counter()
    from loam_livox_tpu_torch.io import native
    from loam_livox_tpu_torch.ops import graph_cond as GC

    native_lib = native.build()
    driver, runtime = GC.versions()
    emit("build", seconds=t1 - t0,
         sources=["knn_fused.cu", "debounce.cu", "graph_cond.cu", "threefry.cu",
                  "peer_gather.cu", "voxel_centroid.cu"],
         cuda_driver=driver, cuda_runtime=runtime,
         ptxas_k5=ptxas_report(build.build_logs.get("knn_fused", "")),
         ptxas_debounce=ptxas_report(build.build_logs.get("debounce", ""), k=None),
         ptxas_graph_cond={kernel: ptxas_report(build.build_logs.get("graph_cond", ""), k=None,
                                                name=kernel)
                           for kernel in ("loop_cond_kernel", "switch_cond_kernel")},
         ptxas_threefry={kernel: ptxas_report(build.build_logs.get("threefry", ""), k=None,
                                              name=kernel)
                         for kernel in ("threefry_split_kernel", "threefry_keep_mask_kernel")},
         ptxas_peer_gather=ptxas_report(build.build_logs.get("peer_gather", ""), k=None),
         ptxas_voxel_centroid=ptxas_report(build.build_logs.get("voxel_centroid", ""), k=None),
         launch_k5_surfaces=kf.launch_shape(5, 65536),
         native_io={"library": os.path.relpath(native_lib, HERE),
                    "seconds": time.perf_counter() - t1})
    base = load_baseline(args.baseline) if args.baseline else None
    base_knn = base.knn_fused if base else None

    # 3. each kernel against its plain version at the paths' shapes, then
    # at the scene alignment's
    worst_err = kernel_phase(dev, base_knn)
    r_align = alignment_kernel(dev)
    worst_err = max(worst_err, r_align["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="scene alignment, artifact keyframes 0 / 19",
         **r_align)

    # the loop gates over the committed unscaled artifact, on the card and
    # on the CPU: the same pair must close, the scores within 0.02
    rep, closers = {}, {}
    # the run's files (git-ignored): the loop dumps, the cli bag and logs
    dump_root = os.path.join(HERE, "loam_livox_tpu_torch", "_build", "chip_smoke")
    shutil.rmtree(dump_root, ignore_errors=True)
    for where, device in (("gpu", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        closer = closers[where] = replay_artifact(C, device, os.path.join(dump_root,
                                                                          f"loop_{where}"))
        res = closer.result
        rep[where] = dict(closed=closer.closed, his=res.his_idx if res else None,
                          cur=res.cur_idx if res else None,
                          score=res.icp_score if res else None,
                          payoff_verdict=artifact_payoff(closer) if res else None,
                          trace=closer.gate_trace, counts=dict(closer.counts),
                          seconds=time.perf_counter() - t0)
    ok = (rep["gpu"]["closed"] and rep["cpu"]["closed"]
          and (rep["gpu"]["his"], rep["gpu"]["cur"]) == (rep["cpu"]["his"], rep["cpu"]["cur"])
          == (0, 19) and abs(rep["gpu"]["score"] - rep["cpu"]["score"]) < 0.02
          and rep["gpu"]["score"] < 0.20 and rep["gpu"]["payoff_verdict"]["ok"]
          and [e["stage"] for e in rep["gpu"]["trace"]]
          == [e["stage"] for e in rep["cpu"]["trace"]])
    emit("reference", path="loop_unscaled replay", ok=ok, **rep)
    if not ok:
        raise AssertionError("the card's replay of the loop artifact departs from the CPU's")

    # 4. the port on the card against the port on the CPU, on small streams
    def small(cfg):
        return cfg.replace(
            capacity={"max_raw_points": 16384, "max_corner": 256, "max_surface": 1024,
                      "max_corner_ds": 256, "max_surface_ds": 1024,
                      "map_corner_capacity": 1024, "map_surf_capacity": 4096,
                      "hist_corner_capacity": 128, "hist_surf_capacity": 512,
                      "history_window": 16},
            mapping={"init_accumulate_frames": 6},
            optimization={"icp_maximum_iteration": 5, "full_iterations": 3})

    for label, cfg, n_small, acc_tol in (
            ("main", small(C.SlamConfig()), 16, 2),
            ("precision", small(C.precision_profile()), 12, 3),
            ("racing", small(C.realtime_racing_profile()), 12, 3)):
        sim, frames = simulate(n_small, 10000, 6)
        _, ate_gpu, acc_gpu = run_stream(cfg, sim, frames, dev)
        _, ate_cpu, acc_cpu = run_stream(cfg, sim, frames, "cpu")
        ok = abs(ate_gpu - ate_cpu) < 0.05 and abs(acc_gpu - acc_cpu) <= acc_tol
        emit("reference", path=label, frames=n_small, rows=n_small * rows_per_frame(cfg),
             ate_gpu=ate_gpu, ate_cpu=ate_cpu, accepted_gpu=acc_gpu, accepted_cpu=acc_cpu,
             ok=ok)
        if not ok:
            raise AssertionError(f"the card's {label} run departs from the CPU reference")

    # cell matching, the three-head front end and the Velodyne front end.
    # The mid100_trilidar CI variant (3 x 3,072 points) leaves its pieces
    # too weakly constrained to hold two runs together, so its reference
    # runs the scenario's own 3 x 8,192 points at CPU scale.
    from loam_livox_tpu_torch.eval import scenarios as S

    cut = {"map_corner_capacity": 1024, "map_surf_capacity": 4096}
    mid_cpu_scale = {"capacity": {**S.SMALL_CAPS, **cut, "max_raw_points": 8192},
                     "mapping": {"init_accumulate_frames": 6},
                     "optimization": {"icp_maximum_iteration": 5, "full_iterations": 3}}
    for label, kw in (("full_mapping", dict(small=True, overrides={"capacity": cut})),
                      ("mid100_trilidar", dict(frames=12, overrides=mid_cpu_scale))):
        g = S.run_scenario(label, device=dev, **kw)
        c = S.run_scenario(label, device="cpu", **kw)
        ok = (abs(g["ate_aligned"] - c["ate_aligned"]) < 0.05
              and abs(g["accepted"] - c["accepted"]) <= 3)
        emit("reference", path=label, frames=g["frames"], rows=g["rows"],
             ate_gpu=g["ate_aligned"], ate_cpu=c["ate_aligned"], accepted_gpu=g["accepted"],
             accepted_cpu=c["accepted"], ok=ok)
        if not ok:
            raise AssertionError(f"the card's {label} run departs from the CPU reference")
    vel_small = velodyne_config(C, {**S.SMALL_CAPS, **cut, "max_raw_points": 16384})
    sweeps, truth = velodyne_sweeps(8)
    _, ate_gpu, acc_gpu = run_velodyne(vel_small, sweeps, truth, dev)
    _, ate_cpu, acc_cpu = run_velodyne(vel_small, sweeps, truth, "cpu")
    ok = abs(ate_gpu - ate_cpu) < 0.05 and acc_gpu == acc_cpu
    emit("reference", path="velodyne", frames=8, rows=8, ate_gpu=ate_gpu, ate_cpu=ate_cpu,
         accepted_gpu=acc_gpu, accepted_cpu=acc_cpu, ok=ok)
    if not ok:
        raise AssertionError("the card's Velodyne run departs from the CPU reference")

    # 5. the main path: the shipped default, SlamConfig() with the
    # capacity schedule on (as bench.py:127 runs the JAX pipeline), 40
    # frames of 10,000 points
    cfg = C.SlamConfig().replace(mapping={"init_accumulate_frames": 10})
    n = 40
    sim, frames = simulate(n + 4, 10000, 10)
    sim_main, frames_main = sim, frames
    run_stream(cfg, sim, frames[:12], dev)          # warm-up: first registrations
    torch.cuda.synchronize()
    reset_counts(kf, P)
    n_fixed = 20            # main_fixed's frames, below
    t0 = time.perf_counter()
    pipe, ate, accepted = run_stream(cfg, sim, frames[:n], dev, split=n_fixed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = P.host_syncs()
    iters = sum(pipe.iterations)
    # the frame program's row: one graph launch a frame, the kernels' runs
    # counted on the card (graph_row fails otherwise)
    graph_main = graph_row("main", pipe, n, kf, syncs, P.graph_counts(), wall)
    launches = graph_main["kernel_runs"]["knn_fused"]
    emit("main", frames=n, fps=n / wall, wall_s=wall, accepted=accepted, ate_aligned=ate,
         fps_first_20=n_fixed / pipe.split_wall_s,
         icp_iterations=iters, loop_iterations=pipe.loop_iterations,
         knn_fused_launches=launches,
         host_syncs_per_frame=sum(syncs.values()) / n,
         host_syncs={k: v / n for k, v in syncs.items()}, schedule_syncs=syncs["schedule"],
         schedule=schedule_info(pipe),
         map_surface_fill=int(pipe.state.map_surface.mask.sum()),
         map_corner_fill=int(pipe.state.map_corners.mask.sum()),
         map_surface_capacity=pipe.state.map_surface.capacity,
         map_corner_capacity=pipe.state.map_corners.capacity,
         state_read_held=pipe.state_read_held, **graph_main)
    if not (ate < 0.35 and accepted >= n // 2):
        raise AssertionError(f"main path off: ATE {ate}, accepted {accepted}/{n}")
    if pipe.scheduler is None or syncs["schedule"] <= 0:
        raise AssertionError("the main path ran without its capacity schedule")
    launches_by_path = {"main": launches}

    # the same first 20 frames through the plain program on the card: the
    # frame program replays it, so rows and state must be bit-equal
    torch.cuda.synchronize()
    reset_counts(kf, P)
    t0 = time.perf_counter()
    pipe_pl, ate_pl, acc_pl = run_stream(cfg, sim, frames[:n_fixed], dev, plain=True)
    torch.cuda.synchronize()
    wall_pl = time.perf_counter() - t0
    launches_by_path["main_plain"] = kf.launches
    held = assert_runs_equal("main", pipe, pipe_pl, n_fixed)
    path_line("main_plain", pipe_pl, n_fixed, wall_pl, ate_pl, acc_pl, kf.launches,
              P.host_syncs(), **{f"{k}_to_main": v for k, v in held.items()})

    # the same frames at the configured capacities (the schedule off): the
    # fixed-capacity main row of the earlier slices, 20 frames
    cfg_fixed = cfg.replace(capacity={"auto_schedule": 0})
    torch.cuda.synchronize()
    reset_counts(kf, P)
    t0 = time.perf_counter()
    pipe_x, ate_x, acc_x = run_stream(cfg_fixed, sim, frames[:n_fixed], dev)
    torch.cuda.synchronize()
    wall_x = time.perf_counter() - t0
    launches_by_path["main_fixed"] = path_line("main_fixed", pipe_x, n_fixed, wall_x, ate_x,
                                               acc_x, kf.launches, P.host_syncs())
    if not (ate_x < 0.35 and acc_x >= n_fixed // 2 and pipe_x.scheduler is None):
        raise AssertionError(f"main_fixed off: ATE {ate_x}, accepted {acc_x}/{n_fixed}")
    tr = pipe_x.trajectory
    fixed_rows = {"times": np.asarray(tr.times), "positions": tr.positions_array(),
                  "quaternions": np.asarray(tr.quaternions), "accepted": np.asarray(tr.accepted)}

    # 6. the kernel line, timed on the buffer and queries the main path ended on
    from loam_livox_tpu_torch.core import se3
    from loam_livox_tpu_torch.runtime.odometry import input_downsample

    st = pipe.state
    n_raw = cfg.capacity.max_raw_points
    qs, n_qs = surface_queries(st, frames[n - 1], cfg, dev)
    r = compare_kernel(qs, st.map_surface.xyz, st.map_surface.mask, n_qs, 50.0 ** 0.5,
                       base_knn, reps=50)
    worst_err = max(worst_err, r["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, main-path buffer", **r)
    # the kernel at a shard's input: a slice of the same buffer with a
    # nonzero base, and the shards merged as product mode merges its ranks
    r_shard = shard_input(qs, st.map_surface.xyz, st.map_surface.mask, n_qs, 50.0 ** 0.5)
    worst_err = max(worst_err, r_shard["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, a shard of the main-path buffer",
         **r_shard)
    # the kernel at the main path's first tier: the buffer the schedule
    # starts from (1/16 of the capacities) and the next frame's queries
    r_tier = tier_input(cfg, frames_main, dev)
    worst_err = max(worst_err, r_tier["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, main-path buffer at tier 16", **r_tier)

    # the frame program's two kernels against their plain versions: the
    # debounce on the candidate table of every main-path frame and on
    # seeded tables (DEBOUNCE_SLOTS), timed on the path's last table (512
    # slots); the loop condition on a step's carry (one lane,
    # icp_maximum_iteration 15) at each of its outcomes and on lane axes
    # of 9, 33 and 1,100; the switch index at each of its outcomes
    # (rebuild, append, neither); and the floor of a kernel node in a graph
    from loam_livox_tpu_torch.ops import debounce as DB
    from loam_livox_tpu_torch.ops import graph_cond as GC

    db_held = debounce_phase(cfg, frames[:n], dev)
    db_args = debounce_inputs(cfg, frames[n - 1], dev)
    ns = db_args[0].shape[0]
    r_db = compare_small_kernel("debounce", DB.debounce, DB.debounce_plain, db_args,
                                bytes_=ns * 8 + ns + 8 + ns * 8 + 8, ops=4 * ns,
                                base_kernel=base.debounce.debounce
                                if base and base.debounce else None)
    r_db.update(slots=ns, candidates=int((db_args[0] < db_args[2]).sum()),
                kept=int(DB.debounce_plain(*db_args)[1]), held=db_held,
                ptxas=ptxas_report(build.build_logs.get("debounce", ""), k=None))
    emit("kernel", kernel="debounce", search="main-path candidate table", **r_db)
    # the voxel filter's kernel on its seeded inputs and at the main path's sizes
    r_vox = voxel_phase(dev)
    # the two forms at larger tables: the longest chain (every slot kept)
    # at 4,096 slots (shared memory) and past one block's shared memory
    r_db_sizes = {}
    for ns_big in (4096, 16384, 32768):
        cand, edge, n_pts, n_valid, gap = debounce_tables(np.random.default_rng(ns_big),
                                                          ns_big, 3 * ns_big)[8]
        big = (torch.from_numpy(cand).to(dev), torch.from_numpy(edge).to(dev), n_pts,
               torch.tensor(n_valid, device=dev), gap)
        form = "global" if DB.scratch_bytes(ns_big, big[0].device) else "shared"
        r_db_sizes[ns_big] = r_big = compare_small_kernel(
            "debounce", DB.debounce, DB.debounce_plain, big,
            bytes_=ns_big * 8 + ns_big + 8 + ns_big * 8 + 8, ops=4 * ns_big, reps=50)
        emit("kernel", kernel="debounce", search=f"longest chain, {ns_big} slots, {form} form",
             **r_big)
    # the two sizes the card refused before: a front end past one block's
    # shared memory, and a kNN buffer past the kernel's largest operand
    emit("repair", what="front end at max_splits 16,384, card against CPU",
         **front_end_past_shared(frames[n - 1], dev))
    r_split = split_search(dev)
    worst_err = max(worst_err, r_split["max_abs_err"])
    emit("repair", what="kNN over 2,000,000 rows in row blocks, against the plain search",
         **r_split)
    max_loops = cfg.optimization.icp_maximum_iteration
    r_cond = None
    for lanes, loops in ((1, 0), (1, max_loops - 1), (1, max_loops), (0, 3), (9, 0), (33, 0),
                         (1100, 0), (1100, 3)):
        active = torch.zeros(max(lanes, 1), dtype=torch.bool, device=dev)
        active[lanes - 1:lanes] = lanes > 0      # the last lane set; (0, ...) one lane unset
        args = (active, torch.tensor(loops, dtype=torch.int32, device=dev), max_loops)
        base_cond = base.graph_cond.loop_condition if base and base.graph_cond else None
        r_c = compare_small_kernel("loop_cond", GC.loop_condition, GC.loop_condition_plain,
                                   args, bytes_=active.numel() + 4 + 4, ops=active.numel() + 1,
                                   base_kernel=base_cond if r_cond is None else None)
        r_cond = r_cond or r_c
        emit("kernel", kernel="graph_cond", search=f"loop condition, {active.numel()} lanes, "
             f"lane {lanes - 1} set, loops {loops}", **r_c)
    r_cond.update(ptxas=ptxas_report(build.build_logs.get("graph_cond", ""), k=None,
                                     name="loop_cond_kernel"))
    r_switch = None
    for row, outcome in (((True, False), "rebuild"), ((False, True), "append"),
                         ((False, False), "neither"), ((True,), "rebuild, no appends"),
                         ((False,), "neither, no appends")):
        r_s = compare_small_kernel("switch_cond", GC.switch_index, GC.switch_index_plain,
                                   (torch.tensor(row, device=dev),),
                                   bytes_=len(row) + 4, ops=len(row))
        r_switch = r_switch or dict(r_s, ptxas=ptxas_report(
            build.build_logs.get("graph_cond", ""), k=None, name="switch_cond_kernel"))
        emit("kernel", kernel="graph_cond", search=f"switch index, flags {list(row)} "
             f"({outcome})", **r_s)
    # the threefry kernels against their plain versions at the paths'
    # shapes: the keep mask on a step's residual mask (one lane, the main
    # path's corner + surface inputs) and on a racing group's (9 lanes),
    # over seeded masks (fill 0.4, and the budget of the subsampled rows);
    # the split of a step's key in two and of a group's key into 9
    from loam_livox_tpu_torch.ops import threefry as TF

    caps_f = cfg_fixed.capacity
    n_res = caps_f.max_corner_ds + caps_f.max_surface_ds
    r_mask = {}
    rng_t = np.random.default_rng(14)
    for lanes in (1, 9):
        keys = torch.from_numpy(rng_t.integers(0, 2 ** 32, (lanes, 2)).astype(np.uint32)).to(dev)
        mask = torch.from_numpy(rng_t.uniform(size=(lanes, n_res)) < 0.4).to(dev)
        r_mask[lanes] = compare_small_kernel(
            "threefry_keep_mask", TF.keep_mask, TF.keep_mask_plain, (keys, mask, 200),
            bytes_=2 * lanes * n_res + 8 * lanes, ops=THREEFRY_OPS_PER_DRAW * lanes * n_res)
        emit("kernel", kernel="threefry_keep_mask", search=f"{lanes} lane(s) of {n_res} "
             "residual blocks, fill 0.4, budget 200", **r_mask[lanes])
    r_split = {}
    for lanes, num in ((1, 2), (1, 9)):
        keys = torch.from_numpy(rng_t.integers(0, 2 ** 32, (lanes, 2)).astype(np.uint32)).to(dev)
        r_split[num] = compare_small_kernel(
            "threefry_split", TF.split, TF.split_plain, (keys, num),
            bytes_=8 * lanes + 8 * lanes * num, ops=THREEFRY_OPS_PER_BLOCK * lanes * num)
        emit("kernel", kernel="threefry_split", search=f"a key into {num}", **r_split[num])
    r_mask[1]["ptxas"] = ptxas_report(build.build_logs.get("threefry", ""), k=None,
                                      name="threefry_keep_mask_kernel")
    r_split[2]["ptxas"] = ptxas_report(build.build_logs.get("threefry", ""), k=None,
                                       name="threefry_split_kernel")

    floor = node_floor()
    emit("node_floor", **floor)

    # torch's own count of synchronising calls over three more frames of
    # the same run (a cross-check of the audit in runtime/pipeline.py)
    sync_check("main", pipe, frames[n:n + 3])

    # where a frame's time goes: torch.profiler over the last frame
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        feed(pipe, frames[n + 3:])
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    pipe.flush()
    ka = prof.key_averages()
    kernels_ka = [e for e in ka if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels_ka) / 1e3
    launches_api = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                          "cudaLaunchKernelExC"))
    graph_launches_api = sum(e.count for e in ka if e.key == "cudaGraphLaunch")
    prof_iters = pipe.iterations[-1:]
    # the profiler slows the host, not the card: set the device time per
    # ICP iteration against the unprofiled main run's frame time
    busy_per_iter = busy_ms / max(sum(prof_iters), 1)
    idle_main = 1 - busy_per_iter * (iters / n) / (wall * 1e3 / n)
    if not kernels_ka:      # no device records on this host: not measured
        busy_ms = busy_per_iter = idle_main = None

    def top(rows, attr):
        rows = sorted(rows, key=lambda e: getattr(e, attr), reverse=True)[:8]
        return [[e.key[:60], getattr(e, attr) / 1e3, e.count] for e in rows]

    emit("profile", frames=1, iterations=prof_iters, wall_ms_per_frame_profiled=wall_ms,
         device_busy_ms_per_frame=busy_ms, device_busy_ms_per_icp_iteration=busy_per_iter,
         device_idle_share_main_estimate=idle_main,
         kernel_launches_per_frame=launches_api, graph_launches_per_frame=graph_launches_api,
         kernel_launches_per_icp_iteration=launches_api / max(sum(prof_iters), 1),
         top_kernels_self_device_ms_per_frame=top(kernels_ka, "self_device_time_total"),
         top_self_cpu_ms_per_frame=top(ka, "self_cpu_time_total"))

    # 7. the other rows of bench.py (bench.py:129-137) at full width: 20
    # raw frames of 10,000 points padded on the card beforehand
    n_path = 20
    sim, host_frames = simulate(n_path + 12, 10000, 10)
    dev_frames = on_device(host_frames, n_raw, dev)
    accel = {"init_accumulate_frames": 10}
    paths = {
        "precision": C.precision_profile().replace(mapping=accel),
        "realtime": C.realtime_profile().replace(mapping=accel),
        "racing": C.realtime_racing_profile().replace(mapping=accel),
        "chunked": C.SlamConfig().replace(mapping=accel, parallel={"dispatch_chunk": 8}),
    }
    racing_pipe = None
    for label, cfg_p in paths.items():
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe_p, ate_p, acc_p = run_stream(cfg_p, sim, dev_frames[:n_path], dev)
        torch.cuda.synchronize()
        wall_p = time.perf_counter() - t0
        launches_p = path_row(label, pipe_p, n_path, wall_p, ate_p, acc_p, kf, P)
        launches_by_path[label] = launches_p
        if label in ("racing", "chunked"):
            # the same frames through the plain program on the card: the
            # frame program's chunk and group graphs replay it, bit for bit
            torch.cuda.synchronize()
            reset_counts(kf, P)
            t0 = time.perf_counter()
            pipe_pl, ate_pl, acc_pl = run_stream(cfg_p, sim, dev_frames[:n_path], dev,
                                                 plain=True)
            torch.cuda.synchronize()
            wall_pl = time.perf_counter() - t0
            held = assert_runs_equal(label, pipe_p, pipe_pl)
            launches_by_path[f"{label}_plain"] = path_row(
                f"{label}_plain", pipe_pl, n_path, wall_pl, ate_pl, acc_pl, kf, P,
                **{f"{k}_to_{label}": v for k, v in held.items()})
        if label == "precision":
            sync_check(label, pipe_p, dev_frames[n_path:n_path + 3])
        if label == "racing":
            # four more groups, so the queue (3 deep) drains one
            sync_check(label, pipe_p, dev_frames[n_path:n_path + 12])
            racing_pipe = pipe_p

    # 8. the lane axis on the racing path's own buffer: the surface
    # queries of the last group's 9 lanes, at the pose the path ended on
    from loam_livox_tpu_torch.runtime.pipeline import extract_pieces

    st = racing_pipe.state
    cfg_r = paths["racing"]
    lanes = [input_downsample(piece, cfg_r)[1]
             for frame in dev_frames[n_path - 3:n_path]
             for piece in extract_pieces(frame[0], frame[1], frame[3], frame[2], cfg_r)]
    q_lanes = torch.stack([se3.quat_rotate(st.q_w, b.xyz) + st.t_w for b in lanes])
    n_lanes = torch.stack([b.mask.sum(dtype=torch.int32) for b in lanes])
    r_lanes = compare_kernel(q_lanes.contiguous(), st.map_surface.xyz, st.map_surface.mask,
                             n_lanes, 50.0 ** 0.5, reps=50)
    worst_err = max(worst_err, r_lanes["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, racing-path buffer, 9 lanes",
         **r_lanes)

    # the other correspondence engines at the main path's configuration
    # (20 frames each; grid ran 40 until this slice added rows), and
    # product mode on one card
    main_cfg = C.SlamConfig().replace(mapping={"init_accumulate_frames": 10})
    for label, n_e in (("grid", 20), ("dense", 20)):
        cfg_e = main_cfg.replace(optimization={"correspondence": label})
        launches_by_path[label], launches_by_path[f"{label}_plain"] = engine_path(
            label, cfg_e, sim_main, frames_main, n_e, dev, kf, P)
    # product mode runs at the configured capacities (the schedule is off
    # there, as in the JAX package): held to the main_fixed rows
    n_prod = 20
    launches_prod, r_peer = product_phase(
        main_cfg, sim_main, frames_main, n_prod, dev, kf, P,
        {k: v[:n_prod] for k, v in fixed_rows.items()}, os.path.join(dump_root, "product"))
    launches_by_path.update(launches_prod)
    # residual subsampling (the reference's maximum_residual_blocks cap of
    # 200) on the frame program: main_fixed's configuration and first 20
    # frames, and the racing profile's groups of 3 over 12 frames, each
    # with its bit-equal plain twin
    launches_by_path.update(subsampled_rows(
        "subsampled", cfg_fixed.replace(optimization={"subsample_residuals": 200}),
        sim_main, frames_main, 20, dev, kf, P))
    launches_by_path.update(subsampled_rows(
        "subsampled_racing", paths["racing"].replace(optimization={"subsample_residuals": 200}),
        sim, dev_frames, 12, dev, kf, P))

    # 9. cell matching at full width: the full_mapping scenario's own
    # configuration and stream (60 frames of 10,000 points, registration
    # after 20, 8,192 cells x 32 points, 16,384 / 65,536-point buffers)
    cfg_f, kw_f = S.scenario_config("full_mapping")
    n_f = kw_f["frames"]
    sim_f = S.simulators(cfg_f, kw_f)[0]
    host_f = [sim_f.frame(i) for i in range(n_f + 3)]
    dev_f = on_device(host_f, cfg_f.capacity.max_raw_points, dev)
    n_fp = 30           # full_mapping_plain's frames (registration from frame 20)
    torch.cuda.synchronize()
    reset_counts(kf, P)
    t0 = time.perf_counter()
    pipe_f, ate_f, acc_f = run_stream(cfg_f, sim_f, dev_f[:n_f], dev, split=n_fp)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    st_f = pipe_f.state
    launches_by_path["full_mapping"] = path_line(
        "full_mapping", pipe_f, n_f, wall_f, ate_f, acc_f, kf.launches, P.host_syncs(),
        corner_cells=int(st_f.cell_corners.n_cells()),
        plane_cells=int(st_f.cell_planes.n_cells()),
        cell_capacity=st_f.cell_planes.capacity, cell_pool=st_f.cell_planes.pool_size,
        rebuild_gather_rows=st_f.cell_planes.capacity * st_f.cell_planes.pool_size)
    if not (ate_f < 0.40 and acc_f >= 30):
        raise AssertionError(f"full_mapping off: ATE {ate_f}, accepted {acc_f}/{n_f}")
    sync_check("full_mapping", pipe_f, dev_f[n_f:])
    # its first 30 frames through the plain program on the card, bit-equal
    torch.cuda.synchronize()
    reset_counts(kf, P)
    t0 = time.perf_counter()
    pipe_fp, ate_fp, acc_fp = run_stream(cfg_f, sim_f, dev_f[:n_fp], dev, plain=True)
    torch.cuda.synchronize()
    wall_fp = time.perf_counter() - t0
    launches_by_path["full_mapping_plain"] = kf.launches
    held = assert_runs_equal("full_mapping", pipe_f, pipe_fp, n_fp)
    path_line("full_mapping_plain", pipe_fp, n_fp, wall_fp, ate_fp, acc_fp, kf.launches,
              P.host_syncs(), **{f"{k}_to_full_mapping": v for k, v in held.items()})
    # the kernel on the cell-gathered buffer the path ended on
    qs_f, n_qs_f = surface_queries(st_f, host_f[n_f - 1], cfg_f, dev)
    r_f = compare_kernel(qs_f, st_f.map_surface.xyz, st_f.map_surface.mask, n_qs_f,
                         50.0 ** 0.5, reps=50)
    worst_err = max(worst_err, r_f["max_abs_err"])
    emit("kernel", kernel="knn_fused", search="surfaces, full_mapping cell-gathered buffer",
         **r_f)

    # 10. three heads at full width: 30 frames of 3 x 8,192 points, two
    # merged pieces a frame, on the frame program (the heads key, then a
    # step key launch a piece: 1 + 2 launches a frame); then the same 30
    # frames through the plain program (registration starts at the 51st
    # step, frame 26), bit-equal
    from loam_livox_tpu_torch.eval.ate import ate_rmse

    cfg_m, kw_m = S.scenario_config("mid100_trilidar")
    n_m = kw_m["frames"]
    sims_m = S.simulators(cfg_m, kw_m)
    parts = [[sim.frame(i) for sim in sims_m] for i in range(n_m)]
    for plain in (False, True):
        label = "mid100_trilidar_plain" if plain else "mid100_trilidar"
        torch.cuda.synchronize()
        reset_counts(kf, P)
        t0 = time.perf_counter()
        pipe_m = run_feed(cfg_m, parts, dev, S.multi_head_frame, plain=plain)
        torch.cuda.synchronize()
        wall_m = time.perf_counter() - t0
        est_m = pipe_m.trajectory.positions_array()
        gt_m = np.stack([sims_m[0].gt_pose_at(t)[1] for t in pipe_m.trajectory.times])
        ate_m, acc_m = ate_rmse(est_m, gt_m), int(sum(pipe_m.trajectory.accepted))
        extra = {}
        if plain:
            held = assert_runs_equal("mid100_trilidar", graph_m, pipe_m)
            extra = {f"{k}_to_mid100_trilidar": v for k, v in held.items()}
        else:
            graph_m = pipe_m
        launches_by_path[label] = path_line(
            label, pipe_m, n_m, wall_m, ate_m, acc_m, kf.launches, P.host_syncs(),
            heads=0 if plain else len(sims_m), points_per_head=kw_m["points"], **extra)
        if not (np.all(np.isfinite(est_m)) and est_m.shape == (2 * n_m, 3)
                and ate_m < 0.75 and acc_m >= n_m):
            raise AssertionError(f"{label} off: ATE {ate_m}, accepted {acc_m}/{2 * n_m}")

    # 11. the Velodyne front end on the frame program: 20 VLP-16 sweeps of
    # 16 x 720 points, at the configured capacities (the front end's
    # accuracy check), then with the capacity schedule on as the JAX
    # package runs it, where the first two tiers keep only the sweep's
    # x <= -7.6 m surface voxels (the smallest keys) until the buffers
    # grow: reported, under the paths' golden (aligned ATE < 0.35 m, every
    # sweep accepted); then 12 sweeps in chunks of 4 and in racing groups
    # of 3 at the configured capacities (aligned ATE < 0.35 m, at least
    # half accepted).  Each through the plain program too, bit-equal
    n_v = 20
    sweeps, truth = velodyne_sweeps(n_v)
    fixed = velodyne_config(C, {"auto_schedule": 0})
    for label, cfg_v, n_run in (
            ("velodyne", fixed, n_v), ("velodyne_scheduled", velodyne_config(C), n_v),
            ("velodyne_chunked", fixed.replace(parallel={"dispatch_chunk": 4}), 12),
            ("velodyne_racing", fixed.replace(parallel={"frame_batch": 3}), 12)):
        dev_v = on_device(sweeps[:n_run], cfg_v.capacity.max_raw_points, dev)
        for plain in (False, True):
            row = f"{label}_plain" if plain else label
            torch.cuda.synchronize()
            reset_counts(kf, P)
            t0 = time.perf_counter()
            pipe_v, ate_v, acc_v = run_velodyne(cfg_v, dev_v, truth[:n_run], dev, plain=plain)
            torch.cuda.synchronize()
            wall_v = time.perf_counter() - t0
            err_v = float(np.abs(pipe_v.trajectory.positions_array() - truth[:n_run]).max())
            extra = {}
            if plain:
                held = assert_runs_equal(label, graph_v, pipe_v)
                extra = {f"{k}_to_{label}": v for k, v in held.items()}
            else:
                graph_v = pipe_v
            launches_by_path[row] = path_line(row, pipe_v, n_run, wall_v, ate_v, acc_v,
                                              kf.launches, P.host_syncs(),
                                              max_position_error=err_v,
                                              raced_groups=pipe_v.raced_groups,
                                              fallback_groups=pipe_v.fallback_groups, **extra)
            scheduled = pipe_v.scheduler is not None
            if label in ("velodyne", "velodyne_scheduled"):
                ok = acc_v == n_run and (ate_v < 0.35 if scheduled else err_v < 0.10)
            else:       # the short rows: the bench rows' golden
                ok = ate_v < 0.35 and acc_v >= n_run // 2
            if not ok:
                raise AssertionError(f"{row} off: accepted {acc_v}/{n_run}, ATE {ate_v}, "
                                     f"position error {err_v}")

    # 12. loop closure at full width: the loop_closure scenario's own
    # configuration and stream, the service on its worker thread and
    # stream; the odometry's launches and the loop's counted apart
    kf.launches = 0
    host_loop = loop_sim.get(timeout=600)
    n_lp = 40           # loop_closure_plain's frames: keyframes complete at 29 and 39
    lp, pipe_lp, entries_lp = loop_path(S, P, kf, dev, host_loop, split=n_lp)
    launches_by_path["loop_closure"] = lp["knn_fused_launches"]
    launches_by_path["loop_closure_service"] = lp["loop_knn_fused_launches"]
    emit("path", path="loop_closure", **lp)
    if not (lp["loop_closed"] and lp["ate_aligned"] < 0.45
            and lp["loop_knn_fused_launches"] > 0):
        raise AssertionError(f"loop_closure off: closed {lp['loop_closed']}, "
                             f"ATE {lp['ate_aligned']}")
    loop_plain(S, P, kf, dev, host_loop, n_lp, pipe_lp, entries_lp)
    launches_by_path["loop_closure_plain"] = kf.launches
    if base is not None:
        emit("loop_fps_in_turns", **loop_fps_in_turns(host_loop, dev, card))

    # 13. the command line on the card, resume on the card, and the loop
    # artifact's dumps and state file
    launches_by_path["cli"] = cli_phase(C, P, kf, dev, dump_root, card)
    resume_phase(C, dev, dump_root, card)
    loop_files_phase(C, dev, dump_root, closers["gpu"], card)

    # 14. the large-scale scenario at full size (its own configuration and
    # stream: 60 frames of 10,000 points in the 45 m world, the realtime
    # profile, the capacity schedule on), under its golden
    # (tests/test_scenarios_ci.py:23: aligned ATE < 1.30 m), at least half
    # its rows accepted; where its tiers end is reported, not held
    cfg_l, kw_l = S.scenario_config("largescale_realtime")
    n_l = kw_l["frames"]
    sim_l = S.simulators(cfg_l, kw_l)[0]
    dev_l = on_device(large_sim.get(timeout=900), cfg_l.capacity.max_raw_points, dev)
    torch.cuda.synchronize()
    reset_counts(kf, P)
    t0 = time.perf_counter()
    pipe_l, ate_l, acc_l = run_stream(cfg_l, sim_l, dev_l, dev)
    torch.cuda.synchronize()
    wall_l = time.perf_counter() - t0
    rows_l = len(pipe_l.trajectory.times)
    launches_by_path["largescale_realtime"] = path_line(
        "largescale_realtime", pipe_l, n_l, wall_l, ate_l, acc_l, kf.launches, P.host_syncs(),
        world_half_extent_m=kw_l["scene"]["half_extent"])
    emit("scenario", scenario="largescale_realtime", frames=n_l, rows=rows_l, fps=n_l / wall_l,
         ate_aligned=ate_l, accepted=acc_l, schedule=schedule_info(pipe_l))
    if not (ate_l < 1.30 and acc_l >= rows_l // 2):
        raise AssertionError(f"largescale_realtime over its golden: ATE {ate_l}, "
                             f"accepted {acc_l}/{rows_l}")

    kernels = [{
        "name": "knn_fused", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/knn_fused.cu",
        "replaces": "loam_livox_tpu/ops/pallas/knn_fused.py:305",
        "launches": launches, "max_abs_err": worst_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "lanes_ms": r_lanes["ms"], "lanes_kernel_ms": r_lanes["kernel_ms"],
        "lanes_bound_ms": r_lanes["bound_ms"], "lanes_plain_ms": r_lanes["plain_ms"],
        "lanes_library_ms": r_lanes["library_ms"],
        "full_mapping_ms": r_f["ms"], "full_mapping_kernel_ms": r_f["kernel_ms"],
        "full_mapping_bound_ms": r_f["bound_ms"], "full_mapping_plain_ms": r_f["plain_ms"],
        "full_mapping_library_ms": r_f["library_ms"],
        "alignment_ms": r_align["ms"], "alignment_kernel_ms": r_align["kernel_ms"],
        "alignment_bound_ms": r_align["bound_ms"], "alignment_plain_ms": r_align["plain_ms"],
        "alignment_library_ms": r_align["library_ms"],
        "shard_ms": r_shard["ms"], "shard_kernel_ms": r_shard["kernel_ms"],
        "shard_bound_ms": r_shard["bound_ms"], "shard_plain_ms": r_shard["plain_ms"],
        "shard_library_ms": r_shard["library_ms"],
        "tier16_ms": r_tier["ms"], "tier16_kernel_ms": r_tier["kernel_ms"],
        "tier16_bound_ms": r_tier["bound_ms"], "tier16_plain_ms": r_tier["plain_ms"],
        "tier16_library_ms": r_tier["library_ms"], "launches_by_path": launches_by_path,
        "node_floor_ms": floor["kernel_ms"]}, {
        "name": "debounce", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/debounce.cu",
        "replaces": "loam_livox_tpu/frontend/livox.py:186 (lax.scan, no Pallas kernel)",
        "launches": graph_main["kernel_runs"]["debounce"], "max_abs_err": r_db["max_abs_err"],
        "ms": r_db["ms"], "kernel_ms": r_db["kernel_ms"], "plain_ms": r_db["plain_ms"],
        "bound_ms": r_db["bound_ms"], "bound_by": r_db["bound_by"], "library_ms": None,
        "node_floor_ms": floor["kernel_ms"], "baseline_ms": r_db.get("baseline_ms"),
        "baseline_kernel_ms": r_db.get("baseline_kernel_ms"),
        "runs_by_path": {k: v["debounce"] for k, v in RUNS_BY_PATH.items()},
        **{f"chain_{ns_big}_{k}": r_big[k] for ns_big, r_big in r_db_sizes.items()
           for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")}}, {
        "name": "graph_cond", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/graph_cond.cu",
        "replaces": "loam_livox_tpu/registration/icp.py:327 (lax.while_loop) and "
                    "loam_livox_tpu/runtime/odometry.py:446 (lax.cond), no Pallas kernel",
        "launches": graph_main["kernel_runs"]["loop_cond"]
        + graph_main["kernel_runs"]["switch_cond"],
        "loop_cond_launches": graph_main["kernel_runs"]["loop_cond"],
        "switch_cond_launches": graph_main["kernel_runs"]["switch_cond"],
        "max_abs_err": max(r_cond["max_abs_err"], r_switch["max_abs_err"]),
        "ms": r_cond["ms"], "kernel_ms": r_cond["kernel_ms"], "plain_ms": r_cond["plain_ms"],
        "bound_ms": r_cond["bound_ms"], "bound_by": r_cond["bound_by"], "library_ms": None,
        "switch_ms": r_switch["ms"], "switch_kernel_ms": r_switch["kernel_ms"],
        "switch_plain_ms": r_switch["plain_ms"], "switch_bound_ms": r_switch["bound_ms"],
        "loop_cond_runs_by_path": {k: v["loop_cond"] for k, v in RUNS_BY_PATH.items()},
        "switch_cond_runs_by_path": {k: v["switch_cond"] for k, v in RUNS_BY_PATH.items()},
        "node_floor_ms": floor["kernel_ms"], "baseline_ms": r_cond.get("baseline_ms"),
        "baseline_kernel_ms": r_cond.get("baseline_kernel_ms")}, {
        "name": "threefry_keep_mask", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/threefry.cu",
        "replaces": "loam_livox_tpu/ops/masked.py:73 (random_keep_mask: XLA's threefry and "
                    "elementwise ops), no Pallas kernel",
        "launches": RUNS_BY_PATH["subsampled"]["threefry_keep_mask"],
        "max_abs_err": max(r["max_abs_err"] for r in r_mask.values()),
        "ms": r_mask[1]["ms"], "kernel_ms": r_mask[1]["kernel_ms"],
        "plain_ms": r_mask[1]["plain_ms"], "bound_ms": r_mask[1]["bound_ms"],
        "bound_by": r_mask[1]["bound_by"], "library_ms": None,
        "lanes_ms": r_mask[9]["ms"], "lanes_kernel_ms": r_mask[9]["kernel_ms"],
        "lanes_plain_ms": r_mask[9]["plain_ms"], "lanes_bound_ms": r_mask[9]["bound_ms"],
        "entries": n_res, "node_floor_ms": floor["kernel_ms"],
        "runs_by_path": {k: v["threefry_keep_mask"] for k, v in RUNS_BY_PATH.items()}}, {
        "name": "threefry_split", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/threefry.cu",
        "replaces": "loam_livox_tpu/registration/icp.py:235 and "
                    "loam_livox_tpu/runtime/odometry.py:243 (jax.random.split: XLA's "
                    "threefry), no Pallas kernel",
        "launches": graph_main["kernel_runs"]["threefry_split"],
        "max_abs_err": max(r["max_abs_err"] for r in r_split.values()),
        "ms": r_split[2]["ms"], "kernel_ms": r_split[2]["kernel_ms"],
        "plain_ms": r_split[2]["plain_ms"], "bound_ms": r_split[2]["bound_ms"],
        "bound_by": r_split[2]["bound_by"], "library_ms": None,
        "into_9_ms": r_split[9]["ms"], "into_9_kernel_ms": r_split[9]["kernel_ms"],
        "into_9_plain_ms": r_split[9]["plain_ms"], "into_9_bound_ms": r_split[9]["bound_ms"],
        "node_floor_ms": floor["kernel_ms"],
        "runs_by_path": {k: v["threefry_split"] for k, v in RUNS_BY_PATH.items()}}, {
        "name": "peer_gather", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/peer_gather.cu",
        "replaces": "the all-gather and merge of loam_livox_tpu/parallel/sharded.py's sharded "
                    "kNN (XLA's collective), no Pallas kernel",
        "launches": RUNS_BY_PATH["product"]["peer_gather"],
        "max_abs_err": max(r["max_abs_err"] for r in r_peer.values()),
        "ms": r_peer[1]["ms"], "kernel_ms": r_peer[1]["kernel_ms"],
        "plain_ms": r_peer[1]["plain_ms"], "bound_ms": r_peer[1]["bound_ms"],
        "bound_by": r_peer[1]["bound_by"], "library_ms": None,
        "lanes_ms": r_peer[9]["ms"], "lanes_kernel_ms": r_peer[9]["kernel_ms"],
        "lanes_plain_ms": r_peer[9]["plain_ms"], "lanes_bound_ms": r_peer[9]["bound_ms"],
        "ranks": 1, "node_floor_ms": floor["kernel_ms"],
        "runs_by_path": {k: v["peer_gather"] for k, v in RUNS_BY_PATH.items()}}, {
        "name": "voxel_centroid", "route": "cuda",
        "source": "loam_livox_tpu_torch/csrc/voxel_centroid.cu",
        "replaces": "loam_livox_tpu/ops/voxel.py:88-90 (three jax.ops.segment_sum), "
                    "no Pallas kernel",
        "launches": graph_main["kernel_runs"]["voxel_centroid"],
        "max_abs_err": max(r["max_abs_err"] for r in r_vox.values()),
        **{k: r_vox[VOXEL_TIMED[0]][k]
           for k in ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{f"{name}_{k}": r_vox[name][k] for name in VOXEL_TIMED[1:]
           for k in ("ms", "kernel_ms", "plain_ms", "bound_ms")},
        "node_floor_ms": floor["kernel_ms"],
        "runs_by_path": {k: v["voxel_centroid"] for k, v in RUNS_BY_PATH.items()}}]
    emit("done", seconds=time.perf_counter() - t_start, card=card)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
