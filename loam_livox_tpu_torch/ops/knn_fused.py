"""The correspondence search: exact k-NN through the hand-written CUDA
kernel ``csrc/knn_fused.cu`` on the card, its plain version
(`ops.knn.knn`) on the CPU.

It stands in for the TPU kernel of
``loam_livox_tpu/ops/pallas/knn_fused.py`` and keeps its contract
(ascending exact f32 squared distances, BIG where fewer than k valid
references are in range, ``query_count`` and ``max_radius``), with an
exact selection in place of the TPU's binned one.  The kernel emits the
exact distances, merged over its reference slices and gated, so the
TPU wrapper's rescoring pass and any merge here have nothing left to do.

The reference operand (`build_ref_operand`) depends only on the
matching buffer: build it once per frame, as ICP does.

Queries may carry a leading lane axis, (L, Q, 3) with an (L,) tensor of
counts: the counterpart of ``jax.vmap`` over the TPU kernel in the
racing path (``loam_livox_tpu/runtime/batched.py:76-85``).  One launch
serves every lane (a grid row per lane) against the one operand.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..core import accounting
from . import build
from .knn import BIG, knn

GROUP = 256    # references per bounding box and operand padding (kGroup in the source)
MAX_K = 8
MAX_LANES = 65535   # gridDim.y

#: kernel launches made from Python since the last reset (read and reset
#: by callers that check the main path went through the kernel); launches
#: inside `core.accounting.charged_to` count into that dict's "knn_fused"
#: instead, and a call recorded into a CUDA graph launches nothing
launches = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
runs = build.RunCounter()


class RefOperand(NamedTuple):
    ref4: torch.Tensor    # (Mp, 4) rows (x, y, z, ||r||² + mask penalty)
    boxes: torch.Tensor   # (Mp // GROUP, 8) rows (lo_xyz, 0, hi_xyz, 0)
    n_ref: torch.Tensor   # () int32: one past the last valid reference


def build_ref_operand(ref_xyz: torch.Tensor, ref_mask: torch.Tensor) -> RefOperand:
    """Pad the references to a multiple of GROUP and precompute the
    kernel's rows, the per-group boxes (an all-invalid group gets an
    empty box, lo > hi) and the valid prefix, without a host sync."""
    m = ref_xyz.shape[0]
    mp = -(-max(m, 1) // GROUP) * GROUP
    dev = ref_xyz.device
    ref = torch.zeros((mp, 3), dtype=torch.float32, device=dev)
    ref[:m] = ref_xyz
    mask = torch.zeros((mp,), dtype=torch.bool, device=dev)
    mask[:m] = ref_mask
    r2 = (ref * ref).sum(dim=1) + torch.where(
        mask, torch.zeros((), device=dev), torch.full((), BIG, device=dev))
    ref4 = torch.cat([ref, r2[:, None]], dim=1).contiguous()
    grp = ref.reshape(mp // GROUP, GROUP, 3)
    gmask = mask.reshape(mp // GROUP, GROUP, 1)
    inf = torch.full((), float("inf"), device=dev)
    lo = torch.where(gmask, grp, inf).amin(dim=1)
    hi = torch.where(gmask, grp, -inf).amax(dim=1)
    pad = torch.zeros((mp // GROUP, 1), dtype=torch.float32, device=dev)
    boxes = torch.cat([lo, pad, hi, pad], dim=1).contiguous()
    iota = torch.arange(1, mp + 1, dtype=torch.int32, device=dev)
    n_ref = torch.where(mask, iota, torch.zeros_like(iota)).amax()
    return RefOperand(ref4=ref4, boxes=boxes, n_ref=n_ref)


def search_work(query_xyz: torch.Tensor, query_count, ref_op: RefOperand,
                max_radius: float | None, k: int = 5) -> tuple[int, int]:
    """(pairs, bytes) that any exact search skipping whole GROUP-point
    groups must spend on these inputs, whatever its tiling.

    Pairs: each valid query (row < ``query_count``) against each valid
    reference of every group whose box lies within ``max_radius`` of
    that query's own point (every group when it is None), box distances
    in float64.  Bytes: the valid queries, the reference rows up to the
    last valid one and their boxes read once, the (n_q, k) lists written
    once.  With a lane axis, pairs, queries and lists sum over the lanes
    and the shared operand counts once.  Reads the counts on the host: a
    yardstick, not a device path.
    """
    lanes = query_xyz.reshape(-1, query_xyz.shape[-2], 3)
    counts = ([lanes.shape[1]] * lanes.shape[0] if query_count is None else
              torch.as_tensor(query_count).reshape(-1).expand(lanes.shape[0]).tolist())
    n_ref = int(ref_op.n_ref)
    valid = (ref_op.ref4[:, 3] < 0.5 * BIG).reshape(-1, GROUP).sum(1)
    live = valid > 0
    lo = ref_op.boxes[live, 0:3].double()
    hi = ref_op.boxes[live, 4:7].double()
    pairs = n_q_all = 0
    for q_lane, count in zip(lanes, counts):
        n_q = min(max(int(count), 0), q_lane.shape[0])
        n_q_all += n_q
        if max_radius is None:
            pairs += n_q * int(valid.sum())
            continue
        for q in q_lane[:n_q].double().split(256):
            gap = torch.clamp(torch.maximum(lo[None] - q[:, None], q[:, None] - hi[None]), min=0)
            near = (gap * gap).sum(-1) <= float(max_radius) ** 2
            pairs += int((near.to(valid.dtype) * valid[live][None]).sum())
    n_groups = -(-n_ref // GROUP)
    return pairs, n_q_all * 12 + n_ref * 16 + n_groups * 32 + n_q_all * k * 8


def _library() -> ctypes.CDLL:
    lib = build.load("knn_fused")
    fn = lib.knn_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.knn_fused_info.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.knn_fused_info.restype = ctypes.c_int
        lib.knn_fused_max_rows.argtypes = [ctypes.c_int]
        lib.knn_fused_max_rows.restype = ctypes.c_int
        lib.knn_fused_group.restype = ctypes.c_int
        if lib.knn_fused_group() != GROUP:
            raise RuntimeError("knn_fused.cu group size differs from the wrapper's")
    return lib


def max_ref_rows(k: int) -> int:
    """The most reference rows (operand rows, a multiple of GROUP) one
    launch takes at ``k`` on the current card: past it a caller splits
    the references into blocks (`registration.icp`)."""
    rows = _library().knn_fused_max_rows(k)
    if rows <= 0:
        raise RuntimeError(f"knn_fused: no operand size for k = {k} on this card")
    return rows


def launch_shape(k: int, mp: int) -> dict:
    """The kernel's launch shape on the current card for a k-search of an
    ``mp``-row operand: threads per block, cluster size, dynamic shared
    bytes, blocks resident per SM and clusters resident at once."""
    out = (ctypes.c_int * 5)()
    err = _library().knn_fused_info(k, mp, out)
    if err != 0:
        raise RuntimeError(f"knn_fused_info failed: CUDA error {err}")
    return dict(zip(("threads", "cluster", "smem_bytes", "blocks_per_sm",
                     "max_active_clusters"), out))


def knn_fused(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
              ref_mask: torch.Tensor, k: int = 5,
              ref_op: RefOperand | None = None,
              query_count: torch.Tensor | int | None = None,
              max_radius: float | None = None):
    """(Q, k) ascending squared distances and int32 indices of the k
    nearest valid references (contract in `ops.knn`); (L, Q, k) for
    (L, Q, 3) queries, with ``query_count`` an (L,) tensor, one count a
    lane (a single count or None applies to every lane).

    A CUDA query launches the kernel; a CPU query runs the plain
    version.  ``query_count`` may live on the device: it is never read
    on the host.
    """
    if query_xyz.device.type == "cpu":
        return knn(query_xyz, ref_xyz, ref_mask, k, query_count, max_radius)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"knn_fused: unsupported device {query_xyz.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_fused: k must lie in [1, {MAX_K}], got {k}")
    dev = query_xyz.device
    lane_axis = query_xyz.dim() == 3
    q3 = query_xyz if lane_axis else query_xyz[None]
    if (query_xyz.dtype != torch.float32 or query_xyz.dim() not in (2, 3)
            or q3.shape[2] != 3 or q3.stride(2) != 1 or q3.stride(1) != 3
            or (q3.shape[0] > 1 and q3.stride(0) % 3)):
        raise ValueError("knn_fused: query must be a (Q, 3) or (L, Q, 3) float32 "
                         "tensor with contiguous rows")
    n_lanes, n_rows = q3.shape[:2]
    if n_lanes > MAX_LANES:
        raise ValueError(f"knn_fused: {n_lanes} lanes exceed the kernel's grid, "
                         f"at most {MAX_LANES}")
    if ref_op is None:
        ref_op = build_ref_operand(ref_xyz, ref_mask)
    ref4, boxes = ref_op.ref4, ref_op.boxes
    mp = ref4.shape[0]
    if (ref4.device != dev or boxes.device != dev
            or ref4.dtype != torch.float32 or boxes.dtype != torch.float32
            or ref4.shape[1] != 4 or mp % GROUP
            or boxes.shape != (mp // GROUP, 8)
            or not ref4.is_contiguous() or not boxes.is_contiguous()
            or ref4.data_ptr() % 16 or boxes.data_ptr() % 16):
        raise ValueError("knn_fused: malformed reference operand")
    lib = _library()
    max_rows = lib.knn_fused_max_rows(k)
    if mp > max_rows:
        raise ValueError(f"knn_fused: {mp} reference rows exceed the kernel's largest "
                         f"operand, {max_rows} rows at k = {k}")

    out_d = torch.empty((n_lanes, n_rows, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_lanes, n_rows, k), dtype=torch.int32, device=dev)
    if n_lanes and n_rows:
        # the counts stay on the device; a host count is filled in there
        n_ref = ref_op.n_ref.to(device=dev, dtype=torch.int32)
        if isinstance(query_count, torch.Tensor):
            n_q = query_count.to(device=dev, dtype=torch.int32).reshape(-1)
            if n_q.numel() == 1:
                n_q = n_q.expand(n_lanes)
            if n_q.numel() != n_lanes:
                raise ValueError(f"knn_fused: {n_q.numel()} query counts for {n_lanes} lanes")
            n_q = n_q.contiguous()
        else:
            n = n_rows if query_count is None else min(max(int(query_count), 0), n_rows)
            n_q = torch.full((n_lanes,), n, dtype=torch.int32, device=dev)
        r2 = float("inf") if max_radius is None else float(max_radius) ** 2

        global launches
        err = lib.knn_fused_launch(
            q3.data_ptr(), n_rows, n_lanes, q3.stride(0) // 3, ref4.data_ptr(),
            boxes.data_ptr(), mp, n_ref.data_ptr(), n_q.data_ptr(), r2, k,
            out_d.data_ptr(), out_i.data_ptr(), runs.address(dev),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"knn_fused kernel launch failed: CUDA error {err}")
        counts = accounting.charged()
        if torch.cuda.is_current_stream_capturing():
            pass            # recorded into a graph: its replays count in `runs`
        elif counts is None:
            launches += 1
        else:
            counts["knn_fused"] = counts.get("knn_fused", 0) + 1
    return (out_d, out_i) if lane_axis else (out_d[0], out_i[0])
