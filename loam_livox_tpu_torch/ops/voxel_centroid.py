"""The voxel filter's segmented centroids on the card: the hand-written
CUDA kernel ``csrc/voxel_centroid.cu``, one launch a filter.

From the points sorted by voxel key (``ops.voxel``'s keys, stable sort
and segment ids), it writes the filter's three outputs at ``capacity`` slots: each
voxel's centroid, mean time (zeros with ``with_time=False``) and mask,
valid voxels first in key order.  It computes `ops.voxel.centroids_plain`
on the card bit for bit (the source's note gives the summation order),
reading only the rows that contribute.  `ops.voxel.voxel_downsample`
launches it for a CUDA tensor and runs the plain version for a CPU one.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import accounting
from ..core.types import PointBatch
from . import build

#: kernel launches made from Python since the last reset; launches inside
#: `core.accounting.charged_to` count into that dict's "voxel_centroid"
#: instead, and a call recorded into a CUDA graph launches nothing
launches = 0
#: calls recorded into CUDA graphs (`runtime.frame_program` counts a
#: captured piece's filters by it)
captured = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
runs = build.RunCounter()
#: rows a launch takes (float32 counts stay exact below 2^24)
MAX_ROWS = 1 << 24


def _library() -> ctypes.CDLL:
    lib = build.load("voxel_centroid")
    fn = lib.voxel_centroid_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, ctypes.c_longlong, p, p, p, p, p]
        fn.restype = i
    return lib


def centroids(key_s: torch.Tensor, seg: torch.Tensor, order: torch.Tensor,
              xyz: torch.Tensor, time: torch.Tensor, capacity: int, with_time: bool,
              invalid_key: int) -> PointBatch:
    """The filter's ``capacity`` slots from ``key_s`` (N,) int64 sorted
    ascending (masked rows at ``invalid_key``, above every voxel key),
    ``seg`` its `ops.voxel.segment_ids`, ``order`` (N,) int64 the sort's
    permutation, and the input's ``xyz`` (N, 3) and ``time`` (N,)
    float32, all on one card."""
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"voxel_centroid: the kernel runs on a CUDA tensor, got {dev}")
    n = key_s.shape[0] if key_s.dim() == 1 else -1
    if (key_s.dtype != torch.int64 or seg.dtype != torch.int64 or seg.shape != (n,)
            or order.dtype != torch.int64 or order.shape != (n,)
            or xyz.dtype != torch.float32 or xyz.shape != (n, 3)
            or time.dtype != torch.float32 or time.shape != (n,)
            or any(t.device != dev for t in (key_s, seg, order, time))):
        raise ValueError("voxel_centroid: key_s, seg and order (N,) int64, xyz (N, 3) and time "
                         "(N,) float32 on one card")
    if not (0 <= n < MAX_ROWS and 0 < capacity < 2 ** 31):
        raise ValueError(f"voxel_centroid: {n} rows into {capacity} slots outside the "
                         "kernel's range")
    keys, ids, perm = key_s.contiguous(), seg.contiguous(), order.contiguous()
    pts = xyz.contiguous()
    t_in = time.contiguous() if with_time else None
    out_xyz = torch.empty((capacity, 3), dtype=torch.float32, device=dev)
    out_time = torch.empty((capacity,), dtype=torch.float32, device=dev)
    out_mask = torch.empty((capacity,), dtype=torch.bool, device=dev)
    global launches, captured
    err = _library().voxel_centroid_launch(
        keys.data_ptr(), ids.data_ptr(), perm.data_ptr(), pts.data_ptr(),
        None if t_in is None else t_in.data_ptr(), n, capacity, invalid_key,
        out_xyz.data_ptr(), out_time.data_ptr(), out_mask.data_ptr(), runs.address(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"voxel_centroid kernel launch failed: CUDA error {err}")
    counts = accounting.charged()
    if torch.cuda.is_current_stream_capturing():
        captured += 1       # its replays count in `runs`
    elif counts is None:
        launches += 1
    else:
        counts["voxel_centroid"] = counts.get("voxel_centroid", 0) + 1
    return PointBatch(xyz=out_xyz, time=out_time, mask=out_mask)
