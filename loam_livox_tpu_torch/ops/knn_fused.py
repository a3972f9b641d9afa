"""The correspondence search: exact k-NN through the hand-written CUDA
kernel ``csrc/knn_fused.cu`` on the card, its plain version
(`ops.knn.knn`) on the CPU.

It stands in for the TPU kernel of
``loam_livox_tpu/ops/pallas/knn_fused.py`` and keeps its contract
(ascending exact f32 squared distances, BIG where fewer than k valid
references are in range, ``query_count`` and ``max_radius``), with an
exact selection in place of the TPU's binned one.  The kernel emits the
exact distances, so the TPU wrapper's rescoring pass has nothing to
correct here and is not repeated.

The reference operand (`build_ref_operand`) depends only on the
matching buffer: build it once per frame, as ICP does.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .knn import BIG, finish, knn

CHUNK = 2048   # references per kernel block (kChunk in the source)
GROUP = 256    # references per bounding box (kGroup in the source)
MAX_K = 8

#: kernel launches since the last reset (read and reset by callers that
#: check the main path went through the kernel)
launches = 0


class RefOperand(NamedTuple):
    ref4: torch.Tensor    # (Mp, 4) rows (x, y, z, ||r||² + mask penalty)
    boxes: torch.Tensor   # (Mp // GROUP, 8) rows (lo_xyz, 0, hi_xyz, 0)
    n_ref: torch.Tensor   # () int32: one past the last valid reference


def build_ref_operand(ref_xyz: torch.Tensor, ref_mask: torch.Tensor) -> RefOperand:
    """Pad the references to a multiple of CHUNK and precompute the
    kernel's rows, the per-group boxes (an all-invalid group gets an
    empty box, lo > hi) and the valid prefix, without a host sync."""
    m = ref_xyz.shape[0]
    mp = -(-max(m, 1) // CHUNK) * CHUNK
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


def _library():
    lib = build.load("knn_fused")
    fn = lib.knn_fused_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.knn_fused_chunk.restype = ctypes.c_int
        lib.knn_fused_group.restype = ctypes.c_int
        if (lib.knn_fused_chunk(), lib.knn_fused_group()) != (CHUNK, GROUP):
            raise RuntimeError("knn_fused.cu tile sizes differ from the wrapper's")
    return fn


def knn_fused(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
              ref_mask: torch.Tensor, k: int = 5,
              ref_op: RefOperand | None = None,
              query_count: torch.Tensor | int | None = None,
              max_radius: float | None = None):
    """(Q, k) ascending squared distances and int32 indices of the k
    nearest valid references (contract in `ops.knn`).

    A CUDA query launches the kernel; a CPU query runs the plain
    version.  ``query_count`` may be a device scalar: it is never read
    on the host.
    """
    if query_xyz.device.type == "cpu":
        return knn(query_xyz, ref_xyz, ref_mask, k, query_count, max_radius)
    if query_xyz.device.type != "cuda":
        raise ValueError(f"knn_fused: unsupported device {query_xyz.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_fused: k must lie in [1, {MAX_K}], got {k}")
    dev = query_xyz.device
    if (query_xyz.dtype != torch.float32 or query_xyz.dim() != 2
            or query_xyz.shape[1] != 3 or not query_xyz.is_contiguous()):
        raise ValueError("knn_fused: query must be a contiguous (Q, 3) float32 tensor")
    if ref_op is None:
        ref_op = build_ref_operand(ref_xyz, ref_mask)
    ref4, boxes = ref_op.ref4, ref_op.boxes
    mp = ref4.shape[0]
    if (ref4.device != dev or boxes.device != dev
            or ref4.dtype != torch.float32 or boxes.dtype != torch.float32
            or ref4.shape[1] != 4 or mp % CHUNK
            or boxes.shape != (mp // GROUP, 8)
            or not ref4.is_contiguous() or not boxes.is_contiguous()):
        raise ValueError("knn_fused: malformed reference operand")

    n_rows = query_xyz.shape[0]
    if n_rows == 0:
        return (torch.empty((0, k), device=dev),
                torch.empty((0, k), dtype=torch.int32, device=dev))
    if query_count is None:
        n_q = torch.full((), n_rows, dtype=torch.int32, device=dev)
    else:
        n_q = torch.as_tensor(query_count, device=dev).to(torch.int32)
    counts = torch.stack([ref_op.n_ref.to(torch.int32), n_q]).contiguous()
    r2 = float("inf") if max_radius is None else float(max_radius) ** 2
    n_chunks = mp // CHUNK
    part_d = torch.empty((n_chunks, k, n_rows), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_chunks, k, n_rows), dtype=torch.int32, device=dev)

    global launches
    err = _library()(
        query_xyz.data_ptr(), n_rows, ref4.data_ptr(), boxes.data_ptr(), mp,
        counts.data_ptr(), r2, k, part_d.data_ptr(), part_i.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"knn_fused kernel launch failed: CUDA error {err}")
    launches += 1

    # Merge the per-chunk lists: chunks are in index order and each list
    # is (distance, index)-sorted, so a stable sort keeps ties on the
    # lower index.
    cand_d = part_d.permute(2, 0, 1).reshape(n_rows, n_chunks * k)
    cand_i = part_i.permute(2, 0, 1).reshape(n_rows, n_chunks * k)
    d, order = torch.sort(cand_d, dim=1, stable=True)
    idx = torch.gather(cand_i, 1, order[:, :k])
    return finish(d[:, :k], idx, max_radius)
