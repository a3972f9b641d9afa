"""The sharded hot primitives over a product mesh (the counterpart of
``loam_livox_tpu/parallel/sharded.py``): the kNN with the references
split over the ranks, and the normal equations of a split residual set.

* `knn_sharded`: each rank searches its shard of the references (the
  hand-written kernel on the card, its plain version on the CPU), adds
  its shard's base to the indices, and gathers every rank's (Q, k)
  candidates merged by (distance, index) (`ops.peer_gather`: on the card
  one kernel that reads its peers' candidates through symmetric memory,
  so that a CUDA graph's WHILE body can hold it; on the CPU an
  all-gather and `merge_candidates`).  The kernel's selection is exact,
  so the result is bit for bit the unsharded search's.
* `normal_system_psum`: each rank builds H, g and the cost of its share
  of the residual blocks, and the group sums them.  Under
  ``parallel/deterministic`` (`mesh.det_active`) each rank reduces
  fixed-size blocks of residuals by a pairwise tree, the blocks are
  all-gathered in global order, and every rank reduces them by the same
  tree: the sums do not depend on the world size.  Otherwise one
  all-reduce adds the ranks' partials (fewer bytes, world-size-dependent
  rounding).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.knn import finish
from ..ops.knn_fused import knn_fused
from ..ops.peer_gather import peer_gather
from .mesh import Mesh, det_active


def all_gather(x: torch.Tensor, mesh: Mesh, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """Every rank's ``x`` (same shape on every rank) stacked in rank
    order, (size, *x.shape): one ``all_gather_into_tensor`` into one
    output, ``out`` where the caller preallocated it, so that a CUDA graph
    capture of it allocates no list (NCCL; gloo gathers a list into it)."""
    if out is None:
        out = x.new_empty((mesh.size,) + tuple(x.shape))
    x = x.contiguous()
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x)
    else:
        dist.all_gather(list(out.unbind(0)), x)
    return out


def concat_ranks(stacked: torch.Tensor, axis: int) -> torch.Tensor:
    """The ranks' parts of an `all_gather` output, (size, *shape), joined
    along ``axis`` of ``shape`` (``torch.cat`` of the list)."""
    axis %= stacked.dim() - 1
    moved = stacked.movedim(0, axis)
    shape = list(stacked.shape[1:])
    shape[axis] *= stacked.shape[0]
    return moved.reshape(shape)


def merge_candidates(d: torch.Tensor, idx: torch.Tensor, k: int):
    """The k smallest of (..., C) candidates by (distance, index)."""
    idx_s, order = torch.sort(idx, dim=-1, stable=True)
    d_s = torch.gather(d, -1, order)
    d_s, order = torch.sort(d_s, dim=-1, stable=True)
    return d_s[..., :k], torch.gather(idx_s, -1, order)[..., :k]


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of an axis of ``n_rows`` split evenly."""
    if n_rows % mesh.size:
        raise ValueError(f"{n_rows} rows do not split over {mesh.size} ranks")
    m = n_rows // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def knn_sharded(query_xyz: torch.Tensor, ref_xyz: torch.Tensor, ref_mask: torch.Tensor,
                mesh: Mesh, k: int = 5, query_count=None,
                max_radius: Optional[float] = None, ref_op=None):
    """kNN with the references split over the ranks (module doc).
    ``ref_xyz`` / ``ref_mask`` are the whole (M, ...) references, M a
    multiple of the world size; ``ref_op`` this rank's kernel operand of
    its shard, built here when not given.  Queries and counts as in
    `ops.knn_fused.knn_fused`, the same on every rank.  Returns the
    (..., Q, k) distances and int32 indices of the unsharded search."""
    rows = shard_rows(ref_xyz.shape[0], mesh)
    d, i = knn_fused(query_xyz, ref_xyz[rows], ref_mask[rows], k=k, ref_op=ref_op,
                     query_count=query_count, max_radius=max_radius)
    d, i = peer_gather(d, i + rows.start, mesh, k)
    return finish(d, i.to(torch.int64), None)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the leading axis by pairwise halving (zero-padded to a
    power of two): the same operands pair on every device and in every
    call, the port's `shard_invariant_sum`."""
    n = x.shape[0]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = torch.cat([x, x.new_zeros((p - n,) + x.shape[1:])])
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def normal_system_psum(
        residual_jac_fn: Callable[[torch.Tensor],
                                  Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
        shard_ids: torch.Tensor, mesh: Mesh, block: int = 16,
        deterministic: Optional[bool] = None):
    """H (6, 6), g (6,) and the cost () of a residual set split over the
    ranks.  ``residual_jac_fn(ids)`` returns ``(r (B, 3), J (B, 3, 6),
    w (B,))`` for the residual ids it is given; ``shard_ids`` (N,) are
    all the ids, N a multiple of the world size, and each rank takes its
    share.  With ``deterministic`` (default: `mesh.det_active`) the
    share must be a multiple of ``block``, and the sums are bitwise the
    same at every world size (module doc)."""
    ids = shard_ids[shard_rows(shard_ids.shape[0], mesh)]
    r, J, w = residual_jac_fn(ids)
    sw = torch.sqrt(w)
    rw = r * sw[:, None]
    Jw = J * sw[:, None, None]
    det = det_active() if deterministic is None else deterministic
    if not det:
        H = torch.einsum("nij,nik->jk", Jw, Jw)
        g = torch.einsum("nij,ni->j", Jw, rw)
        parts = torch.cat([H.reshape(-1), g, (rw * rw).sum().reshape(1)])
        dist.all_reduce(parts)
        return parts[:36].reshape(6, 6), parts[36:42], parts[42]
    if ids.shape[0] % block:
        raise ValueError(f"a rank's {ids.shape[0]} residuals do not split into "
                         f"blocks of {block}")
    terms = torch.cat([(Jw[:, :, :, None] * Jw[:, :, None, :]).sum(dim=1).reshape(-1, 36),
                       (Jw * rw[:, :, None]).sum(dim=1),
                       (rw * rw).sum(dim=1, keepdim=True)], dim=1)       # (B, 43)
    blocks = terms.reshape(-1, block, 43).transpose(0, 1)               # (block, nb, 43)
    parts = concat_ranks(all_gather(tree_sum(blocks), mesh), 0)         # (NB, 43)
    total = tree_sum(parts)
    return total[:36].reshape(6, 6), total[36:42], total[42]

