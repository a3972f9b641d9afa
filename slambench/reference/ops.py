"""The plain reference's operations, plain PyTorch on any device: point
batches, the centroid voxel filter, masked helpers, the exact k-NN
search and the Livox split debounce.  A frozen copy of the program's
plain versions (none of its kernels): the same arithmetic, in the same
order, so that on the same inputs both give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e30


def sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q, 3) x (M, 3) -> (Q, M) exact f32 squared distances."""
    dx = q[:, None, 0] - r[None, :, 0]
    dy = q[:, None, 1] - r[None, :, 1]
    dz = q[:, None, 2] - r[None, :, 2]
    d = dx * dx
    d = d + dy * dy
    return d + dz * dz


def finish(d: torch.Tensor, idx: torch.Tensor, max_radius: float | None):
    """Apply the radius gate and the BIG/index-0 convention to selected
    (Q, k) distances and indices."""
    far = d >= 0.5 * BIG
    if max_radius is not None:
        far = far | (d > float(max_radius) ** 2)
    d = torch.where(far, torch.full_like(d, BIG), d)
    idx = torch.where(far, torch.zeros_like(idx), idx)
    return d, idx.to(torch.int32)


def knn(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
        ref_mask: torch.Tensor, k: int = 5,
        query_count: torch.Tensor | int | None = None,
        max_radius: float | None = None):
    """(Q, k) ascending squared distances and int32 indices (module doc);
    (L, Q, k) for (L, Q, 3) queries, each lane searched on its own with
    its own count (an (L,) tensor or sequence; a single count or None
    applies to every lane).

    Reads the valid prefixes on the host, so on CUDA it synchronises:
    it is the reference the kernel is held against, not a device path.
    """
    if query_xyz.dim() == 3:
        n_lanes, n_rows = query_xyz.shape[:2]
        counts = ([None] * n_lanes if query_count is None else
                  torch.as_tensor(query_count).reshape(-1).expand(n_lanes).tolist())
        out_d = torch.empty((n_lanes, n_rows, k), device=query_xyz.device)
        out_i = torch.empty((n_lanes, n_rows, k), dtype=torch.int32, device=query_xyz.device)
        for lane, count in enumerate(counts):
            out_d[lane], out_i[lane] = knn(query_xyz[lane], ref_xyz, ref_mask, k, count,
                                           max_radius)
        return out_d, out_i
    nq_rows = query_xyz.shape[0]
    dev = query_xyz.device
    out_d = torch.full((nq_rows, k), BIG, dtype=torch.float32, device=dev)
    out_i = torch.zeros((nq_rows, k), dtype=torch.int64, device=dev)
    valid = torch.nonzero(ref_mask).flatten()
    n_ref = int(valid[-1]) + 1 if valid.numel() else 0
    n_q = nq_rows if query_count is None else min(max(int(query_count), 0), nq_rows)
    if n_ref and n_q:
        d = sq_dist(query_xyz[:n_q].float(), ref_xyz[:n_ref].float())
        d = torch.where(ref_mask[None, :n_ref], d,
                        torch.full_like(d, float("inf")))
        kk = min(k, n_ref)
        d_s, i_s = torch.sort(d, dim=1, stable=True)
        out_d[:n_q, :kk] = d_s[:, :kk]
        out_i[:n_q, :kk] = i_s[:, :kk]
    return finish(out_d, out_i, max_radius)


class PointBatch(NamedTuple):
    xyz: torch.Tensor    # (N, 3) float32
    time: torch.Tensor   # (N,) float32
    mask: torch.Tensor   # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        """Valid points (over the last axis), int32."""
        return self.mask.sum(dim=-1, dtype=torch.int32)

    @staticmethod
    def empty(capacity: int, device=None) -> "PointBatch":
        return PointBatch(
            xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=device),
            time=torch.zeros((capacity,), dtype=torch.float32, device=device),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=device),
        )


class FeatureFrame(NamedTuple):
    """One frame's corner / surface / full clouds and its time range
    (the motion-deblur normalisation, reference
    ``laser_mapping.hpp:1330-1352``)."""
    corners: PointBatch
    surface: PointBatch
    full: PointBatch
    time_min: torch.Tensor   # () float32
    time_max: torch.Tensor   # () float32

_AXIS_BITS = 15
_AXIS_RANGE = 1 << _AXIS_BITS
_AXIS_OFFSET = _AXIS_RANGE // 2
_INVALID_KEY = 1 << (3 * _AXIS_BITS)


def voxel_keys(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """Packed int64 voxel keys of (N, 3) points."""
    # Divide by a device tensor, not a Python float: CUDA turns division
    # by a host scalar into multiplication by its reciprocal, which moves
    # points that lie on a voxel face.
    leaf_t = torch.full((), leaf, dtype=xyz.dtype, device=xyz.device)
    coords = torch.floor(xyz / leaf_t).to(torch.int64) + _AXIS_OFFSET
    coords = torch.clamp(coords, 0, _AXIS_RANGE - 1)
    return ((coords[:, 0] << (2 * _AXIS_BITS))
            | (coords[:, 1] << _AXIS_BITS) | coords[:, 2])


def segment_sum(out: torch.Tensor, seg: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """out[seg[i]] += values[i], each segment summed in input order."""
    if out.is_cuda:
        return out.index_put_((seg,), values, accumulate=True)
    return out.index_add_(0, seg, values)


def voxel_downsample(batch: PointBatch, leaf: float,
                     capacity: int | None = None,
                     with_time: bool = True) -> PointBatch:
    """Centroid voxel filter into ``capacity`` slots (default: the
    input's), valid voxels first in key order.  ``with_time=False``
    returns a zero time channel."""
    capacity = capacity or batch.capacity
    dev = batch.xyz.device
    key = torch.where(batch.mask, voxel_keys(batch.xyz, leaf),
                      torch.full_like(batch.mask, _INVALID_KEY, dtype=torch.int64))
    key_s, order = torch.sort(key, stable=True)
    valid_s = key_s != _INVALID_KEY
    new_seg = torch.ones_like(valid_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum((new_seg & valid_s).to(torch.int64), 0) - 1
    contrib = valid_s & (seg >= 0) & (seg < capacity)
    seg_c = torch.clamp(seg, 0, capacity - 1)
    w = contrib.to(batch.xyz.dtype)

    xyz_s = batch.xyz[order]
    sums = segment_sum(torch.zeros((capacity, 3), dtype=batch.xyz.dtype, device=dev),
                        seg_c, xyz_s * w[:, None])
    cnts = segment_sum(torch.zeros((capacity,), dtype=batch.xyz.dtype, device=dev),
                        seg_c, w)
    denom = torch.clamp(cnts, min=1.0)
    if with_time:
        tsum = segment_sum(torch.zeros((capacity,), dtype=batch.time.dtype, device=dev),
                            seg_c, batch.time[order] * w)
        time = tsum / denom
    else:
        time = torch.zeros((capacity,), dtype=batch.time.dtype, device=dev)
    return PointBatch(xyz=sums / denom[:, None], time=time, mask=cnts > 0)


def masked_quantile_l1(values: torch.Tensor, mask: torch.Tensor,
                       ratio: float) -> torch.Tensor:
    """Value at position ``floor(ratio * n_valid)`` of the ascending
    valid entries along the last axis (reference
    ``point_cloud_registration.hpp:153-161``)."""
    vals = torch.where(mask, values, torch.full_like(values, BIG))
    svals = torch.sort(vals, dim=-1).values
    n = mask.sum(dim=-1, dtype=torch.int32)
    idx = torch.clamp((ratio * n.float()).to(torch.int32), 0, values.shape[-1] - 1)
    idx = torch.minimum(idx, torch.clamp(n - 1, min=0))
    # gather, not svals[idx]: indexing with a 0-dim tensor reads it on the host
    return torch.gather(svals, -1, idx.long()[..., None])[..., 0]


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Move the valid rows to the front, keeping their order.  Returns
    ``(new_mask, *compacted)`` at the input capacity."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return (mask[order],) + tuple(a[order] for a in arrays)


def debounce_plain(cand_idx: torch.Tensor, cand_is_edge: torch.Tensor, n: int,
                   n_valid: torch.Tensor, gap: int):
    """The debounce as tensor operations (any device, no host read).

    The first candidate of each kind is always kept, so from a kept slot
    ``a`` the next kept slot is the first that lies more than ``gap``
    past it, or the first slot of the other kind when that comes sooner
    and after ``a``.  The kept slots are the chain of that map from slot
    0, walked by pointer doubling."""
    ns = cand_idx.shape[0]
    dev = cand_idx.device
    slots = torch.arange(ns, device=dev)
    valid = cand_idx < n
    far = torch.searchsorted(cand_idx, cand_idx + gap, right=True)
    kind0 = cand_is_edge[0]
    other = valid & (cand_is_edge != kind0)
    f_other = torch.where(other, slots, torch.full_like(slots, ns)).amin()
    nxt = torch.where(slots < f_other, torch.minimum(far, f_other), far)
    # slot ns is a sink past the table
    jump = torch.cat([torch.clamp(nxt, max=ns), torch.full((1,), ns, device=dev)])
    chain = torch.zeros(1, dtype=torch.int64, device=dev)
    while chain.shape[0] < ns:
        chain = torch.cat([chain, jump[chain]])
        jump = jump[jump]
    on_chain = torch.zeros(ns + 1, dtype=torch.bool, device=dev)
    on_chain[chain] = True
    accepted = on_chain[:ns] & valid
    splits = torch.where(accepted, cand_idx, torch.full_like(cand_idx, n))
    free = ~accepted
    first_free = (torch.cumsum(free.to(torch.int64), 0) == 1) & free
    splits = torch.where(first_free, n_valid.to(torch.int64) - 1, splits)
    return torch.sort(splits).values, accepted.sum()
