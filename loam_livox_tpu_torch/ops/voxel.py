"""Centroid voxel filter as a sort plus segment sums.

Replaces the reference's ``pcl::VoxelGrid`` filters (source
``laser_feature_extractor.hpp:372-384``, ICP input
``laser_mapping.hpp:1367-1378``, matching buffer
``laser_mapping.hpp:533-537``).  Each occupied voxel yields the centroid
of its points, the time channel included.

Voxel coordinates are offset by 2¹⁴ and clipped to [0, 2¹⁵) per axis and
packed into one int64 key ``x·2³⁰ + y·2¹⁵ + z``, which orders voxels as
the JAX package's two-word key (x, y·2¹⁵ + z) does.  Masked-out points
carry a key above every voxel key, so they sort last.  When more voxels
are occupied than ``capacity``, the smallest keys win.

After the keys, their stable sort and each sorted row's segment id
(`segment_ids`), a CUDA tensor goes to one launch of the hand-written
kernel ``csrc/voxel_centroid.cu`` (`ops.voxel_centroid`), which reads
only the rows that contribute and computes `centroids_plain` on the card
bit for bit.  A CPU tensor runs `centroids_plain`: segment sums in input
(sorted) order on both devices,
``index_add_`` on the CPU, and on CUDA, where ``index_add_`` would sum in
atomic order (a new rounding on every run), ``index_put_(accumulate=True)``,
which sorts the indices and sums each segment in order.  So a run on the
card repeats itself.
"""
from __future__ import annotations

import torch

from ..core.types import PointBatch
from ..utils.logging import SPAN_VOXEL, spans
from . import voxel_centroid

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
    with spans.device(SPAN_VOXEL, batch.xyz):
        return _voxel_downsample(batch, leaf, capacity, with_time)


def _voxel_downsample(batch: PointBatch, leaf: float, capacity: int | None,
                      with_time: bool) -> PointBatch:
    capacity = capacity or batch.capacity
    key = torch.where(batch.mask, voxel_keys(batch.xyz, leaf),
                      torch.full_like(batch.mask, _INVALID_KEY, dtype=torch.int64))
    key_s, order = torch.sort(key, stable=True)
    if batch.xyz.is_cuda:
        return voxel_centroid.centroids(key_s, segment_ids(key_s), order, batch.xyz,
                                        batch.time, capacity, with_time, _INVALID_KEY)
    return centroids_plain(key_s, order, batch.xyz, batch.time, capacity, with_time)


def segment_ids(key_s: torch.Tensor) -> torch.Tensor:
    """Each row's voxel among the valid keys of ``key_s`` (sorted
    ascending): its key's rank, −1 before the first valid row, a masked
    row the last voxel's."""
    valid_s = key_s != _INVALID_KEY
    new_seg = torch.ones_like(valid_s)
    new_seg[1:] = key_s[1:] != key_s[:-1]
    return torch.cumsum((new_seg & valid_s).to(torch.int64), 0) - 1


def centroids_plain(key_s: torch.Tensor, order: torch.Tensor, xyz: torch.Tensor,
                    time: torch.Tensor, capacity: int, with_time: bool) -> PointBatch:
    """The filter's ``capacity`` slots from the sorted keys ``key_s`` and
    the sort's ``order`` as segment sums (any device, no host read)."""
    dev = xyz.device
    seg = segment_ids(key_s)
    contrib = (key_s != _INVALID_KEY) & (seg >= 0) & (seg < capacity)
    seg_c = torch.clamp(seg, 0, capacity - 1)
    w = contrib.to(xyz.dtype)

    xyz_s = xyz[order]
    sums = segment_sum(torch.zeros((capacity, 3), dtype=xyz.dtype, device=dev),
                       seg_c, xyz_s * w[:, None])
    cnts = segment_sum(torch.zeros((capacity,), dtype=xyz.dtype, device=dev), seg_c, w)
    denom = torch.clamp(cnts, min=1.0)
    if with_time:
        tsum = segment_sum(torch.zeros((capacity,), dtype=time.dtype, device=dev),
                           seg_c, time[order] * w)
        t = tsum / denom
    else:
        t = torch.zeros((capacity,), dtype=time.dtype, device=dev)
    return PointBatch(xyz=sums / denom[:, None], time=t, mask=cnts > 0)
