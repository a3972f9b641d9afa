"""Grid cell map (reference `Points_cloud_cell` / `Points_cloud_map`,
``source/cell_map_keyframe.hpp:53-1000``), the counterpart of
``loam_livox_tpu/map/cell_map.py``.

* **Sorted integer-key directory.**  A cell is its grid coordinates
  packed 10 bits an axis (clipped); free slots hold ``EMPTY_KEY``, which
  sorts last.  Point-to-cell lookup is ``searchsorted``; insertion is a
  sort-merge of the directory with the frame's new keys.
* **Moment sums.**  Each cell keeps ``count``, ``Σp`` and ``Σppᵀ`` of
  every point appended since it was created or last reset.  The
  per-frame sums run in input order on both devices
  (`ops.voxel.segment_sum`), so the card's map equals the CPU's bit for
  bit.
* **Point pool.**  Each cell keeps its last ``P`` points in a ring.
* **Revisit reset** (reference ``:716-758``): a cell touched again
  ``revisit_threshold`` frames or more after its last update restarts
  its moments, pool and creation frame.

``frame_idx`` (the reference's ``m_current_frame_idx``) is a () int32
tensor on the map's device, as in the JAX package: every caller appends
once a frame (a frame that adds nothing appends with an all-False mask),
so it counts frames, and a captured CUDA graph advances it on every
replay.  No function here reads a device value on the host.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import se3
from ..core.types import PointBatch
from ..ops.voxel import segment_sum

# Feature classes (reference: cell_map_keyframe.hpp :436-473)
FEATURE_SPHERE = 0
FEATURE_LINE = 1
FEATURE_PLANE = 2

_AXIS_BITS = 10
_AXIS_RANGE = 1 << _AXIS_BITS          # 1024 cells an axis
_AXIS_OFFSET = _AXIS_RANGE // 2
EMPTY_KEY = 2 ** 31 - 1                # int32; sorts to the back


class CellMap(NamedTuple):
    cell_size: float            # box size (the reference's m_resolution × 2)
    keys: torch.Tensor          # (C,) int32, ascending; EMPTY_KEY = free
    count: torch.Tensor         # (C,) float32: points appended
    sum_p: torch.Tensor         # (C, 3)
    sum_pp: torch.Tensor        # (C, 3, 3)
    pts: torch.Tensor           # (C, P, 3) ring pool
    last_update_frame: torch.Tensor  # (C,) int32
    create_frame: torch.Tensor       # (C,) int32
    frame_idx: torch.Tensor     # () int32: frames appended so far

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def pool_size(self) -> int:
        return self.pts.shape[1]

    def valid(self) -> torch.Tensor:
        return self.keys != EMPTY_KEY

    def n_cells(self) -> torch.Tensor:
        return self.valid().sum()

    def centers(self) -> torch.Tensor:
        """(C, 3) cell centres decoded from the keys."""
        k = torch.where(self.valid(), self.keys, torch.zeros_like(self.keys))
        coords = torch.stack([(k >> (2 * _AXIS_BITS)) & (_AXIS_RANGE - 1),
                              (k >> _AXIS_BITS) & (_AXIS_RANGE - 1),
                              k & (_AXIS_RANGE - 1)], dim=-1) - _AXIS_OFFSET
        return (coords.to(torch.float32) + 0.5) * self.cell_size


def empty_cell_map(cell_size: float, capacity: int = 8192, pool_size: int = 32,
                   device=None) -> CellMap:
    f32 = dict(dtype=torch.float32, device=device)
    return CellMap(
        cell_size=float(cell_size),
        keys=torch.full((capacity,), EMPTY_KEY, dtype=torch.int32, device=device),
        count=torch.zeros((capacity,), **f32),
        sum_p=torch.zeros((capacity, 3), **f32),
        sum_pp=torch.zeros((capacity, 3, 3), **f32),
        pts=torch.zeros((capacity, pool_size, 3), **f32),
        last_update_frame=torch.zeros((capacity,), dtype=torch.int32, device=device),
        create_frame=torch.zeros((capacity,), dtype=torch.int32, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def point_keys(m: CellMap, xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N,) int32 cell keys of the points, ``EMPTY_KEY`` where masked.
    The cell centre is ``i·size + size/2`` (reference `find_cell_center`,
    :556-571)."""
    # a device divisor: CUDA would multiply by a host scalar's reciprocal
    size = torch.full((), m.cell_size, dtype=xyz.dtype, device=xyz.device)
    coords = torch.round(xyz / size - 0.5).to(torch.int32)
    c = torch.clamp(coords + _AXIS_OFFSET, 0, _AXIS_RANGE - 1)
    keys = (c[:, 0] << (2 * _AXIS_BITS)) | (c[:, 1] << _AXIS_BITS) | c[:, 2]
    return torch.where(mask, keys, torch.full_like(keys, EMPTY_KEY))


def _lookup(keys_sorted: torch.Tensor, query: torch.Tensor):
    """(slot, found) of each query key in the sorted directory."""
    slot = torch.clamp(torch.searchsorted(keys_sorted, query), max=keys_sorted.shape[0] - 1)
    return slot, keys_sorted[slot] == query


def append_cloud(m: CellMap, batch: PointBatch, revisit_threshold: int,
                 max_new: int = 1024):
    """Insert a world-frame batch (reference ``append_cloud``,
    cell_map_keyframe.hpp:619-672): create missing cells (at most
    ``max_new``, the smallest new keys first; on overflow the directory
    keeps its smallest keys), reset revisited cells, add the moments,
    write the pools, bump ``frame_idx``.

    Returns ``(map, touched3)``: the (C,) mask of slots that received at
    least 3 points (the keyframe cell-membership signal, :646-668)."""
    C, P = m.capacity, m.pool_size
    dev = m.keys.device
    pkeys = point_keys(m, batch.xyz, batch.mask)

    # unique new keys, ascending, at most max_new
    sk = torch.sort(pkeys).values
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    _, exists = _lookup(m.keys, sk)
    new_mask = first & (sk != EMPTY_KEY) & ~exists
    order = torch.argsort((~new_mask).to(torch.uint8), stable=True)
    new_keys = torch.where(new_mask[order], sk[order],
                           torch.full_like(sk, EMPTY_KEY))[:max_new]

    # merged directory; every per-cell array follows its key from the old slot
    merged = torch.sort(torch.cat([m.keys, new_keys])).values[:C]
    old_slot, old_found = _lookup(m.keys, merged)

    def carry(arr):
        found = old_found.reshape((C,) + (1,) * (arr.dim() - 1))
        return torch.where(found, arr[old_slot], torch.zeros((), dtype=arr.dtype, device=dev))

    count, sum_p, sum_pp, pts = (carry(a) for a in (m.count, m.sum_p, m.sum_pp, m.pts))
    last_upd = carry(m.last_update_frame)
    frame = m.frame_idx
    created = torch.where(old_found, carry(m.create_frame), frame)

    # revisit reset (reference find_cell if_treat_revisit, :734-755)
    pslot, pfound = _lookup(merged, pkeys)
    pvalid = pfound & (pkeys != EMPTY_KEY)
    seg = torch.where(pvalid, pslot, torch.full_like(pslot, C)).long()   # C: drop bucket
    touched = torch.zeros((C + 1,), dtype=torch.bool, device=dev).index_fill_(0, seg, True)[:C]
    stale = touched & old_found & ((frame - last_upd) >= revisit_threshold)
    zero = torch.zeros((), device=dev)
    count = torch.where(stale, zero, count)
    sum_p = torch.where(stale[:, None], zero, sum_p)
    sum_pp = torch.where(stale[:, None, None], zero, sum_pp)
    pts = torch.where(stale[:, None, None], zero, pts)
    created = torch.where(stale, frame, created)
    last_upd = torch.where(touched, frame, last_upd)

    # moments: this frame's per-cell sums, each in input order, then added
    w = pvalid.to(torch.float32)
    xyz = torch.where(pvalid[:, None], batch.xyz, zero)
    f32 = dict(dtype=torch.float32, device=dev)
    added = segment_sum(torch.zeros((C + 1,), **f32), seg, w)[:C]
    count = count + added
    sum_p = sum_p + segment_sum(torch.zeros((C + 1, 3), **f32), seg, xyz)[:C]
    outer = xyz[:, :, None] * xyz[:, None, :]
    sum_pp = sum_pp + segment_sum(torch.zeros((C + 1, 3, 3), **f32), seg, outer)[:C]

    # pool ring: a point's position is (count before this frame + its rank
    # in its cell) mod P.  A cell that takes more than P points writes a
    # position again; the last write (highest rank) wins, as in an
    # in-order scatter, so only ranks >= added - P are written and the
    # indices stay unique (CUDA's index_put_ is unordered on duplicates).
    ord2 = torch.argsort(seg, stable=True)
    slot_s = pslot[ord2]
    valid_s = pvalid[ord2]
    new_seg = torch.ones_like(valid_s)
    new_seg[1:] = slot_s[1:] != slot_s[:-1]
    idx_all = torch.arange(slot_s.shape[0], device=dev)
    seg_start = torch.cummax(torch.where(new_seg, idx_all, torch.zeros_like(idx_all)), 0).values
    rank = idx_all - seg_start
    added_s = added[slot_s]
    base = (count - added)[slot_s]
    pos = (base.to(torch.int64) + rank) % P
    write = valid_s & (rank >= added_s.to(torch.int64) - P)
    flat = torch.where(write, slot_s * P + pos, torch.full_like(pos, C * P))
    pool = torch.cat([pts.reshape(C * P, 3), torch.zeros((1, 3), **f32)])
    pool[flat] = torch.where(write[:, None], batch.xyz[ord2], zero)
    pts = pool[:C * P].reshape(C, P, 3)

    return CellMap(cell_size=m.cell_size, keys=merged, count=count, sum_p=sum_p,
                   sum_pp=sum_pp, pts=pts, last_update_frame=last_upd,
                   create_frame=created, frame_idx=m.frame_idx + 1), added >= 3.0


def skip_frame(m: CellMap) -> CellMap:
    """`append_cloud` of a batch with no valid point: only the frame
    index moves (every free slot holds the same zeros, so the merge
    leaves the arrays as they are, and no slot is touched).  The
    odometry step appends with a mask gated by admission instead, so
    that a step has no branch; this is what such an append leaves."""
    return m._replace(frame_idx=m.frame_idx + 1)


def member_mask_from_keys(m: CellMap, keys: torch.Tensor) -> torch.Tensor:
    """(C,) bool: slots whose key appears in ``keys`` (padded with
    ``EMPTY_KEY``).  Keyframes keep member-cell keys, which survive
    directory re-sorts; this binds them to the current slots."""
    slot, found = _lookup(m.keys, keys)
    ok = found & (keys != EMPTY_KEY)
    out = torch.zeros((m.capacity + 1,), dtype=torch.bool, device=m.keys.device)
    return out.index_fill_(0, torch.where(ok, slot, torch.full_like(slot, m.capacity)),
                           True)[:m.capacity]


class CellFeatures(NamedTuple):
    mean: torch.Tensor          # (C, 3)
    cov: torch.Tensor           # (C, 3, 3) singularity-avoided
    eig_val: torch.Tensor       # (C, 3) ascending, raw
    eig_vec: torch.Tensor       # (C, 3, 3) columns, each up to sign
    feature_type: torch.Tensor  # (C,) int32: SPHERE, LINE or PLANE
    feature_dir: torch.Tensor   # (C, 3) plane normal / line direction


def cell_features(m: CellMap, threshold_line: float = 1.0 / 3.0,
                  threshold_plane: float = 1.0 / 3.0,
                  incremental: bool = True) -> CellFeatures:
    """Per-cell mean, covariance, eigen-decomposition and line / plane /
    sphere class (reference ``get_covmat`` :281-315,
    ``get_cov_mat_avoid_singularity`` :251-279, ``determine_feature``
    :436-473).  ``incremental`` (``common/if_update_mean_and_cov_incrementally``)
    takes the lifetime moments; otherwise the moments of the retained
    pool.  The class reads the raw eigenvalues; the singularity fix
    (eigenvalues at least 1 % of the largest) applies only to ``cov``."""
    dev = m.keys.device
    if incremental:
        count, sum_p, sum_pp = m.count, m.sum_p, m.sum_pp
    else:
        P = m.pool_size
        have = (torch.arange(P, device=dev)[None, :]
                < torch.clamp(m.count, max=float(P))[:, None])
        pool = torch.where(have[:, :, None], m.pts, torch.zeros((), device=dev))
        count = have.sum(dim=1).to(torch.float32)
        sum_p = pool.sum(dim=1)
        sum_pp = torch.einsum("cpi,cpj->cij", pool, pool)
    n = torch.clamp(count, min=1.0)
    mean = sum_p / n[:, None]
    denom = torch.clamp(count - 1.0, min=1.0)
    cov = (sum_pp - count[:, None, None] * mean[:, :, None] * mean[:, None, :]) \
        / denom[:, None, None]
    few = count < 5
    cov = torch.where(few[:, None, None], torch.eye(3, device=dev), cov)
    cov = 0.5 * (cov + cov.transpose(-1, -2))

    val, vec = torch.linalg.eigh(cov)          # ascending eigenvalues
    # NDT singularity avoidance [Magnusson 2009, eq. 6.11], factor 0.01
    val_fix = torch.maximum(val, 0.01 * val[:, 2:3])
    cov_fix = torch.einsum("cij,cj,ckj->cik", vec, val_fix, vec)

    # the reference compares with m_resolution·0.75, its half box size
    center_far = torch.linalg.vector_norm(m.centers() - mean, dim=-1) > m.cell_size * 0.5 * 0.75
    is_plane = val[:, 1] * threshold_plane > val[:, 0]
    is_line = val[:, 2] * threshold_line > val[:, 1]
    usable = ~few & ~center_far & m.valid()
    ftype = torch.where(usable & is_plane, FEATURE_PLANE,
                        torch.where(usable & is_line, FEATURE_LINE, FEATURE_SPHERE)
                        ).to(torch.int32)
    fdir = torch.where((ftype == FEATURE_PLANE)[:, None], vec[:, :, 0],
                       torch.where((ftype == FEATURE_LINE)[:, None], vec[:, :, 2],
                                   torch.zeros((), device=dev)))
    return CellFeatures(mean=mean, cov=cov_fix, eig_val=val, eig_vec=vec,
                        feature_type=ftype, feature_dir=fdir)


def cells_in_radius(m: CellMap, center: torch.Tensor, radius: float) -> torch.Tensor:
    """(C,) bool: valid cells whose centre lies within ``radius``
    (reference ``find_cells_in_radius``, :760-788)."""
    d = torch.linalg.vector_norm(m.centers() - center[None, :], dim=-1)
    return m.valid() & (d < radius)


def cells_in_fov(m: CellMap, t_w: torch.Tensor, q_w: torch.Tensor,
                 max_angle_deg: float) -> torch.Tensor:
    """(C,) bool: valid cells whose centre ray lies within
    ``max_angle_deg`` of the body +X axis, or whose centre is within
    1e-6 of the sensor (reference ``if_pt_in_fov``,
    laser_mapping.hpp:310-324)."""
    rel = m.centers() - t_w[None, :]
    # the body +X axis; torch.eye builds it on the device (a list would be
    # a blocking host copy)
    fwd = se3.quat_rotate(q_w, torch.eye(3, device=t_w.device)[0])
    dn = torch.linalg.vector_norm(rel, dim=-1)
    cosang = (rel * fwd[None, :]).sum(dim=-1) / torch.clamp(dn, min=1e-9)
    # the gate in f32 (degrees times f32 π/180), as the JAX package has it
    f32 = dict(dtype=torch.float32)
    cos_gate = float(torch.cos(torch.tensor(max_angle_deg, **f32)
                               * torch.tensor(math.pi / 180, **f32)))
    return m.valid() & ((cosang > cos_gate) | (dn < 1e-6))


def gather_cell_points(m: CellMap, cell_mask: torch.Tensor) -> PointBatch:
    """The pools of the selected cells as one (C·P)-row masked batch
    with a zero time channel (the matching-buffer gather, reference
    laser_mapping.hpp:482-515; the caller voxel-filters it)."""
    C, P = m.capacity, m.pool_size
    dev = m.keys.device
    have = torch.arange(P, device=dev)[None, :] < torch.clamp(m.count, max=float(P))[:, None]
    mask = have & cell_mask[:, None] & m.valid()[:, None]
    return PointBatch(xyz=m.pts.reshape(C * P, 3),
                      time=torch.zeros((C * P,), device=dev),
                      mask=mask.reshape(C * P))
