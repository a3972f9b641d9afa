"""Grid-hash bucketed kNN: the correspondence engine ``grid``
(``optimization/correspondence``), the counterpart of the JAX package's
``ops/bucket_grid.py``.

The matching buffer's points are binned into a sorted directory of
voxel buckets (the sorted-integer-key design of `map.cell_map`); a
query then inspects only the 27 buckets around it: a few hundred
candidates instead of the whole buffer.

Correctness domain: neighbours are found only within ±1 bucket (at
least ``bucket_size`` in every direction).  With ``bucket_size`` at
least 2.5× the voxel leaf of the stored points, a bucket holds at most
~15 points and the 27 buckets hold the true k nearest wherever the map
is locally dense; in sparse regions far matches are missed, the regime
the reference drops with its match-distance gates
(``point_cloud_registration.hpp:64-65``).

Plain torch ops on both devices, at fixed shapes and with no host read
(the frame program captures the build under its rebuild): sort, run
starts, rank in run, a directory write that drops overflow into dump
rows sliced off after, then
per query a ``searchsorted`` over the 27 neighbour keys, a
``(Q, 27, P, 3)`` gather and a top-k that breaks ties as ``lax.top_k``
does (the lower candidate position first).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

BIG = 1e30

_AXIS_BITS = 10
_AXIS_RANGE = 1 << _AXIS_BITS
_AXIS_OFFSET = _AXIS_RANGE // 2
EMPTY_KEY = 2 ** 31 - 1


class BucketGrid(NamedTuple):
    """Sorted bucket directory over a fixed point set."""

    bucket_size: float          # host float
    keys: torch.Tensor          # (B,) int32 ascending, EMPTY_KEY = free
    pts: torch.Tensor           # (B, P, 3) float32
    src_idx: torch.Tensor       # (B, P) int32: index into the source batch
    slot_mask: torch.Tensor     # (B, P) bool

    @property
    def n_buckets(self) -> int:
        return self.keys.shape[0]

    @property
    def bucket_cap(self) -> int:
        return self.pts.shape[1]


def _coords(xyz: torch.Tensor, size: float) -> torch.Tensor:
    size = torch.full((), size, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / size).to(torch.int32)


def _pack(coords: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(coords + _AXIS_OFFSET, 0, _AXIS_RANGE - 1)
    return (c[..., 0] << (2 * _AXIS_BITS)) | (c[..., 1] << _AXIS_BITS) | c[..., 2]


def build_bucket_grid(xyz: torch.Tensor, mask: torch.Tensor, bucket_size: float,
                      n_buckets: int, bucket_cap: int) -> BucketGrid:
    """Bin a masked point batch into the bucket directory.  Points past
    ``bucket_cap`` in one bucket (later in sort order), and buckets past
    ``n_buckets``, are dropped.  Fixed shapes and no host read, as the
    JAX build scatters with ``mode="drop"``: every point is written, a
    dropped one to a dump row past ``n_buckets * bucket_cap`` (and each
    non-head to a dump slot past the directory), sliced off after; the
    kept rows are unique, so the scatter's order decides nothing kept."""
    dev = xyz.device
    n = xyz.shape[0]
    n_rows = n_buckets * bucket_cap
    empty = torch.full((), EMPTY_KEY, dtype=torch.int32, device=dev)
    keys = torch.where(mask, _pack(_coords(xyz, bucket_size)), empty)

    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ks[1:] != ks[:-1]])
    first = first & (ks != EMPTY_KEY)
    bucket_of = (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int64)
    idx_all = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(first, idx_all, torch.zeros_like(idx_all)), 0).values
    rank = idx_all - seg_start

    valid = (ks != EMPTY_KEY) & (bucket_of < n_buckets) & (rank < bucket_cap)
    flat = torch.where(valid, bucket_of * bucket_cap + rank, torch.full_like(rank, n_rows))
    head = first & (bucket_of < n_buckets)
    slot = torch.where(head, bucket_of, torch.full_like(bucket_of, n_buckets))

    dir_keys = torch.full((n_buckets + 1,), EMPTY_KEY, dtype=torch.int32, device=dev)
    dir_keys[slot] = ks
    pts = torch.zeros((n_rows + 1, 3), dtype=torch.float32, device=dev)
    src = torch.zeros((n_rows + 1,), dtype=torch.int32, device=dev)
    smask = torch.zeros((n_rows + 1,), dtype=torch.bool, device=dev)
    pts[flat] = xyz[order].to(torch.float32)
    src[flat] = order.to(torch.int32)
    smask[flat] = valid
    return BucketGrid(bucket_size=float(bucket_size), keys=dir_keys[:n_buckets],
                      pts=pts[:n_rows].reshape(n_buckets, bucket_cap, 3),
                      src_idx=src[:n_rows].reshape(n_buckets, bucket_cap),
                      slot_mask=smask[:n_rows].reshape(n_buckets, bucket_cap))


def _neighbor_offsets(device) -> torch.Tensor:
    """The 27 (dx, dy, dz) in {-1, 0, 1}³, dz fastest: made on the device
    (a host list copied up could not be captured)."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=device)
    return torch.stack([a.reshape(-1) for a in torch.meshgrid(r, r, r, indexing="ij")],
                       dim=1)                                      # (27, 3)


def grid_knn(query_xyz: torch.Tensor, grid: BucketGrid, k: int = 5):
    """The k nearest neighbours of each query within its 27-bucket
    neighbourhood: (squared distances (Q, k) ascending, BIG where there
    are fewer than k candidates, and source indices (Q, k) int32).
    Queries may carry a leading lane axis, (L, Q, 3)."""
    if query_xyz.dim() == 3:
        d, i = grid_knn(query_xyz.reshape(-1, 3), grid, k)
        return (d.reshape(query_xyz.shape[:2] + (k,)),
                i.reshape(query_xyz.shape[:2] + (k,)))
    q = query_xyz.to(torch.float32)
    nq = q.shape[0]
    P = grid.bucket_cap

    nkeys = _pack(_coords(q, grid.bucket_size)[:, None, :]
                  + _neighbor_offsets(q.device)[None])          # (Q, 27)
    slot = torch.searchsorted(grid.keys, nkeys)
    slot = torch.clamp(slot, 0, grid.n_buckets - 1)
    found = grid.keys[slot] == nkeys

    cand_pts = grid.pts[slot]                                    # (Q, 27, P, 3)
    cand_idx = grid.src_idx[slot].reshape(nq, 27 * P)
    cand_ok = grid.slot_mask[slot] & found[:, :, None]
    diff = cand_pts - q[:, None, None, :]
    d = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
    d = torch.where(cand_ok, d, torch.full_like(d, BIG)).reshape(nq, 27 * P)

    # top-k by (distance, position), as lax.top_k breaks ties
    d_s, pos = torch.sort(d, dim=1, stable=True)
    pos = pos[:, :k]
    idx = torch.gather(cand_idx, 1, pos)
    return torch.clamp(d_s[:, :k], min=0.0), idx
