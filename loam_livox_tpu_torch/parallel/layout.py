"""The product layout of the odometry state over a mesh's ranks (the
counterpart of ``loam_livox_tpu/parallel/layout.py``).

The point, cell and bucket axes shard: the history ring's per-frame
point axis, the matching buffer's point axis, the cell maps' directory
axis with their touched mask, and the bucket grids' bucket axis.  The
pose, the counters, the ring's window axis (a time axis), host scalars
and the threefry key replicate, as does an axis of one slot or one that
the world size does not divide.

In the port a sharded field is a slice: each rank keeps rows
``[rank·n/size, (rank+1)·n/size)`` of it (`shard_state`), and
`gather_state` all-gathers the slices back into the whole state, which
the pipeline's step and its checkpoint read.  `state_axes` says, field
by field, which axis a rank slices (``None``: replicated).  The frame
program (`runtime.frame_program`) captures the in-place forms over its
static buffers: `gather_state_into` all-gathers the slices into a whole
state's tensors (one ``all_gather_into_tensor`` a sharded field, no
list), `shard_state_into` copies this rank's rows back into the slices.
A replicated field of slices made by `shard_state` is the whole state's
own tensor, so neither copies it.
"""
from __future__ import annotations

from typing import Any

import torch

from ..core.types import PointBatch
from ..map.cell_map import CellMap
from ..ops.bucket_grid import BucketGrid
from .mesh import Mesh
from .sharded import all_gather, concat_ranks


def _ax(n: int, size: int, axis: int):
    """``axis`` when an axis of ``n`` rows shards over ``size`` ranks."""
    return axis if n > 1 and n % size == 0 else None


def batch_axes(b: PointBatch, size: int) -> PointBatch:
    a = _ax(b.capacity, size, 0)
    return PointBatch(xyz=a, time=a, mask=a)


def cell_map_axes(m: CellMap | None, size: int):
    if m is None:
        return None
    a = _ax(m.capacity, size, 0)
    return CellMap(cell_size=None, keys=a, count=a, sum_p=a, sum_pp=a, pts=a,
                   last_update_frame=a, create_frame=a, frame_idx=None)


def bucket_grid_axes(g: BucketGrid | None, size: int):
    if g is None:
        return None
    a = _ax(g.n_buckets, size, 0)
    return BucketGrid(bucket_size=None, keys=a, pts=a, src_idx=a, slot_mask=a)


def state_axes(state, size: int):
    """The axis each `OdometryState` field shards on (module doc)."""
    ch = _ax(state.hist_corner_xyz.shape[1], size, 1)
    sh = _ax(state.hist_surf_xyz.shape[1], size, 1)
    replicated = {name: None for name in state._fields}
    return type(state)(**{
        **replicated,
        "hist_corner_xyz": ch, "hist_corner_mask": ch,
        "hist_surf_xyz": sh, "hist_surf_mask": sh,
        "cell_corners": cell_map_axes(state.cell_corners, size),
        "cell_planes": cell_map_axes(state.cell_planes, size),
        "cell_full": cell_map_axes(state.cell_full, size),
        "last_touched": (None if state.last_touched is None
                         else _ax(state.last_touched.shape[0], size, 0)),
        "map_corners": batch_axes(state.map_corners, size),
        "map_surface": batch_axes(state.map_surface, size),
        "grid_corners": bucket_grid_axes(state.grid_corners, size),
        "grid_surface": bucket_grid_axes(state.grid_surface, size),
    })


def _map(fn, tree: Any, axes: Any):
    """``fn(leaf, axis)`` over the tensors of a NamedTuple tree whose
    axis is set; everything else passes through."""
    if axes is None or tree is None:
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x, a) for x, a in zip(tree, axes)))
    return fn(tree, axes) if isinstance(tree, torch.Tensor) else tree


def shard_state(state, mesh: Mesh):
    """``(slices, axes)``: this rank's slice of every sharded tensor (a
    copy: the whole tensor is not kept) and the layout to gather it by."""
    def take(x, axis):
        m = x.shape[axis] // mesh.size
        return x.narrow(axis, mesh.rank * m, m).clone()

    axes = state_axes(state, mesh.size)
    return _map(take, state, axes), axes


def gather_state(state, axes, mesh: Mesh):
    """The whole state from every rank's slices, in rank order.  A
    collective: every rank calls it."""
    return _map(lambda x, axis: concat_ranks(all_gather(x, mesh), axis), state, axes)


def _zip(fn, axes: Any, *trees):
    """``fn(axis, *leaves)`` over the tensors of NamedTuple trees of one
    structure whose axis is set."""
    if axes is None or trees[0] is None:
        return
    if isinstance(trees[0], tuple) and hasattr(trees[0], "_fields"):
        for parts in zip(axes, *trees):
            _zip(fn, *parts)
    elif isinstance(trees[0], torch.Tensor):
        fn(axes, *trees)


def gather_state_into(slices, whole, axes, mesh: Mesh) -> None:
    """`gather_state` written into ``whole``'s tensors in place (a
    collective).  A field sharded on its first axis is gathered straight
    into the whole tensor; another through one stacked buffer."""
    def gather(axis, part, out):
        if axis == 0 and out.is_contiguous():
            all_gather(part, mesh, out.view((mesh.size,) + tuple(part.shape)))
        else:
            out.copy_(concat_ranks(all_gather(part, mesh), axis))
    _zip(gather, axes, slices, whole)


def shard_state_into(whole, slices, axes, mesh: Mesh) -> None:
    """This rank's rows of ``whole``'s sharded tensors copied into
    ``slices`` in place (`shard_state` without new tensors)."""
    def take(axis, x, part):
        part.copy_(x.narrow(axis, mesh.rank * part.shape[axis], part.shape[axis]))
    _zip(take, axes, whole, slices)
