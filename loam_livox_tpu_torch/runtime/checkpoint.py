"""Checkpoint and resume, the counterpart of
``loam_livox_tpu/runtime/checkpoint.py`` (the reference's "maps saving
and reload", ``Points_cloud_map::save_to_file`` /
``load_mapping_from_file``, ``cell_map_keyframe.hpp:818-960``).

* `save_state` / `load_state`: the whole `OdometryState` with
  ``torch.save`` (the JAX package uses orbax): pose, history ring,
  matching buffers, cell maps (``None`` where the configuration keeps
  none), the counters and the cell maps' frame index (device scalars; a
  file that holds them as host integers loads too), and the threefry
  key of residual subsampling (`ops.threefry`), a tensor like the
  others.  A resumed run continues bit for bit, and the key's draws are
  the same numbers on the CPU and on the card, so a state moved between
  them continues the same subsample stream.  A file of the port's
  earlier format, which held a ``torch.Generator``'s state in place of
  the key, loads with ``PRNGKey(0)`` (`load_state` warns when
  ``subsample_residuals`` > 0, where that restarts the stream).  The
  format is the port's own; the JAX package reads the state through
  ``interop.state_from_numpy``'s field names, not this file.
* `save_loop_state` / `load_loop_state`: the loop service's host state
  in the JAX package's ``.npz`` layout (``checkpoint.py:73-187``), so a
  file written by either package loads in the other.
* `save_pipeline` / `load_pipeline`: both together (the JAX
  ``:189-248``), after a flush that also drains the loop worker.
* `export_reference_map`: the plane cell map in the reference's JSON.

With the capacity schedule active (`runtime.capacity_schedule`),
`save_pipeline` also writes the tier the state's buffers are shaped at
(``capacity_scale.txt``, the JAX package's file), and `load_pipeline`
restores that tier before it loads the state (scale 1, the configured
capacities, when the file is missing); the resumed pipeline's next
check comes 4 units later, as a fresh JAX pipeline's does.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..core import accounting
from ..core.config import SlamConfig
from ..core.types import PointBatch, resolve_device
from ..map.cell_map import EMPTY_KEY, CellMap
from .loop_service import LoopCloser
from ..ops.bucket_grid import BucketGrid
from .odometry import OdometryState, init_state

#: host reads of the restored frame counter since the last reset
SYNCS = {"resume": 0}

# ---- the odometry state ------------------------------------------------------


def _pack(value):
    """A state field as plain tensors, numbers and dicts (host tensors)."""
    if value is None or isinstance(value, (int, float)):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, (PointBatch, CellMap, BucketGrid)):
        return {f: _pack(getattr(value, f)) for f in value._fields}
    raise TypeError(f"cannot checkpoint a {type(value).__name__}")


def save_state(state: OdometryState, path: str) -> None:
    """Write the state to ``path`` (one ``torch.save`` file)."""
    torch.save({f: _pack(getattr(state, f)) for f in state._fields}, path)


def _unpack(saved, ref, name: str, device):
    """``saved`` rebuilt like ``ref`` (the fresh state's field) on
    ``device``; every tensor's shape must equal the reference's."""
    if ref is None or saved is None:
        if (ref is None) != (saved is None):
            raise ValueError(f"checkpoint field {name}: {'no' if saved is None else 'a'} "
                             "cell map or bucket grid where the config has "
                             f"{'none' if ref is None else 'one'}")
        return None
    if isinstance(ref, (PointBatch, CellMap, BucketGrid)):
        return type(ref)(**{f: _unpack(saved[f], getattr(ref, f), f"{name}.{f}", device)
                            for f in ref._fields})
    if isinstance(ref, torch.Tensor):
        if not isinstance(saved, torch.Tensor):
            # a counter or a cell map's frame index saved as a host int
            saved = torch.tensor(saved)
        if tuple(saved.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint shape {tuple(saved.shape)} of {name} != config "
                             f"shape {tuple(ref.shape)}: capacities differ")
        return saved.to(device=device, dtype=ref.dtype)
    return type(ref)(saved)


def load_state(path: str, cfg: SlamConfig, device=None) -> OdometryState:
    """A state written by `save_state`, on ``device`` (the card unless the
    CPU is asked for).  ``cfg`` must have the capacities the state was
    written with: any shape that differs raises ``ValueError``."""
    dev = resolve_device(device)
    saved = torch.load(path, map_location="cpu", weights_only=True)
    ref = init_state(cfg, dev)
    if isinstance(saved.get("rng"), dict):
        # the earlier format: a torch.Generator's state in place of the key
        if cfg.optimization.subsample_residuals > 0:
            warnings.warn(
                "state file of the earlier format (a torch.Generator's state, not the "
                "threefry key): the resumed run draws from PRNGKey(0), another subsample "
                "stream than the saved run would have")
        saved = {**saved, "rng": ref.rng.cpu()}
    return OdometryState(**{f: _unpack(saved[f], getattr(ref, f), f, dev)
                            for f in ref._fields})


def export_reference_map(state: OdometryState, path: str) -> int:
    """Write the plane cell map in the reference's JSON schema; with no
    plane map (history matching without loop closure) the empty
    document the JAX package writes for its 1-slot map."""
    from ..io.serialization import save_cell_map_json

    return save_cell_map_json(state.cell_planes, path)


# ---- the loop service --------------------------------------------------------

#: the dtypes of the JAX package's descriptor fields in the file
_DESCRIPTOR_DTYPES = {"ratio_nonzero_line": np.float32, "ratio_nonzero_plane": np.float32,
                      "roi_range": np.float32, "n_cells": np.int32, "n_line": np.int32,
                      "n_plane": np.int32}


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _member_keys(keys) -> np.ndarray:
    """The distinct keys of a key tensor, ascending, without padding."""
    k = _host(keys).astype(np.int64).reshape(-1)
    return np.unique(k[k != EMPTY_KEY])


def save_loop_state(closer: LoopCloser, path: str) -> None:
    """Write the service's host state to ``path`` (one ``.npz``, the JAX
    package's layout): the keyframe records with descriptors and era
    snapshots, the waiting records, the open accumulators' keys and
    frame counts, the one-shot flag and the result.  Call it with the
    service drained (`save_pipeline` flushes first)."""
    arrays = {}
    meta = {"closed": closer.closed, "dropped_keyframes": closer.dropped_keyframes,
            "pair_idx": closer._pair_idx, "n_keyframes": len(closer.keyframes),
            "n_waiting": len(closer.waiting),
            "updating": [{"frames": acc.frames} for acc in closer.updating],
            "result": None}
    if closer.result is not None:
        r = closer.result
        meta["result"] = {"accepted": r.accepted, "his_idx": r.his_idx,
                          "cur_idx": r.cur_idx, "icp_score": r.icp_score}
        if r.q_opt is not None:
            arrays["result_q_opt"] = np.asarray(r.q_opt)
            arrays["result_t_opt"] = np.asarray(r.t_opt)

    def pack_record(prefix: str, rec) -> None:
        arrays[f"{prefix}_keys"] = _member_keys(rec.keys).astype(np.int32)
        arrays[f"{prefix}_q"] = _host(rec.q).astype(np.float32)
        arrays[f"{prefix}_t"] = _host(rec.t).astype(np.float32)
        arrays[f"{prefix}_end"] = np.int64(rec.ending_frame_idx)
        if rec.descriptor is not None:
            for fname, val in zip(rec.descriptor._fields, rec.descriptor):
                arrays[f"{prefix}_d_{fname}"] = _host(val).astype(
                    _DESCRIPTOR_DTYPES.get(fname, np.float32))
        for s in ("snap_line", "snap_plane", "snap_full"):
            v = getattr(rec, s)
            if v is not None:
                arrays[f"{prefix}_{s}"] = np.asarray(v, np.float32)

    for i, rec in enumerate(closer.keyframes):
        pack_record(f"kf{i}", rec)
    for i, item in enumerate(closer.waiting):
        pack_record(f"wait{i}", item[0])
    for i, acc in enumerate(closer.updating):
        arrays[f"acc{i}_keys"] = (_member_keys(torch.cat([k.cpu() for k in acc.frame_keys]))
                                  if acc.frame_keys else np.zeros(0, np.int64))
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_loop_state(path: str, cfg: SlamConfig, cell_map: Optional[CellMap] = None,
                    device=None) -> LoopCloser:
    """A new `LoopCloser` on ``device`` holding the state of a file written
    by `save_loop_state` (either package's).  ``cell_map`` (the resumed
    run's full-cloud cell map) is attached to restored waiting keyframes;
    without one they are dropped when the service reaches them, as a
    waiting-list overflow is.  The restored tensors are copied on the
    frame stream, which is synchronised before the service may read
    them on its own stream."""
    from ..interop import loop_state_from_npz

    closer = LoopCloser(cfg, device=device)
    dev = closer.device
    saved = loop_state_from_npz(path, dev)
    event = None
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
        if closer._stream is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
    with closer._lock:
        closer.keyframes = list(saved.keyframes)
        closer.updating = list(saved.updating)
        closer.closed = saved.closed
        closer.dropped_keyframes = saved.dropped_keyframes
        closer.result = saved.result
        closer._pair_idx = saved.pair_idx
        closer.waiting = [(rec, cell_map, event) for rec in saved.waiting]
        closer._work.notify_all()
    return closer


# ---- the whole pipeline -----------------------------------------------------

def save_pipeline(pipe, directory: str) -> None:
    """Checkpoint an `OdometryPipeline`: flush (which dispatches a partial
    chunk or group and drains the loop worker), then the odometry state
    (``odometry``, the port's format) and, with loop closure, the loop
    service (``loop_state.npz``, the shared format).  In product mode
    every rank calls it: the state is gathered from the ranks' slices
    (`parallel.layout.gather_state`), rank 0 writes, and every rank
    returns once the files are there."""
    pipe.flush()
    state = pipe._live()
    if pipe.mesh is None or pipe.mesh.rank == 0:
        os.makedirs(directory, exist_ok=True)
        save_state(state, os.path.join(directory, "odometry"))
        if pipe.scheduler is not None:
            with open(os.path.join(directory, "capacity_scale.txt"), "w") as f:
                f.write(str(pipe.scheduler.scale))
        if pipe.loop_closer is not None:
            save_loop_state(pipe.loop_closer, os.path.join(directory, "loop_state.npz"))
    if pipe.mesh is not None:
        import torch.distributed as dist

        dist.barrier()          # every rank returns once the files are written


def load_pipeline(directory: str, cfg: SlamConfig, device=None, mesh=None):
    """A new pipeline resumed from a directory written by `save_pipeline`
    (at its capacity tier); in product mode every rank loads the file and
    keeps its slices."""
    from .pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg, device=device, mesh=mesh)
    if pipe.scheduler is not None:
        # the tier the saved buffers are shaped at; a directory without
        # the file holds a state at the configured capacities
        scale_path = os.path.join(directory, "capacity_scale.txt")
        scale = 1
        if os.path.exists(scale_path):
            with open(scale_path) as f:
                scale = int(f.read().strip())
        pipe.scheduler.set_scale(scale)
        pipe.cfg_active = pipe.scheduler.cfg
    pipe.state = load_state(os.path.join(directory, "odometry"), pipe.cfg_active, pipe.device)
    loop_path = os.path.join(directory, "loop_state.npz")
    if pipe.loop_closer is not None and os.path.exists(loop_path):
        pipe.loop_closer.shutdown()
        pipe.loop_closer = load_loop_state(loop_path, cfg, cell_map=pipe._live().cell_full,
                                           device=pipe.device)
    # frame_count counts odometry steps (pieces); the pipeline's frame
    # index counts raw frames (the JAX rule, checkpoint.py:240-247)
    c = cfg.common
    pieces = (1 if (c.if_motion_deblur or c.odom_mode == 0 or c.lidar_type == "velodyne")
              else max(1, c.piecewise_number))
    accounting.count(SYNCS, "resume")
    pipe._frame_idx = int(pipe._live().frame_count) // pieces
    return pipe
