"""Configuration and state carried over from the JAX package, as plain
Python and numpy values (this module imports nothing of JAX).

* `config_from_dict` takes ``dataclasses.asdict`` of a JAX
  ``SlamConfig``: the two config trees share section and field names.
* `state_from_numpy` takes the JAX ``OdometryState`` fields as numpy
  arrays (``{name: np.asarray(value)}``; the matching buffers as
  ``map_corners.xyz`` / ``map_corners.mask`` and so on, the feature cell
  maps as ``cell_corners.keys`` / ``cell_corners.count`` and so on) and
  keeps the fields the port's state has.  This state is what a run
  carries from frame to frame: the system's counterpart of a model's
  weights.  The JAX rng key (``rng``, the two uint32 words of
  ``jax.random.key_data``) comes across as the port's threefry key
  (`ops.threefry`), whose draws are JAX's, so a teacher-forced step
  starts from JAX's own key; without one the key is ``PRNGKey(0)``,
  as in a new state.  `state_to_numpy` is the way back: the port's state
  as the same field names, the key among them.
  A JAX cell map of one slot (its placeholder when nothing reads the
  maps) becomes ``None``, the port's placeholder; so do the full-cloud
  map ``cell_full.*`` and ``last_touched`` of a run without loop closure.
  The bucket grids come across when the fields hold them
  (``grid_corners.keys``, ``.pts``, ``.src_idx``, ``.slot_mask``,
  ``.bucket_size``); give them for a ``grid`` run only, since the port
  keeps ``None`` under the other engines.
* `loop_state_from_npz` reads the loop service's state as the JAX
  package's ``runtime/checkpoint.save_loop_state`` writes it (one
  ``.npz``: ``kf{i}_*`` keyframe records with descriptors and era
  snapshots, ``wait{i}_*``, ``acc{i}_keys``, ``result_*`` and a JSON
  ``meta_json``), with numpy alone.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from .core.config import SlamConfig, from_dict
from .core.types import PointBatch
from .loop.keyframe import KeyframeDescriptor
from .map.cell_map import CellMap
from .ops.bucket_grid import BucketGrid
from .ops.threefry import prng_key
from .runtime.loop_service import KeyframeRecord, LoopClosureResult, _Accumulator, settle
from .runtime.odometry import OdometryState

#: the array fields of a cell map, as the JAX ``CellMap`` names them
CELL_MAP_ARRAYS = ("keys", "count", "sum_p", "sum_pp", "pts",
                   "last_update_frame", "create_frame")


def config_from_dict(d: Dict[str, Any]) -> SlamConfig:
    return from_dict(d)


def cell_map_from_numpy(fields: Dict[str, np.ndarray], prefix: str, device):
    """The cell map under ``prefix`` (``{prefix}.keys`` and so on, with
    ``{prefix}.cell_size`` and ``{prefix}.frame_idx``, the latter a ()
    int32 tensor on ``device``), or ``None`` for a one-slot placeholder."""
    keys = np.asarray(fields[f"{prefix}.keys"])
    if keys.shape[0] <= 1:
        return None
    arrays = {name: torch.as_tensor(np.asarray(fields[f"{prefix}.{name}"])).to(device)
              for name in CELL_MAP_ARRAYS}
    frame_idx = torch.as_tensor(np.asarray(fields[f"{prefix}.frame_idx"]),
                                dtype=torch.int32).reshape(()).to(device)
    return CellMap(cell_size=float(fields[f"{prefix}.cell_size"]), frame_idx=frame_idx,
                   **arrays)


def state_from_numpy(fields: Dict[str, np.ndarray], device) -> OdometryState:
    def t(name, dtype=torch.float32):
        return torch.as_tensor(np.asarray(fields[name]), dtype=dtype).to(device)

    def batch(prefix):
        xyz = t(f"{prefix}.xyz")
        time = (t(f"{prefix}.time") if f"{prefix}.time" in fields
                else torch.zeros(xyz.shape[0], device=device))
        return PointBatch(xyz=xyz, time=time, mask=t(f"{prefix}.mask", torch.bool))

    def cells(prefix):
        return (cell_map_from_numpy(fields, prefix, device)
                if f"{prefix}.keys" in fields else None)

    def grid(prefix):
        if f"{prefix}.keys" not in fields:
            return None
        return BucketGrid(bucket_size=float(np.asarray(fields[f"{prefix}.bucket_size"])),
                          keys=t(f"{prefix}.keys", torch.int32), pts=t(f"{prefix}.pts"),
                          src_idx=t(f"{prefix}.src_idx", torch.int32),
                          slot_mask=t(f"{prefix}.slot_mask", torch.bool))

    cell_full = cells("cell_full")
    return OdometryState(
        q_w=t("q_w"), t_w=t("t_w"),
        frame_count=t("frame_count", torch.int32),
        hist_corner_xyz=t("hist_corner_xyz"),
        hist_corner_mask=t("hist_corner_mask", torch.bool),
        hist_surf_xyz=t("hist_surf_xyz"),
        hist_surf_mask=t("hist_surf_mask", torch.bool),
        hist_ptr=t("hist_ptr", torch.int32),
        hist_len=t("hist_len", torch.int32),
        last_his_q=t("last_his_q"), last_his_t=t("last_his_t"),
        last_q_incre=t("last_q_incre"), last_t_incre=t("last_t_incre"),
        cell_corners=cells("cell_corners"),
        cell_planes=cells("cell_planes"),
        map_corners=batch("map_corners"),
        map_surface=batch("map_surface"),
        rng=(t("rng", torch.int64).to(torch.uint32) if "rng" in fields
             else prng_key(0, device)),
        cell_full=cell_full,
        last_touched=(t("last_touched", torch.bool) if cell_full is not None else None),
        grid_corners=grid("grid_corners"),
        grid_surface=grid("grid_surface"),
    )


def state_to_numpy(state: OdometryState) -> Dict[str, np.ndarray]:
    """The port's state as host arrays under the names `state_from_numpy`
    takes (``map_corners.xyz``, ``cell_corners.keys``, ``rng`` and so
    on; host scalars such as a cell map's ``cell_size`` as 0-d arrays;
    absent maps and grids left out)."""
    out: Dict[str, np.ndarray] = {}
    for name in state._fields:
        v = getattr(state, name)
        if isinstance(v, torch.Tensor):
            out[name] = v.detach().cpu().numpy()
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            for f in v._fields:
                x = getattr(v, f)
                out[f"{name}.{f}"] = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                                      else np.asarray(x))
    return out


class LoopState(NamedTuple):
    """The loop service's state as `loop_state_from_npz` reads it."""
    keyframes: List[KeyframeRecord]
    waiting: List[KeyframeRecord]      # completed, not yet analysed
    updating: List[_Accumulator]       # open accumulators
    closed: bool
    dropped_keyframes: int
    result: Optional[LoopClosureResult]
    pair_idx: int = 0                  # scene-alignment dumps written


def loop_state_from_npz(path: str, device) -> LoopState:
    """The keyframe records (keys, poses, descriptors with the gates'
    scalars settled on the host, era snapshots), the waiting records,
    the accumulators and the result of a JAX ``save_loop_state`` file.
    Tensors go to ``device``; snapshots stay host arrays, as the service
    keeps them."""
    z = np.load(path)
    meta = json.loads(bytes(z["meta_json"]).decode())

    def tensor(name, dtype):
        return torch.as_tensor(np.asarray(z[name]), dtype=dtype).to(device)

    def record(prefix: str) -> KeyframeRecord:
        desc = None
        if f"{prefix}_d_img_line" in z:
            desc = settle(KeyframeDescriptor(**{
                f: (tensor(f"{prefix}_d_{f}", torch.float32) if f.startswith(("img", "center"))
                    else np.asarray(z[f"{prefix}_d_{f}"]))
                for f in KeyframeDescriptor._fields}))

        def snap(s):
            key = f"{prefix}_{s}"
            return np.asarray(z[key], np.float32) if key in z else None

        return KeyframeRecord(
            keys=tensor(f"{prefix}_keys", torch.int32), q=tensor(f"{prefix}_q", torch.float32),
            t=tensor(f"{prefix}_t", torch.float32), ending_frame_idx=int(z[f"{prefix}_end"]),
            descriptor=desc, snap_line=snap("snap_line"), snap_plane=snap("snap_plane"),
            snap_full=snap("snap_full"))

    updating = [_Accumulator(frame_keys=[tensor(f"acc{i}_keys", torch.int32)],
                             frames=int(acc["frames"]))
                for i, acc in enumerate(meta["updating"])] or [_Accumulator()]
    result = None
    if meta["result"] is not None:
        r = meta["result"]
        result = LoopClosureResult(
            accepted=bool(r["accepted"]), his_idx=int(r["his_idx"]), cur_idx=int(r["cur_idx"]),
            icp_score=float(r["icp_score"]),
            q_opt=np.asarray(z["result_q_opt"]) if "result_q_opt" in z else None,
            t_opt=np.asarray(z["result_t_opt"]) if "result_t_opt" in z else None)
    return LoopState(
        keyframes=[record(f"kf{i}") for i in range(int(meta["n_keyframes"]))],
        waiting=[record(f"wait{i}") for i in range(int(meta["n_waiting"]))],
        updating=updating, closed=bool(meta["closed"]),
        dropped_keyframes=int(meta["dropped_keyframes"]), result=result,
        pair_idx=int(meta.get("pair_idx", 0)))
