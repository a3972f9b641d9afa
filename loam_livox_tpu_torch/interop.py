"""Configuration and state carried over from the JAX package, as plain
Python and numpy values (this module imports nothing of JAX).

* `config_from_dict` takes ``dataclasses.asdict`` of a JAX
  ``SlamConfig``: the two config trees share section and field names.
* `state_from_numpy` takes the JAX ``OdometryState`` fields as numpy
  arrays (``{name: np.asarray(value)}``; the matching buffers as
  ``map_corners.xyz`` / ``map_corners.mask`` and so on) and keeps the
  fields the port's state has.  This state is what a run carries from
  frame to frame: the system's counterpart of a model's weights.  The
  JAX rng key has no counterpart (the draws cannot match): the port's
  generator starts from seed 0, as in a new state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.config import SlamConfig, from_dict
from .core.types import PointBatch
from .runtime.odometry import OdometryState


def config_from_dict(d: Dict[str, Any]) -> SlamConfig:
    return from_dict(d)


def state_from_numpy(fields: Dict[str, np.ndarray], device) -> OdometryState:
    def t(name, dtype=torch.float32):
        return torch.as_tensor(np.asarray(fields[name]), dtype=dtype).to(device)

    def batch(prefix):
        xyz = t(f"{prefix}.xyz")
        time = (t(f"{prefix}.time") if f"{prefix}.time" in fields
                else torch.zeros(xyz.shape[0], device=device))
        return PointBatch(xyz=xyz, time=time, mask=t(f"{prefix}.mask", torch.bool))

    return OdometryState(
        q_w=t("q_w"), t_w=t("t_w"),
        frame_count=int(fields["frame_count"]),
        hist_corner_xyz=t("hist_corner_xyz"),
        hist_corner_mask=t("hist_corner_mask", torch.bool),
        hist_surf_xyz=t("hist_surf_xyz"),
        hist_surf_mask=t("hist_surf_mask", torch.bool),
        hist_ptr=int(fields["hist_ptr"]),
        hist_len=int(fields["hist_len"]),
        last_his_q=t("last_his_q"), last_his_t=t("last_his_t"),
        last_q_incre=t("last_q_incre"), last_t_incre=t("last_t_incre"),
        map_corners=batch("map_corners"),
        map_surface=batch("map_surface"),
        rng=torch.Generator(device=device).manual_seed(0),
    )
