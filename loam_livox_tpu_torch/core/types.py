"""Point batches, poses and feature frames.

Every cloud is a fixed-capacity ``(xyz, time, mask)`` triple: padded
slots hold zeros and a False mask.  The ``time`` channel carries each
point's timestamp (the reference keeps it in PCL's ``intensity``,
``source/livox_feature_extractor.hpp:246-264``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import se3


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  To a card it goes through
    pinned memory without blocking, so the host does not wait for the
    work already queued on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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

    @staticmethod
    def from_xyz(xyz: torch.Tensor, time: torch.Tensor | None = None,
                 mask: torch.Tensor | None = None) -> "PointBatch":
        """Every point valid and at time 0 unless ``mask`` / ``time`` say
        otherwise."""
        if time is None:
            time = torch.zeros(xyz.shape[:-1], dtype=xyz.dtype, device=xyz.device)
        if mask is None:
            mask = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
        return PointBatch(xyz=xyz, time=time, mask=mask)

    def pad_to(self, capacity: int) -> "PointBatch":
        """The batch with padding slots appended up to ``capacity``."""
        n = self.capacity
        if capacity < n:
            raise ValueError(f"cannot pad {n} points into capacity {capacity}")
        pad = capacity - n
        return PointBatch(xyz=torch.nn.functional.pad(self.xyz, (0, 0, 0, pad)),
                          time=torch.nn.functional.pad(self.time, (0, pad)),
                          mask=torch.nn.functional.pad(self.mask, (0, pad)))

    def transform(self, q: torch.Tensor, t: torch.Tensor) -> "PointBatch":
        """The points moved by the pose (q, t)."""
        return self._replace(xyz=se3.pose_transform(q, t, self.xyz))


class Pose(NamedTuple):
    """World pose as (wxyz quaternion, translation)."""
    q: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "Pose":
        return Pose(q=se3.quat_identity(dtype, device),
                    t=torch.zeros(3, dtype=dtype, device=device))

    def compose(self, other: "Pose") -> "Pose":
        """self ∘ other: first other, then self."""
        return Pose(*se3.pose_compose(self.q, self.t, other.q, other.t))

    def inverse(self) -> "Pose":
        return Pose(*se3.pose_inverse(self.q, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return se3.pose_transform(self.q, self.t, pts)


class FeatureFrame(NamedTuple):
    """One frame's corner / surface / full clouds and its time range
    (the motion-deblur normalisation, reference
    ``laser_mapping.hpp:1330-1352``)."""
    corners: PointBatch
    surface: PointBatch
    full: PointBatch
    time_min: torch.Tensor   # () float32
    time_max: torch.Tensor   # () float32
