"""Point batches and feature frames.

Every cloud is a fixed-capacity ``(xyz, time, mask)`` triple: padded
slots hold zeros and a False mask.  The ``time`` channel carries each
point's timestamp (the reference keeps it in PCL's ``intensity``,
``source/livox_feature_extractor.hpp:246-264``).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


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
