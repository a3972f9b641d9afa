"""Multi-LiDAR (Livox Mid-100) front end, the counterpart of
``loam_livox_tpu/frontend/multi.py``: up to three heads, each through
the Livox extractor, merged into one feature frame per piecewise window
(reference ``laser_feature_extractor.hpp:85,173-180,305-389``).

The reference runs one `Livox_laser` per topic and publishes the merge
of the heads' feature clouds.  Here the heads run one after another;
the merge concatenates their masked batches, so every merged cloud has
S times a head's capacity.  Optional per-head extrinsics move each
head's points into the common frame (the Mid-100 sensor publishes a
common frame, so by default none apply, as in the reference).

Each head's `livox.extract_point_info` runs its split debounce on the
device (`ops.debounce`): a multi-head frame reads nothing on the host
in its front end.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..core import se3
from ..core.config import CapacityConfig, FeatureExtractionConfig
from ..core.types import FeatureFrame, PointBatch
from ..utils.logging import SPAN_FRONT_END, spans
from .livox import extract_point_info, select_features


def _merge(batches: List[PointBatch]) -> PointBatch:
    return PointBatch(*(torch.cat(parts) for parts in zip(*batches)))


def extract_multi_lidar(xyz: torch.Tensor, intensity: torch.Tensor, mask: torch.Tensor,
                        base_time: float, fe: FeatureExtractionConfig,
                        caps: CapacityConfig, piecewise_number: int = 1,
                        extrinsic_q: Optional[torch.Tensor] = None,
                        extrinsic_t: Optional[torch.Tensor] = None) -> List[FeatureFrame]:
    """(S, N, 3) points, (S, N) intensities and masks of S heads sharing
    one frame time -> ``piecewise_number`` merged feature frames.  With
    ``extrinsic_q`` (S, 4) (and optionally ``extrinsic_t`` (S, 3)) each
    head's valid points are rotated (and moved) into the common frame."""
    with spans.device(SPAN_FRONT_END, xyz):
        heads = range(xyz.shape[0])
        infos = [extract_point_info(xyz[s], intensity[s], mask[s], base_time, fe, caps)
                 for s in heads]

        def placed(b: PointBatch, s: int) -> PointBatch:
            if extrinsic_q is None:
                return b
            pts = se3.quat_rotate(extrinsic_q[s], b.xyz)
            if extrinsic_t is not None:
                pts = pts + extrinsic_t[s]
            return b._replace(xyz=torch.where(b.mask[:, None], pts, torch.zeros_like(pts)))

        frames = []
        for p in range(piecewise_number):
            lo, hi = p / piecewise_number, (p + 1) / piecewise_number
            per_head = [select_features(xyz[s], info, n_petals, lo, hi, fe)
                        for s, (info, n_petals) in zip(heads, infos)]
            frames.append(FeatureFrame(
                corners=_merge([placed(f.corners, s) for s, f in enumerate(per_head)]),
                surface=_merge([placed(f.surface, s) for s, f in enumerate(per_head)]),
                full=_merge([placed(f.full, s) for s, f in enumerate(per_head)]),
                time_min=torch.stack([f.time_min for f in per_head]).amin(),
                time_max=torch.stack([f.time_max for f in per_head]).amax()))
        return frames
