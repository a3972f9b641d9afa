"""End-to-end odometry over a stream of raw frames: front end → source
voxel filter → odometry step, one raw frame at a time.

The entry points (`OdometryPipeline`, `run_odometry`) run on the card
unless the caller passes ``device="cpu"``; without a card and without
that argument they raise.  The poses stay on the device until `flush`
copies the whole trajectory to the host at once.

Host-sync audit of the per-frame path (the input to a CUDA-graph port):

    where                                   what                         per frame
    frontend/livox.py extract_point_info    .cpu() of the <= max_splits  1
                                            turning-point candidates for
                                            the host debounce
    registration/icp.py register_frame      bool(active): the early-exit  <= icp_maximum_iteration
                                            test of the ICP loop          (the first read also
                                                                          carries the map-size gate)
    runtime/odometry.py commit_frame        bool(admit): history          1
                                            admission, which decides the
                                            ring write and rebuild/append

Everything else stays on the device: the raw frame and the split table
go up through pinned memory without blocking, the kNN kernel reads its
valid-prefix counts from device memory, and the solver's accept/reject
steps are ``torch.where``.  `host_syncs` counts the three reads;
``chip_smoke.py`` checks the list against PyTorch's own sync-debug
report, by source line.  (Writing a Python scalar into a CUDA tensor,
``t[0] = 1.0``, is a blocking copy too, and stays off this path.)
"""
from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core.config import SlamConfig, require_supported
from ..core.types import FeatureFrame, to_device
from ..frontend import livox
from ..io.simulator import LivoxSimulator
from ..ops.voxel import voxel_downsample
from ..registration import icp
from . import odometry
from .odometry import OdometryState, init_state, odometry_step


def host_syncs() -> dict:
    """Host reads of device values on the per-frame path since the last
    `reset_host_syncs`, by place."""
    return {**livox.SYNCS, **icp.SYNCS, **odometry.SYNCS}


def reset_host_syncs() -> None:
    for counts in (livox.SYNCS, icp.SYNCS, odometry.SYNCS):
        for key in counts:
            counts[key] = 0


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


def source_downsample(frame: FeatureFrame, cfg: SlamConfig) -> FeatureFrame:
    """The front end's voxel filter before publishing: corner leaf =
    line resolution, surface leaf = half the plane resolution (reference
    laser_feature_extractor.hpp:192-193, 372-384)."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    return frame._replace(
        corners=voxel_downsample(frame.corners, fe.mapping_line_resolution,
                                 capacity=caps.max_corner),
        surface=voxel_downsample(frame.surface, fe.mapping_plane_resolution / 2.0,
                                 capacity=caps.max_surface))


def process_raw_frame(state: OdometryState, pts, inten, mask, base_time: float,
                      cfg: SlamConfig):
    """One padded raw frame through the front end and one odometry step
    (motion deblur: one registration per frame).  Returns
    ``(state, reg, frame)``."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    _, _, frame = livox.extract_frame(pts, inten, mask, base_time, fe, caps)
    frame = source_downsample(frame, cfg)
    state, reg = odometry_step(state, frame, cfg)
    return state, reg, frame


@dataclass
class TrajectoryRecord:
    times: List[float] = field(default_factory=list)
    positions: List[np.ndarray] = field(default_factory=list)
    quaternions: List[np.ndarray] = field(default_factory=list)
    accepted: List[bool] = field(default_factory=list)

    def positions_array(self) -> np.ndarray:
        return np.asarray(self.positions, np.float64)


class OdometryPipeline:
    """Livox front end + odometry over raw frames, one frame per call."""

    def __init__(self, cfg: SlamConfig, device=None):
        require_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        # The 6×6 normal equations and every float32 product must stay
        # full f32: TF32 keeps ~3 decimal digits, enough to move the
        # LM steps and the acceptance gates.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.state: OdometryState = init_state(cfg, self.device)
        self.trajectory = TrajectoryRecord()
        self.iterations: List[int] = []   # ICP iterations of each frame
        self._pending: list = []          # device poses not yet on the host

    def process_raw(self, xyz: np.ndarray, intensity: np.ndarray,
                    base_time: float) -> None:
        """One raw sensor frame: (N, 3) points and (N,) intensities,
        padded here to ``capacity.max_raw_points``."""
        n = self.cfg.capacity.max_raw_points
        m = min(len(xyz), n)
        pts = np.zeros((n, 3), np.float32)
        inten = np.zeros((n,), np.float32)
        mask = np.zeros((n,), bool)
        pts[:m] = xyz[:m]
        inten[:m] = intensity[:m]
        mask[:m] = True
        dev = self.device
        self.state, reg, frame = process_raw_frame(
            self.state, to_device(pts, dev), to_device(inten, dev),
            to_device(mask, dev), float(base_time), self.cfg)
        self.iterations.append(reg.iterations)
        self._pending.append(torch.cat([
            frame.time_min.reshape(1), reg.t_w, reg.q_w,
            reg.accepted.reshape(1).to(torch.float32)]))

    def flush(self) -> None:
        """Copy every pending pose to the host (one transfer)."""
        if not self._pending:
            return
        rows = torch.stack(self._pending).cpu().numpy()
        self._pending = []
        for row in rows:
            self.trajectory.times.append(float(row[0]))
            self.trajectory.positions.append(row[1:4].copy())
            self.trajectory.quaternions.append(row[4:8].copy())
            self.trajectory.accepted.append(bool(row[8]))


def run_odometry(cfg: SlamConfig, n_frames: int,
                 sim: Optional[LivoxSimulator] = None, device=None):
    """Simulate and process ``n_frames``; returns (pipeline, sim, wall_s)."""
    pipe = OdometryPipeline(cfg, device=device)
    sim = sim or LivoxSimulator()
    t0 = _time.perf_counter()
    for i in range(n_frames):
        xyz, inten, base_t = sim.frame(i)
        pipe.process_raw(xyz, inten, base_t)
    pipe.flush()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    return pipe, sim, _time.perf_counter() - t0
