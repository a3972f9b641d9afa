"""End-to-end odometry over a stream of raw frames: front end → source
voxel filter → odometry step.

The front end is the Livox extractor, or with ``common/lidar_type``
``velodyne`` the mechanical-LiDAR one (one sweep, one registration, no
pieces; intensity unused).  A multi-head frame (`frontend.multi`) goes
through `OdometryPipeline.head_frames` (its front end and source
filters, `extract_heads`) and then piece by piece through
`OdometryPipeline.process_feature_frame`.

Three ways to dispatch, as in the JAX package's pipeline:

* sequential (the default): each raw frame at once.  With motion
  deblur off, a frame is ``common/piecewise_number`` index-fraction
  pieces (P), each registered on its own, in order; with
  ``common/odom_mode`` 0 only the first piece runs.  Motion deblur
  forces one piece.
* chunked (``parallel/dispatch_chunk`` K > 1): K raw frames buffered,
  then run back to back.  The per-frame semantics are the sequential
  ones, so the trajectory is bitwise the sequential one.
* racing (``parallel/frame_batch`` G > 1): G raw frames buffered, then
  their G·P pieces registered in one lane-batched solve
  (`runtime.batched`).  When the last observed per-step translation
  exceeds ``parallel/batch_motion_guard_t`` the group runs sequentially
  instead.  The observation lags: dispatched groups (a fallback's raw
  frames, one each) wait in a queue, and the host reads one only once
  more than ``common/maximum_parallel_thread`` are queued, so the guard
  sees motion up to that many groups old.

The capacity schedule (`runtime.capacity_schedule`, on by default as in
the JAX package): every path above runs its steps at ``cfg_active``,
the configuration whose six fill-driven capacities start at
``1/schedule_start_scale`` of ``cfg``'s and double when a check of the
state's fills, every 4 to 64 dispatch units (a raw frame, a chunk, a
raced group or a `process_feature_frame` step), finds one past its
watermark.  A growth comes only between units and re-pads the state;
``ladder`` records it with the units run by then.  The schedule is off
in product mode, with ``parallel/deterministic`` 1, under the ``grid``
engine and in cell matching.

With ``loop_closure/if_enable_loop_closure`` the full-cloud cell map, a
touched-cell mask and the pose go to `runtime.loop_service.LoopCloser`
as they are dispatched, still on the device, in the JAX package's units:
a raw frame (its last piece's mask), a chunk, or a raced group (the OR
of its frames' or lanes' masks, slot by slot), each indexed by its first
raw frame, so keyframes count those units; `flush` waits for the
service.

Product mode (``parallel/mesh_devices`` N > 1, or a `parallel.mesh.Mesh`
given): one process a device, N ranks of a `torch.distributed` group,
each fed the same raw frames.  The state is kept sharded
(`parallel.layout`): each rank holds its slices of the point, cell and
bucket axes, and the step reads the state gathered from the slices.
The registration's kNN over the matching buffer runs sharded
(`parallel.sharded.knn_sharded`, bit for bit the unsharded search), and
the small per-frame solve runs whole on every rank, as the JAX package
pins it replicated; so the trajectory is the 1-rank run's.  On the card
the frame program captures the same: a unit gathers the rank's static
slices into its whole static state, runs its steps (the sharded
search's all-gathers inside the WHILE bodies) and copies the rank's
rows back; `_live` then reads the whole static state without a
collective.

The entry points (`OdometryPipeline`, `run_odometry`) run on the card
unless the caller passes ``device="cpu"``; without a card and without
that argument they raise.  The trajectory has one row per registered
piece, stamped with the piece's first point time.  Its rows stay on
the device until the host reads them: at `flush` in one transfer, or
group by group in the racing queue.

Logs, as in the JAX package (``runtime/pipeline.py:590-647``): with a
``log_dir`` (or ``common/if_verbose_screen_printf`` 0, the reference's
inverted flag, which echoes to the screen) each dispatch unit (a raw
frame, a chunk, a raced group, a fallen-back frame) writes a
``mapping`` line of its last registration (cost, inlier threshold,
blocks, iterations, rotation and translation steps, accepted), two
``pcd_log`` lines of its last pose and a ``timer`` line; with
``common/if_save_to_pcd_files`` each raw frame given as host arrays on
the sequential path is written to ``<log_dir>/pcd/aft_mapp_<frame>.pcd``,
its raw points moved by the frame's endpoint pose on the host (not
deblurred).  These need the rows on the host as each unit is
dispatched, so logging, pcd files and ``eager_drain`` (the command
line's ``--follow``) read the queue after every raw frame, down to the
racing queue depth.

On the card every configuration runs on the frame program
(`runtime.frame_program.on_slice`: the Livox or Velodyne front end,
history or cell matching, the ``knn_fused``, ``grid`` or ``dense``
engine, loop closure on or off, residual subsampling on or off, with or
without a product mesh): each raw frame is one CUDA graph launch
(`runtime.frame_program`), the counterpart of the JAX package's one
jitted program a frame; its rows, state and iterations equal the plain
program's (`process_raw_frame`) bit for bit.  The frame program also
runs a chunk (one graph launch a chunk of K frames), a racing group (one
launch a group), a feature-frame step (one launch) and a multi-head
frame's front end (one launch, so a Mid-100 frame of P pieces is 1 + P).
No configuration runs the plain program on the card any more, unless a
caller sets ``program = None`` (the comparison runs of the GPU tests and
``chip_smoke.py``); on the CPU every path runs the plain program.  On the graph path
the program updates its static state in place; `state` hands a reader
outside the pipeline a copy of it, so that a state once read stays as
it was, as the JAX pipeline's new arrays do, and the loop service gets
copies of what it keeps (`_feed_loop`).

Host-sync audit (a sync drains the launch queue):

    where                                   what                             how often
    registration/icp.py run_host_loop       bool(active.any()): the early    <= icp_maximum_iteration
                                            exit of the ICP loop             + 1 a piece, or a racing
                                                                             group, on the plain
                                                                             program; none in the
                                                                             frame program
    runtime/odometry.py commit_history      history admission (``admit``):   never (the cell maps
                                            no read left                     take masked insertions)
    runtime/pipeline.py _drain              .cpu() of the rows of the        1 a racing group (or
                                            groups drained past the queue    fallback frame) past
                                            depth, for the motion guard      the queue depth; with
                                                                             logs or eager_drain,
                                                                             1 a raw frame
    runtime/pipeline.py _log_unit           .cpu() of the unit's last        1 a logged dispatch
                                            registration's scalars for the   unit, only with logs
                                            ``mapping`` line
    runtime/capacity_schedule.py            .cpu() of the six buffer fills   1 every 4-64 dispatch
    CapacityScheduler.maybe_grow            (``schedule``)                   units until the tier
                                                                             reaches the configured
                                                                             capacities
    runtime/checkpoint.py load_pipeline     the restored frame counter       1 a resume
                                            (``resume``)

The front end reads nothing on the host: its split debounce runs on
the device (`ops.debounce`), so it has no place here.  The loop service adds no read on the frame thread in async mode: a
keyframe's member keys are united on the device, and the worker's reads
(and, inline, the service's reads on the frame thread) count in
``LoopCloser.counts``, not here.

Everything else stays on the device: the raw frame goes up through
pinned memory without blocking, the kNN kernel reads its valid-prefix
counts from device memory, and the solver's accept/reject steps are
``torch.where``.  `host_syncs` counts the reads; ``chip_smoke.py``
checks the list against PyTorch's own sync-debug report, by source
line.  (Writing a Python scalar into a CUDA tensor, ``t[0] = 1.0``, is
a blocking copy too, and stays off this path.)
"""
from __future__ import annotations

import os
import time as _time
from collections import deque
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..core import se3
from ..core.config import SlamConfig, require_supported
from ..core.types import FeatureFrame, resolve_device, to_device
from ..frontend import livox
from ..frontend.velodyne import extract_velodyne_features
from ..io.simulator import LivoxSimulator
from ..ops.voxel import voxel_downsample
from ..parallel.layout import gather_state, shard_state
from ..parallel.mesh import Mesh, make_mesh, mesh_device, set_active_mesh
from ..registration import icp
from ..core import accounting
from ..utils import logging as L
from . import capacity_schedule, checkpoint, odometry
from .batched import odometry_step_batched
from .capacity_schedule import CapacityScheduler, schedule_active
from .frame_program import FrameProgram, map_tensors, on_slice
from .loop_service import LoopCloser
from .odometry import OdometryState, init_state, odometry_step

#: host reads of drained trajectory rows and of logged registrations
#: since the last reset
SYNCS = {"drain": 0, "log": 0}


_SYNC_PLACES = (icp.SYNCS, odometry.SYNCS, capacity_schedule.SYNCS,
                checkpoint.SYNCS, SYNCS)


def host_syncs() -> dict:
    """Host reads of device values on the per-frame path since the last
    `reset_host_syncs`, by place."""
    return {k: v for counts in _SYNC_PLACES for k, v in counts.items()}


def graph_counts() -> dict:
    """Frame-program launches and captures (and the seconds the captures
    took) since the last `reset_host_syncs`."""
    return dict(accounting.GRAPHS)


def reset_host_syncs() -> None:
    """Zero the host-sync places and the graph counters."""
    for counts in (*_SYNC_PLACES, accounting.GRAPHS):
        for key in counts:
            counts[key] = type(counts[key])(0)


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


def piece_count(cfg: SlamConfig) -> int:
    """Pieces a raw frame splits into: motion deblur forces one
    (reference laser_feature_extractor.hpp:306-309), and a Velodyne
    sweep is one (reference :827-864)."""
    if cfg.common.if_motion_deblur or cfg.common.lidar_type == "velodyne":
        return 1
    return max(1, cfg.common.piecewise_number)


def extract_pieces(pts, inten, mask, base_time, cfg: SlamConfig,
                   n_run: int | None = None) -> List[FeatureFrame]:
    """The front end and the source voxel filter of one padded raw frame
    (``base_time`` a float or a scalar tensor): its first ``n_run``
    (default all) pieces."""
    fe = cfg.feature_extraction
    if cfg.common.lidar_type == "velodyne":
        frames = [extract_velodyne_features(pts, mask, base_time, fe,
                                            minimum_range=fe.minimum_range)]
    else:
        _, _, frames = livox.extract_frame(pts, inten, mask, base_time, fe,
                                           cfg.capacity, piece_count(cfg))
    return [source_downsample(f, cfg) for f in frames[:n_run]]


def extract_heads(xyz, inten, mask, base_time, cfg: SlamConfig) -> List[FeatureFrame]:
    """A multi-head raw frame's front end: (S, N, 3) points, (S, N)
    intensities and masks of S heads sharing ``base_time`` (a float or a
    scalar tensor) through `frontend.multi.extract_multi_lidar`, then each
    merged piece's source voxel filter at the merged capacities (S times
    a head's).  The frame program captures it (`FrameProgram.run_heads`)."""
    from ..frontend.multi import extract_multi_lidar

    fe = cfg.feature_extraction
    frames = extract_multi_lidar(xyz, inten, mask, base_time, fe, cfg.capacity,
                                 piecewise_number=cfg.common.piecewise_number)
    return [fr._replace(
        corners=voxel_downsample(fr.corners, fe.mapping_line_resolution,
                                 capacity=fr.corners.capacity),
        surface=voxel_downsample(fr.surface, fe.mapping_plane_resolution / 2.0,
                                 capacity=fr.surface.capacity)) for fr in frames]


def steps_per_frame(cfg: SlamConfig) -> int:
    """Odometry steps a raw frame runs: its pieces, or with ``odom_mode``
    0 only the first (the reference's extractor publishes only piece 0
    in odometry mode, laser_feature_extractor.hpp:385-388)."""
    return 1 if cfg.common.odom_mode == 0 else piece_count(cfg)


def process_raw_frame(state: OdometryState, pts, inten, mask, base_time: float,
                      cfg: SlamConfig):
    """One padded raw frame through the front end and one odometry step
    a piece that runs (reference pipeline.py:99-133, `steps_per_frame`):
    the plain program, which the frame program (`runtime.frame_program`)
    replays on the card.  Returns ``(state, regs, frames)``, one result
    and feature frame a step."""
    frames = extract_pieces(pts, inten, mask, base_time, cfg, steps_per_frame(cfg))
    regs = []
    for frame in frames:
        state, reg = odometry_step(state, frame, cfg)
        regs.append(reg)
    return state, regs, frames


def trajectory_rows(regs, frames) -> torch.Tensor:
    """(n, 10) device rows (time_min, t_w, q_w, accepted, iterations)."""
    def iters(reg):
        if isinstance(reg.iterations, torch.Tensor):
            return reg.iterations.to(torch.float32).reshape(1)
        return torch.full((1,), float(reg.iterations), device=reg.t_w.device)

    return torch.stack([
        torch.cat([f.time_min.reshape(1), r.t_w, r.q_w,
                   r.accepted.reshape(1).to(torch.float32), iters(r)])
        for r, f in zip(regs, frames)])


class _Unit(NamedTuple):
    """One dispatch unit's rows waiting on the device, with what its logs
    read: the unit's first raw frame, its last registration (with logs
    on; None for a `process_feature_frame` step, which logs nothing) and
    the raw points of a sequential frame given as host arrays when pcd
    files are on."""
    rows: torch.Tensor
    frame_idx: int
    reg: Optional[icp.RegistrationResult]
    raw: Optional[np.ndarray]


@dataclass
class TrajectoryRecord:
    times: List[float] = field(default_factory=list)
    positions: List[np.ndarray] = field(default_factory=list)
    quaternions: List[np.ndarray] = field(default_factory=list)
    accepted: List[bool] = field(default_factory=list)

    def positions_array(self) -> np.ndarray:
        return np.asarray(self.positions, np.float64)


class OdometryPipeline:
    """Livox front end + odometry over raw frames (module doc)."""

    def __init__(self, cfg: SlamConfig, device=None, log_dir: Optional[str] = None,
                 mesh: Optional[Mesh] = None):
        require_supported(cfg)
        self.cfg = cfg
        n_mesh = int(cfg.parallel.mesh_devices)
        if mesh is None and n_mesh > 1:
            mesh = make_mesh(n_mesh)
        elif mesh is not None and n_mesh > 1 and mesh.size != n_mesh:
            raise ValueError(f"parallel/mesh_devices={n_mesh} but the mesh has "
                             f"{mesh.size} ranks")
        #: the product mesh (module doc), or None
        self.mesh = mesh
        self._axes = None
        #: under a mesh on the frame program, the whole static state the
        #: last unit left (its slices gathered), read by `_live` with no
        #: collective; None where the slices are newer
        self._whole = None
        self.device = resolve_device(device)
        if mesh is not None:
            self.device = mesh_device(mesh, self.device)
        self.logger = L.FileLogger(log_dir, screen=cfg.common.if_verbose_screen_printf == 0)
        #: the program's span timer and recorder (`utils.logging.spans`)
        self.timer = L.spans
        self._pcd_dir = None
        if cfg.common.if_save_to_pcd_files:
            self._pcd_dir = os.path.join(log_dir or ".", "pcd")
            os.makedirs(self._pcd_dir, exist_ok=True)
        #: read the rows after every raw frame (the command line's --follow)
        self.eager_drain = False
        par = cfg.parallel
        self.frame_batch = max(1, int(par.frame_batch))
        self.dispatch_chunk = max(1, int(par.dispatch_chunk))
        if self.frame_batch > 1 and piece_count(cfg) > 1 and cfg.common.odom_mode == 0:
            raise ValueError(
                "parallel/frame_batch > 1 with piecewise > 1 requires "
                "common/odom_mode = 1 (odometry mode publishes only "
                "piece 0, which the batched lanes do not model)")
        if self.frame_batch > 1 and self.dispatch_chunk > 1:
            raise ValueError(
                "parallel/dispatch_chunk and parallel/frame_batch are "
                "mutually exclusive (sequential chunking vs racing)")
        # racing: groups left queued before the host reads them (a depth
        # of 1 reads every group at once, fully synchronous)
        depth = max(1, int(cfg.common.maximum_parallel_thread))
        self.queue_depth = 0 if depth == 1 else depth
        # The 6×6 normal equations and every float32 product must stay
        # full f32: TF32 keeps ~3 decimal digits, enough to move the
        # LM steps and the acceptance gates.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # The capacity schedule (runtime/capacity_schedule.py): the steps
        # run at cfg_active, whose six fill-driven capacities grow toward
        # cfg's as the measured fills demand; self.cfg keeps the caller's
        # configuration.
        self.scheduler: Optional[CapacityScheduler] = None
        self.cfg_active = cfg
        if schedule_active(cfg, mesh):
            self.scheduler = CapacityScheduler(cfg)
            self.cfg_active = self.scheduler.cfg
        self._sched_interval = 4          # dispatch units between fill checks
        self._sched_countdown = self._sched_interval
        self._units = 0                   # dispatch units run
        #: (dispatch units run, scale) at each growth of the schedule
        self.ladder: List[tuple] = []
        self.state = init_state(self.cfg_active, self.device)
        self.trajectory = TrajectoryRecord()
        self.iterations: List[int] = []   # ICP iterations of each trajectory row
        self._buf: list = []              # raw frames waiting for their chunk or group
        self._pending: deque = deque()    # _Unit rows not yet on the host
        self._last_motion = 0.0           # racing guard: last observed step (m)
        self._loop_iterations = 0         # passes of the plain program's loops
        #: the frame program on the card, for a configuration on its slice;
        #: set to None, the plain program runs instead (the card's reference
        #: run that chip_smoke.py and the GPU tests hold it against)
        self.program: Optional[FrameProgram] = (
            FrameProgram(self.device, mesh) if on_slice(cfg, self.device, mesh) else None)
        self.raced_groups = 0
        self._raced_loop_iterations = 0   # the plain program's batched loops
        self.fallback_groups = 0
        self._frame_idx = 0               # raw frames run
        self.loop_closer: Optional[LoopCloser] = None
        if cfg.loop_closure.if_enable_loop_closure:
            self.loop_closer = LoopCloser(cfg, device=self.device)

    @property
    def loop_iterations(self) -> int:
        """ICP loop passes run (each launches the kNN kernel twice): a
        piece's iterations, or one batched loop for a racing group; the
        frame program's passes are summed on the card and read here."""
        graph = self.program.loop_passes() if self.program is not None else 0
        return self._loop_iterations + graph

    @property
    def raced_loop_iterations(self) -> int:
        """The racing groups' share of `loop_iterations`: one batched loop
        a group (on the frame program summed on the card)."""
        graph = self.program.group_passes() if self.program is not None else 0
        return self._raced_loop_iterations + graph

    def _live(self) -> OdometryState:
        """The state as the pipeline's own code reads it: on the frame
        program its static state itself, no copy; in product mode
        gathered from the ranks' slices (a collective), or on the frame
        program the whole static state its last unit gathered and
        updated (no collective: the slices are that state's rows)."""
        if self.mesh is None:
            return self._state
        if self._whole is not None:
            return self._whole
        return gather_state(self._state, self._axes, self.mesh)

    @property
    def state(self) -> OdometryState:
        """The odometry state; in product mode gathered from the ranks'
        slices (a collective: every rank reads it at the same point).
        Where the frame program holds it, a copy: the next frame updates
        the program's static state in place, never a state read here.
        A state set here is copied into the static state at the next
        frame."""
        state = self._live()
        return state if self.program is None else map_tensors(torch.clone, state)

    @state.setter
    def state(self, state: OdometryState) -> None:
        if self.mesh is None:
            self._state = state
        else:
            self._state, self._axes = shard_state(state, self.mesh)
            self._whole = None

    def _hold(self, state: OdometryState) -> None:
        """Keep the state a frame-program unit left: its static state, or
        under a mesh the rank's static slices (the next unit's input) and
        the whole static state (`_live`)."""
        if self.mesh is None:
            self._state = state
        else:
            self._state, self._whole = self.program.slices, state

    def _activate(self) -> None:
        """Register this pipeline's mesh and numerics flags for the
        registration code (several pipelines may take turns in one
        process)."""
        det = self.cfg.parallel.deterministic
        set_active_mesh(self.mesh, None if det < 0 else bool(det))

    def process_raw(self, xyz, intensity, base_time: float, mask=None) -> None:
        """One raw sensor frame: (N, 3) points and (N,) intensities as
        host arrays, padded here to ``capacity.max_raw_points``; or, with
        ``mask``, tensors already padded to that size (on the pipeline's
        device, as bench.py hands the JAX pipeline device arrays)."""
        with self.timer.host("process_raw"):
            self._process_raw(xyz, intensity, base_time, mask)

    def _process_raw(self, xyz, intensity, base_time: float, mask) -> None:
        self._activate()
        n = self.cfg.capacity.max_raw_points
        dev = self.device
        self.timer.tic(L.SPAN_FRAME)
        raw = None
        if mask is not None and isinstance(xyz, torch.Tensor) and xyz.shape == (n, 3):
            with self.timer.host("copy-up"):
                pts, inten, mask = (torch.as_tensor(a, device=dev)
                                    for a in (xyz, intensity, mask))
        else:
            m = min(len(xyz), n)
            pts = np.zeros((n, 3), np.float32)
            inten = np.zeros((n,), np.float32)
            valid = np.zeros((n,), bool)
            pts[:m] = xyz[:m]
            inten[:m] = intensity[:m]
            valid[:m] = True
            if self._pcd_dir is not None:
                raw = pts[:m]
            with self.timer.host("copy-up"):
                pts, inten, mask = (to_device(a, dev) for a in (pts, inten, valid))
        frame = (pts, inten, mask, float(base_time))
        if self.frame_batch > 1:
            self._buf.append(frame)
            if len(self._buf) == self.frame_batch:
                self._dispatch_group()
                self._maybe_grow_capacity()
        elif self.dispatch_chunk > 1:
            self._buf.append(frame)
            if len(self._buf) == self.dispatch_chunk:
                self._dispatch_chunk()
                self._maybe_grow_capacity()
        else:
            self._pending.append(self._run_frame(*frame)._replace(raw=raw))
            self._feed_loop(1)
            self._maybe_grow_capacity()
        if self.frame_batch > 1 or self._eager():
            self._drain(len(self._pending) - self.queue_depth)

    def _maybe_grow_capacity(self) -> None:
        """The schedule's check after a dispatch unit: every few units,
        read the fills and grow the active capacities past a watermark
        (the JAX package's countdown, runtime/pipeline.py:449-465).  A
        growth re-pads the state only: queued rows and the loop
        service's entries keep the shapes they were made at."""
        self._units += 1
        if self.scheduler is None or self.scheduler.at_max():
            return
        self._sched_countdown -= 1
        if self._sched_countdown > 0:
            return
        with self.timer.host("schedule"):
            self.state, self.cfg_active, grew = self.scheduler.maybe_grow(self._live())
        if grew:
            self.ladder.append((self._units, self.scheduler.scale))
            self._sched_interval = 4
        else:
            self._sched_interval = min(self._sched_interval * 2, 64)
        self._sched_countdown = self._sched_interval

    def _eager(self) -> bool:
        """Whether the rows are read after every raw frame (module doc)."""
        return self.eager_drain or self.logger.enabled() or self._pcd_dir is not None

    def _run_frame(self, pts, inten, mask, base_time: float) -> _Unit:
        """One raw frame through the front end and the odometry (the frame
        program on the card, on its slice; else the plain program);
        returns its unit, not yet queued."""
        if self.program is not None:
            state, rows, last_reg = self.program.run(
                self._state, pts, inten, mask, base_time, self.cfg_active,
                steps_per_frame(self.cfg_active), self._axes)
            self._hold(state)
            return self._unit(rows, last_reg)
        with self.timer.device(f"{L.SPAN_UNIT}.frame", pts):
            self.state, regs, frames = process_raw_frame(self._live(), pts, inten, mask,
                                                         base_time, self.cfg_active)
        self._loop_iterations += sum(r.iterations for r in regs)
        return self._unit(trajectory_rows(regs, frames), regs[-1])

    def _unit(self, rows: torch.Tensor, last_reg) -> _Unit:
        """A unit dispatched at the current raw frame; it keeps its last
        registration only when the logs will read it."""
        return _Unit(rows, self._frame_idx, last_reg if self.logger.enabled() else None, None)

    def _feed_loop(self, n_frames: int) -> None:
        """Hand the loop service the state's touched cells and pose, still
        on the device, as one entry for the ``n_frames`` raw frames just
        run (the JAX package parks one entry a frame, a chunk or a raced
        group, indexed by its first frame); then count the frames.  On
        the frame program, whose next unit overwrites its static state,
        the service gets copies of what it keeps (`LoopCloser.on_frame`):
        the pose, and the full-cloud map when a keyframe completes, copied
        on the frame stream before the service records its event."""
        closer = self.loop_closer
        if closer is not None and not closer.closed:
            st = self._live()
            cell_full, q_w, t_w = st.cell_full, st.q_w, st.t_w
            if self.program is not None:
                q_w, t_w = q_w.clone(), t_w.clone()
                if closer.completes_keyframe():
                    cell_full = map_tensors(torch.clone, cell_full)
            closer.on_frame(cell_full, st.last_touched, q_w, t_w, self._frame_idx)
        self._frame_idx += n_frames

    def process_feature_frame(self, frame: FeatureFrame) -> None:
        """One odometry step on a finished feature frame (a multi-head
        piece, `frontend.multi`; on the frame program one graph launch,
        its loop passes summed on the card); its trajectory row waits on
        the device like a raw frame's.  Frames given here bypass any chunk
        or group that `process_raw` is filling, and feed no loop service
        (as the JAX package's ``process_feature_frame``)."""
        with self.timer.host("process_feature_frame"):
            self._activate()
            if self.program is not None:
                state, rows, _ = self.program.run_step(self._state, frame, self.cfg_active,
                                                       self._axes)
                self._hold(state)
            else:
                with self.timer.device(f"{L.SPAN_UNIT}.step", frame.time_min):
                    self.state, reg = odometry_step(self._live(), frame, self.cfg_active)
                self._loop_iterations += reg.iterations
                rows = trajectory_rows([reg], [frame])
            self._pending.append(self._unit(rows, None))
            self._maybe_grow_capacity()

    def head_frames(self, xyz, inten, mask, base_time: float) -> List[FeatureFrame]:
        """A multi-head raw frame's merged feature frames (`extract_heads`
        at the configured capacities), one a piece, for
        `process_feature_frame`: on the frame program one graph launch,
        whose frames the next launch overwrites (each step copies its
        frame in before its own launch)."""
        with self.timer.host("head_frames"):
            if self.program is not None:
                return self.program.run_heads(xyz, inten, mask, base_time, self.cfg)
            with self.timer.device(f"{L.SPAN_UNIT}.heads", xyz):
                return extract_heads(xyz, inten, mask, base_time, self.cfg)

    def _dispatch_chunk(self) -> None:
        """The buffered raw frames back to back, on the card's frame
        program as one graph launch; the loop service gets one entry with
        the OR of their touched masks (the JAX package's chunk scan,
        runtime/pipeline.py:162-178)."""
        buf, self._buf = self._buf, []
        if self.program is not None:
            # the graph writes the OR of the frames' touched masks into the
            # state's last_touched (`frame_program._ChunkKey`)
            state, rows, last_reg = self.program.run_chunk(
                self._state, buf, self.cfg_active, steps_per_frame(self.cfg_active), self._axes)
            self._hold(state)
            self._pending.append(self._unit(rows, last_reg))
            self._feed_loop(len(buf))
            return
        touched = None          # stays None without loop closure
        units = []
        for frame in buf:
            units.append(self._run_frame(*frame))
            mask = self._live().last_touched
            touched = mask if touched is None else touched | mask
        self.state = self._live()._replace(last_touched=touched)
        self._pending.append(self._unit(torch.cat([u.rows for u in units]), units[-1].reg))
        self._feed_loop(len(buf))

    def _dispatch_group(self) -> None:
        """The buffered raw frames as one racing group (on the card's frame
        program one graph launch), or sequentially when the motion guard
        trips."""
        buf, self._buf = self._buf, []
        guard = self.cfg.parallel.batch_motion_guard_t
        if guard > 0 and self._last_motion > guard:
            self.fallback_groups += 1
            for frame in buf:
                self._pending.append(self._run_frame(*frame))
                self._feed_loop(1)
            return
        self.raced_groups += 1
        if self.program is not None:
            state, rows, last_reg = self.program.run_group(self._state, buf, self.cfg_active,
                                                           self._axes)
            self._hold(state)
            self._pending.append(self._unit(rows, last_reg))
            self._feed_loop(len(buf))
            return
        with self.timer.device(f"{L.SPAN_UNIT}.group", buf[0][0]):
            frames = [piece for frame in buf
                      for piece in extract_pieces(*frame, self.cfg_active)]
            self.state, regs, loops = odometry_step_batched(self._live(), frames,
                                                            self.cfg_active)
        self._loop_iterations += loops
        self._raced_loop_iterations += loops
        self._pending.append(self._unit(trajectory_rows(regs, frames), regs[-1]))
        self._feed_loop(len(buf))

    def _drain(self, count: int) -> None:
        """Read the oldest ``count`` queued entries on the host (one
        transfer) into the trajectory, and observe their motion."""
        if count <= 0:
            return
        with self.timer.host("drain"):
            self._drain_units([self._pending.popleft() for _ in range(count)])

    def _drain_units(self, units: List[_Unit]) -> None:
        SYNCS["drain"] += 1
        host = torch.cat([u.rows for u in units]).cpu().numpy()
        start = 0
        for unit in units:
            rows = host[start:start + len(unit.rows)]
            start += len(unit.rows)
            prev = self.trajectory.positions[-1] if self.trajectory.positions else rows[0, 1:4]
            steps = np.diff(np.vstack([prev[None], rows[:, 1:4]]), axis=0)
            self._last_motion = float(np.linalg.norm(steps, axis=1).max())
            for row in rows:
                self.trajectory.times.append(float(row[0]))
                self.trajectory.positions.append(row[1:4].copy())
                self.trajectory.quaternions.append(row[4:8].copy())
                self.trajectory.accepted.append(bool(row[8]))
                self.iterations.append(int(row[9]))
            if unit.reg is not None and self.logger.enabled():
                self._log_unit(unit, rows[-1])
            if unit.raw is not None and self._pcd_dir is not None:
                # the registered raw frame (reference laser_mapping.hpp:1608-1611),
                # moved on the host by the endpoint pose, not deblurred
                from ..io.serialization import save_pcd

                q, t = rows[-1, 4:8], rows[-1, 1:4]
                R = se3.quat_to_matrix(torch.from_numpy(q.copy())).numpy()
                save_pcd(os.path.join(self._pcd_dir, f"aft_mapp_{unit.frame_idx}.pcd"),
                         unit.raw @ R.T + t)

    def _log_unit(self, unit: _Unit, last_row: np.ndarray) -> None:
        """The unit's ``mapping``, ``pcd_log`` and ``timer`` lines (the
        reference's logs, point_cloud_registration.hpp:534-557,
        laser_mapping.hpp:1506-1512): one read of its last registration."""
        reg = unit.reg
        SYNCS["log"] += 1
        vals = torch.stack([torch.as_tensor(v, device=reg.t_w.device).reshape(-1)[-1]
                            .to(torch.float64) for v in (
                                reg.final_cost, reg.inlier_threshold, reg.n_blocks,
                                reg.iterations, reg.angular_diff_deg, reg.t_diff,
                                reg.accepted)]).cpu().numpy()
        self.logger.printf(
            "mapping", "frame %d: cost=%.6f inlier_thr=%.6f blocks=%d iters=%d "
            "dR=%.3fdeg dT=%.3fm accepted=%d", unit.frame_idx, vals[0], vals[1], int(vals[2]),
            int(vals[3]), vals[4], vals[5], int(bool(vals[6])))
        self.logger.printf("pcd_log", "Curr_Q = %f,%f,%f,%f", *last_row[4:8])
        self.logger.printf("pcd_log", "Curr_T = %f,%f,%f", *last_row[1:4])
        self.logger.write("timer", f"{L.SPAN_FRAME}: {self.timer.toc(L.SPAN_FRAME):.3f} ms")

    def flush(self) -> None:
        """Dispatch a partial chunk or group, then copy every pending row
        to the host (one transfer)."""
        with self.timer.host("flush"):
            self._activate()
            if self._buf:
                if self.frame_batch > 1:
                    self._dispatch_group()
                else:
                    self._dispatch_chunk()
            self._drain(len(self._pending))
            if self.loop_closer is not None:
                # every queued keyframe processed before the loop output is read
                self.loop_closer.drain()

    def get_corrected_map(self, stride: int = 2, resolution: float = 0.0) -> np.ndarray:
        """The corrected global map after an accepted loop closure (the
        reference's /pc_aft_loop_closure, laser_mapping.hpp:1091-1100);
        raises if no loop was accepted."""
        if self.loop_closer is None or self.loop_closer.result is None:
            raise RuntimeError("no accepted loop closure to refine from")
        return self.loop_closer.corrected_map(self._live().cell_full, stride=stride,
                                              resolution=resolution)

    def get_surround_map(self, radius: float | None = None) -> np.ndarray:
        """The map around the current pose (the reference's surround
        publisher, `service_pub_surround_pts`, laser_mapping.hpp:1151-1201):
        the full-cloud cells within ``radius`` when loop closure keeps
        them, else the surface matching buffer, voxel-filtered at
        ``surround_pointcloud_resolution``.  Returns (N, 3) float32."""
        from ..map.cell_map import cells_in_radius, gather_cell_points

        mp = self.cfg.mapping
        radius = radius or max(mp.maximum_search_range_surface, 100.0)
        st = self._live()
        if st.cell_full is not None:
            batch = gather_cell_points(st.cell_full, cells_in_radius(st.cell_full, st.t_w, radius))
        else:
            batch = st.map_surface
        ds = voxel_downsample(batch, mp.surround_pointcloud_resolution)
        return ds.xyz[ds.mask].cpu().numpy()


def run_odometry(cfg: SlamConfig, n_frames: int,
                 sim: Optional[LivoxSimulator] = None, device=None,
                 mesh: Optional[Mesh] = None):
    """Simulate and process ``n_frames``; returns (pipeline, sim, wall_s)."""
    pipe = OdometryPipeline(cfg, device=device, mesh=mesh)
    sim = sim or LivoxSimulator()
    t0 = _time.perf_counter()
    for i in range(n_frames):
        xyz, inten, base_t = sim.frame(i)
        pipe.process_raw(xyz, inten, base_t)
    pipe.flush()
    if pipe.device.type == "cuda":
        torch.cuda.synchronize(pipe.device)
    return pipe, sim, _time.perf_counter() - t0
