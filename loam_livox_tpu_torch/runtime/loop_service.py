"""The loop-closure service (reference `service_loop_detection`,
``source/laser_mapping.hpp:874-1148``, and the keyframe production of
`process_new_scan`, ``:1523-1564``), the counterpart of
``loam_livox_tpu/runtime/loop_service.py``.

The frame thread only updates the keyframe accumulators: each frame's
touched cells (the full-cloud cell map's slots that took at least 3
points) are kept on the device as that frame's masked keys, and a
completed accumulator's union is formed on the device too, so the frame
path reads nothing on the host.  A completed keyframe joins a waiting
list bounded by ``maximum_keyframe_in_waiting_list`` (drop-oldest,
reference :1552-1555) with the cell map it completed against, which
the service keeps as it was handed (`LoopCloser.on_frame` says what a
caller must not overwrite).

The heavy work (the descriptor, the similarity scan, up to N scene
alignments, the pose-graph solve) runs on a worker thread
(``loop_closure/if_loop_service_async`` 1, the reference's detached
thread, :1683-1686) whose device work goes on a CUDA stream of its
own, or inline on the frame thread (0, the deterministic mode the tests
pin).  The worker's stream waits on an event recorded on the frame
stream when the keyframe completed, and the snapshot's tensors are
marked used on the worker's stream, so the caching allocator does not
hand their blocks to the frame stream while the worker reads them.
The worker's host reads (descriptor scalars, gate values, the
alignment's and ICP's loop exits, snapshots, the result) and its kernel
launches count into ``LoopCloser.counts`` (`core.accounting`), not into
the frame path's audit.

Behaviour, as in the JAX package:
* overlapping accumulators: a new one every ``scans_between_two_keyframe``
  frames, each complete after ``scans_of_each_keyframe`` frames
  (reference :1533-1560);
* the candidate gates in the reference's order (:988-1033): keyframe
  index separation; nonzero-ratio floors; |roi_range difference| ≤ 5 m;
  similarity (plane > planar threshold, or line > linear threshold and
  plane > 0.92); cell-count balance, whose reference expression is
  unsigned arithmetic meaning "skip if the candidate has more cells than
  the current keyframe";
* scene-alignment ICP: score > 2× the threshold skips 11 candidates
  ahead, < the threshold accepts, in between skips 6 (:1048-1108);
* on accept: the odometry chain of the keyframe poses plus one loop
  edge, solved, and the service ends (one-shot ``if_end``, :1110-1147).

With a dump directory (``dump_dir``) the service writes what the JAX
package's does, where it runs (the worker thread, or inline):
``keyframe_<frame>.json`` per keyframe in the reference's cell-map schema
(``loop_closure/if_dump_keyframe_data``, reference :972-977), per scene
alignment ``{i}_a/b/c.pcd`` and ``{i}_pair.json``
(``map_alignment_if_dump_matching_result``, scene_alignment.hpp:356-379),
and on an accepted loop ``loop.g2o``, ``poses_ori.txt`` and
``poses_opm.txt`` (reference :1080-1087), which `loop.map_refine.
refine_mapping` rebuilds the corrected map from.  Each dump reads the
device once, counted as ``dump`` in ``LoopCloser.counts``.  With
``common/if_verbose_screen_printf`` 0 (the reference's inverted flag) the
gate trace is echoed to the screen.
"""
from __future__ import annotations

import json
import os
import threading
import weakref
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..core import accounting, se3
from ..core.config import SlamConfig, require_supported
from ..core.types import PointBatch, resolve_device
from ..io.serialization import cell_map_to_json, save_g2o, save_pcd, save_poses_txt
from ..loop.keyframe import KeyframeDescriptor, describe_keyframe, max_similarity
from ..loop.map_refine import rebuild_corrected_map, refine_points
from ..loop.pose_graph import add_loop_edge, build_odometry_chain, optimize_pose_graph
from ..loop.scene_alignment import align_keyframes, extract_cells_of_type
from ..map.cell_map import (EMPTY_KEY, FEATURE_LINE, FEATURE_PLANE, CellMap,
                            gather_cell_points, member_mask_from_keys)

#: the descriptor fields the gates read as host numbers
_SCALARS = ("ratio_nonzero_line", "ratio_nonzero_plane", "roi_range", "n_cells",
            "n_line", "n_plane")


@dataclass
class KeyframeRecord:
    keys: torch.Tensor            # (K,) int32 member cell keys, EMPTY_KEY padded
    q: torch.Tensor               # (4,) world pose at completion
    t: torch.Tensor               # (3,)
    ending_frame_idx: int
    descriptor: Optional[KeyframeDescriptor] = None
    # The member cells' point pools when the keyframe completed (world
    # frame, host arrays): the directory resets a revisited cell in
    # place, so a keyframe keeps its own era's points (the reference keeps
    # the old cell alive instead, cell_map_keyframe.hpp:734-755).
    snap_line: Optional[np.ndarray] = None   # (Nl, 3) float32
    snap_plane: Optional[np.ndarray] = None
    snap_full: Optional[np.ndarray] = None


@dataclass
class _Accumulator:
    frame_keys: list = field(default_factory=list)   # each frame's masked keys
    frames: int = 0


@dataclass
class LoopClosureResult:
    accepted: bool
    his_idx: int
    cur_idx: int
    icp_score: float
    q_opt: Optional[np.ndarray] = None   # optimised keyframe poses
    t_opt: Optional[np.ndarray] = None


def key_union(frame_keys: List[torch.Tensor]) -> torch.Tensor:
    """The distinct keys of the frames' masked keys, ascending, padded with
    ``EMPTY_KEY`` to the total length (sorts only: no host read)."""
    s = torch.sort(torch.cat(frame_keys)).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    return torch.sort(torch.where(first, s, torch.full_like(s, EMPTY_KEY))).values


def settle(d: KeyframeDescriptor) -> KeyframeDescriptor:
    """The gates' scalars as host numbers, in one transfer: the ratios as
    float32 scalars (a gate compares them with its threshold in float32,
    as the JAX package's numpy scalars do), the ROI range as a float, the
    counts as ints.  The images and the centre stay tensors."""
    vals = torch.stack([torch.as_tensor(getattr(d, f)).to(torch.float64).reshape(())
                        for f in _SCALARS]).cpu().numpy()
    host = dict(zip(_SCALARS, vals))
    return d._replace(
        ratio_nonzero_line=np.float32(host["ratio_nonzero_line"]),
        ratio_nonzero_plane=np.float32(host["ratio_nonzero_plane"]),
        roi_range=float(host["roi_range"]),
        **{f: int(host[f]) for f in ("n_cells", "n_line", "n_plane")})


def _host_points(batch: PointBatch) -> np.ndarray:
    return np.ascontiguousarray(batch.xyz[batch.mask].cpu().numpy(), np.float32)


class LoopCloser:
    def __init__(self, cfg: SlamConfig, device=None, dump_dir: Optional[str] = None):
        require_supported(cfg)
        self.cfg = cfg
        self.lc = cfg.loop_closure
        self.device = resolve_device(device)
        self.keyframes: List[KeyframeRecord] = []
        self.updating: List[_Accumulator] = [_Accumulator()]
        # completed keyframes awaiting analysis: (record, cell-map snapshot,
        # frame-stream event or None)
        self.waiting: list = []
        self.dropped_keyframes = 0
        self.closed = False
        self.result: Optional[LoopClosureResult] = None
        self.gate_trace: List[dict] = []
        #: the service's host reads and kernel launches, by place
        self.counts = {"descriptor": 0, "snapshot": 0, "gate": 0, "align_exit": 0,
                       "icp_exit": 0, "result": 0, "dump": 0, "knn_fused": 0,
                       "voxel_centroid": 0}
        self.dump_dir = dump_dir
        self._pair_idx = 0                      # scene-alignment dumps written
        # the reference's inverted screen flag: 0 echoes (tools_logger.hpp:51-80)
        self._screen = cfg.common.if_verbose_screen_printf == 0
        self._incremental = bool(cfg.common.if_update_mean_and_cov_incrementally)
        # the 6×6 and (6N)² solves and the correlations stay full f32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._busy = False
        self._stop = False
        self._worker: Optional[threading.Thread] = None
        self._stream = None
        if self.lc.if_loop_service_async:
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
            self._worker = threading.Thread(target=self._service_loop,
                                            name="loop_detection", daemon=True)
            self._worker.start()
            # join the worker when the service is collected or at exit
            self._finalizer = weakref.finalize(
                self, LoopCloser._shutdown_parts, self._lock, self._work, self._worker,
                weakref.ref(self))

    @staticmethod
    def _shutdown_parts(lock, cond, worker, self_ref) -> None:
        obj = self_ref()
        with lock:
            if obj is not None:
                obj._stop = True
            cond.notify_all()
        if obj is not None:
            worker.join(timeout=5.0)

    @property
    def busy(self) -> bool:
        """Whether a keyframe is being processed."""
        return self._busy

    # ---- per-frame accumulation (frame thread) ---------------------------
    def completes_keyframe(self) -> bool:
        """Whether the next `on_frame` completes a keyframe."""
        return not self.closed and self.updating[0].frames + 1 >= self.lc.scans_of_each_keyframe

    def on_frame(self, cell_full: CellMap, touched: torch.Tensor, q_w, t_w,
                 frame_idx: int) -> Optional[KeyframeRecord]:
        """Feed one registered frame's touched-cell mask and pose (device
        tensors; nothing is read on the host).  Returns the keyframe that
        completed, if one did: inline it is processed before returning,
        async the worker processes it later.

        What it keeps: ``touched`` and ``cell_full.keys`` are read here,
        on the frame stream, into a new tensor; ``q_w`` and ``t_w`` go into
        the record of a keyframe that completes here, and ``cell_full``
        (every tensor of it) waits with that record until the keyframe is
        processed (`completes_keyframe` says beforehand).  A caller that
        overwrites its tensors later (the frame program's static state)
        hands copies of what is kept."""
        if self.closed:
            return None
        fkeys = torch.where(touched, cell_full.keys, torch.full_like(cell_full.keys, EMPTY_KEY))
        for acc in self.updating:
            acc.frame_keys.append(fkeys)
            acc.frames += 1

        completed = None
        if self.updating[0].frames >= self.lc.scans_of_each_keyframe:
            acc = self.updating.pop(0)
            completed = KeyframeRecord(keys=key_union(acc.frame_keys), q=q_w, t=t_w,
                                       ending_frame_idx=frame_idx)
            event = None
            if self._stream is not None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            # reference order (laser_mapping.hpp:1541, 1552-1555): enqueue,
            # drop the oldest past the bound, the service takes the front
            with self._lock:
                self.waiting.append((completed, cell_full, event))
                if len(self.waiting) > self.lc.maximum_keyframe_in_waiting_list:
                    self.waiting.pop(0)
                    self.dropped_keyframes += 1
                self._work.notify()
            if self._worker is None:
                self._drain_waiting()
        if not self.updating or self.updating[-1].frames >= self.lc.scans_between_two_keyframe:
            self.updating.append(_Accumulator())
        return completed

    def _take(self):
        """The front of the waiting list; the caller holds the lock."""
        rec, m, event = self.waiting.pop(0)
        self._busy = True
        return rec, m, event

    def _run(self, rec: KeyframeRecord, m: CellMap, event) -> None:
        try:
            if m is None:
                # restored from a checkpoint without the live map
                # (`runtime.checkpoint.load_loop_state`)
                with self._lock:
                    self.dropped_keyframes += 1
                return
            if self._stream is None:
                with accounting.charged_to(self.counts):
                    self.process_keyframe(rec, m)
                return
            self._stream.wait_event(event)
            for t in (*m[1:8], rec.keys, rec.q, rec.t):
                t.record_stream(self._stream)
            with torch.cuda.stream(self._stream), accounting.charged_to(self.counts):
                self.process_keyframe(rec, m)
            self._stream.synchronize()
        finally:
            with self._lock:
                self._busy = False
                self._work.notify_all()

    def _drain_waiting(self) -> None:
        """Process the waiting list inline (sync mode)."""
        while True:
            with self._lock:
                if not self.waiting or self.closed:
                    return
                item = self._take()
            self._run(*item)

    def _service_loop(self) -> None:
        """The worker: take keyframes until a loop is accepted (one-shot,
        reference :1110, 1143-1147) or the service stops."""
        while True:
            with self._lock:
                while not self.waiting and not self._stop and not self.closed:
                    self._work.wait()
                if self._stop or self.closed:
                    return
                item = self._take()
            self._run(*item)

    def drain(self, timeout: float | None = None) -> None:
        """Block until every queued keyframe is processed or the service
        has closed (`OdometryPipeline.flush` calls it)."""
        if self._worker is None:
            self._drain_waiting()
            return
        with self._lock:
            self._work.wait_for(lambda: self.closed or (not self.waiting and not self._busy),
                                timeout=timeout)

    def shutdown(self) -> None:
        with self._lock:
            self._stop = True
            self._work.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None

    # ---- keyframe analysis and the loop scan ----------------------------
    def process_keyframe(self, rec: KeyframeRecord, m: CellMap) -> None:
        member = member_mask_from_keys(m, rec.keys)
        self.counts["descriptor"] += 3   # two 3 × 3 moments, then the scalars
        rec.descriptor = settle(describe_keyframe(m, member, incremental=self._incremental))
        self.counts["snapshot"] += 3
        rec.snap_line = _host_points(extract_cells_of_type(m, member, FEATURE_LINE,
                                                           incremental=self._incremental))
        rec.snap_plane = _host_points(extract_cells_of_type(m, member, FEATURE_PLANE,
                                                            incremental=self._incremental))
        rec.snap_full = _host_points(gather_cell_points(m, member))
        self.keyframes.append(rec)
        if self.lc.if_dump_keyframe_data and self.dump_dir:
            self._dump_keyframe(rec, m, member)
        if self.closed or not self.lc.if_enable_loop_closure:
            return
        self._scan_for_loop()

    def _trace(self, his: int, stage: str, **vals) -> None:
        """One candidate's gate record (the reference prints these values
        during the scan, laser_mapping.hpp:1002-1057)."""
        entry = {"cur": len(self.keyframes) - 1, "his": his, "stage": stage, **vals}
        self.gate_trace.append(entry)
        if self._screen:
            print(f"[loop] {entry}", flush=True)

    def _scan_for_loop(self) -> None:
        lc = self.lc
        d_last = self.keyframes[-1].descriptor
        n = len(self.keyframes)
        his = 0
        while his < n - 1:
            if n - his < lc.minimum_keyframe_differen:
                break  # every later candidate is too recent
            d_his = self.keyframes[his].descriptor
            if (d_his.ratio_nonzero_plane < lc.avail_ratio_plane
                    and d_his.ratio_nonzero_line < lc.avail_ratio_line):
                self._trace(his, "ratio", rz_plane=float(d_his.ratio_nonzero_plane),
                            rz_line=float(d_his.ratio_nonzero_line))
                his += 1
                continue
            if abs(d_his.roi_range - d_last.roi_range) > 5.0:
                self._trace(his, "roi", roi_his=d_his.roi_range, roi_last=d_last.roi_range)
                his += 1
                continue
            self.counts["gate"] += 1
            sim_plane, sim_line = torch.stack([
                max_similarity(d_last.img_plane, d_his.img_plane),
                max_similarity(d_last.img_line, d_his.img_line)]).tolist()
            ok = ((sim_line > lc.minimum_similarity_linear and sim_plane > 0.92)
                  or sim_plane > lc.minimum_similarity_planar)
            self._trace(his, "similarity", sim_plane=sim_plane, sim_line=sim_line, passed=ok)
            if not ok:
                his += 1
                continue
            # the cell-count balance, as the reference behaves (module doc)
            if d_his.n_cells > d_last.n_cells:
                self._trace(his, "cell_balance", n_his=d_his.n_cells, n_last=d_last.n_cells)
                his += 1
                continue
            res = self._verify_icp(self.keyframes[-1], self.keyframes[his])
            score = float(res.inlier_threshold)
            self._trace(his, "icp", score=score)
            if score > 2.0 * lc.map_alignment_inlier_threshold:
                his += 11
                continue
            if score < lc.map_alignment_inlier_threshold:
                self._accept_loop(his, n - 1, res)
                return
            his += 6

    def _verify_icp(self, last: KeyframeRecord, his: KeyframeRecord):
        """Align the historical keyframe's era snapshot onto the current
        one's.  Not the live directory: it may have reset a historical
        keyframe's cells with the current pass's points.  The snapshots go
        up unpadded (the JAX package pads them to the directory's C·P rows
        for its static shapes; the voxel filters' output is the same)."""
        def batch(xyz: np.ndarray) -> PointBatch:
            pts = torch.from_numpy(xyz).to(self.device)
            return PointBatch(xyz=pts, time=torch.zeros(len(xyz), device=self.device),
                              mask=torch.ones(len(xyz), dtype=torch.bool, device=self.device))

        # the starting translation is zero, not the centre difference
        # (`loop.scene_alignment.align_keyframes`)
        res = align_keyframes(batch(last.snap_line), batch(last.snap_plane),
                              batch(his.snap_line), batch(his.snap_plane),
                              last.descriptor.center, his.descriptor.center, self.cfg,
                              init_t=torch.zeros(3, device=self.device))
        if self.lc.map_alignment_if_dump_matching_result and self.dump_dir:
            self._dump_matching_pair(last, his, res)
        return res

    def _accept_loop(self, his_idx: int, cur_idx: int, align) -> None:
        qs = torch.stack([k.q.to(self.device) for k in self.keyframes]).to(torch.float32)
        ts = torch.stack([k.t.to(self.device) for k in self.keyframes]).to(torch.float32)
        n = qs.shape[0]
        g = build_odometry_chain(qs, ts, capacity_edges=n)
        # loop edge cur → his: the alignment moved the historical cloud into
        # the current (drifted) frame, so his's corrected pose is
        # icp ∘ T_his and the measured relative pose T_cur⁻¹ ∘ (icp ∘ T_his)
        # (reference laser_mapping.hpp:1062-1083, scene_alignment.hpp:97-129)
        q_cur_inv = se3.quat_conjugate(qs[cur_idx])
        rel_q = se3.quat_multiply(q_cur_inv, se3.quat_multiply(align.q, qs[his_idx]))
        rel_t = se3.quat_rotate(q_cur_inv, se3.quat_rotate(align.q, ts[his_idx]) + align.t
                                - ts[cur_idx])
        g = add_loop_edge(g, n - 1, cur_idx, his_idx, rel_q, rel_t)
        q_opt, t_opt, _ = optimize_pose_graph(g)
        self.counts["result"] += 1
        q_opt, t_opt, score = q_opt.cpu().numpy(), t_opt.cpu().numpy(), \
            float(align.inlier_threshold)
        self.result = LoopClosureResult(accepted=True, his_idx=his_idx, cur_idx=cur_idx,
                                        icp_score=score, q_opt=q_opt, t_opt=t_opt)
        self.closed = True   # one-shot (reference if_end, :1110)
        if self.dump_dir:
            self._dump_artifacts(g, qs, ts)

    # ---- dumps (module doc) ------------------------------------------------
    def _dump_keyframe(self, rec: KeyframeRecord, m: CellMap, member: torch.Tensor) -> None:
        """The keyframe's member cells in the reference's JSON schema
        (reference laser_mapping.hpp:972-977)."""
        os.makedirs(self.dump_dir, exist_ok=True)
        self.counts["dump"] += 1
        cells = cell_map_to_json(m, member)
        with open(os.path.join(self.dump_dir, f"keyframe_{rec.ending_frame_idx}.json"), "w") as f:
            json.dump(cells, f)

    def _dump_matching_pair(self, last: KeyframeRecord, his: KeyframeRecord, res) -> None:
        """One scene alignment (reference scene_alignment.hpp:356-379): the
        two keyframes' line and plane snapshots, the historical one moved
        by the solved pose, as PCDs, and the pose and score as JSON."""
        os.makedirs(self.dump_dir, exist_ok=True)
        i = self._pair_idx
        self._pair_idx += 1
        self.counts["dump"] += 1
        host = torch.cat([res.q.reshape(4), res.t.reshape(3),
                          res.inlier_threshold.reshape(1).to(torch.float32)]).cpu()
        q, t = host[:4], host[4:7]
        a = np.concatenate([last.snap_line, last.snap_plane], axis=0)
        b = np.concatenate([his.snap_line, his.snap_plane], axis=0)
        c = b @ se3.quat_to_matrix(q).numpy().T + t.numpy()
        save_pcd(os.path.join(self.dump_dir, f"{i}_a.pcd"), a)
        save_pcd(os.path.join(self.dump_dir, f"{i}_b.pcd"), b)
        save_pcd(os.path.join(self.dump_dir, f"{i}_c.pcd"), c)
        with open(os.path.join(self.dump_dir, f"{i}_pair.json"), "w") as f:
            json.dump({"q_wxyz": q.numpy().tolist(), "t": t.numpy().tolist(),
                       "inlier_threshold": float(host[7])}, f)

    def _dump_artifacts(self, g, qs: torch.Tensor, ts: torch.Tensor) -> None:
        """``loop.g2o`` (the graph's edges and the original keyframe poses)
        and ``poses_ori.txt`` / ``poses_opm.txt`` in the reference's
        formats (laser_mapping.hpp:1080-1087)."""
        os.makedirs(self.dump_dir, exist_ok=True)
        self.counts["dump"] += 1
        parts = (g.edge_mask, g.edge_i, g.edge_j, g.rel_t, g.rel_q, qs, ts)
        host = torch.cat([p.reshape(-1).to(torch.float64) for p in parts]).cpu().numpy()
        e, n = g.edge_mask.shape[0], qs.shape[0]
        cols = np.cumsum([0, e, e, e, 3 * e, 4 * e, 4 * n, 3 * n])
        mask, ei, ej, rel_t, rel_q, q_ori, t_ori = (host[a:b] for a, b in zip(cols[:-1], cols[1:]))
        rel_t, rel_q = rel_t.reshape(e, 3).astype(np.float32), rel_q.reshape(e, 4).astype(np.float32)
        q_ori, t_ori = q_ori.reshape(n, 4).astype(np.float32), t_ori.reshape(n, 3).astype(np.float32)
        edges = [{"id_begin": int(ei[k]), "id_end": int(ej[k]), "t": rel_t[k], "q_wxyz": rel_q[k]}
                 for k in np.nonzero(mask)[0]]
        save_g2o(os.path.join(self.dump_dir, "loop.g2o"), t_ori, q_ori, edges)
        save_poses_txt(os.path.join(self.dump_dir, "poses_ori.txt"), t_ori, q_ori)
        save_poses_txt(os.path.join(self.dump_dir, "poses_opm.txt"),
                       self.result.t_opt, self.result.q_opt)

    # ---- map refinement (reference Mapping_refine,
    # ceres_pose_graph_3d.hpp:437-500) -----------------------------------
    def _keyframe_cloud(self, m: CellMap, idx: int) -> np.ndarray:
        """Keyframe ``idx``'s member points: its era snapshot, or else the
        live directory's pools."""
        rec = self.keyframes[idx]
        if rec.snap_full is not None:
            return rec.snap_full
        return _host_points(gather_cell_points(m, member_mask_from_keys(m, rec.keys)))

    def refine_keyframe_cloud(self, m: CellMap, idx: int) -> np.ndarray:
        """Keyframe ``idx``'s points moved by its correction T_opt · T_ori⁻¹."""
        if self.result is None or not self.result.accepted:
            raise RuntimeError("no accepted loop closure to refine from")
        rec = self.keyframes[idx]
        return refine_points(self._keyframe_cloud(m, idx), rec.q.cpu(), rec.t.cpu(),
                             self.result.q_opt[idx], self.result.t_opt[idx])

    def corrected_map(self, m: CellMap, stride: int = 2, resolution: float = 0.0
                      ) -> np.ndarray:
        """The corrected global map after an accepted loop: every
        ``stride``-th keyframe's cloud moved and merged (the reference's
        /pc_aft_loop_closure, laser_mapping.hpp:1091-1100, stride 2)."""
        if self.result is None or not self.result.accepted:
            raise RuntimeError("no accepted loop closure to refine from")
        clouds = [self._keyframe_cloud(m, i) for i in range(len(self.keyframes))]
        qs = np.stack([k.q.cpu().numpy() for k in self.keyframes])
        ts = np.stack([k.t.cpu().numpy() for k in self.keyframes])
        return rebuild_corrected_map(clouds, (ts, qs), (self.result.t_opt, self.result.q_opt),
                                     stride=stride, resolution=resolution)
