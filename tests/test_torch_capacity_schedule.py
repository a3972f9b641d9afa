"""The port's adaptive capacity schedule
(`loam_livox_tpu_torch.runtime.capacity_schedule`) against the JAX
package's on the CPU.

* Op level, bit-equal: `scaled_caps` field by field at scales 1-1,024 on
  the default, SMALL and shipped-profile configurations; `needs_growth`
  on the same fill vectors (a fill equal to a saturation field's
  capacity, fills at and just over the watermark); `measure_fills` and
  `resize_state` of a JAX state carried over with
  `interop.state_from_numpy`; `schedule_active` over its truth table.
* Truncation: at tier 16 of the default capacities a 10,000-point frame
  overfills ``max_surface_ds`` (256 slots), the history surface slot
  (128 rows) and, appended to a nearly full buffer, the matching
  buffer's tail.  With registration not yet enabled (the pose stays the
  identity, so no rounding of a transform enters) the port's ICP input
  filter, world filter, ring write and append keep exactly the JAX
  package's points, bit for bit.
* Streams, with ``auto_schedule`` 1 on both sides: the SMALL capacities
  of tests/test_capacity_schedule.py, ``schedule_start_scale`` 8 and
  watermark 0.7, frames of 10,000 points (at that package's 3,072
  points the two packages part from frame 5 with the schedule on or
  off: the frames are too weakly constrained).  Sequentially (12
  frames: growths at frames 4 and 8) and chunked (``dispatch_chunk`` 4,
  16 frames: one check after 4 chunks, the history slot long saturated
  at tier 8) the scale after every raw frame, the growth
  count and the buffer shapes are equal, and the trajectory agrees
  under `first_match` (tests/test_torch_odometry.py): aligned ATE within
  0.05 m of the JAX run's on the input or on the input one ulp away,
  accepted rows within 2.
* Checkpoint: a run saved right after its growth at frame 8 (scale 2,
  both countdowns at 4) writes ``capacity_scale.txt``, and the resumed
  run equals the uninterrupted one bit for bit; a directory without the
  file loads at scale 1.
"""
import dataclasses
from typing import List, NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import config as JC
from loam_livox_tpu.core.types import PointBatch as JPointBatch
from loam_livox_tpu.eval.ate import ate_rmse
from loam_livox_tpu.core.types import FeatureFrame as JFeatureFrame
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.ops.voxel import voxel_downsample as jvoxel
from loam_livox_tpu.runtime import capacity_schedule as J
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.parallel.mesh import Mesh
from loam_livox_tpu_torch.runtime import capacity_schedule as T
from loam_livox_tpu_torch.runtime import checkpoint as ck
from loam_livox_tpu_torch.runtime.odometry import input_downsample
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline, extract_pieces
from test_torch_checkpoint import assert_states_equal
from test_torch_odometry import first_match, one_ulp, state_fields

torch.set_num_threads(2)

#: tests/test_capacity_schedule.py's capacities
SMALL = {
    "max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
    "max_corner_ds": 256, "max_surface_ds": 1024,
    "map_corner_capacity": 4096, "map_surf_capacity": 16384,
    "hist_corner_capacity": 128, "hist_surf_capacity": 1024,
    "history_window": 16,
}
INIT = 4


def port(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


def stream_config(**parallel):
    return JC.SlamConfig().replace(
        common={"if_motion_deblur": 0, "piecewise_number": 1},
        mapping={"init_accumulate_frames": INIT},
        capacity={**SMALL, "max_raw_points": 16384, "auto_schedule": 1,
                  "schedule_start_scale": 8, "schedule_watermark": 0.7},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3},
        parallel=parallel)


CONFIGS = {
    "default": JC.SlamConfig(),
    "small": JC.SlamConfig().replace(capacity=SMALL),
    "precision": JC.precision_profile(),
    "realtime": JC.realtime_profile(),
    "realtime_racing": JC.realtime_racing_profile(),
    "largescale": JC.largescale_profile(),
    "bounded": JC.SlamConfig().replace(capacity=JC.bounded_scene_caps()),
}
SCALES = [1, 2, 3, 4, 8, 16, 32, 64, 100, 128, 256, 512, 1000, 1024]


# ---------------------------------------------------------------- ops --

@pytest.mark.parametrize("name", list(CONFIGS))
def test_scaled_caps_match_jax(name):
    cfg = CONFIGS[name]
    assert T.SCALED_FIELDS == J.SCALED_FIELDS
    assert T.SATURATION_FIELDS == J.SATURATION_FIELDS and T.FILL_FIELDS == J.FILL_FIELDS
    for scale in SCALES:
        want = dataclasses.asdict(J.scaled_caps(cfg, scale))
        got = dataclasses.asdict(T.scaled_caps(port(cfg), scale))
        assert got == want, scale


@pytest.mark.parametrize("name", ["default", "small", "realtime"])
def test_needs_growth_matches_jax(name):
    rng = np.random.default_rng(5)
    outcomes = set()
    for scale in (1, 2, 4, 8, 16):
        jcfg = J.scaled_caps(CONFIGS[name], scale)
        tcfg = T.scaled_caps(port(CONFIGS[name]), scale)
        caps = np.array([getattr(jcfg.capacity, f) for f in J.FILL_FIELDS])
        wm = 0.7
        vectors = [rng.integers(0, caps * 1.1 + 1) for _ in range(20)]
        for k, f in enumerate(J.FILL_FIELDS):
            base = (caps * 0.1).astype(np.int64)
            for fill in (caps[k], caps[k] - 1, int(wm * caps[k]), int(wm * caps[k]) + 1):
                v = base.copy()
                v[k] = fill
                vectors.append(v)
        for v in vectors:
            v = v.astype(np.int32)
            want = J.needs_growth(v, jcfg, wm)
            assert T.needs_growth(v, tcfg, wm) == want, (scale, v)
            assert T.needs_growth(torch.from_numpy(v), tcfg, wm) == want
            outcomes.add(want)
    assert outcomes == {True, False}


def filled_jax_state(cfg, seed=0):
    """A JAX state at ``cfg``'s capacities with random points in the
    history ring and the matching buffers, valid prefixes of random
    length, and a moved pose."""
    rng = np.random.default_rng(seed)
    st = jinit_state(cfg)

    def ring(mask):
        w, c = mask.shape
        valid = np.arange(c)[None, :] < rng.integers(0, c + 1, (w, 1))
        return (jnp.asarray(rng.uniform(-20, 20, (w, c, 3)).astype(np.float32)),
                jnp.asarray(valid))

    def buffer(b):
        c = b.capacity
        return JPointBatch(jnp.asarray(rng.uniform(-20, 20, (c, 3)).astype(np.float32)),
                           jnp.asarray(rng.uniform(0, 0.1, c).astype(np.float32)),
                           jnp.arange(c) < int(rng.integers(1, c)))

    hc, hcm = ring(st.hist_corner_mask)
    hs, hsm = ring(st.hist_surf_mask)
    return st._replace(
        q_w=jnp.asarray([0.9, 0.1, -0.3, 0.2], jnp.float32) / np.sqrt(0.95),
        t_w=jnp.asarray([1.5, -2.0, 0.25], jnp.float32), frame_count=jnp.int32(9),
        hist_corner_xyz=hc, hist_corner_mask=hcm, hist_surf_xyz=hs, hist_surf_mask=hsm,
        hist_ptr=jnp.int32(9), hist_len=jnp.int32(9),
        map_corners=buffer(st.map_corners), map_surface=buffer(st.map_surface))


def test_measure_fills_of_a_carried_state():
    cfg = J.scaled_caps(stream_config(), 8)
    for seed in range(3):
        st = filled_jax_state(cfg, seed)
        want = np.asarray(J.measure_fills(st))
        got = T.measure_fills(state_from_numpy(state_fields(st), "cpu"))
        assert got.dtype == torch.int32 and got.shape == (6,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_resize_state_matches_jax():
    cfg = stream_config()
    low, high = J.scaled_caps(cfg, 8), J.scaled_caps(cfg, 2)
    st = filled_jax_state(low)
    want = state_from_numpy(state_fields(J.resize_state(st, high)), "cpu")
    before = state_from_numpy(state_fields(st), "cpu")
    got = T.resize_state(before, port(high))
    assert_states_equal(got, want)
    for name in ("hist_corner_xyz", "hist_corner_mask", "hist_surf_xyz", "hist_surf_mask"):
        a, b = getattr(before, name), getattr(got, name)
        assert b.dtype == a.dtype and b.shape[0] == a.shape[0]
        assert torch.equal(b[:, :a.shape[1]], a) and not b[:, a.shape[1]:].any()
    # the corner slot sits at its floor (64) at both tiers
    assert got.hist_corner_xyz is before.hist_corner_xyz
    assert got.hist_surf_xyz.shape[1] == 4 * before.hist_surf_xyz.shape[1]
    for name in ("map_corners", "map_surface"):
        a, b = getattr(before, name), getattr(got, name)
        assert b.capacity == getattr(high.capacity, {"map_corners": "map_corner_capacity",
                                                      "map_surface": "map_surf_capacity"}[name])
        for f in ("xyz", "time", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert torch.equal(y[:len(x)], x) and not y[len(x):].any(), (name, f)
    assert got.q_w is before.q_w and got.rng is before.rng
    # the port's own fields: loop closure's cell map and touched mask
    # stay as they are, and a shrink raises
    loop = port(high).replace(loop_closure={"if_enable_loop_closure": 1},
                              capacity={"cell_capacity": 256, "cell_point_capacity": 4})
    from loam_livox_tpu_torch.runtime.odometry import init_state

    small_loop = init_state(T.scaled_caps(loop, 4), "cpu")
    big_loop = T.resize_state(small_loop, loop)
    for f in big_loop.cell_full._fields:
        assert getattr(big_loop.cell_full, f) is getattr(small_loop.cell_full, f), f
    assert big_loop.last_touched is small_loop.last_touched
    assert big_loop.map_surface.capacity == loop.capacity.map_surf_capacity
    with pytest.raises(ValueError, match="grow-only"):
        T.resize_state(got, port(low))


PARALLEL = [{}, {"frame_batch": 3}, {"dispatch_chunk": 4}, {"mesh_devices": 2},
            {"deterministic": 1}, {"deterministic": 0}]
OTHER = [{}, {"capacity": {"auto_schedule": 0}},
         {"optimization": {"correspondence": "grid"}},
         {"optimization": {"correspondence": "dense"}},
         {"mapping": {"matching_mode": 1}},
         {"loop_closure": {"if_enable_loop_closure": 1}}]


def test_schedule_active_truth_table():
    seen = set()
    for par in PARALLEL:
        for other in OTHER:
            cfg = JC.SlamConfig().replace(parallel=par, **other)
            for mesh in (None, Mesh(rank=0, size=1, backend="gloo")):
                want = J.schedule_active(cfg, None if mesh is None else object())
                assert T.schedule_active(port(cfg), mesh) == want, (par, other, mesh)
                seen.add(want)
    assert seen == {True, False}
    # the shipped default runs the schedule, from 1/16 of the capacities
    pipe = OdometryPipeline(port(JC.SlamConfig()), device="cpu")
    assert pipe.scheduler is not None and pipe.scheduler.scale == 16
    assert pipe.state.map_surface.capacity == 65536 // 16
    assert pipe.state.hist_surf_xyz.shape[1] == 128
    assert pipe.cfg.capacity.map_surf_capacity == 65536
    assert OdometryPipeline(port(JC.SlamConfig().replace(mapping={"matching_mode": 1})),
                            device="cpu").scheduler is None


# ---------------------------------------------------------- truncation --

def to_jax_frame(fr) -> JFeatureFrame:
    def batch(b):
        return JPointBatch(*(jnp.asarray(x.numpy()) for x in b))
    return JFeatureFrame(batch(fr.corners), batch(fr.surface), batch(fr.full),
                         jnp.asarray(fr.time_min.numpy()), jnp.asarray(fr.time_max.numpy()))


def test_truncation_at_tier_16_matches_jax():
    cfg = J.scaled_caps(JC.SlamConfig().replace(mapping={"init_accumulate_frames": 100}), 16)
    caps, fe = cfg.capacity, cfg.feature_extraction
    tcfg = port(cfg)
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0))
    xyz, inten, t0 = sim.frame(3)
    n = caps.max_raw_points
    pts, it, m = np.zeros((n, 3), np.float32), np.zeros(n, np.float32), np.zeros(n, bool)
    pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
    # the frame from the port's front end (tests/test_torch_ops.py holds
    # it to the JAX one), handed to both steps
    (tfr,) = extract_pieces(torch.from_numpy(pts), torch.from_numpy(it), torch.from_numpy(m),
                            t0, tcfg)
    fr = to_jax_frame(tfr)

    # the ICP input filter truncates to max_surface_ds
    jsurf = jvoxel(fr.surface, fe.mapping_plane_resolution, capacity=caps.max_surface_ds)
    unbounded = jvoxel(fr.surface, fe.mapping_plane_resolution)
    assert int(unbounded.mask.sum()) > caps.max_surface_ds == int(jsurf.mask.sum())
    tcorner, tsurf = input_downsample(tfr, tcfg)
    jcorner = jvoxel(fr.corners, fe.mapping_line_resolution, capacity=caps.max_corner_ds)
    for a, b in ((tsurf, jsurf), (tcorner, jcorner)):
        for f in ("xyz", "time", "mask"):
            np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)))

    # one step: the world filter into the ring slot, and the append to
    # matching buffers 10 rows short of full (frame 1: off the rebuild
    # cadence), clipped at the tail
    rng = np.random.default_rng(0)

    def nearly_full(b):
        c = b.capacity
        return JPointBatch(jnp.asarray(rng.uniform(-20, 20, (c, 3)).astype(np.float32)),
                           b.time, jnp.arange(c) < c - 10)

    st = jinit_state(cfg)
    st = st._replace(frame_count=jnp.int32(1), map_corners=nearly_full(st.map_corners),
                     map_surface=nearly_full(st.map_surface))
    jnew, jreg = jstep(st, fr, cfg)
    tnew, treg = tstep(state_from_numpy(state_fields(st), "cpu"), tfr, tcfg)
    after = state_fields(jnew)
    assert not bool(jreg.enabled) and bool(jreg.accepted) and bool(treg.accepted)
    assert int(after["hist_surf_mask"][0].sum()) == caps.hist_surf_capacity
    assert int(after["map_surface.mask"].sum()) == caps.map_surf_capacity
    for name in ("q_w", "t_w", "hist_corner_xyz", "hist_corner_mask", "hist_surf_xyz",
                 "hist_surf_mask"):
        np.testing.assert_array_equal(getattr(tnew, name).numpy(), after[name], err_msg=name)
    for name in ("map_corners", "map_surface"):
        for f in ("xyz", "mask"):
            np.testing.assert_array_equal(getattr(getattr(tnew, name), f).numpy(),
                                          after[f"{name}.{f}"], err_msg=f"{name}.{f}")


# ------------------------------------------------------------- streams --

class Run(NamedTuple):
    scales: List[int]            # the scale after each raw frame
    shapes: List[tuple]          # the scheduled buffers' shapes after each
    growths: int
    ate: float
    accepted: int
    rows: int


def run_stream(pipe, frames: int, nudge=0) -> Run:
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))
    scales, shapes = [], []
    for i in range(frames):
        xyz, inten, t0 = sim.frame(i)
        pipe.process_raw(one_ulp(xyz, nudge) if nudge else xyz, inten, t0)
        st = pipe.state
        scales.append(pipe.scheduler.scale)
        shapes.append(tuple(tuple(x.shape) for x in (
            st.hist_corner_xyz, st.hist_surf_xyz, st.map_corners.xyz, st.map_surface.xyz)))
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    return Run(scales, shapes, pipe.scheduler.growths, ate_rmse(est, gt),
               int(sum(pipe.trajectory.accepted)), len(est))


@pytest.mark.parametrize("chunk, ladder", [
    (1, [8, 8, 8, 4, 4, 4, 4, 2, 2, 2, 2, 2]),
    (4, [8] * 15 + [4]),
])
def test_scheduled_stream_matches_jax(chunk, ladder):
    cfg = stream_config(dispatch_chunk=chunk)
    frames = len(ladder)
    got = run_stream(OdometryPipeline(port(cfg), device="cpu"), frames)
    assert got.rows == frames and got.ate < 0.35, got

    def check(want):
        assert got.scales == want.scales, (got.scales, want.scales)
        assert got.growths == want.growths and got.shapes == want.shapes
        assert abs(got.ate - want.ate) < 0.05, (got.ate, want.ate)
        assert abs(got.accepted - want.accepted) <= 2, (got.accepted, want.accepted)

    first_match(check, (run_stream(JaxPipeline(cfg), frames, nudge) for nudge in (0, 1, -1)))
    # the check counts dispatch units: after 4 frames, or after 4 chunks
    assert got.scales == ladder


# ---------------------------------------------------------- checkpoint --

def test_checkpoint_resumes_at_its_tier(tmp_path):
    cfg = port(stream_config())
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))
    frames = [sim.frame(i) for i in range(12)]
    whole = OdometryPipeline(cfg, device="cpu")
    for f in frames[:8]:
        whole.process_raw(*f)
    # the split lies right after the growth at frame 8
    assert whole.ladder == [(4, 4), (8, 2)]
    assert (whole._sched_countdown, whole._sched_interval) == (4, 4)
    ck.save_pipeline(whole, str(tmp_path / "ckpt"))
    with open(tmp_path / "ckpt" / "capacity_scale.txt") as f:
        assert f.read() == "2"
    for f in frames[8:]:
        whole.process_raw(*f)
    whole.flush()

    second = ck.load_pipeline(str(tmp_path / "ckpt"), cfg, device="cpu")
    assert second.scheduler.scale == 2
    assert dataclasses.asdict(second.cfg_active) == dataclasses.asdict(T.scaled_caps(cfg, 2))
    for f in frames[8:]:
        second.process_raw(*f)
    second.flush()
    for name in ("times", "positions", "quaternions", "accepted"):
        np.testing.assert_array_equal(np.asarray(getattr(second.trajectory, name)),
                                      np.asarray(getattr(whole.trajectory, name)[8:]),
                                      err_msg=name)
    assert_states_equal(second.state, whole.state)
    assert second.scheduler.scale == whole.scheduler.scale

    # a directory without the tier file holds a state at the configured
    # capacities (here: saved with the schedule off), and loads at scale 1
    fixed = OdometryPipeline(cfg.replace(capacity={"auto_schedule": 0}), device="cpu")
    for f in frames[:2]:
        fixed.process_raw(*f)
    ck.save_pipeline(fixed, str(tmp_path / "fixed"))
    assert not (tmp_path / "fixed" / "capacity_scale.txt").exists()
    back = ck.load_pipeline(str(tmp_path / "fixed"), cfg, device="cpu")
    assert back.scheduler.scale == 1 and back.scheduler.at_max()
    assert back.state.map_surface.capacity == cfg.capacity.map_surf_capacity
    assert_states_equal(back.state, fixed.state)
