"""Cell matching mode (``mapping/matching_mode`` 1): the port's odometry
step against the JAX package's, teacher-forced, on the CPU.

The JAX package runs a simulator stream in cell mode.  Before every
frame t its ``OdometryState``, cell maps included, is carried into the
port (`interop.state_from_numpy`) and both packages run one step on the
same feature frame.  As in tests/test_torch_odometry.py the port's kNN
is routed through the JAX dense engine, so both rank neighbours alike
and everything downstream must agree to f32 round-off: poses within
1e-4, world points within 1e-3 m, masks equal.  The cell maps must
agree as well: directory keys, counts, update and creation frames and
frame index equal, pooled points within 1e-3 m, moment sums within
rtol 1e-4 (sums of ~10² points at ±10 m).  A frame that is not admitted
only moves the maps' frame index.

Capacities: ``SMALL_CAPS`` with 10,000 points a frame, 1,024 cells of
16 points, matching buffers cut to 1,024 / 4,096 points.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.interop import CELL_MAP_ARRAYS, config_from_dict, state_from_numpy
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
from test_torch_odometry import jax_frames, jax_knn_fused, to_port_frame

torch.set_num_threads(2)

N_FRAMES = 12
INIT = 4
POSE_TOL = dict(rtol=0, atol=1e-4)
PTS_TOL = dict(rtol=0, atol=1e-3)


def jax_config():
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096,
                  "cell_capacity": 1024, "cell_point_capacity": 16},
        mapping={"init_accumulate_frames": INIT, "matching_mode": 1},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3})


def state_fields(st) -> dict:
    """A JAX OdometryState (cell maps included) as the numpy dict
    `state_from_numpy` takes."""
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if name in ("map_corners", "map_surface"):
            for f in ("xyz", "time", "mask"):
                out[f"{name}.{f}"] = np.array(getattr(v, f))
        elif name in ("cell_corners", "cell_planes"):
            for f in CELL_MAP_ARRAYS + ("cell_size", "frame_idx"):
                out[f"{name}.{f}"] = np.array(getattr(v, f))
        elif isinstance(v, jnp.ndarray):
            out[name] = np.array(v)
    return out


@pytest.fixture(scope="module")
def jax_stream():
    """(state before, frame, state after, registration) of every frame."""
    cfg = jax_config()
    st = jinit_state(cfg)
    steps = []
    for fr in jax_frames(cfg, N_FRAMES):
        new, reg = jstep(st, fr, cfg)
        steps.append((state_fields(st), fr, state_fields(new), reg))
        st = new
    return cfg, steps


@pytest.mark.parametrize("t", range(N_FRAMES))
def test_teacher_forced_cell_mode_step_matches_jax(jax_stream, monkeypatch, t):
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    cfg, steps = jax_stream
    before, fr, after, jreg = steps[t]
    new, reg = tstep(state_from_numpy(before, "cpu"), to_port_frame(fr),
                     config_from_dict(dataclasses.asdict(cfg)))

    assert bool(reg.accepted) == bool(jreg.accepted)
    assert bool(reg.enabled) == bool(jreg.enabled) == (t >= INIT)
    assert reg.iterations == int(jreg.iterations)
    for name in ("q_w", "t_w", "last_his_q", "last_his_t"):
        np.testing.assert_allclose(getattr(new, name).numpy(), after[name], **POSE_TOL,
                                   err_msg=name)
    assert new.frame_count == int(after["frame_count"]) == t + 1
    for name in ("cell_corners", "cell_planes"):
        cells = getattr(new, name)
        assert cells.frame_idx == int(after[f"{name}.frame_idx"]) == t + 1
        for f in ("keys", "count", "last_update_frame", "create_frame"):
            np.testing.assert_array_equal(getattr(cells, f).numpy(), after[f"{name}.{f}"],
                                          err_msg=f"{name}.{f}")
        np.testing.assert_allclose(cells.pts.numpy(), after[f"{name}.pts"], **PTS_TOL,
                                   err_msg=name)
        for f in ("sum_p", "sum_pp"):
            np.testing.assert_allclose(getattr(cells, f).numpy(), after[f"{name}.{f}"],
                                       rtol=1e-4, atol=1e-3, err_msg=f"{name}.{f}")
    for name in ("map_corners", "map_surface"):
        b = getattr(new, name)
        np.testing.assert_array_equal(b.mask.numpy(), after[f"{name}.mask"], err_msg=name)
        np.testing.assert_allclose(b.xyz.numpy(), after[f"{name}.xyz"], **PTS_TOL,
                                   err_msg=name)


def test_cell_mode_stream_fills_the_maps(jax_stream):
    """The stream exercises what the step test claims: cells in both
    maps, a cell-gathered matching buffer, frames that register, and a
    rejected (so not admitted) frame."""
    _, steps = jax_stream
    last = steps[-1][2]
    assert (last["cell_planes.keys"] != 2 ** 31 - 1).sum() > 50
    assert (last["cell_corners.keys"] != 2 ** 31 - 1).sum() >= 3
    assert last["map_surface.mask"].sum() > 100
    flags = [(bool(reg.enabled), bool(reg.accepted)) for *_, reg in steps]
    assert flags.count((True, True)) >= 4 and (True, False) in flags, flags


# ------------------------------------------------------ racing stream --

def test_racing_cell_mode_stream_matches_jax():
    """Racing dispatch in cell matching mode: the JAX pipeline and the
    port's over one stream, 3 raw frames a group, motion guard off.
    Whole frames as lanes (motion deblur on, one piece a frame): lanes of
    pieces are weakly constrained (tests/test_torch_racing.py says why).
    Every lane registers against the state's cell-gathered matching
    buffer and inserts its cells in commit order in both packages
    (``runtime/batched.py``).  Aligned ATE within 0.05 m of each other
    and under the 0.35 m golden, accepted rows within 3, as in the
    other stream tests."""
    from loam_livox_tpu.eval.ate import ate_rmse
    from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = jax_config().replace(
        optimization={"icp_maximum_iteration": 5},
        parallel={"frame_batch": 3, "batch_motion_guard_t": 0.0})
    n_frames = 12

    def run(pipe):
        sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                             traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))
        for i in range(n_frames):
            pipe.process_raw(*sim.frame(i))
        pipe.flush()
        est = pipe.trajectory.positions_array()
        gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
        return ate_rmse(est, gt), int(sum(pipe.trajectory.accepted)), est

    ate_j, acc_j, est_j = run(JaxPipeline(cfg))
    port = OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    ate_t, acc_t, est_t = run(port)
    assert est_t.shape == est_j.shape == (n_frames, 3) and np.all(np.isfinite(est_t))
    assert port.raced_groups == n_frames // 3 and port.fallback_groups == 0
    assert port.state.cell_planes.n_cells() > 50
    assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
    assert abs(acc_t - acc_j) <= 3, (acc_t, acc_j)
    assert ate_t < 0.35 and acc_t >= n_frames // 2, (ate_t, acc_t)
