"""The port's racing pipeline (``parallel/frame_batch``) against the JAX
pipeline on the CPU, as streams: the realtime racing profile (G = 3 raw
frames over piecewise 3, 9 lanes a group, queue depth 3) with the
motion guard off.  Sizes and the comparison (aligned ATE within
0.05 m, accepted rows within 3, the same rows) as in
tests/test_torch_piecewise.py, whose header says why 10,000 points a
frame, but with 5 ICP iterations as in tests/test_batched.py.  Racing
lanes are thirds of a rosette started from a coast of the last
increment (tests/test_torch_racing.py says how weakly they are
constrained), and both packages reject most lanes once the platform
moves; at 3 iterations the two runs' rejections fall on different
groups (22 against 29 accepted rows), at 5 they agree.
tests/test_torch_racing_guard.py runs the guard.
"""
import dataclasses

import numpy as np
import torch

from loam_livox_tpu.core.config import SlamConfig, realtime_racing_profile
from loam_livox_tpu.eval.ate import ate_rmse
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.runtime import pipeline as tpipe
from test_torch_odometry import first_match, one_ulp

torch.set_num_threads(2)

N_FRAMES = 12
INIT = 6


def stream_config(base=None, init=INIT, **parallel) -> SlamConfig:
    return (base or realtime_racing_profile()).replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": init},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3},
        parallel={"frame_batch": 3, **parallel})


def run(pipe, n_frames, ramp, nudge=0):
    """The stream through ``pipe``; ``nudge`` ±1 moves every raw point one
    float32 ulp (tests/test_torch_odometry.py `one_ulp`)."""
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=3),
                         traj=Trajectory(ramp_t0=ramp))
    for i in range(n_frames):
        xyz, inten, t0 = sim.frame(i)
        pipe.process_raw(one_ulp(xyz, nudge) if nudge else xyz, inten, t0)
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    return ate_rmse(est, gt), int(sum(pipe.trajectory.accepted)), est


def assert_racing_agrees(cfg, n_frames, ramp=0.1 * INIT + 0.2):
    """Both pipelines over the stream (the platform still until
    ``ramp`` s); returns the port's pipeline.  The port must agree with
    the JAX run on the stream, or, where one ulp of input moves the JAX
    run itself as far, with its run on the stream one ulp away
    (`first_match`: 29 accepted rows on the stream, 23 on both nudged
    streams and in the port on an AVX-512 host)."""
    port = tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    ate_t, acc_t, est_t = run(port, n_frames, ramp)
    rows = n_frames * (1 if cfg.common.if_motion_deblur else cfg.common.piecewise_number)
    assert est_t.shape == (rows, 3)
    assert np.all(np.isfinite(est_t))

    def check(jax_run):
        ate_j, acc_j, est_j = jax_run
        assert est_j.shape == (rows, 3)
        assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
        assert abs(acc_t - acc_j) <= 3, (acc_t, acc_j)

    first_match(check, (run(JaxPipeline(cfg), n_frames, ramp, nudge) for nudge in (0, 1, -1)))
    assert ate_t < 0.35 and acc_t >= rows // 3, (ate_t, acc_t)
    assert np.all(np.diff(np.asarray(port.trajectory.times)) > 0)
    assert len(port.iterations) == rows
    return port


def test_racing_stream_matches_jax():
    port = assert_racing_agrees(stream_config(batch_motion_guard_t=0.0), N_FRAMES)
    assert (port.raced_groups, port.fallback_groups) == (N_FRAMES // 3, 0)
    # a group's lanes share one loop of at most icp_maximum_iteration passes
    assert 0 < port.loop_iterations <= 5 * port.raced_groups
    assert port.raced_loop_iterations == port.loop_iterations
