"""The port's piecewise (deblur-off) paths against the JAX package on the
CPU: the front end's windows, residual subsampling, the shipped
precision profile and ``odom_mode`` 0 as streams, and chunked dispatch
against the port's own sequential run.

Stream sizes follow tests/test_torch_pipeline.py rather than
tests/test_batched.py: ``SMALL_CAPS`` with the matching buffers cut to
1,024 / 4,096 points (``auto_schedule=0`` on the JAX side, so both
packages truncate at the same capacities), 12 frames, 3 ICP iterations,
but 10,000 points a frame.  At 3,072 points a piece holds ~1,000 points
and both packages reject two thirds of the piecewise registrations
(rotations off by 5-70°), which leaves nothing stable to compare.
Trajectories are held as in that file: aligned ATE within 0.05 m of the
JAX run's, accepted rows within 3, the same number of rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig, precision_profile
from loam_livox_tpu.eval.ate import ate_rmse
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.frontend import livox as jlivox
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.ops import masked as jmasked
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

from loam_livox_tpu_torch.frontend import livox as tlivox
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.ops import masked as tmasked
from loam_livox_tpu_torch.runtime import pipeline as tpipe

torch.set_num_threads(2)

N_FRAMES = 12
INIT = 6


def stream_config(base: SlamConfig) -> SlamConfig:
    return base.replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3})


def simulator():
    return LivoxSimulator(SimConfig(points_per_frame=10000, seed=3),
                          traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))


def run(pipe, n_frames=N_FRAMES):
    sim = simulator()
    for i in range(n_frames):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    return ate_rmse(est, gt), int(sum(pipe.trajectory.accepted)), est


def port_pipeline(cfg):
    return tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")


def assert_streams_agree(cfg, rows):
    ate_j, acc_j, est_j = run(JaxPipeline(cfg))
    port = port_pipeline(cfg)
    ate_t, acc_t, est_t = run(port)
    assert est_t.shape == est_j.shape == (rows, 3)
    assert np.all(np.isfinite(est_t))
    assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
    assert abs(acc_t - acc_j) <= 3, (acc_t, acc_j)
    assert len(port.iterations) == rows and sum(port.iterations) > 0
    times = np.asarray(port.trajectory.times)
    assert np.all(np.diff(times) > 0)
    return ate_t, acc_t


# ------------------------------------------------------------ front end --

@pytest.fixture(scope="module")
def raw_frame():
    cfg = SlamConfig().replace(capacity={"max_raw_points": 4096})
    sim = LivoxSimulator(SimConfig(points_per_frame=3072, seed=3))
    xyz, inten, t0 = sim.frame(9)
    pts = np.zeros((4096, 3), np.float32)
    it = np.zeros(4096, np.float32)
    m = np.zeros(4096, bool)
    pts[:3072], it[:3072], m[:3072] = xyz, inten, True
    return cfg, pts, it, m, t0


@pytest.mark.parametrize("pieces", [1, 2, 3])
def test_piece_windows_match_jax(raw_frame, pieces):
    """Each window [p/P, (p+1)/P] of the valid count, both ends
    inclusive, selects the JAX package's points bit for bit."""
    cfg, pts, it, m, t0 = raw_frame
    fe, caps = cfg.feature_extraction, cfg.capacity
    _, _, jfr = jlivox.extract_frame(jnp.asarray(pts), jnp.asarray(it), jnp.asarray(m),
                                     t0, fe, caps, piecewise_number=pieces)
    tc = config_from_dict(dataclasses.asdict(cfg))
    _, _, tfr = tlivox.extract_frame(torch.from_numpy(pts), torch.from_numpy(it),
                                     torch.from_numpy(m), t0, tc.feature_extraction,
                                     tc.capacity, piecewise_number=pieces)
    assert len(tfr) == len(jfr) == pieces
    for j, t in zip(jfr, tfr):
        for part in ("corners", "surface", "full"):
            jb, tb = getattr(j, part), getattr(t, part)
            np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask), err_msg=part)
            np.testing.assert_array_equal(tb.xyz.numpy(), np.asarray(jb.xyz), err_msg=part)
            # base + idx·10 µs: XLA contracts it into one FMA, so the
            # times may differ in their last bit (as in test_torch_ops.py)
            np.testing.assert_allclose(tb.time.numpy(), np.asarray(jb.time), rtol=1e-6, atol=0,
                                       err_msg=part)
        assert float(t.time_min) == float(j.time_min)
        assert float(t.time_max) == float(j.time_max)
    if pieces > 1:
        # adjacent windows share their boundary index
        assert float(tfr[0].time_max) == float(tfr[1].time_min)


# ------------------------------------------------------ subsampling --

@pytest.mark.parametrize("budget, fill", [(200, 0.5), (50, 0.05), (4000, 0.9), (10, 0.0)])
def test_random_keep_mask_matches_jax_draws(budget, fill):
    """Fed the JAX package's own uniforms, the port thins the mask the same
    way, lane by lane."""
    rng = np.random.default_rng(budget)
    mask = rng.uniform(size=(3, 2048)) < fill
    keys = jax.random.split(jax.random.PRNGKey(budget), 3)
    jmasks = [np.asarray(jmasked.random_keep_mask(key, jnp.asarray(m), budget))
              for key, m in zip(keys, mask)]
    draws = np.stack([np.asarray(jax.random.uniform(key, (2048,))) for key in keys])
    out = tmasked.random_keep_mask(torch.from_numpy(mask), budget, torch.from_numpy(draws))
    np.testing.assert_array_equal(out.numpy(), np.stack(jmasks))


def test_subsampled_registration_runs():
    """``subsample_residuals`` > 0 thins the residual blocks with the
    state's threefry key: the stream registers, a second run from the
    same key reproduces it, and it draws the JAX package's numbers, so
    it stays with the JAX stream (aligned ATE within 0.05 m, accepted
    rows within 3) and ends on JAX's key."""
    cfg = stream_config(precision_profile()).replace(
        optimization={"subsample_residuals": 100})
    port = port_pipeline(cfg)
    a = run(port, n_frames=5)
    b = run(port_pipeline(cfg), n_frames=5)
    np.testing.assert_array_equal(a[2], b[2])
    assert a[2].shape == (15, 3) and np.all(np.isfinite(a[2]))
    jax_pipe = JaxPipeline(cfg)
    ate_j, acc_j, est_j = run(jax_pipe, n_frames=5)
    assert est_j.shape == a[2].shape
    assert abs(a[0] - ate_j) < 0.05 and abs(a[1] - acc_j) <= 3, (a[:2], (ate_j, acc_j))
    np.testing.assert_array_equal(port.state.rng.numpy(), np.asarray(jax_pipe.state.rng))


# ------------------------------------------------------------ streams --

def test_precision_stream_matches_jax():
    """The shipped precision profile: deblur off, three registrations a
    raw frame, one trajectory row each."""
    ate, accepted = assert_streams_agree(stream_config(precision_profile()), 3 * N_FRAMES)
    assert ate < 0.35 and accepted >= 2 * N_FRAMES, (ate, accepted)


def test_odom_mode_0_stream_matches_jax():
    """Odometry mode publishes only the first piece of each raw frame."""
    cfg = stream_config(precision_profile()).replace(common={"odom_mode": 0})
    assert_streams_agree(cfg, N_FRAMES)


def test_chunked_is_bitwise_sequential():
    """Chunked dispatch runs the buffered frames back to back with the
    sequential semantics: the same trajectory bit for bit, a partial tail
    chunk included (14 = 3 × 4 + 2)."""
    cfg = stream_config(precision_profile())
    seq = port_pipeline(cfg)
    chunked = port_pipeline(cfg.replace(parallel={"dispatch_chunk": 4}))
    _, _, est_s = run(seq, n_frames=14)
    _, _, est_c = run(chunked, n_frames=14)
    np.testing.assert_array_equal(est_c, est_s)
    np.testing.assert_array_equal(np.asarray(chunked.trajectory.quaternions),
                                  np.asarray(seq.trajectory.quaternions))
    assert chunked.trajectory.accepted == seq.trajectory.accepted
    assert chunked.iterations == seq.iterations
    assert chunked.loop_iterations == seq.loop_iterations > 0


@pytest.mark.parametrize("parallel, common, match", [
    ({"frame_batch": 3}, {"if_motion_deblur": 0, "odom_mode": 0}, "odom_mode"),
    ({"frame_batch": 3, "dispatch_chunk": 4}, {}, "mutually exclusive"),
])
def test_racing_refusals(parallel, common, match):
    cfg = SlamConfig().replace(parallel=parallel, common=common)
    with pytest.raises(ValueError, match=match):
        tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    with pytest.raises(ValueError, match=match):
        JaxPipeline(cfg)
