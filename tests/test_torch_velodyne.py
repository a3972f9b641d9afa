"""The port's Velodyne front end (``loam_livox_tpu_torch.frontend.velodyne``)
and the Velodyne pipeline against the JAX package on the CPU.

Inputs are synthetic VLP-16 sweeps (16 rings × 720 azimuths in a square
room, with and without a plate; `chip_smoke.vlp16_sweep`), padded to
16,384 slots with a few NaN, too-near and masked points.

* Ring ids, the kept mask and the sweep time, then the full, corner and
  surface clouds: masks equal, full and corner points equal (they are
  copies), the surface's voxel centroids within 1e-5 m, times within
  rtol 1e-6 (f32 atan2 / division round-off in the last bit).  Where
  two ring neighbours' depths are within 4 ulps, the occlusion test's
  side is a tie that the host's instruction set decides (one corner of
  the plate sweep on an AVX-512 host): such corners may differ, each
  within reach of a tie and at most two a tie, and the surface then
  differs only in their voxels.  The
  HDL-64 ring formula on the same points; other ring counts raise.
* A short stream: the sensor moves 3 cm and 2 cm a sweep along x and y
  through the room with the plate; the port's and the JAX pipeline
  (``lidar_type`` velodyne, ``scan_line`` 16, motion deblur off since a
  synthetic sweep is taken from one pose) register every sweep after
  the first; accept flags equal, positions within 0.05 m of each other
  and of the truth.  Not closer: the convergence test stops each
  registration once a step moves less than 1 cm
  (``minimum_icp_T_diff``), here after 2 iterations, and the two
  searches' near-tie order differs (tests/test_torch_odometry.py), so
  the packages drift apart by ~1 cm in z over 8 sweeps.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.frontend import velodyne as jvel
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

from chip_smoke import vlp16_sweep
from loam_livox_tpu_torch.frontend import velodyne as tvel
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

torch.set_num_threads(2)
CAP = 16384
CFG = SlamConfig().replace(feature_extraction={"scan_line": 16})
TIME_TOL = dict(rtol=1e-6, atol=0)


def padded_sweep(pillar: bool):
    pts = vlp16_sweep(pillar=pillar)
    xyz = np.zeros((CAP, 3), np.float32)
    mask = np.zeros(CAP, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    xyz[100] = np.nan                    # a NaN return
    xyz[2000] = [0.05, 0.0, 0.0]         # inside minimum_range
    mask[3000:3010] = False              # dropped by the caller
    return xyz, mask


@pytest.fixture(scope="module", params=[True, False], ids=["plate", "room"])
def sweep(request):
    xyz, mask = padded_sweep(request.param)
    fe = CFG.feature_extraction
    j = jvel.extract_velodyne_features(jnp.asarray(xyz), jnp.asarray(mask), jnp.float32(1.5),
                                       fe, CFG.capacity)
    tfe = config_from_dict(dataclasses.asdict(CFG)).feature_extraction
    t = tvel.extract_velodyne_features(torch.from_numpy(xyz), torch.from_numpy(mask), 1.5, tfe)
    return request.param, j, t


@pytest.mark.parametrize("pillar", [True, False], ids=["plate", "room"])
def test_ring_ids_and_sweep_time_match_jax(pillar):
    xyz, mask = padded_sweep(pillar)
    xs = np.nan_to_num(xyz, nan=0.0)
    for lines in (16, 64):
        jsid, jm = jvel._scan_id(jnp.asarray(xs), jnp.asarray(mask), lines)
        tsid, tm = tvel._scan_id(torch.from_numpy(xs), torch.from_numpy(mask), lines)
        np.testing.assert_array_equal(tsid.numpy(), np.array(jsid))
        np.testing.assert_array_equal(tm.numpy(), np.array(jm))
        if lines == 16:
            assert len(np.unique(tsid.numpy()[tm.numpy()])) == 16
            jrel = jvel._relative_time(jnp.asarray(xs), jm)
            trel = tvel._relative_time(torch.from_numpy(xs), tm)
            np.testing.assert_allclose(trel.numpy(), np.array(jrel), rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="16 and 64"):
        tvel._scan_id(torch.from_numpy(xs), torch.from_numpy(mask), 32)


def depth_tie_reach(xyz, mask, lines=16, ulps=4):
    """Points whose corner label hangs on a rounding tie.  The occlusion
    test compares the depths of ring neighbours (``depth > d_nxt``,
    reference :538-601) and masks 6 points on the side it picks; where
    two depths are within ``ulps`` f32 ulps, the packages' last bits
    decide the side.  Returns, for each tie, the points from 10 before
    it to 11 after it in ring order: the masked side either way, plus
    the ±5 that a greedy pick suppresses.  A site must be an
    edge: the test runs only where the curvature is above 0.1."""
    n = xyz.shape[0]
    xs = np.nan_to_num(xyz, nan=0.0)
    finite = np.isfinite(xyz).all(axis=1)
    m = mask & finite & ((xs.astype(np.float64) ** 2).sum(axis=1) >= 0.01)
    sid, m = (np.asarray(a) for a in jvel._scan_id(jnp.asarray(xs), jnp.asarray(m), lines))
    order = np.argsort(np.where(m, sid, lines) * n + np.arange(n), kind="stable")
    p, m, ring = xs[order], m[order], sid[order]
    depth = np.sqrt(np.maximum((p.astype(np.float32) ** 2).sum(axis=1), np.float32(1e-12)))
    # only an edge (curvature over ±5 above 0.1; 0.05 here) runs the test
    p64 = np.pad(p.astype(np.float64), ((5, 5), (0, 0)))
    acc = sum(p64[5 + o:5 + o + n] for o in range(-5, 6)) - 11.0 * p64[5:5 + n]
    edge = (acc ** 2).sum(axis=1) > 0.05
    tie = (m[:-1] & m[1:] & (ring[:-1] == ring[1:]) & edge[:-1]
           & (np.abs(depth[:-1] - depth[1:]) <= ulps * np.spacing(depth[:-1])))
    return [{tuple(r) for r in p[max(i - 10, 0):i + 12][m[max(i - 10, 0):i + 12]]}
            for i in np.nonzero(tie)[0]]


def rows(b):
    return {tuple(r) for r in np.asarray(b.xyz)[np.asarray(b.mask)]}


def test_feature_clouds_match_jax(sweep):
    """The clouds equal, except where a depth tie (`depth_tie_reach`)
    decides a corner: each mismatched corner lies in a tie's reach, at
    most two a tie, and the surface differs only in the voxels of the
    mismatched corners."""
    plate, j, t = sweep
    xyz, mask = padded_sweep(plate)
    # the ties with a corner of either package in reach
    ties = [r for r in depth_tie_reach(xyz, mask) if r & (rows(j.corners) | rows(t.corners))]
    moved = rows(j.corners) ^ rows(t.corners)
    assert moved <= set().union(*ties) and len(moved) <= 2 * len(ties), (moved, len(ties))
    leaf = CFG.feature_extraction.mapping_plane_resolution / 2.0
    moved_voxels = {tuple(np.floor(np.asarray(r) / leaf).astype(int)) for r in moved}
    for name in ("full", "corners", "surface"):
        jb, tb = getattr(j, name), getattr(t, name)
        assert tb.capacity == CAP
        if moved and name != "full":
            # outside the ties: the corners by point (with their times),
            # the surface's centroids by voxel, one a voxel
            def keyed(b):
                m = np.asarray(b.mask)
                xs, ts = np.asarray(b.xyz)[m], np.asarray(b.time)[m]
                keys = ([tuple(x) for x in xs] if name == "corners"
                        else [tuple(np.floor(x / leaf).astype(int)) for x in xs])
                assert len(set(keys)) == len(keys), name
                return {k: (x, tt) for k, x, tt in zip(keys, xs, ts)
                        if k not in moved_voxels and tuple(x) not in moved}
            jk, tk = keyed(jb), keyed(tb)
            assert jk.keys() == tk.keys() and len(jk) > 0, name
            for k in jk:
                np.testing.assert_allclose(tk[k][0], jk[k][0], rtol=0, atol=1e-5, err_msg=name)
                np.testing.assert_allclose(tk[k][1], jk[k][1], **TIME_TOL, err_msg=name)
            continue
        np.testing.assert_array_equal(tb.mask.numpy(), np.array(jb.mask), err_msg=name)
        tol = dict(rtol=0, atol=1e-5) if name == "surface" else dict(rtol=0, atol=0)
        np.testing.assert_allclose(tb.xyz.numpy(), np.array(jb.xyz), **tol, err_msg=name)
        np.testing.assert_allclose(tb.time.numpy(), np.array(jb.time), **TIME_TOL, err_msg=name)
    np.testing.assert_allclose([float(t.time_min), float(t.time_max)],
                               [float(j.time_min), float(j.time_max)], **TIME_TOL)
    assert int(t.full.mask.sum()) == 16 * 720 - 12
    # the plate's edges are the sweep's only corners
    assert (int(t.corners.mask.sum()) > 10) == plate and int(t.surface.mask.sum()) > 100
    assert 1.5 <= float(t.time_min) and float(t.time_max) <= 1.6 + 1e-6


def stream_config():
    return CFG.replace(
        common={"lidar_type": "velodyne", "if_motion_deblur": 0},
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": CAP,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": 1},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3})


def run(pipe, n=8):
    truth = np.array([[0.03 * i, 0.02 * i, 0.0] for i in range(n)])
    for i, o in enumerate(truth):
        pts = vlp16_sweep(origin=o)
        pipe.process_raw(pts, np.zeros(len(pts), np.float32), 0.1 * i)
    pipe.flush()
    return truth, pipe.trajectory.positions_array(), list(pipe.trajectory.accepted)


def test_velodyne_stream_matches_jax():
    cfg = stream_config()
    truth, est_j, acc_j = run(JaxPipeline(cfg))
    _, est_t, acc_t = run(OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)),
                                           device="cpu"))
    assert est_t.shape == truth.shape and acc_t == acc_j and all(acc_t)
    np.testing.assert_allclose(est_t, est_j, rtol=0, atol=0.05)
    np.testing.assert_allclose(est_t, truth, rtol=0, atol=0.05)



def run_racing(group, monkeypatch, n=8):
    """``n`` sweeps (the first still, then 3 cm and 2 cm a sweep along x
    and y) through the racing pipeline (``parallel/frame_batch`` =
    ``group``, motion guard off); the Velodyne front end is spied on and
    the Livox extractor refuses.  Returns (pipeline, front-end calls,
    truth, positions, accept flags)."""
    from loam_livox_tpu_torch.frontend import livox as tlivox
    from loam_livox_tpu_torch.runtime import pipeline as tpipe

    calls = []
    real = tpipe.extract_velodyne_features

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a Velodyne sweep reached the Livox extractor")

    monkeypatch.setattr(tpipe, "extract_velodyne_features", spy)
    monkeypatch.setattr(tlivox, "extract_frame", refuse)
    monkeypatch.setattr(tlivox, "extract_point_info", refuse)
    cfg = stream_config().replace(parallel={"frame_batch": group, "batch_motion_guard_t": 0.0})
    pipe = OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    truth = np.array([[0.03 * max(i - 1, 0), 0.02 * max(i - 1, 0), 0.0] for i in range(n)])
    for i, o in enumerate(truth):
        pts = vlp16_sweep(origin=o)
        pipe.process_raw(pts, np.zeros(len(pts), np.float32), 0.1 * i)
    pipe.flush()
    return pipe, calls, truth, pipe.trajectory.positions_array(), list(pipe.trajectory.accepted)


@pytest.mark.parametrize("group", [2, 3])
def test_racing_sweeps_run_the_velodyne_front_end(monkeypatch, group):
    """Racing dispatch of Velodyne sweeps: every sweep goes through the
    Velodyne front end, one lane a sweep, and none reaches the Livox
    extractor.  The port keeps this on purpose: the JAX package's
    batched program runs the Livox extractor there (its
    ``runtime/pipeline.py:203-225``), an oversight, since the reference
    has no pieces on this path (laser_feature_extractor.hpp:827-864)."""
    pipe, calls, truth, est, acc = run_racing(group, monkeypatch)
    assert len(calls) == len(truth) and pipe.raced_groups == -(-len(truth) // group)
    assert pipe.fallback_groups == 0 and est.shape == truth.shape and all(acc)
    assert np.all(np.isfinite(est))


def test_racing_sweeps_track_the_trajectory(monkeypatch):
    """Two sweeps a group track the known trajectory within the
    sequential run's tolerance (0.05 m; measured 0.016 m).  Three a
    group lag more (up to 0.072 m at 3.6 cm a sweep: the lanes' ICP
    stops after one or two passes from their coasted starts), noted in
    ROADMAP.md §3."""
    pipe, calls, truth, est, acc = run_racing(2, monkeypatch)
    np.testing.assert_allclose(est, truth, rtol=0, atol=0.05)
