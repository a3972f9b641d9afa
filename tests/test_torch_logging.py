"""The pipeline's logs (``OdometryPipeline(..., log_dir=...)``,
``loam_livox_tpu_torch.utils.logging``) against the JAX package's, on
the CPU.

One small stream (8 frames of 6,000 points, registration from frame 4)
runs through both pipelines with a log directory, pcd files on
(``common/if_save_to_pcd_files``) and the screen echo on
(``common/if_verbose_screen_printf`` 0, the reference's inverted flag).

* ``mapping.log``: one line a raw frame, the same frame numbers, block
  and iteration counts and accept flags; cost and inlier threshold
  within 2e-6 (printed to 6 decimals), the rotation step within 2e-3
  degrees and the translation step within 2e-3 m (the packages' ICPs
  differ by f32 round-off; measured 1e-6 and 0).
* ``pcd_log.log``: the same lines, the quaternion and translation
  within 1e-4 (measured 4e-5).
* ``timer.log``: one ``Frame process: <ms> ms`` line a frame.
* ``pcd/aft_mapp_<frame>.pcd``: the raw points moved by the frame's
  endpoint pose, within 1e-3 m (a 1e-5 rotation at 20 m).
* The screen echo repeats every file line as ``[stream] line``.
* The logs' host reads: one ``log`` and one ``drain`` read a frame with
  logs on, none with them off; the chunked path logs one line a chunk.
* `utils.logging.SpanTimer` times spans by label.
"""
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.io.serialization import load_pcd
from loam_livox_tpu_torch.runtime import pipeline as tpipe
from loam_livox_tpu_torch.utils.logging import FileLogger, SpanTimer

torch.set_num_threads(2)
N_FRAMES = 8
MAPPING = re.compile(r"frame (\d+): cost=(\S+) inlier_thr=(\S+) blocks=(\d+) iters=(\d+) "
                     r"dR=(\S+)deg dT=(\S+)m accepted=(\d)")


def stream_config(**common):
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": 4},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3}, common=common)


def frames():
    sim = LivoxSimulator(SimConfig(points_per_frame=6000, seed=2), traj=Trajectory(ramp_t0=0.5))
    return [sim.frame(i) for i in range(N_FRAMES)]


def run(pipe):
    for f in frames():
        pipe.process_raw(*f)
    pipe.flush()
    pipe.logger.close()
    return pipe


def lines(d, stream):
    with open(os.path.join(d, f"{stream}.log")) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    cfg = stream_config(if_save_to_pcd_files=1, if_verbose_screen_printf=0)
    dj, dt = str(tmp_path_factory.mktemp("jax")), str(tmp_path_factory.mktemp("port"))
    run(JaxPipeline(cfg, log_dir=dj))
    tpipe.reset_host_syncs()
    port = run(tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                                      log_dir=dt))
    return dj, dt, tpipe.host_syncs(), port


def test_mapping_lines_match_jax(logs):
    dj, dt, _, _ = logs
    got, want = lines(dt, "mapping"), lines(dj, "mapping")
    assert len(got) == len(want) == N_FRAMES
    registered = 0
    for a, b in zip(got, want):
        ma, mb = MAPPING.fullmatch(a), MAPPING.fullmatch(b)
        assert ma and mb, (a, b)
        for k in (1, 4, 5, 8):        # frame, blocks, iterations, accepted
            assert ma.group(k) == mb.group(k), (a, b)
        va, vb = (np.array([float(m.group(k)) for k in (2, 3, 6, 7)]) for m in (ma, mb))
        assert np.all(np.abs(va - vb) <= [2e-6, 2e-6, 2e-3, 2e-3]), (a, b)
        registered += int(ma.group(5)) > 0
    assert registered == N_FRAMES - 4


def test_pose_and_timer_lines_match_jax(logs):
    dj, dt, _, _ = logs
    got, want = lines(dt, "pcd_log"), lines(dj, "pcd_log")
    assert len(got) == len(want) == 2 * N_FRAMES
    for a, b in zip(got, want):
        (na, va), (nb, vb) = (s.split(" = ") for s in (a, b))
        assert na == nb and na in ("Curr_Q", "Curr_T")
        np.testing.assert_allclose(np.array(va.split(","), float), np.array(vb.split(","), float),
                                   rtol=0, atol=1e-4)
    timer = lines(dt, "timer")
    assert len(timer) == len(lines(dj, "timer")) == N_FRAMES
    assert all(re.fullmatch(r"Frame process: \d+\.\d{3} ms", t) for t in timer)


def test_aft_mapp_files_match_jax(logs):
    dj, dt, _, _ = logs
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(dt, "pcd", "*.pcd")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(dj, "pcd", "*.pcd")))
    assert len(names) == N_FRAMES
    for name in names:
        a, _ = load_pcd(os.path.join(dt, "pcd", name))
        b, _ = load_pcd(os.path.join(dj, "pcd", name))
        assert a.shape == b.shape and len(a) > 1000
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=name)


def test_screen_echo_and_log_reads(logs, capfd):
    dj, dt, syncs, port = logs
    assert syncs["log"] == N_FRAMES and syncs["drain"] == N_FRAMES
    # the echo repeats each line; the fixture's output is gone, so echo anew
    logger = FileLogger(None, screen=True)
    assert logger.enabled()
    logger.printf("mapping", "frame %d: x", 3)
    assert capfd.readouterr().out == "[mapping] frame 3: x\n"
    # a stream with the echo alone (no directory) logs to the screen only
    tpipe.reset_host_syncs()
    run(tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(
        stream_config(if_verbose_screen_printf=0))), device="cpu"))
    out = capfd.readouterr().out.splitlines()
    assert [s for s in out if s.startswith("[mapping] ")] == \
        ["[mapping] " + s for s in lines(dt, "mapping")]
    assert len([s for s in out if s.startswith("[pcd_log] ")]) == 2 * N_FRAMES
    assert tpipe.host_syncs()["log"] == N_FRAMES


def test_no_log_reads_without_logs():
    tpipe.reset_host_syncs()
    pipe = run(tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(stream_config())),
                                      device="cpu"))
    assert not pipe.logger.enabled()
    assert tpipe.host_syncs()["log"] == 0 and tpipe.host_syncs()["drain"] == 1


def test_chunked_path_logs_a_line_a_chunk(tmp_path):
    cfg = stream_config().replace(parallel={"dispatch_chunk": 4})
    run(tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu",
                               log_dir=str(tmp_path)))
    assert [MAPPING.fullmatch(s).group(1) for s in lines(str(tmp_path), "mapping")] == ["0", "4"]
    assert not os.path.exists(tmp_path / "pcd")


def test_span_timer_and_device_trace(tmp_path):
    t = SpanTimer()
    with t.span("Frame process"):
        pass
    assert t.toc("missing") == 0.0
    assert t.summary().startswith("Frame process: total ")
