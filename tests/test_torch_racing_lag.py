"""The racing guard's lag against the JAX pipeline on the CPU.  At the
realtime profile's queue depth of 3 the guard reads motion only from
groups drained past the queue, so it trips three groups late.  Over 18
raw frames (six groups, guard at 1e-9) the first drained group shows no
motion (it registered nothing: the matching buffer was still empty) and
the second does, so exactly the sixth group falls back.  Only the
decisions are compared (they hang on motion being zero or not, which no
rounding moves), at 3,072 points a frame; the trajectories are held in
tests/test_torch_racing_{stream,guard}.py.
"""
import dataclasses

import torch

from loam_livox_tpu.core.config import realtime_racing_profile
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.runtime import pipeline as jpipe

from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.runtime import pipeline as tpipe

from test_torch_racing_guard import count_batched_dispatches

torch.set_num_threads(2)


def test_guard_lags_by_the_queue_depth(monkeypatch):
    calls = count_batched_dispatches(monkeypatch)
    cfg = realtime_racing_profile().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "map_corner_capacity": 1024,
                  "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": 6},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3},
        parallel={"frame_batch": 3, "batch_motion_guard_t": 1e-9})
    port = tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    jax_pipe = jpipe.OdometryPipeline(cfg)
    for pipe in (jax_pipe, port):
        sim = LivoxSimulator(SimConfig(points_per_frame=3072, seed=3),
                             traj=Trajectory(ramp_t0=0.8))
        for i in range(18):
            pipe.process_raw(*sim.frame(i))
        pipe.flush()
        assert len(pipe.trajectory.times) == 54
    assert port.queue_depth == jax_pipe.pipeline_depth == 3
    assert (port.raced_groups, port.fallback_groups) == (calls["batched"], 1) == (5, 1)
