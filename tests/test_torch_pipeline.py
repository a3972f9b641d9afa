"""Slice-level checks of the PyTorch port's pipeline on the CPU.

* The port's `OdometryPipeline` and the JAX one (``auto_schedule=0``, so
  both truncate at the same capacities) run the same simulator stream.
  Trajectories are never compared bitwise (the iteration-capped ICP
  amplifies 1-ulp differences, docs/multichip.md:59-71): the port's
  aligned ATE must stay under the ``odometry_only`` golden bound
  (0.35 m, tests/test_scenarios_ci.py:21) and within 0.05 m of the JAX
  run's, and the accepted counts may differ by at most 2.
* The package imports neither JAX nor the JAX package.
* Without a card, the entry points refuse to run unless asked for the CPU.

Capacities as in tests/test_torch_odometry.py: ``SMALL_CAPS`` with
10,000 points a frame and the matching buffers cut to 1,024 / 4,096
points, which keeps the JAX CPU search near 1 s an iteration.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.ate import ate_rmse
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline

import loam_livox_tpu_torch
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.runtime import pipeline as tpipe

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
N_FRAMES = 20
INIT = 6


def stream_config():
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3})


def run(pipe):
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))
    for i in range(N_FRAMES):
        xyz, inten, t0 = sim.frame(i)
        pipe.process_raw(xyz, inten, t0)
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    return ate_rmse(est, gt), int(sum(pipe.trajectory.accepted)), est


def test_port_trajectory_matches_jax_run():
    cfg = stream_config()
    ate_j, acc_j, est_j = run(JaxPipeline(cfg))
    port = tpipe.OdometryPipeline(config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    ate_t, acc_t, est_t = run(port)
    assert est_t.shape == est_j.shape == (N_FRAMES, 3)
    assert np.all(np.isfinite(est_t))
    assert ate_t < 0.35, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < 0.05, (ate_t, ate_j)
    assert abs(acc_t - acc_j) <= 2, (acc_t, acc_j)
    assert acc_t >= INIT + 4, acc_t
    assert sum(port.iterations) > 0


def test_port_imports_no_jax():
    """The sequential, piecewise (precision profile) and racing paths, the
    grid and dense engines, product mode on a group of one rank, the
    scaling harness and the scenario runner, a few frames each, load
    nothing of JAX."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from loam_livox_tpu_torch import SlamConfig, run_odometry\n"
        "from loam_livox_tpu_torch.core.config import precision_profile, realtime_racing_profile\n"
        "from loam_livox_tpu_torch.eval.scenarios import scenario_config\n"
        "from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig\n"
        "small = dict(capacity={'max_raw_points': 4096, 'map_corner_capacity': 1024,\n"
        "    'map_surf_capacity': 4096, 'history_window': 4},\n"
        "    mapping={'init_accumulate_frames': 1}, optimization={'icp_maximum_iteration': 2})\n"
        "for base, frames, rows in ((SlamConfig(), 2, 2), (precision_profile(), 2, 6),\n"
        "                           (realtime_racing_profile(), 4, 12)):\n"
        "    pipe, sim, wall = run_odometry(base.replace(**small), frames,\n"
        "        LivoxSimulator(SimConfig(points_per_frame=3000)), device='cpu')\n"
        "    assert len(pipe.trajectory.positions) == rows\n"
        "    assert np.all(np.isfinite(pipe.trajectory.positions_array()))\n"
        "for engine in ('grid', 'dense'):\n"
        "    cfg = SlamConfig().replace(**small).replace(optimization={'correspondence': engine,\n"
        "        'icp_maximum_iteration': 2}, capacity={'corner_bucket_count': 256,\n"
        "        'surf_bucket_count': 512})\n"
        "    pipe, sim, wall = run_odometry(cfg, 3, LivoxSimulator(SimConfig(points_per_frame=3000)),\n"
        "                                   device='cpu')\n"
        "    assert (pipe.state.grid_surface is not None) == (engine == 'grid')\n"
        "import os, tempfile\n"
        "import torch.distributed as dist\n"
        "from loam_livox_tpu_torch.parallel.mesh import make_mesh\n"
        "from loam_livox_tpu_torch.eval.scaling import measure_scaling\n"
        "import loam_livox_tpu_torch.parallel.sharded_registration\n"
        "store = os.path.join(tempfile.mkdtemp(), 'store')\n"
        "dist.init_process_group('gloo', store=dist.FileStore(store, 1), rank=0, world_size=1)\n"
        "pipe, sim, wall = run_odometry(SlamConfig().replace(**small), 2,\n"
        "    LivoxSimulator(SimConfig(points_per_frame=3000)), device='cpu', mesh=make_mesh(1))\n"
        "assert pipe.mesh.size == 1 and len(pipe.trajectory.positions) == 2\n"
        "assert measure_scaling(make_mesh(1), device='cpu', n_query=64, n_ref=512, reps=1)[\n"
        "    'sharded_overhead_x'] > 0\n"
        "dist.destroy_process_group()\n"
        "scenario_config('largescale_realtime', small=True)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'loam_livox_tpu' or m.startswith('loam_livox_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    from loam_livox_tpu_torch.eval import scaling
    from loam_livox_tpu_torch.parallel.mesh import initialize_multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loam_livox_tpu_torch.OdometryPipeline(loam_livox_tpu_torch.SlamConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loam_livox_tpu_torch.run_odometry(loam_livox_tpu_torch.SlamConfig(), 1)
    assert tpipe.resolve_device("cpu").type == "cpu"
    # product mode's group and the scaling harness: NCCL on the cards
    # unless the CPU is asked for; the refusal comes before the missing
    # process group's error
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        initialize_multihost()
    with pytest.raises(RuntimeError, match="launcher"):
        initialize_multihost(backend="gloo")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling.main([])
    with pytest.raises(RuntimeError, match="launcher"):
        scaling.main(["--device", "cpu"])
