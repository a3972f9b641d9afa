"""The port's product mode (``parallel/mesh_devices`` > 1) on 2 gloo
ranks on the CPU, the counterpart of tests/test_parallel_mode.py.

Each run spawns its ranks (tests/test_torch_dist_worker.py, one thread
each, so every run rounds alike) with its own time limit.  The 1-rank
runs are the plain single-device pipeline in a spawned process of its
own.  The contract is the JAX package's two legs (docs/multichip.md):

1. on the standstill frames (the init window) the sharded run's state
   is bit for bit the 1-rank run's, field by field;
2. after that, the trajectory gap stays inside the 1-ulp yardstick (a
   1-rank run with every post-ramp frame moved one float32 ulp):
   at most 4 × its gap or 5 mm, ATE within twice its ATE spread or
   0.05 m, accepted rows within twice its spread or 3.

The port's product mode shards the matching buffer's search and gathers
the state for the step, so its run is in fact bit for bit the 1-rank
run throughout; the test holds the contract, not that.

``--mesh 2`` runs the command line on both ranks (the group the test
starts stands in for a launcher's): rank 0 prints the summary.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.ate import ate_rmse
from loam_livox_tpu.eval.scenarios import SMALL_CAPS

from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
from test_torch_dist_worker import launch

INIT = 6
FRAMES = 16


def small_cfg(mesh_devices: int) -> dict:
    return dataclasses.asdict(SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3},
        parallel={"mesh_devices": mesh_devices, "deterministic": 1}))


def run(world: int, tmp_path, frames=FRAMES, seed=3, nudge=False):
    return launch("pipeline", world, tmp_path / f"{world}{'n' if nudge else ''}{frames}",
                  timeout=150, cfg=small_cfg(world), frames=frames, seed=seed,
                  ramp=0.1 * INIT + 0.2, nudge=nudge)


def test_map_build_is_bitwise(tmp_path):
    """Leg 1: through the init window every state tensor of the 2-rank
    run equals the 1-rank run's."""
    one = run(1, tmp_path, frames=INIT)[0]
    for out in run(2, tmp_path, frames=INIT):
        fields = [k for k in one if k.startswith("state.")]
        assert len(fields) > 15 and set(fields) == {k for k in out if k.startswith("state.")}
        for name in fields:
            np.testing.assert_array_equal(out[name], one[name], err_msg=name)
        np.testing.assert_array_equal(out["positions"], 0.0)


@pytest.mark.parametrize("seed", [3, 1])
def test_sharded_pipeline_matches_single_rank(tmp_path, seed):
    one = run(1, tmp_path, seed=seed)[0]
    yard = launch("pipeline", 1, tmp_path / "yard", timeout=150, cfg=small_cfg(1),
                  frames=FRAMES, seed=seed, ramp=0.1 * INIT + 0.2, nudge=True, init=INIT)[0]
    two = run(2, tmp_path, seed=seed)
    np.testing.assert_array_equal(two[0]["positions"], two[1]["positions"])
    t1, tp, t2 = one["positions"], yard["positions"], two[0]["positions"]
    assert t1.shape == t2.shape == tp.shape == (FRAMES, 3)
    np.testing.assert_array_equal(t2[:INIT], 0.0)          # leg 1: pinned at the origin
    gap_p = float(np.linalg.norm(tp - t1, axis=1).max())
    gap = float(np.linalg.norm(t2 - t1, axis=1).max())
    assert gap <= max(4.0 * gap_p, 5e-3), (gap, gap_p)
    gt = one["gt"]
    a1, a2, ap = ate_rmse(t1, gt), ate_rmse(t2, gt), ate_rmse(tp, gt)
    assert abs(a2 - a1) <= max(2.0 * abs(ap - a1), 0.05), (a1, a2, ap)
    acc1, acc2, accp = (int(r["accepted"].sum()) for r in (one, two[0], yard))
    assert abs(acc2 - acc1) <= max(2 * abs(accp - acc1), 3), (acc1, acc2, accp)
    assert np.linalg.norm(t1[-1] - t1[0]) > 0.02 and acc1 >= 5


def test_cli_mesh_flag(tmp_path):
    argv = ["--frames", "5", "--mesh", "2", "--device", "cpu", "--quiet",
            "--set", "mapping/init_accumulate_frames=2",
            "--set", "optimization/icp_maximum_iteration=3",
            "--save-poses", str(tmp_path / "poses.txt")]
    for k, v in SMALL_CAPS.items():
        argv += ["--set", f"capacity/{k}={v}"]
    outs = launch("cli", 2, tmp_path / "cli", timeout=150, argv=argv)
    assert [int(o["rc"]) for o in outs] == [0, 0]
    summary = json.loads(str(outs[0]["stdout"]).strip().splitlines()[-1])
    assert summary["mesh_devices"] == 2 and summary["frames"] == 5
    # the default precision profile registers 3 pieces a frame
    assert summary["steps"] == 15 and summary["device"] == "cpu"
    assert str(outs[1]["stdout"]) == ""
    assert len(open(tmp_path / "poses.txt").read().splitlines()) == 15


def test_mesh_size_must_be_the_world_size(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        cfg = config_from_dict(small_cfg(2))
        with pytest.raises(ValueError, match="mesh_devices=2 but the process group has 1"):
            OdometryPipeline(cfg, device="cpu")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        OdometryPipeline(config_from_dict(small_cfg(2)), device="cpu")


def test_product_checkpoint_resumes_bit_for_bit(tmp_path):
    """`save_pipeline` in product mode gathers the ranks' slices and rank
    0 writes; `load_pipeline` with the mesh gives each rank its slices
    back, and the resumed run equals the straight one on every rank."""
    outs = launch("resume", 2, tmp_path, timeout=150, cfg=small_cfg(2), frames=10, split=6,
                  ckpt=str(tmp_path / "ckpt"))
    for out in outs:
        np.testing.assert_array_equal(out["rows_second"], out["rows_whole"])
        assert bool(out["state_equal"]) and int(out["fields"]) > 15
        assert bool(out["slices"])
    assert os.path.exists(tmp_path / "ckpt" / "odometry")


def test_subsampled_product_is_bitwise_one_rank(tmp_path):
    """Residual subsampling in product mode: the threefry key is
    replicated and every rank draws the same numbers from it, so the
    2-rank run's trajectory and every state tensor, the key included,
    are the 1-rank run's bit for bit."""
    def cfg(world):
        d = small_cfg(world)
        d["optimization"]["subsample_residuals"] = 200
        return d

    frames = 10
    one = launch("pipeline", 1, tmp_path / "one", timeout=150, cfg=cfg(1), frames=frames,
                 seed=3, ramp=0.1 * INIT + 0.2)[0]
    two = launch("pipeline", 2, tmp_path / "two", timeout=150, cfg=cfg(2), frames=frames,
                 seed=3, ramp=0.1 * INIT + 0.2)
    fields = [k for k in one if k.startswith("state.")]
    assert "state.rng" in fields and int(one["accepted"].sum()) >= frames - INIT
    for out in two:
        np.testing.assert_array_equal(out["positions"], one["positions"])
        for name in fields:
            np.testing.assert_array_equal(out[name], one[name], err_msg=name)
