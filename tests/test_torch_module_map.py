"""The last gaps of the module map, each against its JAX counterpart on the
CPU: the scenarios' command line (``python -m ...eval.scenarios``, its
``--set`` parsing as ``loam_livox_tpu/eval/scenarios.py:273-300`` parses),
``io.simulator.BoxScene`` (and its export from ``io``), ``core.types.Pose``
with ``PointBatch.{count, from_xyz, pad_to, transform}``, and
``ops.masked.masked_{mean,min,max}``.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import types as jtypes
from loam_livox_tpu.eval.scenarios import run_scenario as jrun_scenario
from loam_livox_tpu.io import BoxScene as JBoxScene
from loam_livox_tpu.ops import masked as jmasked

from loam_livox_tpu_torch.core import types as ttypes
from loam_livox_tpu_torch.eval import scenarios as tscen
from loam_livox_tpu_torch.io import BoxScene as TBoxScene
from loam_livox_tpu_torch.ops import masked as tmasked

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def test_override_parsing_follows_the_jax_rules():
    names, over, opts = tscen.parse_overrides(
        ["odometry_only", "--set", "optimization/icp_maximum_iteration=4",
         "--set", "mapping.maximum_pointcloud_delay_time=0.5", "--set",
         "optimization/correspondence=dense", "full_mapping", "--device", "cpu",
         "--small", "--frames", "3"])
    assert names == ["odometry_only", "full_mapping"]
    # an int, else a float, else a string; NS.KEY as NS/KEY
    assert over == {"optimization": {"icp_maximum_iteration": 4, "correspondence": "dense"},
                    "mapping": {"maximum_pointcloud_delay_time": 0.5}}
    assert opts == {"device": "cpu", "small": True, "frames": 3}
    assert tscen.parse_overrides([]) == ([], {}, {"device": None, "small": False,
                                                  "frames": None})


def test_scenarios_command_line_matches_jax_run():
    """One JSON line a scenario from a child process, at the CI variant's
    size, beside the JAX package's run of the same scenario, frames and
    overrides."""
    over = ["--set", "optimization/icp_maximum_iteration=2",
            "--set", "mapping/init_accumulate_frames=2"]
    out = subprocess.run(
        [sys.executable, "-m", "loam_livox_tpu_torch.eval.scenarios", "odometry_only",
         *over, "--device", "cpu", "--small", "--frames", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    port = lines[0]
    jax_run = jrun_scenario("odometry_only", frames=4, small=True,
                            overrides={"optimization": {"icp_maximum_iteration": 2},
                                       "mapping": {"init_accumulate_frames": 2}})
    assert port["scenario"] == "odometry_only" and port["frames"] == jax_run["frames"] == 4
    assert port["accepted"] == jax_run["accepted"]
    assert abs(port["ate_aligned"] - jax_run["ate_aligned"]) < 0.05


def test_box_scene_matches_jax():
    a = TBoxScene.random_room(np.random.default_rng(4))
    b = JBoxScene.random_room(np.random.default_rng(4))
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.reflectivity, b.reflectivity)
    rng = np.random.default_rng(5)
    origins = rng.uniform(-3, 3, (500, 3))
    dirs = rng.normal(size=(500, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for x, y in zip(a.raycast(origins, dirs), b.raycast(origins, dirs)):
        np.testing.assert_array_equal(x, y)


def test_pose_and_point_batch_match_jax():
    rng = np.random.default_rng(6)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3).astype(np.float32)
    q2 = rng.normal(size=4).astype(np.float32)
    q2 /= np.linalg.norm(q2)
    t2 = rng.normal(size=3).astype(np.float32)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    tp, tp2 = ttypes.Pose(torch.from_numpy(q), torch.from_numpy(t)), \
        ttypes.Pose(torch.from_numpy(q2), torch.from_numpy(t2))
    jp, jp2 = jtypes.Pose(jnp.asarray(q), jnp.asarray(t)), jtypes.Pose(jnp.asarray(q2),
                                                                       jnp.asarray(t2))
    close = dict(rtol=1e-5, atol=1e-5)
    for a, b in ((tp.compose(tp2), jp.compose(jp2)), (tp.inverse(), jp.inverse()),
                 (ttypes.Pose.identity(), jtypes.Pose.identity())):
        np.testing.assert_allclose(a.q.numpy(), np.asarray(b.q), **close)
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), **close)
    np.testing.assert_allclose(tp.apply(torch.from_numpy(pts)).numpy(),
                               np.asarray(jp.apply(jnp.asarray(pts))), **close)

    mask = rng.random(7) < 0.6
    tb = ttypes.PointBatch.from_xyz(torch.from_numpy(pts), mask=torch.from_numpy(mask))
    jb = jtypes.PointBatch.from_xyz(jnp.asarray(pts), mask=jnp.asarray(mask))
    assert int(tb.count()) == int(jb.count()) == int(mask.sum())
    for a, b in ((tb.pad_to(12), jb.pad_to(12)),
                 (tb.transform(tp.q, tp.t), jb.transform(jp.q, jp.t)),
                 (ttypes.PointBatch.from_xyz(torch.from_numpy(pts)),
                  jtypes.PointBatch.from_xyz(jnp.asarray(pts)))):
        np.testing.assert_allclose(a.xyz.numpy(), np.asarray(b.xyz), **close)
        np.testing.assert_array_equal(a.time.numpy(), np.asarray(b.time))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
    with pytest.raises(ValueError):
        tb.pad_to(3)


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_masked_reductions_match_jax(axis):
    rng = np.random.default_rng(8)
    v = rng.normal(size=(5, 9)).astype(np.float32)
    m = rng.random((5, 9)) < 0.5
    m[2] = False                      # a row with nothing valid
    for name in ("masked_mean", "masked_min", "masked_max"):
        a = getattr(tmasked, name)(torch.from_numpy(v), torch.from_numpy(m), axis=axis)
        b = getattr(jmasked, name)(jnp.asarray(v), jnp.asarray(m), axis=axis)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
