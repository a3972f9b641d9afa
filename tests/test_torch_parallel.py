"""The port's sharded primitives (``loam_livox_tpu_torch.parallel``) on
1, 2 and 4 gloo ranks on the CPU, against the unsharded port and the
JAX package on its 8-device CPU mesh (tests/test_parallel.py).

Each case spawns its ranks (tests/test_torch_dist_worker.py, a
``FileStore`` in the test's directory) with its own time limit.

* `knn_sharded`: bit for bit the unsharded search (`ops.knn_fused`,
  whose CPU path is the exact plain search) at every world size, with
  and without a query count, a radius and a lane axis; against the JAX
  package's `knn_sharded`, as tests/test_parallel.py holds that one
  against its single-device search: distances within 1e-5, at least
  99 % of the indices equal (the JAX search ranks by the expanded
  ‖q‖² + ‖r‖² − 2⟨q, r⟩ with a 0.99-recall selection).
* `normal_system_psum`: under ``deterministic`` H, g and the cost are
  bitwise the same at 1, 2 and 4 ranks, and match the dense einsum and
  the JAX package's psum within 1e-4 relative.
* `optimize_pose_graph_sharded` (edges split over 2 ranks) against the
  JAX package's over its 8 devices, both on the drifted-loop graph of
  tests/test_loop.py: poses within 1e-4, as the other solvers are held
  (tests/test_torch_loop_ops.py).
* `sharded_registration` at 1 and 2 ranks: bitwise equal (deterministic
  sums), and its pose steps toward the truth.
* `parallel.layout`: each rank holds its slice of the sharded axes, and
  slicing then gathering gives the state back bit for bit.
* `eval.scaling` at 1 and 2 ranks: the measurement runs and reports
  positive times, and at one rank the sharded path's overhead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.loop import pose_graph as jpg
from loam_livox_tpu.parallel import knn_sharded as jknn_sharded
from loam_livox_tpu.parallel import make_mesh as jmake_mesh
from loam_livox_tpu.parallel import normal_system_psum as jpsum

from loam_livox_tpu_torch.ops.knn_fused import knn_fused
from test_torch_dist_worker import launch

torch.set_num_threads(2)
K, RADIUS, COUNT = 5, 1.5, 100


@pytest.fixture(scope="module")
def knn_inputs():
    rng = np.random.default_rng(0)
    return {"q": rng.uniform(-5, 5, (128, 3)).astype(np.float32),
            "ref": rng.uniform(-5, 5, (1024, 3)).astype(np.float32),
            "mask": rng.uniform(size=1024) > 0.1,
            "count": np.array(COUNT), "lane_counts": np.array([64, 30], np.int32)}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_knn_sharded_is_the_unsharded_search(knn_inputs, world, tmp_path):
    outs = launch("knn", world, tmp_path, knn_inputs, timeout=120, k=K, radius=RADIUS)
    t = {n: torch.from_numpy(a) for n, a in knn_inputs.items()}
    want = {
        "full": knn_fused(t["q"], t["ref"], t["mask"], k=K),
        "part": knn_fused(t["q"], t["ref"], t["mask"], k=K, query_count=COUNT,
                          max_radius=RADIUS),
        "lanes": knn_fused(t["q"].reshape(2, -1, 3), t["ref"], t["mask"], k=K,
                           query_count=t["lane_counts"], max_radius=RADIUS),
    }
    for out in outs:                                 # every rank holds the result
        for name, (d, i) in want.items():
            np.testing.assert_array_equal(out[f"{name}_d"], d.numpy(), err_msg=name)
            np.testing.assert_array_equal(out[f"{name}_i"], i.numpy(), err_msg=name)
    assert (outs[0]["part_d"][COUNT:] >= 1e29).all() and (outs[0]["part_d"][:COUNT] < 1e29).any()

    # against the JAX package's sharded search on its 8 devices
    jd, ji = jknn_sharded(jnp.asarray(knn_inputs["q"]), jnp.asarray(knn_inputs["ref"]),
                          jnp.asarray(knn_inputs["mask"]), jmake_mesh(8), k=K)
    np.testing.assert_allclose(outs[0]["full_d"], np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert (outs[0]["full_i"] == np.asarray(ji)).mean() > 0.99


@pytest.fixture(scope="module")
def system_inputs():
    rng = np.random.default_rng(1)
    n = 256
    return {"r": rng.normal(size=(n, 3)).astype(np.float32),
            "J": rng.normal(size=(n, 3, 6)).astype(np.float32),
            "w": rng.uniform(0, 1, n).astype(np.float32)}


def test_normal_system_psum_is_bitwise_across_world_sizes(system_inputs, tmp_path):
    runs = {w: launch("psum", w, tmp_path / str(w), system_inputs, timeout=120,
                      deterministic=True) for w in (1, 2, 4)}
    for w in (2, 4):
        for rank_out in runs[w]:
            for name in ("H", "g", "c"):
                np.testing.assert_array_equal(rank_out[name], runs[1][0][name], err_msg=name)
    sw = np.sqrt(system_inputs["w"].astype(np.float64))
    rw = system_inputs["r"] * sw[:, None]
    Jw = system_inputs["J"] * sw[:, None, None]
    H0, g0 = np.einsum("nij,nik->jk", Jw, Jw), np.einsum("nij,ni->j", Jw, rw)
    out = runs[4][0]
    np.testing.assert_allclose(out["H"], H0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["g"], g0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out["c"]), np.sum(rw * rw), rtol=1e-4)
    s = {n: jnp.asarray(a) for n, a in system_inputs.items()}
    jH, jg, jc = jpsum(lambda i: (s["r"][i], s["J"][i], s["w"][i]), jnp.arange(256),
                       jmake_mesh(8))
    np.testing.assert_allclose(out["H"], np.asarray(jH), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out["g"], np.asarray(jg), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out["c"]), float(jc), rtol=1e-4)


def test_normal_system_psum_all_reduce_matches_dense(system_inputs, tmp_path):
    (out, _) = launch("psum", 2, tmp_path, system_inputs, timeout=120, deterministic=False)
    sw = np.sqrt(system_inputs["w"].astype(np.float64))
    Jw = system_inputs["J"] * sw[:, None, None]
    np.testing.assert_allclose(out["H"], np.einsum("nij,nik->jk", Jw, Jw), rtol=1e-4,
                               atol=1e-4)


def test_sharded_pose_graph_matches_jax(tmp_path):
    from test_loop import TestPoseGraphCG

    g, gt_t = TestPoseGraphCG()._drifted_loop_graph(pad_to=16)
    jq, jt, _ = jpg.optimize_pose_graph_sharded(
        g, jax.sharding.Mesh(np.array(jax.devices()), ("shard",)), iterations=20,
        cg_iterations=60)
    inputs = {f: (np.asarray(v).astype(np.int64) if np.asarray(v).dtype == np.int32
                  else np.asarray(v)) for f, v in zip(jpg.PoseGraph._fields, g)}
    outs = launch("pose_graph", 2, tmp_path, inputs, timeout=120, iterations=20,
                  cg_iterations=60)
    for out in outs:
        np.testing.assert_allclose(out["q"], np.asarray(jq), rtol=0, atol=1e-4)
        np.testing.assert_allclose(out["t"], np.asarray(jt), rtol=0, atol=1e-4)
        assert np.linalg.norm(out["t"] - gt_t, axis=1).max() < 0.02


def test_sharded_registration_is_bitwise_across_world_sizes(tmp_path):
    rng = np.random.default_rng(2)
    # points on three planes; the frame is the map moved by a small step
    planes = [rng.uniform(-4, 4, (700, 3)).astype(np.float32) for _ in range(3)]
    for axis, p in enumerate(planes):
        p[:, axis] = 0.0 if axis < 2 else -1.5
    world_pts = np.concatenate(planes)
    frame = world_pts[rng.permutation(len(world_pts))[:512]] - np.float32([0.05, -0.03, 0.02])
    inputs = {"map_xyz": world_pts, "map_mask": np.ones(len(world_pts), bool),
              "frame_xyz": frame.astype(np.float32), "frame_mask": np.ones(512, bool),
              "q_last": np.array([1, 0, 0, 0], np.float32), "t_last": np.zeros(3, np.float32)}
    one = launch("registration", 1, tmp_path / "1", inputs, timeout=120, iterations=4)[0]
    two = launch("registration", 2, tmp_path / "2", inputs, timeout=120, iterations=4)
    for out in two:
        for name in ("q", "t", "costs"):
            np.testing.assert_array_equal(out[name], one[name], err_msg=name)
    np.testing.assert_allclose(one["t"], [0.05, -0.03, 0.02], atol=5e-3)
    assert one["costs"][-1] < one["costs"][0]


def test_layout_slices_and_gathers_the_state(tmp_path):
    cfg = dataclasses.asdict(SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0},
        mapping={"init_accumulate_frames": 2},
        optimization={"icp_maximum_iteration": 2}, parallel={"mesh_devices": 2}))
    outs = launch("layout", 2, tmp_path, timeout=120, cfg=cfg, frames=3)
    whole = outs[0]["whole_map_surface"]
    assert whole.shape == (SMALL_CAPS["map_surf_capacity"], 3)
    for rank, out in enumerate(outs):
        half = whole.shape[0] // 2
        np.testing.assert_array_equal(out["slice_map_surface"],
                                      whole[rank * half:(rank + 1) * half])
        hw = out["whole_hist_surf"].shape[1] // 2
        np.testing.assert_array_equal(out["slice_hist_surf"],
                                      out["whole_hist_surf"][:, rank * hw:(rank + 1) * hw])
        np.testing.assert_array_equal(out["whole_map_surface"], whole)
        assert bool(out["regathered_equal"])
    assert np.abs(whole).sum() > 0


@pytest.mark.parametrize("world", [1, 2])
def test_scaling_harness(world, tmp_path):
    """`eval.scaling` (tests/test_scaling_harness.py's counterpart): the
    sharded step and the product pipeline timed at the group's size beside
    the plain ones; at one rank the overhead ratio is reported."""
    for out in launch("scaling", world, tmp_path, timeout=150):
        assert out["plain_time_s"] > 0 and (out["sharded_time_s"] > 0).all()
        assert out["sizes"].tolist() == [world]
        assert out["fps_keys"].tolist() == sorted(["0", str(world)]) and (out["fps"] > 0).all()
        assert (out["overhead"] > 0) == (world == 1)
