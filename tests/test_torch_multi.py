"""The port's multi-LiDAR front end (``loam_livox_tpu_torch.frontend.multi``)
and the ``mid100_trilidar`` scenario against the JAX package on the CPU.

* `extract_multi_lidar` on three simulator heads (seeds 0, 1, 2), with
  one and two pieces, with and without extrinsics: merged capacities and
  masks equal, times within rtol 1e-6 (XLA may fuse base + index·dt
  into one FMA, as in tests/test_torch_ops.py), points within 1e-5 m
  (the rotation's f32 round-off; without extrinsics they are copies and
  equal).
* The ``mid100_trilidar`` scenario through both runners: the JAX one
  on one device (``mesh_devices`` 1; its CI variant would shard over the
  test harness's 8 virtual devices) with ``auto_schedule`` 0 so both
  truncate at the same capacities, both with the matching buffers cut
  to 1,024 / 4,096 points (these streams fill less than that; the cut
  keeps the JAX CPU search near a second an iteration).
  - At the scenario's own 3 × 8,192 points a frame, CPU-scale otherwise
    (12 frames, ``SMALL_CAPS``, registration after 6 frames, 5 / 3 ICP
    iterations): the port's aligned ATE within 0.05 m of the JAX run's
    and the accepted rows equal.
  - The CI variant (24 frames of 3 × 3,072 points) on the port alone,
    under the 0.75 m golden (tests/test_scenarios_ci.py:25).  Against
    JAX it is no yardstick: each head's third of the points leaves half
    a rosette per piece so weakly constrained that both packages reject
    most pieces, and from poses equal to 0.1 mm their registrations of
    piece 14 land 0.29 m apart; the two runs' ATEs differ by 0.09 m
    (scripts/torch_mid100_compare.py prints both runs row by row).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import se3 as jse3
from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval import scenarios as jscenarios
from loam_livox_tpu.frontend.multi import extract_multi_lidar as jmulti
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig

from loam_livox_tpu_torch.eval import scenarios as tscenarios
from loam_livox_tpu_torch.frontend.multi import extract_multi_lidar as tmulti
from loam_livox_tpu_torch.interop import config_from_dict

torch.set_num_threads(2)
N_RAW = 4096
CUT = {"map_corner_capacity": 1024, "map_surf_capacity": 4096}


@pytest.fixture(scope="module")
def heads():
    xyz = np.zeros((3, N_RAW, 3), np.float32)
    inten = np.zeros((3, N_RAW), np.float32)
    mask = np.zeros((3, N_RAW), bool)
    for s in range(3):
        x, i, t0 = LivoxSimulator(SimConfig(points_per_frame=3500, seed=s)).frame(4)
        xyz[s, :len(x)], inten[s, :len(x)], mask[s, :len(x)] = x, i, True
    return xyz, inten, mask, t0


@pytest.mark.parametrize("extrinsics", [False, True])
@pytest.mark.parametrize("pieces", [1, 2])
def test_extract_multi_lidar_matches_jax(heads, pieces, extrinsics):
    xyz, inten, mask, t0 = heads
    cfg = SlamConfig().replace(capacity={"max_raw_points": N_RAW})
    fe, caps = cfg.feature_extraction, cfg.capacity
    ext = {}
    if extrinsics:
        rng = np.random.default_rng(1)
        q = np.array(jse3.quat_exp(jnp.asarray(rng.normal(0, 0.5, (3, 3)), jnp.float32)))
        ext = dict(extrinsic_q=q, extrinsic_t=rng.normal(0, 0.2, (3, 3)).astype(np.float32))
    jf = jmulti(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask), jnp.float32(t0),
                fe, caps, piecewise_number=pieces,
                **{k: jnp.asarray(v) for k, v in ext.items()})
    tcfg = config_from_dict(__import__("dataclasses").asdict(cfg))
    tf = tmulti(torch.from_numpy(xyz), torch.from_numpy(inten), torch.from_numpy(mask), t0,
                tcfg.feature_extraction, tcfg.capacity, piecewise_number=pieces,
                **{k: torch.from_numpy(v) for k, v in ext.items()})
    assert len(tf) == len(jf) == pieces
    pts_tol = dict(rtol=0, atol=1e-5 if extrinsics else 0)
    for j, t in zip(jf, tf):
        for name in ("corners", "surface", "full"):
            jb, tb = getattr(j, name), getattr(t, name)
            assert tb.capacity == 3 * N_RAW
            np.testing.assert_array_equal(tb.mask.numpy(), np.array(jb.mask), err_msg=name)
            np.testing.assert_allclose(tb.time.numpy(), np.array(jb.time), rtol=1e-6, atol=0,
                                       err_msg=name)
            np.testing.assert_allclose(tb.xyz.numpy(), np.array(jb.xyz), **pts_tol,
                                       err_msg=name)
        np.testing.assert_allclose([float(t.time_min), float(t.time_max)],
                                   [float(j.time_min), float(j.time_max)], rtol=1e-6, atol=0)
        per_head = t.full.mask.reshape(3, -1).sum(dim=1)
        assert bool((per_head > 500).all()), per_head


def test_mid100_stream_matches_jax():
    over = {"capacity": {**jscenarios.SMALL_CAPS, **CUT, "max_raw_points": 8192,
                         "auto_schedule": 0},
            "parallel": {"mesh_devices": 1},
            "mapping": {"init_accumulate_frames": 6},
            "optimization": {"icp_maximum_iteration": 5, "full_iterations": 3}}
    jres = jscenarios.run_scenario("mid100_trilidar", frames=12, overrides=over)
    tres = tscenarios.run_scenario("mid100_trilidar", frames=12, overrides=over, device="cpu")
    assert tres["rows"] == 2 * 12
    assert abs(tres["ate_aligned"] - jres["ate_aligned"]) < 0.05, (tres, jres)
    assert tres["accepted"] == jres["accepted"] >= 18, (tres, jres)


def test_mid100_small_under_golden():
    res = tscenarios.run_scenario("mid100_trilidar", small=True,
                                  overrides={"capacity": CUT}, device="cpu")
    assert res["rows"] == 2 * res["frames"] == 48
    assert res["ate_aligned"] < 0.75 and res["accepted"] >= 10, res
