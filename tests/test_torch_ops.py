"""Op-level agreement of the PyTorch port (``loam_livox_tpu_torch``) with
the JAX package on the CPU: config, se3, masked ops, the voxel filter,
the simulator copy, the Livox front end and the ICP residuals.

Inputs are made with numpy from fixed seeds and handed to both
packages.  Integer and bool outputs must be equal.  Floats agree at
rtol = atol = 1e-5 (f32 with XLA's and PyTorch's CPU kernels doing the
same arithmetic in different op orders) unless a test states otherwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import config as jcfg
from loam_livox_tpu.core import se3 as jse3
from loam_livox_tpu.core.types import PointBatch as JPointBatch
from loam_livox_tpu.frontend import livox as jlivox
from loam_livox_tpu.io import simulator as jsim
from loam_livox_tpu.ops import masked as jmasked
from loam_livox_tpu.ops.voxel import voxel_downsample as jvoxel
from loam_livox_tpu.registration import residuals as jres

from loam_livox_tpu_torch.core import config as tcfg
from loam_livox_tpu_torch.core import se3 as tse3
from loam_livox_tpu_torch.core.types import PointBatch as TPointBatch
from loam_livox_tpu_torch.frontend import livox as tlivox
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.io import simulator as tsim
from loam_livox_tpu_torch.ops import masked as tmasked
from loam_livox_tpu_torch.ops.voxel import voxel_downsample as tvoxel
from loam_livox_tpu_torch.registration import residuals as tres
from loam_livox_tpu_torch.runtime.pipeline import source_downsample

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dtype) if dtype else torch.from_numpy(np.asarray(a))


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or TOL))


# ---------------------------------------------------------------- config --

@pytest.mark.parametrize("profile", [
    "SlamConfig", "precision_profile", "deblur_precision_profile",
    "realtime_profile", "realtime_racing_profile", "largescale_profile"])
def test_config_profiles_match_field_for_field(profile):
    j = dataclasses.asdict(getattr(jcfg, profile)())
    p = dataclasses.asdict(getattr(tcfg, profile)())
    assert p == j
    assert config_from_dict(j) == getattr(tcfg, profile)()
    assert tcfg.bounded_scene_caps() == jcfg.bounded_scene_caps()


@pytest.mark.parametrize("name", ["performance_precision", "performance_realtime"])
def test_config_yaml_loads_unchanged(name):
    path = f"configs/{name}.yaml"
    assert (dataclasses.asdict(tcfg.load_yaml(path))
            == dataclasses.asdict(jcfg.load_yaml(path)))


@pytest.mark.parametrize("override, item", [
    ({"loop_closure": {"if_enable_loop_closure": 1, "if_dump_keyframe_data": 1},
      "optimization": {"correspondence": "dense"}}, 14),
    ({"parallel": {"mesh_devices": 8}}, 15),
    ({"optimization": {"correspondence": "dense"}}, 14),
    ({"optimization": {"correspondence": "grid"}}, 14),
    ({"common": {"if_save_to_pcd_files": 1}, "parallel": {"mesh_devices": 2}}, 15),
    ({"common": {"if_verbose_screen_printf": 0}, "optimization": {"correspondence": "grid"}},
     14),
    # an unported item on top of a ported path
    ({"parallel": {"dispatch_chunk": 4, "mesh_devices": 4},
      "loop_closure": {"if_enable_loop_closure": 1, "map_alignment_if_dump_matching_result": 1}},
     15),
    ({"parallel": {"frame_batch": 3, "mesh_devices": 4}}, 15),
])
def test_unported_paths_raise(override, item):
    """The paths of queue 1 items 14 (the dense and grid engines) and 15
    (product mode), refused until both were ported, are accepted: the
    engines' state is built, and product mode asks for its process group
    (tests/test_torch_parallel_mode.py runs it)."""
    from loam_livox_tpu_torch.runtime.odometry import init_state
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = tcfg.SlamConfig().replace(**override)
    tcfg.require_supported(cfg)
    if item == 14:
        small = cfg.replace(capacity={"map_corner_capacity": 256, "map_surf_capacity": 256,
                                      "corner_bucket_count": 64, "surf_bucket_count": 64})
        st = init_state(small, "cpu")
        assert (st.grid_surface is not None) == (cfg.optimization.correspondence == "grid")
    else:
        with pytest.raises(RuntimeError, match="torch.distributed initialised"):
            OdometryPipeline(cfg, device="cpu")
    tcfg.require_supported(tcfg.SlamConfig().replace(
        capacity={"auto_schedule": 0}, optimization={"correspondence": "pallas"}))


@pytest.mark.parametrize("override", [
    {"common": {"if_motion_deblur": 0}},
    {"parallel": {"frame_batch": 3}},
    {"parallel": {"dispatch_chunk": 4}},
    {"optimization": {"subsample_residuals": 200}},
    {"common": {"lidar_type": "velodyne"}},
    {"mapping": {"matching_mode": 1}},
    {"common": {"if_motion_deblur": 0}, "mapping": {"matching_mode": 1}},
    {"loop_closure": {"if_enable_loop_closure": 1}},
    {"mapping": {"matching_mode": 1}, "loop_closure": {"if_enable_loop_closure": 1,
                                                       "if_loop_service_async": 0}},
    {"parallel": {"dispatch_chunk": 4}, "loop_closure": {"if_enable_loop_closure": 1}},
    {"common": {"if_motion_deblur": 0}, "parallel": {"frame_batch": 3},
     "loop_closure": {"if_enable_loop_closure": 1}},
    {"loop_closure": {"if_enable_loop_closure": 1, "if_dump_keyframe_data": 1}},
    {"common": {"if_save_to_pcd_files": 1}},
    {"common": {"if_verbose_screen_printf": 0}},
    {"parallel": {"dispatch_chunk": 4},
     "loop_closure": {"if_enable_loop_closure": 1, "map_alignment_if_dump_matching_result": 1}},
    {"optimization": {"correspondence": "dense"}},
    {"optimization": {"correspondence": "grid"}, "mapping": {"matching_mode": 1}},
    {"parallel": {"mesh_devices": 4, "frame_batch": 3}},
])
def test_shipped_profile_paths_are_accepted(override):
    """Queue 1 items 9 (piecewise windows, racing, chunked dispatch,
    residual subsampling), 10 (cell matching), 11 (the Velodyne front
    end), 12 (loop closure), 13 (the host side: loop dumps, pcd files,
    screen diagnostics), 14 (the dense and grid engines) and 15 (product
    mode) are ported."""
    tcfg.require_supported(tcfg.SlamConfig().replace(**override))


def test_unknown_lidar_type_raises():
    with pytest.raises(ValueError, match="'livox' and 'velodyne'"):
        tcfg.require_supported(tcfg.SlamConfig().replace(common={"lidar_type": "ouster"}))
    with pytest.raises(ValueError, match="'dense' and 'grid'"):
        tcfg.require_supported(tcfg.SlamConfig().replace(
            optimization={"correspondence": "kdtree"}))


# ------------------------------------------------------------------- se3 --

@pytest.fixture(scope="module")
def quats():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(32, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    v = rng.normal(size=(32, 3)).astype(np.float32) * 3
    phi = rng.normal(size=(32, 3)).astype(np.float32) * 0.5
    phi[:4] *= 1e-5                      # the small-angle branches
    s = rng.uniform(0, 1, 32).astype(np.float32)
    return q, q2, v, phi, s


SE3_CASES = {
    "normalize": lambda m, q, q2, v, phi, s: m.quat_normalize(q * 2.5),
    "conjugate": lambda m, q, q2, v, phi, s: m.quat_conjugate(q),
    "multiply": lambda m, q, q2, v, phi, s: m.quat_multiply(q, q2),
    "rotate": lambda m, q, q2, v, phi, s: m.quat_rotate(q, v),
    "to_matrix": lambda m, q, q2, v, phi, s: m.quat_to_matrix(q),
    "matrix_to_quat": lambda m, q, q2, v, phi, s: m.matrix_to_quat(m.quat_to_matrix(q)),
    "exp": lambda m, q, q2, v, phi, s: m.quat_exp(phi),
    "log": lambda m, q, q2, v, phi, s: m.quat_log(q),
    "slerp_identity": lambda m, q, q2, v, phi, s: m.quat_slerp_identity(q[0], s),
    "angular_distance": lambda m, q, q2, v, phi, s: m.quat_angular_distance(q, q2),
    "pose_compose": lambda m, q, q2, v, phi, s: m.pose_compose(q, v, q2, phi),
    "pose_inverse": lambda m, q, q2, v, phi, s: m.pose_inverse(q, v),
    "pose_relative": lambda m, q, q2, v, phi, s: m.pose_relative(q, v, q2, phi),
    "pose_transform": lambda m, q, q2, v, phi, s: m.pose_transform(q, v, phi),
    "rodrigues": lambda m, q, q2, v, phi, s: m.rodrigues_matrix(
        m.quat_to_axis_angle(q)[0], m.quat_to_axis_angle(q)[1]),
    "axis_angle": lambda m, q, q2, v, phi, s: m.quat_to_axis_angle(q),
}


@pytest.mark.parametrize("name", list(SE3_CASES))
def test_se3_matches_jax(quats, name):
    fn = SE3_CASES[name]
    ref = fn(jse3, *(jnp.asarray(a) for a in quats))
    out = fn(tse3, *(t(np.ascontiguousarray(a)) for a in quats))
    ref = ref if isinstance(ref, tuple) else (ref,)
    out = out if isinstance(out, tuple) else (out,)
    for o, r in zip(out, ref):
        # log/axis-angle divide by |v| ~ 1e-5 near the identity: 1e-4
        close(o, r, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- masked ops --

def test_compact_is_stable_and_equal():
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=300) < 0.3
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = np.arange(300, dtype=np.int32)
    jm, ja, jb = jmasked.compact(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    tm, ta, tb = tmasked.compact(t(mask), t(a), t(b))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("ratio, fill", [(0.8, 0.5), (0.5, 0.1), (0.8, 0.0), (1.0, 1.0)])
def test_masked_quantile_l1(ratio, fill):
    rng = np.random.default_rng(2)
    vals = rng.exponential(size=257).astype(np.float32)
    mask = rng.uniform(size=257) < fill
    ref = jmasked.masked_quantile_l1(jnp.asarray(vals), jnp.asarray(mask), ratio)
    out = tmasked.masked_quantile_l1(t(vals), t(mask), ratio)
    assert float(out) == float(ref)


# ---------------------------------------------------------------- voxel --

@pytest.mark.parametrize("leaf, cap, with_time, spread", [
    (0.4, None, True, 10.0),
    (0.1, 512, True, 3.0),
    (0.2, 64, True, 10.0),      # more voxels than slots: smallest keys win
    (0.4, 1024, False, 10.0),
    (0.05, None, True, 2000.0),  # keys clipped at the 15-bit range
])
def test_voxel_downsample_matches_jax(leaf, cap, with_time, spread):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-spread, spread, (2048, 3)).astype(np.float32)
    xyz[::7] = xyz[::7].round(1)        # points on voxel faces
    time = rng.uniform(0, 0.1, 2048).astype(np.float32)
    mask = rng.uniform(size=2048) < 0.8
    ref = jvoxel(JPointBatch(jnp.asarray(xyz), jnp.asarray(time), jnp.asarray(mask)),
                 leaf, capacity=cap, with_time=with_time)
    out = tvoxel(TPointBatch(t(xyz), t(time), t(mask)), leaf, capacity=cap,
                 with_time=with_time)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    close(out.xyz, ref.xyz)
    close(out.time, ref.time)


# ------------------------------------------------------------ simulator --

@pytest.mark.parametrize("frame_idx", [0, 17])
def test_simulator_matches_jax(frame_idx):
    cfg = dict(points_per_frame=2000, seed=5)
    js = jsim.LivoxSimulator(jsim.SimConfig(**cfg))
    ts = tsim.LivoxSimulator(tsim.SimConfig(**cfg))
    for i in range(frame_idx + 1):       # same rng stream position
        jx, ji, jt = js.frame(i)
        tx, ti, tt = ts.frame(i)
    assert tt == jt
    # R is f32 in both; XLA may contract its products: 1e-5 m at ≤ 20 m
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti, ji, rtol=1e-6)
    np.testing.assert_allclose(ts.gt_pose_at(1.3)[1], js.gt_pose_at(1.3)[1])


# ------------------------------------------------------------- front end --

@pytest.fixture(scope="module")
def raw_frames():
    cfg = jcfg.SlamConfig().replace(capacity={"max_raw_points": 4096})
    sim = jsim.LivoxSimulator(jsim.SimConfig(points_per_frame=3600, seed=3))
    frames = []
    for i in range(3):
        xyz, inten, t0 = sim.frame(i * 7)
        if i == 2:                       # NaN dropouts as well
            xyz[100:103] = np.nan
        pts = np.zeros((4096, 3), np.float32)
        it = np.zeros(4096, np.float32)
        m = np.zeros(4096, bool)
        pts[:3600], it[:3600], m[:3600] = xyz, inten, True
        frames.append((pts, it, m, t0))
    return cfg, frames


def acos_tolerance_deg(angle_deg, ulps: int):
    """How far ``ulps`` float32 ulps of the cosine move ``acos``, in
    degrees, at each angle (the larger of the two directions; acos's
    derivative 1/sin diverges at 0°, so the step is taken, not the
    derivative)."""
    x = np.cos(np.deg2rad(np.asarray(angle_deg, np.float64)))
    du = ulps * np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)
    lo, hi = np.clip(x - du, -1.0, 1.0), np.clip(x + du, -1.0, 1.0)
    return np.rad2deg(np.maximum(np.arccos(lo) - np.arccos(x), np.arccos(x) - np.arccos(hi)))


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_frontend_matches_jax(raw_frames, idx):
    cfg, frames = raw_frames
    pts, it, m, t0 = frames[idx]
    fe, caps = cfg.feature_extraction, cfg.capacity
    jinfo, jpet = jlivox.extract_point_info(jnp.asarray(pts), jnp.asarray(it),
                                            jnp.asarray(m), jnp.float32(t0), fe, caps)
    tc = config_from_dict(dataclasses.asdict(cfg))
    tinfo, tpet = tlivox.extract_point_info(t(pts), t(it), t(m), t0,
                                            tc.feature_extraction, tc.capacity)
    assert tpet == int(jpet) and tpet > 0
    for name in ("pt_type", "label", "in_mask"):
        np.testing.assert_array_equal(getattr(tinfo, name).numpy(),
                                      np.asarray(getattr(jinfo, name)), err_msg=name)
    for name in ("depth_sq2", "polar_dis_sq2", "pt_2d", "curvature", "sigma", "time"):
        close(getattr(tinfo, name), getattr(jinfo, name), rtol=1e-5, atol=1e-6)
    # acos is ill-conditioned near 0°: its argument, the cosine, is a
    # quotient of f32 dot products and norms whose last bits differ
    # between the two packages' instruction selections (XLA and ATen
    # pick their code by the host's ISA).  So the tolerance of each angle
    # is 1e-3° plus what 4 ulps of its cosine move acos there.
    view_t, view_j = np.asarray(tinfo.view_angle), np.asarray(jinfo.view_angle)
    assert np.all(np.abs(view_t - view_j) <= 1e-3 + 1e-5 * np.abs(view_j)
                  + acos_tolerance_deg(view_j, ulps=4))
    close(tinfo.scan_angle, jinfo.scan_angle, rtol=1e-5, atol=1e-3)
    close(tinfo.scan_angle, jinfo.scan_angle, rtol=1e-5, atol=1e-3)

    jfr = jlivox.select_features(jnp.asarray(pts), jinfo, jpet, 0.0, 1.0, fe, caps)
    tfr = tlivox.select_features(t(pts), tinfo, tpet, 0.0, 1.0, tc.feature_extraction)
    for part in ("corners", "surface", "full"):
        jb, tb = getattr(jfr, part), getattr(tfr, part)
        np.testing.assert_array_equal(tb.mask.numpy(), np.asarray(jb.mask), err_msg=part)
        np.testing.assert_array_equal(tb.xyz.numpy(), np.asarray(jb.xyz), err_msg=part)
        close(tb.time, jb.time, rtol=1e-6, atol=0)
    close(tfr.time_min, jfr.time_min, rtol=1e-6, atol=0)
    close(tfr.time_max, jfr.time_max, rtol=1e-6, atol=0)

    # the source voxel filter (pipeline.py:112-127)
    jds = jvoxel(jfr.surface, fe.mapping_plane_resolution / 2.0, capacity=caps.max_surface)
    tds = source_downsample(tfr, tc).surface
    np.testing.assert_array_equal(tds.mask.numpy(), np.asarray(jds.mask))
    close(tds.xyz, jds.xyz)


# ------------------------------------------------------------- residuals --

@pytest.fixture(scope="module")
def residual_inputs():
    rng = np.random.default_rng(4)
    n, m = 40, 300
    map_xyz = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    d = np.sort(rng.exponential(1.0, (n, 5)), axis=1).astype(np.float32)
    d[:5, -1] = 60.0                      # gated out
    idx = rng.integers(0, m, (n, 5)).astype(np.int32)
    idx[5, 1] = idx[5, 0]                 # degenerate line
    qmask = rng.uniform(size=n) < 0.9
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 4
    s = rng.uniform(0, 1, n).astype(np.float32)
    q_incre = np.asarray(jse3.quat_exp(jnp.asarray([0.02, -0.01, 0.03])))
    q_last = rng.normal(size=4).astype(np.float32)
    q_last /= np.linalg.norm(q_last)
    return map_xyz, d, idx, qmask, pts, s, q_incre, q_last


@pytest.mark.parametrize("deblur", [True, False])
def test_residuals_and_jacobians_match_jax(residual_inputs, deblur):
    map_xyz, d, idx, qmask, pts, s, q_incre, q_last = residual_inputs
    t_incre = np.array([0.05, -0.02, 0.01], np.float32)
    t_last = np.array([1.0, 2.0, -0.5], np.float32)
    J = lambda a: jnp.asarray(a)  # noqa: E731
    jl = jres.build_line_targets(J(d), J(idx), J(map_xyz), J(qmask), 2.0)
    jp = jres.build_plane_targets(J(d), J(idx), J(map_xyz), J(qmask), 50.0)
    tl = tres.build_line_targets(t(d), t(idx), t(map_xyz), t(qmask), 2.0)
    tp = tres.build_plane_targets(t(d), t(idx), t(map_xyz), t(qmask), 50.0)
    for a, b in ((tl, jl), (tp, jp)):
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
        for x, y in zip(a[:2], b[:2]):
            close(x, y)
    args_j = (J(q_incre), J(t_incre), J(pts), J(s))
    args_t = (t(q_incre), t(t_incre), t(pts), t(s))
    close(tres.line_residuals(*args_t, tl, t(q_last), t(t_last), deblur),
          jres.line_residuals(*args_j, jl, J(q_last), J(t_last), deblur))
    close(tres.plane_residuals(*args_t, tp, t(q_last), t(t_last), deblur),
          jres.plane_residuals(*args_j, jp, J(q_last), J(t_last), deblur))
    if deblur:
        jj = jres.point_world_jacobian_deblur(*args_j, J(q_last))
        tj = tres.point_world_jacobian_deblur(*args_t, t(q_last))
    else:
        jj = jres.point_world_jacobian(*args_j[:3], J(q_last))
        tj = tres.point_world_jacobian(*args_t[:3], t(q_last))
    close(tj, jj, rtol=1e-5, atol=1e-5)
    close(tres.line_jacobian(tj, tl), jres.line_jacobian(jj, jl))
    close(tres.plane_jacobian(tj, tp), jres.plane_jacobian(jj, jp))
    sq = np.linspace(0, 0.1, 17).astype(np.float32)
    close(tres.huber_rho(t(sq), 0.1), jres.huber_rho(J(sq), 0.1))
    close(tres.huber_weight(t(sq), 0.1), jres.huber_weight(J(sq), 0.1))
