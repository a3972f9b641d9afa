"""Solver-level agreement of the port's registration with the JAX package
on the CPU.

* The port builds the deblur Jacobian in closed form; the JAX default
  builds it by forward-mode autodiff.  The Huber-weighted normal
  equations H, g of the two agree to f32 round-off: rtol 1e-4 of their
  largest entry.
* `solve_two_phase` on the same targets (JAX in forward mode): poses
  within 1e-4.
* `register_frame` on teacher-forced frames (the JAX state and frame
  carried into the port, the correspondences routed through the JAX
  dense engine as in tests/test_torch_odometry.py, and the JAX side on
  its closed-form Jacobian, ``deblur_analytic_jacobian=1``, so that the
  forward-mode round-off is not amplified over the ICP iterations):
  accept flags and iteration counts equal, poses within 1e-4.  Where one
  ulp of input moves the JAX registration itself into another basin
  (frame 2: 0.03 m in t_w), the port must match the JAX registration of
  the frame one ulp away instead (tests/test_torch_odometry.py
  `first_match`), or else its pose gap must lie within that one-ulp
  spread, and its accept flag agree (frame 2 on an AVX-512 host: 4.8e-4
  m from the unnudged run, the spread 0.012-0.03 m).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import se3 as jse3
from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.frontend import livox as jlivox
from loam_livox_tpu.io.simulator import ConvexScene, LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.ops.knn import knn as jknn
from loam_livox_tpu.ops.voxel import voxel_downsample as jvoxel
from loam_livox_tpu.registration import gauss_newton as jgn
from loam_livox_tpu.registration import residuals as jres
from loam_livox_tpu.registration.icp import register_frame as jregister
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import input_downsample as jinput
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.core.config import OptimizationConfig
from loam_livox_tpu_torch.core.types import PointBatch
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.ops.knn import finish
from loam_livox_tpu_torch.registration import gauss_newton as tgn
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.registration import residuals as tres
from test_torch_odometry import first_match, one_ulp

torch.set_num_threads(2)


def t(a):
    return torch.from_numpy(np.array(a))


def problem(rotvec, seed=0, n_line=40, n_plane=200):
    """Deblurred points sampled on known lines and planes, seen from a
    pose offset by a small increment: (points, s, line and plane targets
    as numpy, q_incre, t_incre, q_last, t_last)."""
    rng = np.random.default_rng(seed)
    n = n_line + n_plane
    pts = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[:3] = [0.0, 1.0, 1e-4]
    a = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    u = rng.normal(size=(n, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    valid = rng.uniform(size=n) < 0.9
    q_incre = np.asarray(jse3.quat_exp(jnp.asarray(rotvec, jnp.float32)))
    t_incre = np.array([0.05, -0.02, 0.01], np.float32)
    q_last = rng.normal(size=4).astype(np.float32)
    q_last /= np.linalg.norm(q_last)
    t_last = rng.normal(size=3).astype(np.float32)
    return pts, s, a, u, valid, q_incre, t_incre, q_last, t_last, n_line


def residual_fns(pts, s, a, u, valid, q_last, t_last, n_line):
    """(JAX f_with_mask, port fj_with_mask, base mask) of one problem."""
    jl = jres.LineTargets(jnp.asarray(a[:n_line]), jnp.asarray(u[:n_line]),
                          jnp.asarray(valid[:n_line]))
    jp = jres.PlaneTargets(jnp.asarray(a[n_line:]), jnp.asarray(u[n_line:] * 0.9),
                           jnp.asarray(valid[n_line:]))
    tl, tp = tres.LineTargets(*(t(x) for x in jl)), tres.PlaneTargets(*(t(x) for x in jp))
    J = jnp.asarray

    def f_with_mask(mask):
        def f(q, tt):
            rl = jres.line_residuals(q, tt, J(pts[:n_line]), J(s[:n_line]), jl,
                                     J(q_last), J(t_last), True)
            rp = jres.plane_residuals(q, tt, J(pts[n_line:]), J(s[n_line:]), jp,
                                      J(q_last), J(t_last), True)
            return jnp.concatenate([rl, rp]), mask
        return f

    def fj_with_mask(mask):
        def fj(q, tt):
            args = (t(q_last), t(t_last), True)
            rl = tres.line_residuals(q, tt, t(pts[:n_line]), t(s[:n_line]), tl, *args)
            rp = tres.plane_residuals(q, tt, t(pts[n_line:]), t(s[n_line:]), tp, *args)
            jc = tres.point_world_jacobian_deblur(q, tt, t(pts[:n_line]), t(s[:n_line]),
                                                  t(q_last))
            js = tres.point_world_jacobian_deblur(q, tt, t(pts[n_line:]), t(s[n_line:]),
                                                  t(q_last))
            return (torch.cat([rl, rp]),
                    torch.cat([tres.line_jacobian(jc, tl), tres.plane_jacobian(js, tp)]),
                    mask)
        return fj

    return f_with_mask, fj_with_mask, valid


ROTVECS = [(0.01, -0.02, 0.03), (0.2, -0.15, 0.3), (1e-6, -2e-6, 1e-6)]


@pytest.mark.parametrize("rotvec", ROTVECS)
def test_closed_form_normal_equations_match_forward_mode(rotvec):
    pts, s, a, u, valid, q_incre, t_incre, q_last, t_last, n_line = problem(rotvec)
    f_wm, fj_wm, base = residual_fns(pts, s, a, u, valid, q_last, t_last, n_line)
    Hj, gj, *_ = jgn._normal_system(f_wm(jnp.asarray(base)), jnp.asarray(q_incre),
                                    jnp.asarray(t_incre), 0.1, None)
    r, Jt, m = fj_wm(t(base))(t(q_incre), t(t_incre))
    Ht, gt = tgn.system_from_rJ(r, Jt, m, 0.1)
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(Hj)).max())
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(gj)).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_two_phase_matches_jax(seed):
    pts, s, a, u, valid, _, _, q_last, t_last, n_line = problem(ROTVECS[0], seed)
    f_wm, fj_wm, base = residual_fns(pts, s, a, u, valid, q_last, t_last, n_line)
    opt = SlamConfig().optimization
    q0 = np.asarray(jse3.quat_exp(jnp.asarray([0.003, -0.002, 0.004])))
    t0 = np.array([0.02, 0.01, -0.03], np.float32)
    jq, jt, jinfo = jgn.solve_two_phase(f_wm, jnp.asarray(base), jnp.asarray(q0),
                                        jnp.asarray(t0), opt, None)
    tq, tt, tinfo = tgn.solve_two_phase(fj_wm, t(base), t(q0), t(t0),
                                        OptimizationConfig())
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-4)
    assert int(tinfo.n_blocks) == int(jinfo.n_blocks)
    np.testing.assert_allclose(float(tinfo.final_cost), float(jinfo.final_cost), rtol=1e-3)


# ----------------------------------------------------- register_frame --

INIT = 4


@pytest.fixture(scope="module")
def seeded_map():
    """A JAX state whose matching buffer holds the stationary first INIT
    frames, and the next frames (once the platform moves) to register."""
    cfg = SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 5, "full_iterations": 3,
                      "deblur_analytic_jacobian": 1})
    fe, caps = cfg.feature_extraction, cfg.capacity
    rng = np.random.default_rng(3)
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=3),
                         scene=ConvexScene.random_room(rng, n_ridges=60),
                         traj=Trajectory(ramp_t0=0.1 * INIT + 0.2))
    st = jinit_state(cfg)
    frames = []
    for i in range(INIT + 3):
        xyz, inten, t0 = sim.frame(i)
        n = caps.max_raw_points
        pts = np.zeros((n, 3), np.float32)
        it = np.zeros(n, np.float32)
        m = np.zeros(n, bool)
        pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
        _, _, (fr,) = jlivox.extract_frame(jnp.asarray(pts), jnp.asarray(it),
                                           jnp.asarray(m), t0, fe, caps)
        fr = fr._replace(
            corners=jvoxel(fr.corners, fe.mapping_line_resolution, capacity=caps.max_corner),
            surface=jvoxel(fr.surface, fe.mapping_plane_resolution / 2.0,
                           capacity=caps.max_surface))
        if i < INIT:
            st, _ = jstep(st, fr, cfg)
        else:
            frames.append(fr)
    return cfg, st, frames


@pytest.mark.parametrize("which", [0, 1, 2])
def test_register_frame_matches_jax(seeded_map, monkeypatch, which):
    cfg, st, frames = seeded_map
    fr = frames[which]
    ci, si = jinput(fr, cfg)

    def knn_fused(q, ref, mask, k=5, ref_op=None, query_count=None, max_radius=None):
        # register_frame searches with one lane: (1, Q, 3) queries
        d, i = jknn(jnp.asarray(q[0].numpy()), jnp.asarray(ref.numpy()),
                    jnp.asarray(mask.numpy()), k=k, exact=True, precision="high",
                    query_tile=1024)
        return finish(t(d)[None], t(i)[None], max_radius)

    monkeypatch.setattr(ticp, "knn_fused", knn_fused)
    batch = lambda b: PointBatch(*(t(x) for x in b))  # noqa: E731
    tr = ticp.register_frame(batch(ci), batch(si), batch(st.map_corners),
                             batch(st.map_surface), t(st.q_w), t(st.t_w),
                             t(fr.time_min), t(fr.time_max), True,
                             config_from_dict(dataclasses.asdict(cfg)))

    def check(jr):
        assert bool(tr.enabled) and bool(jr.enabled)
        assert bool(tr.accepted) == bool(jr.accepted)
        assert tr.iterations == int(jr.iterations)
        for name in ("q_w", "t_w", "q_incre", "t_incre"):
            np.testing.assert_allclose(getattr(tr, name).numpy(),
                                       np.asarray(getattr(jr, name)),
                                       rtol=0, atol=1e-4, err_msg=name)
        assert int(tr.n_blocks) == int(jr.n_blocks)

    def jax_results():
        for d in (0, 1, -1):
            nudge = (lambda b: b) if d == 0 else (  # noqa: E731
                lambda b: b._replace(xyz=jnp.asarray(one_ulp(b.xyz, d))))
            yield jregister(nudge(ci), nudge(si), st.map_corners, st.map_surface, st.q_w,
                            st.t_w, fr.time_min, fr.time_max, jnp.bool_(True),
                            jax.random.PRNGKey(0), cfg)

    results = list(jax_results())
    try:
        first_match(check, results)
    except AssertionError:
        # no basin matches: then the JAX package's own one-ulp spread
        # (docs/multichip.md's yardstick) must exceed the strict 1e-4
        # and bound the gap, and the accept flag must still agree
        jr, nudged = results[0], results[1:]
        assert bool(tr.accepted) == bool(jr.accepted)
        for name in ("q_w", "t_w"):
            spread = max(np.abs(np.asarray(getattr(r, name)) - np.asarray(getattr(jr, name))).max()
                         for r in nudged)
            gap = np.abs(getattr(tr, name).numpy() - np.asarray(getattr(jr, name))).max()
            assert 1e-4 < spread and gap <= spread, (name, gap, spread)
