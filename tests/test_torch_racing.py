"""The port's racing step (`runtime.batched.odometry_step_batched`)
against the JAX package's on the CPU, teacher-forced.

The JAX package runs `odometry_step_batched` over groups of G = 6 raw
frames of one piece each (motion deblur on, so G·P = 6 lanes).  Before
each group its state is carried into the port
(`interop.state_from_numpy`) and the port runs the same six frames.
The port's search is routed through the JAX dense engine's neighbours,
as in tests/test_torch_odometry.py (whose header says why); everything
else is the port's own.  Per lane: accept and enabled flags and
iteration counts equal, poses within 1e-4 (measured 6e-8); after the
group's commits, history ring and matching buffer as in that file.

Why whole frames: the racing profile's lanes are thirds of a rosette
(deblur off, P = 3), whose rotation is weakly constrained.  There the
JAX package's own vmapped and single registrations of one lane differ
by up to 4.5e-3 in the quaternion after 3 or 10 iterations, so no pose
tolerance near 1e-4 holds; tests/test_torch_racing_stream.py holds
that profile at the trajectory level instead.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.frontend import livox as jlivox
from loam_livox_tpu.io.simulator import ConvexScene, LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu.ops.knn import knn as jknn
from loam_livox_tpu.ops.voxel import voxel_downsample as jvoxel
from loam_livox_tpu.runtime.batched import odometry_step_batched as jbatched
from loam_livox_tpu.runtime.odometry import init_state as jinit_state

from loam_livox_tpu_torch.core.types import FeatureFrame, PointBatch
from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.ops.knn import finish
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime.batched import odometry_step_batched as tbatched

torch.set_num_threads(2)

GROUPS = 4
G, P = 6, 1
INIT = 4


def step_config():
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3})


def state_fields(st) -> dict:
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if name in ("map_corners", "map_surface"):
            for f in ("xyz", "time", "mask"):
                out[f"{name}.{f}"] = np.array(getattr(v, f))
        elif isinstance(v, jnp.ndarray):
            out[name] = np.array(v)
    return out


def to_port_frame(fr) -> FeatureFrame:
    def batch(b):
        return PointBatch(*(torch.from_numpy(np.array(x)) for x in b))
    return FeatureFrame(batch(fr.corners), batch(fr.surface), batch(fr.full),
                        torch.from_numpy(np.array(fr.time_min)),
                        torch.from_numpy(np.array(fr.time_max)))


def jax_piece_stream(cfg):
    """Each raw frame's P piece frames (time order), source voxel filter
    applied, frame after frame (the simulator's noise draws run in frame
    order)."""
    fe, caps = cfg.feature_extraction, cfg.capacity
    rng = np.random.default_rng(3)
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=3),
                         scene=ConvexScene.random_room(rng, n_ridges=60),
                         traj=Trajectory(ramp_t0=0.5))
    i = 0
    while True:
        xyz, inten, t0 = sim.frame(i)
        n = caps.max_raw_points
        pts = np.zeros((n, 3), np.float32)
        it = np.zeros(n, np.float32)
        m = np.zeros(n, bool)
        pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
        _, _, pieces = jlivox.extract_frame(jnp.asarray(pts), jnp.asarray(it), jnp.asarray(m),
                                            t0, fe, caps, piecewise_number=P)
        yield [fr._replace(
            corners=jvoxel(fr.corners, fe.mapping_line_resolution, capacity=caps.max_corner),
            surface=jvoxel(fr.surface, fe.mapping_plane_resolution / 2.0,
                           capacity=caps.max_surface)) for fr in pieces]
        i += 1


def jax_pieces(cfg, n_frames):
    """Every raw frame's P piece frames (time order), source voxel filter
    applied."""
    stream = jax_piece_stream(cfg)
    return [piece for _ in range(n_frames) for piece in next(stream)]


class JaxGroups:
    """(state before, lane frames, state after, lane results) of each
    group of G raw frames, made in order at the first use of a group (a
    file that reads the first groups only pays for those)."""

    def __init__(self, cfg):
        self.cfg, self.state, self.made = cfg, jinit_state(cfg), []
        self.stream = jax_piece_stream(cfg)

    def __getitem__(self, g):
        while len(self.made) <= g:
            lanes = [piece for _ in range(G) for piece in next(self.stream)]
            stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *lanes)
            new, regs = jbatched(self.state, stacked, self.cfg, G * P)
            self.made.append((state_fields(self.state), lanes, state_fields(new), regs))
            self.state = new
        return self.made[g]


@pytest.fixture(scope="module")
def jax_groups():
    """The configuration and the `JaxGroups` of its stream."""
    cfg = step_config()
    return cfg, JaxGroups(cfg)


def jax_knn_fused(q, ref, mask, k=5, ref_op=None, query_count=None, max_radius=None):
    """The port's kNN through the JAX dense engine, lane by lane."""
    lanes = [jknn(jnp.asarray(ql.numpy()), jnp.asarray(ref.numpy()), jnp.asarray(mask.numpy()),
                  k=k, exact=True, precision="high", query_tile=1024)
             for ql in q.reshape((-1,) + q.shape[-2:])]
    d = torch.from_numpy(np.stack([np.array(d) for d, _ in lanes])).reshape(q.shape[:-1] + (k,))
    i = torch.from_numpy(np.stack([np.array(i) for _, i in lanes])).reshape(q.shape[:-1] + (k,))
    return finish(d, i, max_radius)


@pytest.mark.parametrize("g", range(GROUPS))
def test_teacher_forced_batched_step_matches_jax(jax_groups, monkeypatch, g):
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    cfg, groups = jax_groups
    before, lanes, after, jregs = groups[g]
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    new, regs, loops = tbatched(state_from_numpy(before, "cpu"),
                                [to_port_frame(f) for f in lanes], tcfg)

    assert len(regs) == G * P
    for k, reg in enumerate(regs):
        assert bool(reg.enabled) == bool(jregs.enabled[k]), k
        assert bool(reg.accepted) == bool(jregs.accepted[k]), k
        assert int(reg.iterations) == int(jregs.iterations[k]), k
        for name in ("q_w", "t_w", "q_incre", "t_incre"):
            np.testing.assert_allclose(getattr(reg, name).numpy(),
                                       np.asarray(getattr(jregs, name)[k]),
                                       rtol=0, atol=1e-4, err_msg=f"{name} lane {k}")
    assert loops == int(np.asarray(jregs.iterations).max())
    if g >= 1:
        assert all(bool(r.enabled) for r in regs) and loops > 0

    pose_tol = dict(rtol=0, atol=1e-4)
    for name in ("q_w", "t_w", "last_q_incre", "last_t_incre", "last_his_q", "last_his_t"):
        np.testing.assert_allclose(getattr(new, name).numpy(), after[name], **pose_tol,
                                   err_msg=name)
    for name in ("frame_count", "hist_ptr", "hist_len"):
        assert getattr(new, name) == int(after[name]), name
    pts_tol = dict(rtol=0, atol=1e-3)
    for name in ("hist_corner", "hist_surf"):
        np.testing.assert_array_equal(getattr(new, f"{name}_mask").numpy(),
                                      after[f"{name}_mask"], err_msg=name)
        np.testing.assert_allclose(getattr(new, f"{name}_xyz").numpy(),
                                   after[f"{name}_xyz"], **pts_tol, err_msg=name)
    for name in ("map_corners", "map_surface"):
        b = getattr(new, name)
        np.testing.assert_array_equal(b.mask.numpy(), after[f"{name}.mask"], err_msg=name)
        np.testing.assert_allclose(b.xyz.numpy(), after[f"{name}.xyz"], **pts_tol,
                                   err_msg=name)
