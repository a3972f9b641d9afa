"""The CPU side of the frame program's chunk and racing-group graphs
(`runtime.frame_program`), and the two repairs that come before them.

* The racing step split as the group graph runs it: `batched.prepare_group`,
  the host loop, then each lane's `batched.commit_lane` with its
  matching-buffer update picked by the SWITCH node's index
  (`ops.graph_cond.switch_index_plain`) over the lane's flags, bit-equal
  to the port's `odometry_step_batched` (the plain program), on the
  teacher-forced groups of tests/test_torch_racing.py.  Each lane's
  update (rebuild, append or none) is the one the JAX
  ``odometry_step_batched`` took: its commits replayed lane by lane
  with the JAX ``commit_frame`` from its own lane results, a replay that
  must end on the JAX group's state.
* Chunked dispatch (K = 4, a tail of 2) against sequential raw frames
  through the port's pipeline: rows, iterations and every state tensor
  equal.
* The kNN searcher split into row blocks (`registration.icp._searcher`
  with ``max_rows``) against the search of the whole buffer: indices and
  distances equal, with and without a lane axis.
* A state read from a pipeline stays as it was after the next frame.
* `frame_program.on_slice` admits chunked and racing dispatch on the card
  (the Velodyne front end and the ``grid`` engine too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu_torch.core.config import SlamConfig, realtime_racing_profile
from loam_livox_tpu_torch.core.types import PointBatch
from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig
from loam_livox_tpu_torch.ops.graph_cond import switch_index_plain
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime import pipeline as P
from loam_livox_tpu_torch.runtime.batched import commit_lane, odometry_step_batched, prepare_group
from loam_livox_tpu_torch.runtime.frame_program import on_slice
from loam_livox_tpu_torch.runtime.odometry import appended_matching, rebuilt_matching
from test_torch_racing import (G, P as PIECES, jax_groups, jax_knn_fused,  # noqa: F401
                               state_fields, to_port_frame)

torch.set_num_threads(2)

SMALL = {"max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
         "max_corner_ds": 256, "max_surface_ds": 1024, "map_corner_capacity": 1024,
         "map_surf_capacity": 4096, "hist_corner_capacity": 128, "hist_surf_capacity": 512,
         "history_window": 8}


def leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), f"{prefix}.{f}"))
    return out


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


# ------------------------------------------------------ the racing group --

def jax_lane_updates(cfg, before, lanes, after, jregs, appends: bool, monkeypatch):
    """The matching-buffer update each lane of the JAX group took: its
    commits replayed with the JAX ``commit_frame`` from the group's own
    lane results and coasted start poses (as ``odometry_step_batched``
    commits them), each lane's ``lax.cond`` predicate (``do_rebuild``)
    recorded by a callback through a stand-in for the module's ``lax``
    (the package itself is not touched) and its admission read from the
    history ring's pointer: 0 rebuilt, 1 appended (admitted off the
    cadence, where appends run), None kept.  The replay must end on the
    group's state (its points to 1e-4: the coast is rounded outside the
    group's program here)."""
    from jax import lax

    from loam_livox_tpu.core import se3 as jse3
    from loam_livox_tpu.core.types import PointBatch as JBatch
    from loam_livox_tpu.runtime import odometry as jodometry

    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(lax, name)

        @staticmethod
        def cond(pred, *args, **kw):
            jax.debug.callback(lambda v: seen.append(bool(v)), pred)
            return lax.cond(pred, *args, **kw)

    st = jodometry.init_state(cfg)
    fields = {name: jnp.asarray(before[name]) for name in st._fields
              if isinstance(getattr(st, name), jnp.ndarray) and name in before}
    for name in ("map_corners", "map_surface"):
        fields[name] = JBatch(xyz=jnp.asarray(before[f"{name}.xyz"]),
                              time=jnp.asarray(before[f"{name}.time"]),
                              mask=jnp.asarray(before[f"{name}.mask"]))
    st = st._replace(**fields)
    q_inits, t_inits = [], []
    qk, tk = st.q_w, st.t_w
    for _ in lanes:
        q_inits.append(qk)
        t_inits.append(tk)
        tk = jse3.quat_rotate(qk, st.last_t_incre) + tk
        qk = jse3.quat_normalize(jse3.quat_multiply(qk, st.last_q_incre))
    def fresh(*args, **kw):     # a new function: no trace of an earlier call is reused
        return jodometry.commit_frame(*args, **kw)

    monkeypatch.setattr(jodometry, "lax", Recorder())
    commit = jax.jit(fresh, static_argnames=("cfg",))
    choices = []
    for k, frame in enumerate(lanes):
        reg = jax.tree_util.tree_map(lambda x: x[k], jregs)
        corner_in, surf_in = jodometry.input_downsample(frame, cfg)
        ptr = int(st.hist_ptr)
        st, _ = commit(st, frame, corner_in, surf_in, reg, q_inits[k], t_inits[k], cfg=cfg)
        jax.effects_barrier()
        assert len(seen) == k + 1
        admitted = int(st.hist_ptr) != ptr
        choices.append(0 if seen[k] else (1 if admitted and appends else None))
    monkeypatch.undo()
    replayed = state_fields(st)
    for name in ("frame_count", "hist_ptr", "hist_len", "map_surface.mask",
                 "map_corners.mask", "hist_surf_mask", "hist_corner_mask"):
        np.testing.assert_array_equal(replayed[name], after[name], err_msg=name)
    for name in ("q_w", "t_w", "map_surface.xyz", "hist_surf_xyz"):
        np.testing.assert_allclose(replayed[name], after[name], rtol=0, atol=1e-4,
                                   err_msg=name)
    return choices


@pytest.mark.parametrize("g", [0, 1])
def test_group_as_the_graph_runs_it_equals_the_plain_step(jax_groups, monkeypatch, g):
    """The racing step as the group graph runs it, on the CPU: one
    `prepare_group`, the ICP loop, then for each lane `commit_lane` and
    the update its SWITCH node picks, applied alone.  Rows, iterations,
    loop passes and every state tensor equal the plain step's; each
    lane's pick equals the JAX group's."""
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    jcfg, groups = jax_groups
    before, lanes, after, jregs = groups[g]
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    frames = [to_port_frame(f) for f in lanes]

    plain_state, plain_regs, plain_loops = odometry_step_batched(
        state_from_numpy(before, "cpu"), frames, cfg)

    state = state_from_numpy(before, "cpu")
    group = prepare_group(state, frames, cfg)
    assert group.enabled.dtype == torch.bool and group.enabled.shape == (G * PIECES,)
    carry, loops = ticp.run_host_loop(group.icp_pass, group.carry,
                                      cfg.optimization.icp_maximum_iteration)
    regs = group.finish(carry)
    picks = []
    for k, frame in enumerate(frames):
        state, reg, upd = commit_lane(state, k, frame, group, regs, cfg)
        flags = torch.stack([upd.rebuild] + ([] if upd.append is None else [upd.append]))
        pick = int(switch_index_plain(flags))
        if pick == 0:
            map_c, map_s, grid_c, grid_s = rebuilt_matching(state, cfg)
            state = state._replace(map_corners=map_c, map_surface=map_s,
                                   grid_corners=grid_c, grid_surface=grid_s)
        elif pick == 1:
            map_c, map_s = appended_matching(state, upd)
            state = state._replace(map_corners=map_c, map_surface=map_s)
        picks.append(pick if pick < flags.numel() else None)
        assert torch.equal(P.trajectory_rows([reg], [frame]),
                           P.trajectory_rows([plain_regs[k]], [frame])), k
    # group 0 lies in the init window (no lane enabled, no pass), group 1
    # registers (three lanes accepted, three rejected)
    assert loops == plain_loops == int(carry.loops) and (loops > 0) == (g > 0)
    assert_trees_equal(state, plain_state)
    appends = upd.append is not None
    assert picks == jax_lane_updates(jcfg, before, lanes, after, jregs, appends, monkeypatch)
    assert any(p is not None for p in picks)


# ---------------------------------------------------------------- chunks --

def chunk_config(**parallel):
    return SlamConfig().replace(
        capacity={**SMALL, "auto_schedule": 0},
        mapping={"init_accumulate_frames": 2},
        optimization={"icp_maximum_iteration": 2, "full_iterations": 2},
        parallel=parallel)


def test_chunked_dispatch_equals_sequential_frames():
    """Six raw frames as a chunk of 4 and a tail of 2 (`flush`) against
    six sequential frames: rows, iterations and every state tensor equal
    (chunked dispatch keeps the per-frame semantics)."""
    sim = LivoxSimulator(SimConfig(points_per_frame=4000, seed=4))
    frames = [sim.frame(i) for i in range(6)]
    out = []
    for parallel in ({}, {"dispatch_chunk": 4}):
        pipe = P.OdometryPipeline(chunk_config(**parallel), device="cpu")
        for f in frames:
            pipe.process_raw(*f)
        pipe.flush()
        out.append(pipe)
    seq, chunk = out
    assert chunk.dispatch_chunk == 4 and len(chunk.trajectory.times) == 6
    assert chunk._frame_idx == seq._frame_idx == 6
    for name in ("times", "accepted"):
        assert getattr(chunk.trajectory, name) == getattr(seq.trajectory, name)
    assert np.array_equal(chunk.trajectory.positions_array(), seq.trajectory.positions_array())
    assert np.array_equal(np.asarray(chunk.trajectory.quaternions),
                          np.asarray(seq.trajectory.quaternions))
    assert chunk.iterations == seq.iterations and sum(seq.iterations) > 0
    assert_trees_equal(chunk.state, seq.state)


# ---------------------------------------------------- the split searcher --

@pytest.mark.parametrize("lanes", [None, 3])
def test_split_searcher_equals_the_whole_buffers_search(lanes):
    """A 5,000-row buffer searched in blocks of at most 1,024 rows (five
    operands, the last partial) against one search of it: indices and
    distances equal, within the radius gate, with ties (repeated rows in
    different blocks) and a lane that has no queries."""
    rng = np.random.default_rng(5)
    m = 5000
    xyz = rng.uniform(-4, 4, (m, 3)).astype(np.float32)
    xyz[4100:4200] = xyz[100:200]            # equal distances across blocks
    mask = rng.random(m) < 0.6
    mask[4500:] = False
    ref = PointBatch(xyz=torch.from_numpy(xyz), time=torch.zeros(m),
                     mask=torch.from_numpy(mask))
    shape = (300, 3) if lanes is None else (lanes, 300, 3)
    q = torch.from_numpy((rng.uniform(-4, 4, shape)).astype(np.float32))
    counts = (torch.tensor(250, dtype=torch.int32) if lanes is None
              else torch.tensor([250, 0, 300], dtype=torch.int32))
    radius = 1.5
    whole = ticp._searcher("pallas", ref, None, 5, radius, 1024)(q, counts)
    split = ticp._searcher("pallas", ref, None, 5, radius, 1024, max_rows=1024)(q, counts)
    for a, b in zip(split, whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    d, i = whole
    assert (d < 1e29).any() and (i >= 4096).any()    # neighbours in the last block


# ------------------------------------------------------ the state getter --

def test_a_state_read_stays_as_it_was():
    """A state read from the pipeline is not changed by the next frame
    (the JAX pipeline returns new arrays; on the card the frame program
    hands out a copy of its static state)."""
    sim = LivoxSimulator(SimConfig(points_per_frame=4000, seed=4))
    pipe = P.OdometryPipeline(chunk_config(), device="cpu")
    for i in range(3):
        pipe.process_raw(*sim.frame(i))
    held = pipe.state
    copy = {k: v.clone() for k, v in leaves(held).items()}
    pipe.process_raw(*sim.frame(3))
    pipe.flush()
    assert int(pipe.state.frame_count) == 4
    for k, v in leaves(held).items():
        assert torch.equal(v, copy[k]), k


def test_on_slice_admits_chunked_and_racing_dispatch():
    card = torch.device("cuda")
    racing = realtime_racing_profile()
    assert on_slice(SlamConfig().replace(parallel={"dispatch_chunk": 8}), card)
    assert on_slice(racing, card) and int(racing.parallel.frame_batch) > 1
    assert not on_slice(racing, torch.device("cpu"))
    # the Velodyne front end and the grid / dense engines run on the frame
    # program under every dispatch too (tests/test_torch_frame_slice.py)
    assert on_slice(racing.replace(common={"lidar_type": "velodyne"}), card)
    # cell matching and loop closure run on the frame program under every
    # dispatch (their cell maps take masked insertions, no host branch)
    for dispatch in ({}, {"dispatch_chunk": 8}):
        base = SlamConfig().replace(parallel=dispatch)
        assert on_slice(base.replace(loop_closure={"if_enable_loop_closure": 1}), card)
        assert on_slice(base.replace(mapping={"matching_mode": 1}), card)
    assert on_slice(racing.replace(loop_closure={"if_enable_loop_closure": 1}), card)
    assert on_slice(racing.replace(mapping={"matching_mode": 1}), card)
    assert on_slice(racing.replace(optimization={"correspondence": "grid"}), card)
    # residual subsampling too: its draws come from the carry's key
    assert on_slice(racing.replace(optimization={"subsample_residuals": 64}), card)
    assert not on_slice(racing.replace(optimization={"subsample_residuals": 64}),
                        torch.device("cpu"))
