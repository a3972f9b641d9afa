"""Loop closure under chunked and racing dispatch.

The JAX package hands its loop service one entry a dispatch unit: a raw
frame (sequential), a chunk (the OR of its frames' touched masks, slot
by slot, JAX ``runtime/pipeline.py:162-178``) or a raced group (the OR
over its lanes' commits, ``touched_any``, JAX ``runtime/batched.py:
102-123``), each indexed by its first raw frame (``_park``, JAX
``runtime/pipeline.py:505-556``).

* The racing step, teacher-forced against the JAX package's on the CPU
  with loop closure on (the harness of tests/test_torch_racing.py: whole
  frames as lanes, the port's search routed through the JAX dense
  engine): the group's touched mask and the full-cloud cell map equal.
* The port's pipeline: a chunk's entry carries the OR of the masks the
  sequential run gives its frames (the chunked frame path is the
  sequential one, bit for bit) and the chunk's first frame index; a
  raced group's entry carries the OR of its commits' masks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig as JConfig
from loam_livox_tpu.runtime.batched import odometry_step_batched as jbatched
from loam_livox_tpu.runtime.odometry import init_state as jinit_state

from loam_livox_tpu_torch.core.config import SlamConfig as TConfig
from loam_livox_tpu_torch.eval.scenarios import SMALL_CAPS
from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime import batched as tbatched_mod
from loam_livox_tpu_torch.runtime.loop_service import LoopCloser
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
from test_torch_loop_step import state_fields
from test_torch_racing import jax_knn_fused, jax_pieces, to_port_frame

torch.set_num_threads(2)

G = 4          # lanes a group (whole frames)
GROUPS = 2     # the first before registration starts, the second after
CAPS = {**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
        "map_corner_capacity": 1024, "map_surf_capacity": 4096,
        "cell_capacity": 2048, "cell_point_capacity": 16}


@pytest.fixture(scope="module")
def jax_groups():
    cfg = JConfig().replace(
        capacity=CAPS, mapping={"init_accumulate_frames": G},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3},
        loop_closure={"if_enable_loop_closure": 1})
    lanes = jax_pieces(cfg, GROUPS * G)
    st = jinit_state(cfg)
    out = []
    for g in range(GROUPS):
        group = lanes[g * G:(g + 1) * G]
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *group)
        new, _ = jbatched(st, stacked, cfg, G)
        out.append((state_fields(st), group, state_fields(new)))
        st = new
    return cfg, out


@pytest.mark.parametrize("g", range(GROUPS))
def test_racing_group_touched_matches_jax(jax_groups, monkeypatch, g):
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    cfg, groups = jax_groups
    before, group, after = groups[g]
    seen = []
    commit = tbatched_mod.commit_lane

    def keep(*args, **kw):
        state, reg, upd = commit(*args, **kw)
        seen.append(state.last_touched.clone())
        return state, reg, upd

    monkeypatch.setattr(tbatched_mod, "commit_lane", keep)
    new, _, _ = tbatched_mod.odometry_step_batched(
        state_from_numpy(before, "cpu"), [to_port_frame(f) for f in group],
        config_from_dict(dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(new.last_touched.numpy(), after["last_touched"])
    for f in ("keys", "count", "last_update_frame", "create_frame"):
        np.testing.assert_array_equal(getattr(new.cell_full, f).numpy(),
                                      after[f"cell_full.{f}"], err_msg=f)
    # the group's mask is every lane's, not only the last commit's
    union = torch.stack(seen).any(dim=0)
    assert torch.equal(new.last_touched, union) and len(seen) == G
    assert int(union.sum()) > int(seen[-1].sum())


# ------------------------------------------------------------ pipeline --

def port_config(**parallel):
    return TConfig().replace(
        capacity=CAPS, mapping={"init_accumulate_frames": 4},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3},
        loop_closure={"if_enable_loop_closure": 1, "if_loop_service_async": 0},
        parallel={"batch_motion_guard_t": 0.0, **parallel})


def run_recording(cfg, n_frames, monkeypatch):
    """Feed ``n_frames`` simulator frames; returns the service's entries
    as (frame index, touched mask, directory keys)."""
    calls = []

    def record(self, cell_full, touched, q_w, t_w, frame_idx):
        calls.append((frame_idx, touched.clone(), cell_full.keys.clone()))

    monkeypatch.setattr(LoopCloser, "on_frame", record)
    sim = LivoxSimulator(SimConfig(points_per_frame=6000, seed=2),
                         traj=Trajectory(ramp_t0=0.3))
    pipe = OdometryPipeline(cfg, device="cpu")
    for i in range(n_frames):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    return calls, pipe


def test_chunk_entry_is_the_or_of_its_frames(monkeypatch):
    seq, pipe_s = run_recording(port_config(), 8, monkeypatch)
    chunk, pipe_c = run_recording(port_config(dispatch_chunk=4), 8, monkeypatch)
    assert [c[0] for c in seq] == list(range(8))
    assert [c[0] for c in chunk] == [0, 4]
    np.testing.assert_array_equal(pipe_c.trajectory.positions_array(),
                                  pipe_s.trajectory.positions_array())
    for (idx, touched, keys), start in zip(chunk, (0, 4)):
        frames = seq[start:start + 4]
        union = torch.stack([t for _, t, _ in frames]).any(dim=0)
        assert torch.equal(touched, union) and bool(touched.any())
        assert torch.equal(keys, frames[-1][2])
    assert int(chunk[1][1].sum()) > int(seq[7][1].sum())


def test_raced_group_entry_is_the_or_of_its_lanes(monkeypatch):
    lanes = []
    commit = tbatched_mod.commit_lane

    def keep(*args, **kw):
        state, reg, upd = commit(*args, **kw)
        lanes.append(state.last_touched.clone())
        return state, reg, upd

    monkeypatch.setattr(tbatched_mod, "commit_lane", keep)
    calls, pipe = run_recording(port_config(frame_batch=2), 8, monkeypatch)
    assert pipe.raced_groups == 4 and pipe.fallback_groups == 0
    assert [c[0] for c in calls] == [0, 2, 4, 6]
    for k, (_, touched, _) in enumerate(calls):
        assert torch.equal(touched, lanes[2 * k] | lanes[2 * k + 1])
