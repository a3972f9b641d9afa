"""The odometry step with loop closure on: the full-cloud cell map
``cell_full`` and the touched-cell mask ``last_touched`` against the JAX
package's, teacher-forced, on the CPU.

The JAX package runs a simulator stream with loop closure on.  Before
every frame t its ``OdometryState`` (``cell_full`` included) is carried
into the port (`interop.state_from_numpy`) and both packages step once
on the same feature frame, the port's kNN routed through the JAX dense
engine as in tests/test_torch_odometry.py.  Where the step is chaotic
(one ulp of input moves the JAX step itself into another basin: frame
10 on an AVX-512 host, 8.5e-4 in the quaternion), the port must match
the JAX step from the frame one ulp away instead
(tests/test_torch_odometry.py `first_match`).  ``cell_full`` must agree:
keys, counts, update and creation frames and frame index equal, pooled
points within 1e-3 m, moment sums within rtol 1e-4; ``last_touched``
equal.  The stream has frames that are not admitted (a 2-frame history
window with a 0.3 m admission step, so the standstill frames after the
second are not admitted: the full map then only moves its frame index
and the mask is all False) and revisits (cell revisit threshold 3
frames, so a cell seen again after 3 frames restarts).  Both packages
also keep the feature cell maps with loop closure on (nothing reads them
in history matching; the command line's ``--save-map`` writes the plane
map): directory keys, counts and frame index equal as well.

Capacities: ``SMALL_CAPS`` with 10,000 points a frame, matching buffers
cut to 1,024 / 4,096 points, 2,048 cells of 16 points.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.interop import CELL_MAP_ARRAYS, config_from_dict, state_from_numpy
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime.odometry import init_state as tinit_state
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
from test_torch_odometry import first_match, jax_frames, jax_knn_fused, nudged_frame, to_port_frame

torch.set_num_threads(2)

N_FRAMES = 12
INIT = 4


def jax_config():
    return SlamConfig().replace(
        common={"threshold_cell_revisit": 3},
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096,
                  "cell_capacity": 2048, "cell_point_capacity": 16},
        mapping={"init_accumulate_frames": INIT, "maximum_histroy_buffer": 2,
                 "history_add_t_step": 0.3},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3},
        loop_closure={"if_enable_loop_closure": 1})


def state_fields(st) -> dict:
    out = {}
    for name in st._fields:
        v = getattr(st, name)
        if name in ("map_corners", "map_surface"):
            for f in ("xyz", "time", "mask"):
                out[f"{name}.{f}"] = np.array(getattr(v, f))
        elif name in ("cell_full", "cell_corners", "cell_planes"):
            for f in CELL_MAP_ARRAYS + ("cell_size", "frame_idx"):
                out[f"{name}.{f}"] = np.array(getattr(v, f))
        elif isinstance(v, jnp.ndarray):
            out[name] = np.array(v)
    return out


@pytest.fixture(scope="module")
def jax_stream():
    cfg = jax_config()
    st = jinit_state(cfg)
    steps, states = [], []
    for fr in jax_frames(cfg, N_FRAMES):
        new, reg = jstep(st, fr, cfg)
        steps.append((state_fields(st), fr, state_fields(new), reg))
        states.append(st)
        st = new
    return cfg, steps, states


def admitted(before, after) -> bool:
    return int(after["hist_len"]) > int(before["hist_len"]) or not np.array_equal(
        after["hist_surf_mask"], before["hist_surf_mask"])


@pytest.mark.parametrize("t", range(N_FRAMES))
def test_teacher_forced_full_map_matches_jax(jax_stream, monkeypatch, t):
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    cfg, steps, states = jax_stream
    before, fr, after, jreg = steps[t]
    state = state_from_numpy(before, "cpu")
    assert state.cell_corners is not None and state.cell_full is not None
    new, reg = tstep(state, to_port_frame(fr), config_from_dict(dataclasses.asdict(cfg)))

    def check(jax_result):
        after, jreg = jax_result
        assert bool(reg.accepted) == bool(jreg.accepted)
        for name in ("q_w", "t_w", "last_his_q", "last_his_t"):
            np.testing.assert_allclose(getattr(new, name).numpy(), after[name], rtol=0,
                                       atol=1e-4, err_msg=name)
        assert (new.hist_len, new.hist_ptr) == (int(after["hist_len"]), int(after["hist_ptr"]))
        cells = new.cell_full
        assert cells.frame_idx == int(after["cell_full.frame_idx"]) == t + 1
        for f in ("keys", "count", "last_update_frame", "create_frame"):
            np.testing.assert_array_equal(getattr(cells, f).numpy(), after[f"cell_full.{f}"],
                                          err_msg=f)
        np.testing.assert_allclose(cells.pts.numpy(), after["cell_full.pts"], rtol=0, atol=1e-3)
        for f in ("sum_p", "sum_pp"):
            np.testing.assert_allclose(getattr(cells, f).numpy(), after[f"cell_full.{f}"],
                                       rtol=1e-4, atol=1e-3, err_msg=f)
        np.testing.assert_array_equal(new.last_touched.numpy(), after["last_touched"])
        for name in ("cell_corners", "cell_planes"):
            fm = getattr(new, name)
            assert fm.frame_idx == int(after[f"{name}.frame_idx"]) == t + 1
            for f in ("keys", "count"):
                np.testing.assert_array_equal(getattr(fm, f).numpy(), after[f"{name}.{f}"],
                                              err_msg=f"{name}.{f}")
        if not admitted(before, after):
            assert not new.last_touched.any()
            for f in ("keys", "count", "pts"):
                np.testing.assert_array_equal(getattr(cells, f).numpy(), before[f"cell_full.{f}"])
        for name in ("map_corners", "map_surface"):
            b = getattr(new, name)
            np.testing.assert_array_equal(b.mask.numpy(), after[f"{name}.mask"], err_msg=name)

    def jax_results():
        yield after, jreg
        for direction in (1, -1):
            n2, r2 = jstep(states[t], nudged_frame(fr, direction), cfg)
            yield state_fields(n2), r2

    first_match(check, jax_results())


def test_stream_exercises_admission_and_revisits(jax_stream):
    """The stream has what the step test claims: admitted and not
    admitted frames, touched cells, and cells restarted on a revisit."""
    _, steps, _ = jax_stream
    flags = [admitted(before, after) for before, _, after, _ in steps]
    assert flags.count(True) >= 4 and flags.count(False) >= 2, flags
    last = steps[-1][2]
    valid = last["cell_full.keys"] != 2 ** 31 - 1
    assert valid.sum() > 100 and any(s[2]["last_touched"].sum() > 20 for s in steps)
    # a revisit restarts a cell: created after frame 0 though its key came earlier
    first_seen = {}
    for t, (_, _, after, _) in enumerate(steps):
        keys = after["cell_full.keys"]
        for k in keys[keys != 2 ** 31 - 1].tolist():
            first_seen.setdefault(k, t)
    restarted = [k for k, c in zip(last["cell_full.keys"][valid].tolist(),
                                   last["cell_full.create_frame"][valid].tolist())
                 if c > first_seen[k]]
    assert restarted, "no revisit reset in the stream"


def test_full_map_is_off_without_loop_closure():
    cfg = config_from_dict(dataclasses.asdict(jax_config().replace(
        loop_closure={"if_enable_loop_closure": 0})))
    st = tinit_state(cfg, "cpu")
    assert st.cell_full is None and st.last_touched is None
    on = tinit_state(config_from_dict(dataclasses.asdict(jax_config())), "cpu")
    assert on.cell_full.capacity == 2048 and on.last_touched.shape == (2048,)
