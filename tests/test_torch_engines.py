"""The ``grid`` and ``dense`` correspondence engines of the port's
odometry step against the JAX package's, teacher-forced, on the CPU.

The JAX package runs the simulator stream of tests/test_torch_odometry.py
with ``optimization/correspondence`` ``grid`` (its bucket grids built at
init and at every rebuild, no appends) and ``dense`` (its expanded
‖q‖² + ‖r‖² − 2⟨q, r⟩ ranking).  Before a frame its state, the grids
included, is carried into the port (`interop.state_from_numpy`), and
both packages step once on the same frame with the same engine, each
with its own search (nothing is routed through the other package).
Accept flags equal; poses within 1e-4; history and matching-buffer
masks equal; under ``grid`` the grids after the step equal (keys,
slots and source indices; points within 1e-3 m).  Where one ulp of
input moves the JAX step itself into another basin, the port must land
where the JAX step lands from the frame one ulp away
(tests/test_torch_odometry.py `first_match`).

Capacities: ``SMALL_CAPS`` with 10,000 points a frame, matching buffers
cut to 1,024 / 4,096 points, grids of 1,024 / 2,048 buckets.
"""
import dataclasses

import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.runtime.odometry import build_grids, rebuild_interval
from loam_livox_tpu_torch.runtime.odometry import init_state as tinit_state
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
from test_torch_odometry import first_match, jax_frames, nudged_frame, state_fields, to_port_frame

torch.set_num_threads(2)

N_FRAMES = 8
INIT = 4
GRID_ARRAYS = ("keys", "pts", "src_idx", "slot_mask")


def jax_config(engine: str):
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096,
                  "corner_bucket_count": 1024, "surf_bucket_count": 2048},
        mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3,
                      "correspondence": engine})


def fields(st, engine: str) -> dict:
    out = state_fields(st)
    if engine == "grid":
        for name in ("grid_corners", "grid_surface"):
            g = getattr(st, name)
            for f in GRID_ARRAYS + ("bucket_size",):
                out[f"{name}.{f}"] = np.array(getattr(g, f))
    return out


@pytest.fixture(scope="module", params=["grid", "dense"])
def jax_stream(request):
    engine = request.param
    cfg = jax_config(engine)
    st = jinit_state(cfg)
    steps = []
    for fr in jax_frames(cfg, N_FRAMES):
        new, reg = jstep(st, fr, cfg)
        steps.append((st, fr, fields(new, engine), reg))
        st = new
    return engine, cfg, steps


def test_grid_state_is_built_only_under_grid():
    for engine in ("grid", "dense", "auto"):
        st = tinit_state(config_from_dict(dataclasses.asdict(jax_config(engine))), "cpu")
        assert (st.grid_corners is None) == (engine != "grid")
        if engine == "grid":
            assert st.grid_corners.keys.shape == (1024,) and st.grid_surface.keys.shape == (2048,)
            assert not bool(st.grid_surface.slot_mask.any())


@pytest.mark.parametrize("t", [INIT, INIT + 1, INIT + 3])
def test_teacher_forced_engine_step_matches_jax(jax_stream, t):
    engine, cfg, steps = jax_stream
    st, fr, after, jreg = steps[t]
    before = fields(st, engine)
    state = state_from_numpy(before, "cpu")
    assert (state.grid_corners is not None) == (engine == "grid")
    new, reg = tstep(state, to_port_frame(fr), config_from_dict(dataclasses.asdict(cfg)))
    assert bool(reg.enabled)

    def check(jax_result):
        after, jreg = jax_result
        assert bool(reg.accepted) == bool(jreg.accepted)
        for name in ("q_w", "t_w", "last_q_incre", "last_t_incre"):
            np.testing.assert_allclose(getattr(new, name).numpy(), after[name], rtol=0,
                                       atol=1e-4, err_msg=name)
        assert (new.hist_len, new.hist_ptr) == (int(after["hist_len"]), int(after["hist_ptr"]))
        for name in ("hist_corner_mask", "hist_surf_mask"):
            np.testing.assert_array_equal(getattr(new, name).numpy(), after[name], err_msg=name)
        for name in ("map_corners", "map_surface"):
            b = getattr(new, name)
            np.testing.assert_array_equal(b.mask.numpy(), after[f"{name}.mask"], err_msg=name)
            np.testing.assert_allclose(b.xyz.numpy(), after[f"{name}.xyz"], rtol=0, atol=1e-3,
                                       err_msg=name)
        if engine == "grid":
            for name in ("grid_corners", "grid_surface"):
                g = getattr(new, name)
                for f in ("keys", "src_idx", "slot_mask"):
                    np.testing.assert_array_equal(getattr(g, f).numpy(), after[f"{name}.{f}"],
                                                  err_msg=f"{name}.{f}")
                np.testing.assert_allclose(g.pts.numpy(), after[f"{name}.pts"], rtol=0,
                                           atol=1e-3, err_msg=name)

    def jax_results():
        yield after, jreg
        for direction in (1, -1):
            n2, r2 = jstep(st, nudged_frame(fr, direction), cfg)
            yield fields(n2, engine), r2

    first_match(check, jax_results())


def test_grid_buffer_changes_only_at_rebuilds():
    """Under ``grid`` an admitted frame rebuilds the buffer and its grids
    on the rebuild cadence and leaves both as they are in between: a grid
    has no append (``loam_livox_tpu/runtime/odometry.py:393-396``)."""
    cfg = config_from_dict(dataclasses.asdict(jax_config("grid")))
    interval = rebuild_interval(cfg)
    state = tinit_state(cfg, "cpu")
    rebuilt = 0
    for fr in jax_frames(jax_config("grid"), N_FRAMES):
        new, _ = tstep(state, to_port_frame(fr), cfg)
        admitted = new.hist_ptr != state.hist_ptr
        if admitted and state.frame_count % interval == 0:
            rebuilt += 1
            grids = build_grids(new.map_corners, new.map_surface, cfg)
            for got, want in zip((new.grid_corners, new.grid_surface), grids):
                for f in GRID_ARRAYS:
                    assert torch.equal(getattr(got, f), getattr(want, f)), f
        else:
            assert new.map_surface is state.map_surface and new.grid_surface is state.grid_surface
            assert new.map_corners is state.map_corners and new.grid_corners is state.grid_corners
        state = new
    assert rebuilt >= 2 and bool(state.grid_surface.slot_mask.any())
