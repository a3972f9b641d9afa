"""The cell maps on the device: each map's frame index a () int32 tensor,
and the odometry step's cell-map insertion masked by admission (no host
read), against the JAX package on the CPU.

* ``frame_idx`` stays a device tensor through `interop`, `save_state` /
  `load_state` (a file that holds it as a host int loads too) and the
  cell-map JSON load.
* Insertion masked by a False admission leaves every field as
  `map.cell_map.skip_frame` leaves it (compared with ``torch.equal``:
  the merge re-adds zeros, which would turn a ``-0.0`` into ``+0.0``)
  and touches no cell; with either mask it equals the JAX
  ``append_cloud`` with the same mask.
* Teacher-forced steps, an admitted and a not admitted frame each, in
  cell matching mode and with loop closure (the streams of
  tests/test_torch_cell_mode.py and tests/test_torch_loop_step.py, each
  with a 2-frame history window and a 0.3 m admission step, so that
  frames 2 and 3, accepted at a standstill, are not admitted on every
  host: a registration's rejection depends on the host's rounding),
  equal the JAX ``odometry_step`` to the tolerances of those files, the
  port's kNN routed through the JAX dense engine; every map's frame
  index equal.
* A cell-mode and a loop-closure stream through the port's pipeline on
  the CPU read the admission flag on the host 0 times.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.map import cell_map as jcm
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.interop import cell_map_from_numpy, config_from_dict, state_from_numpy
from loam_livox_tpu_torch.io.serialization import load_cell_map_json, save_cell_map_json
from loam_livox_tpu_torch.map import cell_map as tcm
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime import checkpoint
from loam_livox_tpu_torch.runtime.odometry import init_state as tinit_state
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
import test_torch_cell_mode as cell_mode
import test_torch_loop_step as loop_step
from test_torch_cell_map import assert_maps_equal, batches, jax_fields, padded
from test_torch_odometry import jax_frames, jax_knn_fused, to_port_frame

torch.set_num_threads(2)


def assert_frame_idx(m: tcm.CellMap, value: int) -> None:
    assert isinstance(m.frame_idx, torch.Tensor) and m.frame_idx.dtype == torch.int32
    assert m.frame_idx.shape == () and int(m.frame_idx) == value


def filled_map(rng, n_frames=4):
    """Both packages' maps after ``n_frames`` appends of 60 points each
    (a revisit threshold of 2, so later frames restart cells)."""
    jm = jcm.empty_cell_map(1.0, 128, 8)
    tm = tcm.empty_cell_map(1.0, 128, 8)
    for _ in range(n_frames):
        jb, tb = batches(*padded(rng.uniform(-4, 4, (60, 3)), 64))
        jm, _ = jcm.append_cloud(jm, jb, 2, max_new=32)
        tm, _ = tcm.append_cloud(tm, tb, 2, max_new=32)
    return jm, tm


# ---- the frame index as a device tensor -------------------------------------

def test_frame_idx_is_a_tensor_through_interop_checkpoint_and_json(tmp_path):
    rng = np.random.default_rng(3)
    jm, tm = filled_map(rng)
    assert_frame_idx(tm, 4)
    assert_frame_idx(tcm.empty_cell_map(1.0, 8, 2), 0)
    fields = {f"m.{k}": v for k, v in jax_fields(jm).items()}
    assert_frame_idx(cell_map_from_numpy(fields, "m", "cpu"), 4)

    cfg = config_from_dict(dataclasses.asdict(loop_step.jax_config()))
    st = tinit_state(cfg, "cpu")
    st = st._replace(cell_full=st.cell_full._replace(
        frame_idx=torch.tensor(7, dtype=torch.int32)))
    path = str(tmp_path / "state.pt")
    checkpoint.save_state(st, path)
    back = checkpoint.load_state(path, cfg, device="cpu")
    for name in ("cell_full", "cell_corners", "cell_planes"):
        assert_frame_idx(getattr(back, name), 7 if name == "cell_full" else 0)
    # a file written when the frame index was a host int
    saved = torch.load(path, weights_only=True)
    for name in ("cell_full", "cell_corners", "cell_planes"):
        saved[name]["frame_idx"] = 11
    torch.save(saved, path)
    old = checkpoint.load_state(path, cfg, device="cpu")
    for name in ("cell_full", "cell_corners", "cell_planes"):
        assert_frame_idx(getattr(old, name), 11)

    json_path = str(tmp_path / "map.json")
    assert save_cell_map_json(tm, json_path) > 0
    assert_frame_idx(load_cell_map_json(json_path, 128, 8, device="cpu"), 1)
    with open(json_path, "w") as f:
        json.dump([], f)
    assert_frame_idx(load_cell_map_json(json_path, 128, 8, device="cpu"), 0)


# ---- insertion masked by admission ------------------------------------------

def test_masked_insertion_equals_skip_frame_and_jax():
    rng = np.random.default_rng(5)
    jm, tm = filled_map(rng)
    # 60 points in 8 cells, some of them revisits: cells that take 3 or more
    xyz, mask = padded(rng.uniform(-1, 1, (60, 3)), 64)
    for admit in (False, True):
        jb, tb = batches(xyz, mask & admit)
        jn, j3 = jcm.append_cloud(jm, jb, 2, max_new=32)
        tn, t3 = tcm.append_cloud(tm, tb, 2, max_new=32)
        assert_maps_equal(tn, jn, t3, j3)
        assert_frame_idx(tn, 5)
        if admit:
            assert t3.any()
            continue
        skipped = tcm.skip_frame(tm)
        assert not t3.any() and tn.cell_size == skipped.cell_size
        for name in tcm.CellMap._fields[1:]:
            a, b = getattr(tn, name), getattr(skipped, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name


# ---- teacher-forced steps ---------------------------------------------------

def stream(mod, n_frames):
    """(JAX config, [(state before, frame, state after, registration)])
    of the first ``n_frames`` of ``mod``'s stream, its history window cut
    to 2 frames with a 0.3 m admission step."""
    cfg = mod.jax_config().replace(
        mapping={"maximum_histroy_buffer": 2, "history_add_t_step": 0.3})
    st = jinit_state(cfg)
    steps = []
    for fr in jax_frames(cfg, n_frames):
        new, reg = jstep(st, fr, cfg)
        steps.append((mod.state_fields(st), fr, mod.state_fields(new), reg))
        st = new
    return cfg, steps


@pytest.fixture(scope="module")
def cell_stream():
    return stream(cell_mode, 5)


@pytest.fixture(scope="module")
def loop_stream():
    return stream(loop_step, 5)


def admitted(before, after) -> bool:
    return int(after["hist_len"]) > int(before["hist_len"]) or not np.array_equal(
        after["hist_surf_mask"], before["hist_surf_mask"])


def check_step(cfg, steps, t, maps, monkeypatch):
    """The port's step from the JAX state before frame ``t``: pose,
    history counters, the maps (every field to the stream files'
    tolerances) and the matching buffer against the JAX step's."""
    monkeypatch.setattr(ticp, "knn_fused", jax_knn_fused)
    before, fr, after, jreg = steps[t]
    new, reg = tstep(state_from_numpy(before, "cpu"), to_port_frame(fr),
                     config_from_dict(dataclasses.asdict(cfg)))
    assert bool(reg.accepted) == bool(jreg.accepted)
    for name in ("q_w", "t_w", "last_his_q", "last_his_t"):
        np.testing.assert_allclose(getattr(new, name).numpy(), after[name], rtol=0, atol=1e-4,
                                   err_msg=name)
    assert (int(new.hist_len), int(new.hist_ptr)) == (int(after["hist_len"]),
                                                     int(after["hist_ptr"]))
    for name in maps:
        cells = getattr(new, name)
        assert_frame_idx(cells, int(after[f"{name}.frame_idx"]))
        assert int(cells.frame_idx) == t + 1
        for f in ("keys", "count", "last_update_frame", "create_frame"):
            np.testing.assert_array_equal(getattr(cells, f).numpy(), after[f"{name}.{f}"],
                                          err_msg=f"{name}.{f}")
        np.testing.assert_allclose(cells.pts.numpy(), after[f"{name}.pts"], rtol=0, atol=1e-3)
        for f in ("sum_p", "sum_pp"):
            np.testing.assert_allclose(getattr(cells, f).numpy(), after[f"{name}.{f}"],
                                       rtol=1e-4, atol=1e-3, err_msg=f"{name}.{f}")
        if not admitted(before, after):
            for f in ("keys", "count", "pts"):
                np.testing.assert_array_equal(getattr(cells, f).numpy(), before[f"{name}.{f}"])
    if new.last_touched is not None:
        np.testing.assert_array_equal(new.last_touched.numpy(), after["last_touched"])
        assert admitted(before, after) or not new.last_touched.any()
    for name in ("map_corners", "map_surface"):
        b = getattr(new, name)
        np.testing.assert_array_equal(b.mask.numpy(), after[f"{name}.mask"], err_msg=name)
        np.testing.assert_allclose(b.xyz.numpy(), after[f"{name}.xyz"], rtol=0, atol=1e-3,
                                   err_msg=name)
    return admitted(before, after), bool(jreg.accepted)


@pytest.mark.parametrize("t,expect", [(4, (True, True)), (2, (False, True))],
                         ids=["admitted", "not_admitted"])
def test_cell_mode_step_matches_jax(cell_stream, monkeypatch, t, expect):
    cfg, steps = cell_stream
    assert check_step(cfg, steps, t, ("cell_corners", "cell_planes"), monkeypatch) == expect


@pytest.mark.parametrize("t,expect", [(4, (True, True)), (2, (False, True))],
                         ids=["admitted", "not_admitted"])
def test_loop_closure_step_matches_jax(loop_stream, monkeypatch, t, expect):
    cfg, steps = loop_stream
    maps = ("cell_full", "cell_corners", "cell_planes")
    assert check_step(cfg, steps, t, maps, monkeypatch) == expect


# ---- no admission read ------------------------------------------------------

@pytest.mark.parametrize("mod", [cell_mode, loop_step], ids=["cell_mode", "loop_closure"])
def test_streams_read_no_admission_flag(mod):
    """Six raw frames (registration from frame 2) through the port's
    pipeline on the CPU: frames registered and cells inserted, and no
    host read of the admission flag (the loop service inline)."""
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
    from loam_livox_tpu_torch.runtime import pipeline as P

    cfg = config_from_dict(dataclasses.asdict(mod.jax_config().replace(
        mapping={"init_accumulate_frames": 2},
        loop_closure={"if_loop_service_async": 0, "scans_of_each_keyframe": 2,
                      "scans_between_two_keyframe": 2})))
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.4))
    pipe = P.OdometryPipeline(cfg, device="cpu")
    P.reset_host_syncs()
    for i in range(6):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    syncs = P.host_syncs()
    assert syncs["admit"] == 0 and syncs["icp_exit"] > 0
    assert len(pipe.trajectory.times) == 6 and sum(pipe.iterations) > 0
    st = pipe.state
    assert_frame_idx(st.cell_planes, 6)
    assert int(st.cell_planes.n_cells()) > 0
    if st.cell_full is not None:
        assert_frame_idx(st.cell_full, 6)
        assert len(pipe.loop_closer.keyframes) >= 2
