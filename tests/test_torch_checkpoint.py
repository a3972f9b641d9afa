"""Checkpoint and resume (``loam_livox_tpu_torch.runtime.checkpoint``) on
the CPU.

* The odometry state: a state saved after 5 frames loads equal, field
  by field (tensors, host integers, the generator's state), and runs on
  bit for bit like the one never saved (the JAX package's
  tests/test_checkpoint.py:13-40); other capacities raise
  ``ValueError`` (:42-51), and so does a cell map where the
  configuration keeps none.
* The loop service's state crosses between the packages both ways in
  the JAX package's ``.npz`` layout: services fed the same cell map and
  poses (the world of tests/test_torch_loop_service.py) write files that
  the other package loads with equal values: keyframe keys, poses,
  descriptors, era snapshots, open accumulators (keys and frame counts),
  the waiting list, the one-shot flag and the result.
* `save_pipeline` / `load_pipeline`: a run split after 6 of 12 frames
  equals the uninterrupted run bit for bit, every trajectory row and
  every state tensor, on the sequential path (with residual subsampling,
  so the generator's state matters), on the chunked path (split at a
  chunk's end) and with loop closure on, a keyframe open across the
  split: the keyframes' members, descriptors and snapshots equal too.  The racing path is not held:
  its motion guard's last observation is not in the checkpoint, as in
  the JAX package (ROADMAP.md §3).
"""
import warnings

import numpy as np
import pytest
import torch

from loam_livox_tpu.runtime.checkpoint import load_loop_state as jload_loop
from loam_livox_tpu.runtime.checkpoint import save_loop_state as jsave_loop
from loam_livox_tpu.runtime.loop_service import LoopCloser as JCloser

from loam_livox_tpu_torch.core.config import SlamConfig
from loam_livox_tpu_torch.eval.scenarios import SMALL_CAPS
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu_torch.map.cell_map import EMPTY_KEY, CellMap
from loam_livox_tpu_torch.runtime import checkpoint as ck
from loam_livox_tpu_torch.runtime.loop_service import LoopCloser as TCloser
from loam_livox_tpu_torch.runtime.odometry import init_state
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
from test_torch_loop_service import configs, feed, world  # noqa: F401 (fixture)

torch.set_num_threads(2)

CAPS = {**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
        "map_corner_capacity": 1024, "map_surf_capacity": 4096,
        "cell_capacity": 2048, "cell_point_capacity": 16}


def small_config(**over):
    cfg = SlamConfig().replace(capacity=CAPS, mapping={"init_accumulate_frames": 4},
                               optimization={"icp_maximum_iteration": 3, "full_iterations": 3})
    return cfg.replace(**over) if over else cfg


def sim_frames(n, seed=2):
    sim = LivoxSimulator(SimConfig(points_per_frame=6000, seed=seed),
                         traj=Trajectory(ramp_t0=0.5))
    return [sim.frame(i) for i in range(n)]


def fields(state) -> dict:
    """Every field of a state as tensors and numbers, by dotted name."""
    out = {}
    for name in state._fields:
        v = getattr(state, name)
        if isinstance(v, (CellMap,)) or hasattr(v, "_fields"):
            for f in v._fields:
                out[f"{name}.{f}"] = getattr(v, f)
        else:
            out[name] = v
    return out


def assert_states_equal(a, b):
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


# ----------------------------------------------------------- the state --

def test_state_round_trip_continues_identically(tmp_path):
    cfg = small_config(optimization={"subsample_residuals": 200})
    frames = sim_frames(8)
    pipe = OdometryPipeline(cfg, device="cpu")
    for f in frames[:5]:
        pipe.process_raw(*f)
    path = str(tmp_path / "state.pt")
    ck.save_state(pipe.state, path)
    loaded = ck.load_state(path, cfg, "cpu")
    assert_states_equal(loaded, pipe.state)
    assert loaded.rng is not pipe.state.rng and loaded.frame_count == 5
    other = OdometryPipeline(cfg, device="cpu")
    other.state = loaded
    for f in frames[5:]:
        pipe.process_raw(*f)
        other.process_raw(*f)
    pipe.flush()
    other.flush()
    assert_states_equal(other.state, pipe.state)


def test_capacity_mismatch_raises(tmp_path):
    cfg = small_config()
    path = str(tmp_path / "state.pt")
    ck.save_state(init_state(cfg, "cpu"), path)
    with pytest.raises(ValueError, match="capacities differ"):
        ck.load_state(path, cfg.replace(capacity={"map_surf_capacity": 8192}), "cpu")
    with pytest.raises(ValueError, match="cell map"):
        ck.load_state(path, cfg.replace(mapping={"matching_mode": 1}), "cpu")


def test_generator_from_another_device_warns(tmp_path):
    """The state's threefry key is saved as a tensor, whose draws are the
    same numbers on every device: the file carries no device, loads on
    the CPU silently and continues the same subsample stream.  A file of the earlier format, a torch.Generator's
    state in place of the key, loads with PRNGKey(0): with residual
    subsampling on `load_state` warns that the stream restarts; without
    it, the key is unused and loading is silent."""
    cfg = small_config(optimization={"subsample_residuals": 200})
    frames = sim_frames(8)
    pipe = OdometryPipeline(cfg, device="cpu")
    for f in frames[:5]:
        pipe.process_raw(*f)
    state = pipe.state
    path = str(tmp_path / "state.pt")
    ck.save_state(state, path)
    saved = torch.load(path, weights_only=True)
    assert saved["rng"].dtype == torch.uint32 and saved["rng"].shape == (2,)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        loaded = ck.load_state(path, cfg, "cpu")
    assert torch.equal(loaded.rng, state.rng)
    other = OdometryPipeline(cfg, device="cpu")
    other.state = loaded
    for f in frames[5:]:
        pipe.process_raw(*f)
        other.process_raw(*f)
    pipe.flush()
    other.flush()
    assert_states_equal(other.state, pipe.state)

    saved["rng"] = {"generator": torch.Generator().manual_seed(0).get_state(),
                    "device": "cuda"}            # the earlier format, written on the card
    torch.save(saved, path)
    with pytest.warns(UserWarning, match="another subsample stream"):
        loaded = ck.load_state(path, cfg, "cpu")
    assert torch.equal(loaded.rng, init_state(cfg, "cpu").rng)
    assert_states_equal(loaded._replace(rng=state.rng), state)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ck.load_state(path, small_config(), "cpu")


# ------------------------------------------------------ the loop state --

def key_set(keys) -> set:
    k = keys.cpu().numpy() if isinstance(keys, torch.Tensor) else np.asarray(keys)
    return set(k.reshape(-1).tolist()) - {EMPTY_KEY}


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_records_equal(got, want):
    assert key_set(got.keys) == key_set(want.keys) and len(key_set(got.keys)) > 50
    np.testing.assert_array_equal(host(got.q), host(want.q))
    np.testing.assert_array_equal(host(got.t), host(want.t))
    assert got.ending_frame_idx == want.ending_frame_idx
    assert (got.descriptor is None) == (want.descriptor is None)
    if got.descriptor is not None:
        for f in got.descriptor._fields:
            np.testing.assert_array_equal(host(getattr(got.descriptor, f)),
                                          host(getattr(want.descriptor, f)), err_msg=f)
    for s in ("snap_line", "snap_plane", "snap_full"):
        np.testing.assert_array_equal(getattr(got, s), getattr(want, s), err_msg=s)


def acc_keys(acc) -> set:
    if hasattr(acc, "frame_keys"):
        return set().union(*[key_set(k) for k in acc.frame_keys]) if acc.frame_keys else set()
    return set(acc.keys)


def assert_services_equal(got, want):
    assert len(got.keyframes) == len(want.keyframes) > 0
    for a, b in zip(got.keyframes, want.keyframes):
        assert_records_equal(a, b)
    assert len(got.waiting) == len(want.waiting)
    for a, b in zip(got.waiting, want.waiting):
        assert_records_equal(a[0], b[0])
    assert [a.frames for a in got.updating] == [a.frames for a in want.updating]
    assert [acc_keys(a) for a in got.updating] == [acc_keys(a) for a in want.updating]
    assert (got.closed, got.dropped_keyframes, got._pair_idx) == \
        (want.closed, want.dropped_keyframes, want._pair_idx)
    assert (got.result is None) == (want.result is None)
    if got.result is not None:
        for f in ("accepted", "his_idx", "cur_idx", "icp_score"):
            assert getattr(got.result, f) == getattr(want.result, f), f
        np.testing.assert_array_equal(got.result.q_opt, np.asarray(want.result.q_opt))
        np.testing.assert_array_equal(got.result.t_opt, np.asarray(want.result.t_opt))


@pytest.mark.parametrize("n_frames, circle", [(5, 12), (12, 12)], ids=["open", "closed"])
def test_loop_state_crosses_both_ways(world, tmp_path, n_frames, circle):  # noqa: F811
    jcfg, tcfg = configs()
    jsvc, tsvc = JCloser(jcfg), TCloser(tcfg, device="cpu")
    feed(jsvc, tsvc, world, n_frames, circle=circle)
    assert jsvc.closed == tsvc.closed == (n_frames == 12)
    # a keyframe completed but not yet analysed, as a drain-less save leaves it
    jsvc.waiting.append((jsvc.keyframes[-1], None))
    tsvc.waiting.append((tsvc.keyframes[-1], None, None))
    pj, pt = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave_loop(jsvc, pj)
    ck.save_loop_state(tsvc, pt)
    assert_services_equal(ck.load_loop_state(pj, tcfg, device="cpu"), jsvc)
    assert_services_equal(jload_loop(pt, jcfg), tsvc)
    # each package reads back its own file
    assert_services_equal(ck.load_loop_state(pt, tcfg, device="cpu"), tsvc)


def test_restored_waiting_keyframe_without_a_map_is_dropped(world, tmp_path):  # noqa: F811
    jcfg, tcfg = configs(if_enable_loop_closure=0)
    tsvc = TCloser(tcfg, device="cpu")
    feed(JCloser(jcfg), tsvc, world, 4)
    tsvc.waiting.append((tsvc.keyframes[-1], None, None))
    path = str(tmp_path / "loop.npz")
    ck.save_loop_state(tsvc, path)
    restored = ck.load_loop_state(path, tcfg, device="cpu")
    n = len(restored.keyframes)
    restored.drain()
    assert restored.dropped_keyframes == tsvc.dropped_keyframes + 1
    assert len(restored.keyframes) == n and not restored.waiting


# ---------------------------------------------------------- split runs --

SPLIT_CASES = {
    "sequential": dict(optimization={"icp_maximum_iteration": 3, "full_iterations": 3,
                                     "subsample_residuals": 200}),
    "chunked": dict(parallel={"dispatch_chunk": 3}),
    # the bucket grids of the grid engine go through the checkpoint
    "grid": dict(optimization={"correspondence": "grid"},
                 capacity={"corner_bucket_count": 512, "surf_bucket_count": 1024}),
    "loop_closure": dict(loop_closure={"if_enable_loop_closure": 1, "if_loop_service_async": 0,
                                       "scans_of_each_keyframe": 4,
                                       "scans_between_two_keyframe": 2}),
}


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_run_equals_uninterrupted(tmp_path, case):
    cfg = small_config(**SPLIT_CASES[case])
    frames = sim_frames(12)
    whole = OdometryPipeline(cfg, device="cpu")
    for i, f in enumerate(frames):
        whole.process_raw(*f)
        if i == 5:
            whole.flush()       # the split run flushes here when it saves
    whole.flush()

    first = OdometryPipeline(cfg, device="cpu")
    for f in frames[:6]:
        first.process_raw(*f)
    ck.save_pipeline(first, str(tmp_path / "ckpt"))
    if case == "loop_closure":
        open_acc = [a.frames for a in first.loop_closer.updating]
        assert any(0 < n < 4 for n in open_acc), open_acc
    second = ck.load_pipeline(str(tmp_path / "ckpt"), cfg, device="cpu")
    assert second._frame_idx == 6
    for f in frames[6:]:
        second.process_raw(*f)
    second.flush()

    rows = len(first.trajectory.times) + len(second.trajectory.times)
    assert rows == len(whole.trajectory.times) == 12
    for name in ("times", "positions", "quaternions", "accepted"):
        np.testing.assert_array_equal(
            np.asarray(getattr(first.trajectory, name) + getattr(second.trajectory, name)),
            np.asarray(getattr(whole.trajectory, name)), err_msg=name)
    assert first.iterations + second.iterations == whole.iterations
    assert_states_equal(second.state, whole.state)
    if case == "loop_closure":
        got, want = second.loop_closer, whole.loop_closer
        assert len(got.keyframes) == len(want.keyframes) >= 4
        for a, b in zip(got.keyframes, want.keyframes):
            assert_records_equal(a, b)
        assert [a.frames for a in got.updating] == [a.frames for a in want.updating]
        assert [acc_keys(a) for a in got.updating] == [acc_keys(a) for a in want.updating]
