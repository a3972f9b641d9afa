"""The frame program's CPU side against the JAX package: the pieces that
the card captures into one graph a frame (`runtime.frame_program`), each
held against its JAX counterpart here, on the CPU, where the same code
runs eagerly.

* The split debounce (`ops.debounce`, the JAX ``lax.scan`` of
  ``loam_livox_tpu/frontend/livox.py:186-205``): the JAX front end's own
  sorted split table (recorded from its ``jnp.sort``) on simulator
  frames and on frames of random polar distances (hundreds of
  candidates, the 512-slot table overfull), and the kept count; exact.
  Seeded random candidate sets against the greedy loop written out.
* One ICP pass as a function of its carry, run under the host loop
  (`icp.prepare_frame` + `icp.run_host_loop`), against the JAX
  ``register_frame`` on the teacher-forced inputs of
  tests/test_torch_odometry.py, with its ``first_match`` yardstick.
* History admission on the device against the JAX ``odometry_step`` in
  four cases: not admitted, admitted with an append, admitted with a
  rebuild, and admitted because the window is still open.  The
  registration is off (init window) and the pose the identity, so the
  world points are the frame's and every field must be equal: ring,
  pointers, counters, last admitted pose and matching buffers.
* The SWITCH node's index (`ops.graph_cond.switch_index_plain`) over the
  port step's matching-update flags against the update the JAX step's
  ``lax.cond`` took, over admission x cadence x append mode.
* The counters as device scalars through `interop.state_from_numpy` and a
  checkpoint (and a checkpoint that holds them as host integers).
* A slice-configuration frame on the CPU reads nothing on the host for
  the debounce or the admission (`SYNCS`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig
from loam_livox_tpu.core.types import FeatureFrame as JFrame
from loam_livox_tpu.core.types import PointBatch as JBatch
from loam_livox_tpu.eval.scenarios import SMALL_CAPS
from loam_livox_tpu.frontend import livox as jlivox
from loam_livox_tpu.io.simulator import LivoxSimulator, SimConfig
from loam_livox_tpu.registration import icp as jicp
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import input_downsample as jinput
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.core.types import FeatureFrame, PointBatch
from loam_livox_tpu_torch.frontend import livox as tlivox
from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy
from loam_livox_tpu_torch.ops.debounce import debounce
from loam_livox_tpu_torch.ops.graph_cond import switch_index_plain
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime import checkpoint as ck
from loam_livox_tpu_torch.runtime import odometry as todometry
from loam_livox_tpu_torch.runtime import pipeline as P
from loam_livox_tpu_torch.runtime.odometry import input_downsample as tinput
from loam_livox_tpu_torch.runtime.odometry import odometry_step as tstep
from loam_livox_tpu_torch.runtime.odometry import rebuild_interval
from test_torch_odometry import (INIT, first_match, jax_correspondences,  # noqa: F401
                                 jax_stream, nudged_frame, simulator, state_fields,
                                 to_port_frame)

torch.set_num_threads(2)


def port_config(cfg):
    return config_from_dict(dataclasses.asdict(cfg))


# ------------------------------------------------------------ debounce --

def greedy(cand, edge, n, n_valid, gap):
    """The debounce written out as the reference's loop (:541-566)."""
    kept, last, seen = [], -(10 ** 9), set()
    for c, e in zip(cand, edge):
        if c >= n:
            continue
        if e not in seen or c - last > gap:
            kept.append(c)
            last = c
            seen.add(e)
    table = kept + ([n_valid - 1] if len(kept) < len(cand) else [])
    return np.sort(np.array(table + [n] * (len(cand) - len(table)), np.int64)), len(kept)


@pytest.mark.parametrize("seed", range(6))
def test_debounce_matches_the_greedy_loop(seed):
    rng = np.random.default_rng(seed)
    for trial in range(44):
        n = int(rng.integers(8, 4000))
        # the last trials: tables past one block of 1,024 slots
        ns = int(rng.choice([1, 3, 64, 512])) if trial < 40 else [1025, 4096][trial % 2]
        idx = np.sort(rng.choice(n, size=int(rng.integers(0, min(n, ns) + 1)), replace=False))
        cand = np.full(ns, n, np.int64)
        cand[:len(idx)] = idx
        edge = np.zeros(ns, bool)
        edge[:len(idx)] = rng.random(len(idx)) < rng.random()
        n_valid, gap = int(rng.integers(0, n + 1)), int(rng.integers(0, 80))
        want, kept = greedy(cand.tolist(), edge.tolist(), n, n_valid, gap)
        splits, n_acc = debounce(torch.from_numpy(cand), torch.from_numpy(edge), n,
                                 torch.tensor(n_valid), gap)
        np.testing.assert_array_equal(splits.numpy(), want)
        assert int(n_acc) == kept


def jax_split_table(pts, it, m, t0, fe, caps):
    """The JAX front end's sorted split table and petal count: its one
    ``jnp.sort`` call, recorded by a callback through a stand-in for the
    module's ``jnp`` (the package itself is not touched), in a fresh jit
    of the function, so that this trace is the one that runs."""
    seen = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def sort(a, *args, **kw):
            out = jnp.sort(a, *args, **kw)
            jax.debug.callback(lambda v: seen.append(np.asarray(v)), out)
            return out

    def fresh(*args, **kw):      # a new function: no trace of an earlier call is reused
        return jlivox.extract_point_info.__wrapped__(*args, **kw)

    fn = jax.jit(fresh, static_argnames=("fe", "caps"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlivox, "jnp", Recorder())
        _, n_petals = fn(jnp.asarray(pts), jnp.asarray(it), jnp.asarray(m), jnp.float32(t0),
                         fe=fe, caps=caps)
        n_petals = int(n_petals)
        jax.effects_barrier()
    assert len(seen) == 1
    return seen[0], n_petals


def padded(xyz, inten, n):
    pts = np.zeros((n, 3), np.float32)
    it = np.zeros(n, np.float32)
    m = np.zeros(n, bool)
    pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
    return pts, it, m


def random_polar_frame(rng, n_pts, n):
    """Points on the x = 1 plane at random polar distances: a turning
    point every few samples, far more candidates than the table holds,
    and a few NaN and zero-x dropouts."""
    xyz = np.c_[np.ones(n_pts), rng.normal(0, 0.2, (n_pts, 2))].astype(np.float32)
    drop = rng.random(n_pts) < 0.02
    xyz[drop & (rng.random(n_pts) < 0.5)] = np.nan
    xyz[drop & ~np.isnan(xyz[:, 0]), 0] = 0.0
    return padded(xyz, rng.uniform(10, 100, n_pts).astype(np.float32), n)


@pytest.mark.parametrize("source", ["simulator", "random polar", "random polar, gap 3"])
def test_debounce_split_table_matches_jax(source, monkeypatch):
    cfg = SlamConfig().replace(capacity={**SMALL_CAPS, "max_raw_points": 8192})
    if source.endswith("gap 3"):
        cfg = cfg.replace(feature_extraction={"split_min_gap": 3})
    fe, caps = cfg.feature_extraction, cfg.capacity
    tc = port_config(cfg)
    rng = np.random.default_rng(7)
    if source == "simulator":
        xyz, inten, t0 = LivoxSimulator(SimConfig(points_per_frame=6000, seed=5)).frame(3)
        frames = [padded(xyz, inten, caps.max_raw_points) + (t0,)]
    else:
        frames = [random_polar_frame(rng, int(rng.integers(2000, 8000)), caps.max_raw_points)
                  + (0.5,) for _ in range(2)]
    tables = []
    monkeypatch.setattr(tlivox, "debounce", lambda *a: tables.append(debounce(*a)) or tables[-1])
    for pts, it, m, t0 in frames:
        want, j_petals = jax_split_table(pts, it, m, t0, fe, caps)
        _, t_petals = tlivox.extract_point_info(*(torch.from_numpy(a) for a in (pts, it, m)),
                                                t0, tc.feature_extraction, tc.capacity)
        splits, n_acc = tables[-1]
        np.testing.assert_array_equal(splits.numpy(), want.astype(np.int64))
        assert int(t_petals) == j_petals == (0 if int(n_acc) + 1 < 6 else int(n_acc))


# -------------------------------------------------------------- ICP pass --

@pytest.mark.parametrize("k", range(3))
def test_icp_pass_under_the_host_loop_matches_jax(jax_stream, jax_correspondences, k):
    """Registration t = INIT + k: `prepare_frame`'s pass run by the host
    loop against the JAX ``register_frame`` on the same filtered frame and
    state, correspondences taken from the JAX dense engine
    (tests/test_torch_odometry.py), within the JAX package's own
    one-ulp spread (`first_match`)."""
    cfg, steps, states = jax_stream
    t = INIT + k
    before, fr, _, _ = steps[t]
    st = states[t]
    tc = port_config(cfg)
    tst = state_from_numpy(before, "cpu")
    c_in, s_in = tinput(to_port_frame(fr), tc)
    icp_pass, carry, finish = ticp.prepare_frame(
        c_in, s_in, tst.map_corners, tst.map_surface, tst.q_w, tst.t_w,
        to_port_frame(fr).time_min, to_port_frame(fr).time_max,
        tst.frame_count >= tc.mapping.init_accumulate_frames, tc,
        q_incre_init=tst.last_q_incre, t_incre_init=tst.last_t_incre)
    carry, loops = ticp.run_host_loop(icp_pass, carry, tc.optimization.icp_maximum_iteration)
    reg = finish(carry)
    assert int(carry.loops) == loops == int(reg.iterations) and loops > 0

    def jax_register(f):
        jc, js = jinput(f, cfg)
        return jicp.register_frame(jc, js, st.map_corners, st.map_surface, st.q_w, st.t_w,
                                   f.time_min, f.time_max, st.frame_count >= INIT,
                                   jax.random.split(st.rng)[1], cfg,
                                   grid_corners=st.grid_corners, grid_surface=st.grid_surface,
                                   q_incre_init=st.last_q_incre, t_incre_init=st.last_t_incre)

    def check(jreg):
        assert bool(reg.accepted) == bool(jreg.accepted)
        assert int(reg.iterations) == int(jreg.iterations)
        for name in ("q_w", "t_w", "q_incre", "t_incre"):
            np.testing.assert_allclose(getattr(reg, name).numpy(), np.asarray(getattr(jreg, name)),
                                       rtol=0, atol=1e-4, err_msg=name)

    first_match(check, (jax_register(f) for f in (fr, nudged_frame(fr, 1),
                                                   nudged_frame(fr, -1))))


# ------------------------------------------------------------ admission --

W_OPEN = 3          # maximum_histroy_buffer of the admission cases


def admission_config():
    return SlamConfig().replace(
        capacity={**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 4096},
        mapping={"init_accumulate_frames": 1000, "maximum_histroy_buffer": W_OPEN})


def feature_frame(rng, caps):
    """Seeded corner and surface clouds in a 10 m room, part of each
    capacity valid, times across 0.1 s."""
    def batch(cap, fill):
        xyz = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        k = int(fill * cap)
        xyz[:k] = rng.uniform(-5, 5, (k, 3))
        mask[:k] = True
        time = np.where(mask, rng.uniform(2.0, 2.1, cap), 0.0).astype(np.float32)
        return xyz, time, mask

    c, s, f = batch(caps.max_corner, 0.5), batch(caps.max_surface, 0.7), batch(caps.max_surface, 0.7)
    return (c, s, f), np.float32(2.0), np.float32(2.1)


ADMISSION_CASES = {
    # (hist_len, moved, frame_count on the rebuild cadence?)
    "not admitted": (W_OPEN, False, False),
    "admitted, append": (W_OPEN, True, False),
    "admitted, rebuild": (W_OPEN, True, True),
    "window open": (1, False, False),
}


def admission_inputs(cfg, hist_len, moved, on_cadence, seed):
    """A JAX state whose history window holds ``hist_len`` frames, the
    last admitted pose 4 m away (``moved``) or here, the frame counter on
    the rebuild cadence or one past it, matching buffers with 300 / 900
    points, and a seeded feature frame in both packages' types."""
    caps = cfg.capacity
    interval = rebuild_interval(port_config(cfg))
    rng = np.random.default_rng(seed)
    st = jinit_state(cfg)
    w = caps.history_window
    ring = {}
    for kind, cap in (("corner", caps.hist_corner_capacity), ("surf", caps.hist_surf_capacity)):
        xyz = np.zeros((w, cap, 3), np.float32)
        mask = np.zeros((w, cap), bool)
        xyz[:hist_len, :cap // 2] = rng.uniform(-5, 5, (hist_len, cap // 2, 3))
        mask[:hist_len, :cap // 2] = True
        ring[f"hist_{kind}_xyz"], ring[f"hist_{kind}_mask"] = jnp.asarray(xyz), jnp.asarray(mask)

    def prefix(b, k):
        xyz = np.zeros(b.xyz.shape, np.float32)
        mask = np.zeros(b.mask.shape, bool)
        xyz[:k] = rng.uniform(-5, 5, (k, 3))
        mask[:k] = True
        return b._replace(xyz=jnp.asarray(xyz), mask=jnp.asarray(mask))

    st = st._replace(
        **ring, hist_ptr=jnp.int32(hist_len % w), hist_len=jnp.int32(hist_len),
        frame_count=jnp.int32(2 * interval + (0 if on_cadence else 1)),
        last_his_t=jnp.asarray([4.0, 0.0, 0.0] if moved else [0.0, 0.0, 0.0], jnp.float32),
        map_corners=prefix(st.map_corners, 300), map_surface=prefix(st.map_surface, 900))
    parts, tmin, tmax = feature_frame(rng, caps)
    jfr = JFrame(*(JBatch(*(jnp.asarray(a) for a in p)) for p in parts),
                 time_min=jnp.float32(tmin), time_max=jnp.float32(tmax))
    tfr = FeatureFrame(*(PointBatch(*(torch.from_numpy(a) for a in p)) for p in parts),
                       time_min=torch.tensor(tmin), time_max=torch.tensor(tmax))
    return st, jfr, tfr


@pytest.mark.parametrize("case", list(ADMISSION_CASES))
def test_admission_matches_jax(case):
    cfg = admission_config()
    tc = port_config(cfg)
    w = cfg.capacity.history_window
    hist_len, moved, on_cadence = ADMISSION_CASES[case]
    assert rebuild_interval(tc) > 1
    st, jfr, tfr = admission_inputs(cfg, hist_len, moved, on_cadence, len(case))
    before = state_fields(st)
    new_j, jreg = jstep(st, jfr, cfg)
    after = state_fields(new_j)
    new_t, treg = tstep(state_from_numpy(before, "cpu"), tfr, tc)

    admitted = int(after["hist_len"]) != hist_len or int(after["hist_ptr"]) != hist_len % w
    assert admitted == (case != "not admitted")
    assert not bool(treg.enabled) and bool(treg.accepted) == bool(jreg.accepted)
    for name in ("frame_count", "hist_ptr", "hist_len"):
        value = getattr(new_t, name)
        assert value.dtype == torch.int32 and value.dim() == 0, name
        assert int(value) == int(after[name]), name
    for name in ("hist_corner_xyz", "hist_corner_mask", "hist_surf_xyz", "hist_surf_mask",
                 "last_his_q", "last_his_t", "q_w", "t_w"):
        np.testing.assert_array_equal(getattr(new_t, name).numpy(), after[name], err_msg=name)
    for name in ("map_corners", "map_surface"):
        for f in ("xyz", "mask"):
            np.testing.assert_array_equal(getattr(getattr(new_t, name), f).numpy(),
                                          after[f"{name}.{f}"], err_msg=f"{name}.{f}")
    # the buffer changed as the case says: kept, appended to, or rebuilt
    grew = int(after["map_surface.mask"].sum()) - int(before["map_surface.mask"].sum())
    if case == "not admitted":
        assert grew == 0
    elif case == "admitted, rebuild":
        assert not np.array_equal(after["map_surface.xyz"][:900], before["map_surface.xyz"][:900])
    else:
        assert grew > 0 and np.array_equal(after["map_surface.xyz"][:900],
                                           before["map_surface.xyz"][:900])


SWITCH_CASES = [(admit, on_cadence, appends) for appends in (True, False)
                for admit in (True, False) for on_cadence in (True, False)]


@pytest.mark.parametrize("admit,on_cadence,appends", SWITCH_CASES,
                         ids=[f"{'admit' if a else 'reject'}-{'cadence' if c else 'between'}-"
                              f"{'appends' if m else 'rebuilds only'}"
                              for a, c, m in SWITCH_CASES])
def test_switch_index_matches_the_jax_steps_choice(admit, on_cadence, appends, monkeypatch):
    """The SWITCH node's index over the port step's flags (`MatchingUpdate`:
    rebuild, then append where appends run) against the update the JAX
    step's ``lax.cond`` took (``do_rebuild`` / ``do_append``), read from
    its matching buffers: rebuilt (body 0), appended (body 1) or kept (no
    body).  Admitted or not, on the rebuild cadence or between, with and
    without appends (a cadence of 4 either way)."""
    cfg = admission_config()
    if not appends:
        cfg = cfg.replace(capacity={"matching_append_mode": 0, "matching_rebuild_interval": 4})
    tc = port_config(cfg)
    assert rebuild_interval(tc) == 4
    st, jfr, tfr = admission_inputs(cfg, W_OPEN, admit, on_cadence, 3)
    before = state_fields(st)
    after = state_fields(jstep(st, jfr, cfg)[0])
    surf, old = after["map_surface.xyz"], before["map_surface.xyz"]
    if not np.array_equal(surf[:900], old[:900]):
        jax_body = 0                    # rebuilt from the history window
    elif int(after["map_surface.mask"].sum()) > int(before["map_surface.mask"].sum()):
        jax_body = 1                    # the step's points appended
    else:
        assert np.array_equal(surf, old)
        jax_body = None                 # kept
    updates = []
    real = todometry.update_matching
    monkeypatch.setattr(todometry, "update_matching",
                        lambda state, upd, c: updates.append(upd) or real(state, upd, c))
    new_t, _ = tstep(state_from_numpy(before, "cpu"), tfr, tc)
    (upd,) = updates
    assert (upd.append is not None) == appends
    flags = torch.stack([upd.rebuild] + ([upd.append] if appends else []))
    index = switch_index_plain(flags)
    assert index.dtype == torch.int32 and index.dim() == 0
    assert int(index) == (flags.numel() if jax_body is None else jax_body)
    assert jax_body == ((0 if on_cadence else (1 if appends else None)) if admit else None)
    np.testing.assert_array_equal(new_t.map_surface.xyz.numpy(), surf)
    np.testing.assert_array_equal(new_t.map_surface.mask.numpy(), after["map_surface.mask"])


# -------------------------------------------------- counters, round trips --

def test_counters_cross_interop_and_checkpoints_as_tensors(tmp_path):
    cfg = admission_config()
    st = jinit_state(cfg)._replace(frame_count=jnp.int32(17), hist_ptr=jnp.int32(5),
                                   hist_len=jnp.int32(9))
    tst = state_from_numpy(state_fields(st), "cpu")
    for name, want in (("frame_count", 17), ("hist_ptr", 5), ("hist_len", 9)):
        value = getattr(tst, name)
        assert isinstance(value, torch.Tensor) and value.dtype == torch.int32
        assert value.dim() == 0 and int(value) == want
    tc = port_config(cfg)
    path = str(tmp_path / "state.pt")
    ck.save_state(tst, path)
    loaded = ck.load_state(path, tc, "cpu")
    for name in ("frame_count", "hist_ptr", "hist_len"):
        a, b = getattr(loaded, name), getattr(tst, name)
        assert a.dtype == torch.int32 and torch.equal(a, b), name
    # a file that holds the counters as host integers loads them as tensors
    saved = torch.load(path, weights_only=True)
    saved.update(frame_count=17, hist_ptr=5, hist_len=9)
    torch.save(saved, path)
    again = ck.load_state(path, tc, "cpu")
    assert all(torch.equal(getattr(again, n), getattr(tst, n))
               for n in ("frame_count", "hist_ptr", "hist_len"))


def test_slice_frames_read_nothing_for_debounce_or_admission():
    cfg = SlamConfig().replace(
        capacity={**SMALL_CAPS, "max_raw_points": 8192},
        mapping={"init_accumulate_frames": 2},
        optimization={"icp_maximum_iteration": 2, "full_iterations": 2})
    tc = port_config(cfg)
    sim = simulator(5000)
    pipe = P.OdometryPipeline(tc, device="cpu")
    assert pipe.program is None           # the frame program is the card's
    P.reset_host_syncs()
    for i in range(4):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    syncs = P.host_syncs()
    # the front end has no host read left (no place), admission none
    assert syncs["admit"] == 0 and {k for k, v in syncs.items() if v} <= {"icp_exit", "schedule",
                                                                     "drain"}
    assert syncs["icp_exit"] > 0          # the plain program's host loop
    assert P.graph_counts()["graph_launch"] == 0
    assert pipe.loop_iterations == sum(pipe.iterations) > 0
