"""The loop-closure service (`runtime.loop_service.LoopCloser`) against the
JAX package's on the CPU, in inline mode (``if_loop_service_async`` 0,
the deterministic mode).

Both services take the same cell map (the structured world of
tests/test_loop.py, carried over with `interop`) every frame and the
drifted-circle poses of tests/test_loop_service.py.  Required: equal
keyframe key sets; equal gate-trace stages and (cur, his), with the
numbers within 0.02 (the scene alignment recomputes an ICP); the same
closing pair, and optimised poses within 1e-3; the corrected keyframe
cloud within 1e-3 m.  The similarity gate rejects two different worlds,
and in async mode a stalled worker drops the oldest waiting keyframes.
The closing services write dump directories: the keyframe JSONs match
the JAX package's (cells as in tests/test_torch_serialization.py), and
`refine_mapping` rebuilds the JAX package's points from either
package's directory.  A pipeline's loop path runs on the card unless
asked; the dumps are accepted and several devices are refused (item 15).
"""
import time as _time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from loam_livox_tpu.core.config import SlamConfig as JConfig
from loam_livox_tpu.core.types import PointBatch as JBatch
from loam_livox_tpu.map.cell_map import append_cloud, empty_cell_map
from loam_livox_tpu.runtime.loop_service import LoopCloser as JCloser

from loam_livox_tpu_torch.core.config import SlamConfig as TConfig
from loam_livox_tpu_torch.map.cell_map import EMPTY_KEY
from loam_livox_tpu_torch.parallel.mesh import make_mesh
from loam_livox_tpu_torch.runtime import loop_service as tls
from loam_livox_tpu_torch.runtime.loop_service import KeyframeRecord, LoopCloser as TCloser
from test_loop import structured_world
from test_loop_service import build_world_map, drifted_circle_pose
from test_torch_loop_ops import port_map

torch.set_num_threads(2)

LOOP = {"if_enable_loop_closure": 1, "scans_of_each_keyframe": 3,
        "scans_between_two_keyframe": 1, "minimum_keyframe_differen": 4,
        "avail_ratio_plane": 0.001, "avail_ratio_line": 0.0, "if_loop_service_async": 0}


def configs(**over):
    lc = {**LOOP, **over}
    return JConfig().replace(loop_closure=lc), TConfig().replace(loop_closure=lc)


@pytest.fixture(scope="module")
def world():
    jm, touched = build_world_map()
    return jm, touched, port_map(jm), torch.from_numpy(np.array(touched))


def key_set(keys) -> set:
    k = np.asarray(keys.cpu() if isinstance(keys, torch.Tensor) else keys).tolist()
    return set(k) - {EMPTY_KEY}


def feed(jsvc, tsvc, world, n_frames, circle=10):
    jm, jt, tm, tt = world
    for i in range(n_frames):
        q, t = drifted_circle_pose(i, n=circle)
        jsvc.on_frame(jm, jt, q, t, i)
        tsvc.on_frame(tm, tt, torch.from_numpy(q), torch.from_numpy(t), i)


def test_keyframe_cadence_matches_jax(world):
    jcfg, tcfg = configs(if_enable_loop_closure=0)
    jsvc, tsvc = JCloser(jcfg), TCloser(tcfg, device="cpu")
    feed(jsvc, tsvc, world, 8)
    # 3 frames a keyframe, a new one every frame: 6 complete in 8 frames
    assert len(tsvc.keyframes) == len(jsvc.keyframes) == 6
    for a, b in zip(tsvc.keyframes, jsvc.keyframes):
        assert key_set(a.keys) == key_set(b.keys) and len(key_set(a.keys)) > 50
        assert a.ending_frame_idx == b.ending_frame_idx
        assert a.descriptor.n_cells == int(b.descriptor.n_cells)
        assert len(a.snap_plane) == len(b.snap_plane) and len(a.snap_full) == len(b.snap_full)
    assert [acc.frames for acc in tsvc.updating] == [acc.frames for acc in jsvc.updating]
    assert tsvc.counts["knn_fused"] == 0          # no scan with loop closure off


@pytest.fixture(scope="module")
def closed_pair(world, tmp_path_factory):
    """Both services over 12 frames of a closing circle, each writing its
    dump directory (keyframe JSONs, alignment pairs, the loop's g2o and
    pose files)."""
    jcfg, tcfg = configs(if_dump_keyframe_data=1, map_alignment_if_dump_matching_result=1)
    jdir, tdir = (str(tmp_path_factory.mktemp(n)) for n in ("jax_dump", "port_dump"))
    jsvc, tsvc = JCloser(jcfg, dump_dir=jdir), TCloser(tcfg, device="cpu", dump_dir=tdir)
    feed(jsvc, tsvc, world, 12, circle=12)
    return jsvc, tsvc


def test_detects_and_closes_loop_like_jax(closed_pair):
    jsvc, tsvc = closed_pair
    assert jsvc.closed and tsvc.closed
    assert len(tsvc.gate_trace) == len(jsvc.gate_trace) > 0
    for got, want in zip(tsvc.gate_trace, jsvc.gate_trace):
        assert (got["stage"], got["cur"], got["his"]) == (want["stage"], want["cur"], want["his"])
        for k in ("sim_plane", "sim_line", "score", "rz_plane", "rz_line"):
            if k in want:
                assert abs(float(got[k]) - float(want[k])) < 0.02, (k, got, want)
        assert got.get("passed") == want.get("passed")
    jr, tr = jsvc.result, tsvc.result
    assert (tr.his_idx, tr.cur_idx) == (jr.his_idx, jr.cur_idx)
    assert abs(tr.icp_score - jr.icp_score) < 0.02 and tr.icp_score < 0.20
    np.testing.assert_allclose(tr.q_opt, np.asarray(jr.q_opt), rtol=0, atol=1e-3)
    np.testing.assert_allclose(tr.t_opt, np.asarray(jr.t_opt), rtol=0, atol=1e-3)
    # one-shot: a closed service takes no more frames
    q, t = drifted_circle_pose(12, n=12)
    m, touched = build_world_map()
    assert tsvc.on_frame(port_map(m), torch.from_numpy(np.array(touched)),
                         torch.from_numpy(q), torch.from_numpy(t), 12) is None
    # the loop's own tally: scene alignment searched on the CPU path, and
    # charged the loop, not the frame path
    assert tsvc.counts["icp_exit"] > 0 and tsvc.counts["align_exit"] > 0


def test_corrected_keyframe_cloud_matches_jax(world, closed_pair):
    jsvc, tsvc = closed_pair
    jm, _, tm, _ = world
    a = tsvc.refine_keyframe_cloud(tm, 0)
    b = jsvc.refine_keyframe_cloud(jm, 0)
    assert a.shape == b.shape and len(a) > 50
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
    m_a, m_b = tsvc.corrected_map(tm, resolution=0.2), jsvc.corrected_map(jm, resolution=0.2)
    assert abs(len(m_a) - len(m_b)) <= 0.01 * len(m_b)


def test_similarity_gate_rejects_two_worlds():
    """A history keyframe of world A and a current one of world B, 50 m
    apart in one map: the similarity gate must reject (the JAX test of
    tests/test_loop_service.py:106-151)."""
    wa = structured_world(np.random.default_rng(11))
    wb = structured_world(np.random.default_rng(55)) + [50.0, 0, 0]
    pts = np.concatenate([wa, wb]).astype(np.float32)
    padded = np.zeros((8192, 3), np.float32)
    padded[:len(pts)] = pts
    mask = np.zeros(8192, bool)
    mask[:len(pts)] = True
    jm, _ = append_cloud(empty_cell_map(0.5, capacity=4096, pool_size=32),
                         JBatch(jnp.asarray(padded), jnp.zeros(8192), jnp.asarray(mask)),
                         10 ** 9, max_new=4096)
    tm = port_map(jm)
    centers, valid = tm.centers(), tm.valid()
    in_a, in_b = valid & (centers[:, 0] < 25.0), valid & (centers[:, 0] >= 25.0)
    _, tcfg = configs(minimum_keyframe_differen=1)
    svc = TCloser(tcfg, device="cpu")

    def rec(sel, t, end):
        return KeyframeRecord(keys=tm.keys[sel], q=torch.tensor([1.0, 0, 0, 0]),
                              t=torch.tensor(t), ending_frame_idx=end)

    first = rec(in_a, [0.0, 0, 0], 0)
    svc.process_keyframe(first, tm)
    for _ in range(3):       # more keyframes of region A
        pad = rec(in_a, [0.0, 0, 0], 0)
        pad.descriptor = first.descriptor
        svc.keyframes.append(pad)
    svc.process_keyframe(rec(in_b, [50.0, 0, 0], 10), tm)
    assert not svc.closed
    sims = [e for e in svc.gate_trace if e["stage"] == "similarity"]
    assert sims and all(not e["passed"] and e["sim_plane"] < 0.94 for e in sims)


def test_async_drop_oldest_engages_when_worker_lags(world, monkeypatch):
    """The waiting-list bound (reference pop_front, laser_mapping.hpp:
    1552-1555) binds when the worker lags: stall it and complete
    keyframes faster than it drains; the oldest are dropped unprocessed."""
    _, tcfg = configs(if_enable_loop_closure=0, if_loop_service_async=1,
                      maximum_keyframe_in_waiting_list=2, scans_of_each_keyframe=1,
                      scans_between_two_keyframe=1)
    svc = TCloser(tcfg, device="cpu")
    real = TCloser.process_keyframe

    def slow(self, rec, m):
        _time.sleep(0.15)
        real(self, rec, m)

    monkeypatch.setattr(TCloser, "process_keyframe", slow)
    _, _, tm, tt = world
    for i in range(8):
        q, t = drifted_circle_pose(i)
        svc.on_frame(tm, tt, torch.from_numpy(q), torch.from_numpy(t), i)
    svc.drain(timeout=30.0)
    assert not svc.busy
    assert svc.dropped_keyframes > 0 and len(svc.keyframes) >= 1
    assert len(svc.keyframes) + svc.dropped_keyframes == 8
    worker = svc._worker
    svc.shutdown()
    assert not worker.is_alive()


def test_key_union_is_the_set_union():
    keys = torch.tensor([5, 3, 9, 3, EMPTY_KEY, 1], dtype=torch.int32)
    other = torch.tensor([EMPTY_KEY, 9, 2, EMPTY_KEY, 7, 5], dtype=torch.int32)
    u = tls.key_union([keys, other])
    assert u.shape == (12,)
    assert u[:6].tolist() == [1, 2, 3, 5, 7, 9] and (u[6:] == EMPTY_KEY).all()


def test_loop_paths_refused_and_on_the_card_by_default(monkeypatch, tmp_path):
    from loam_livox_tpu_torch import OdometryPipeline

    _, tcfg = configs()
    # the dump directory and the dump switches are ported (item 13)
    assert TCloser(tcfg, device="cpu", dump_dir="out").dump_dir == "out"
    for over in ({"if_dump_keyframe_data": 1}, {"map_alignment_if_dump_matching_result": 1}):
        OdometryPipeline(tcfg.replace(loop_closure=over), device="cpu")
    # product mode (item 15) is ported: it needs its process group, and
    # runs the loop pipeline on a group of one rank
    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        OdometryPipeline(tcfg.replace(parallel={"mesh_devices": 2}), device="cpu")
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        product = OdometryPipeline(tcfg, device="cpu", mesh=make_mesh(1))
        assert product.mesh.size == 1 and product.loop_closer is not None
        assert product.state.cell_full.capacity == tcfg.capacity.cell_capacity
        product.loop_closer.shutdown()
    finally:
        dist.destroy_process_group()
    pipe = OdometryPipeline(tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no accepted loop closure"):
        pipe.get_corrected_map()
    assert pipe.get_surround_map().shape == (0, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OdometryPipeline(tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TCloser(tcfg)


# --------------------------------------------------------------- dumps --

def test_keyframe_dumps_match_jax(closed_pair):
    """One ``keyframe_<frame>.json`` a keyframe in the reference's cell
    schema, the member cells of the keyframe: the same files, cells and
    pools as the JAX package's, the statistics within the tolerances of
    tests/test_torch_serialization.py."""
    import glob
    import json
    import os

    from test_torch_serialization import assert_cells_match

    jsvc, tsvc = closed_pair
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(tsvc.dump_dir, "keyframe_*.json")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(os.path.join(jsvc.dump_dir, "keyframe_*.json")))
    assert len(names) == len(tsvc.keyframes)
    for name in names:
        with open(os.path.join(tsvc.dump_dir, name)) as f, \
                open(os.path.join(jsvc.dump_dir, name)) as g:
            assert_cells_match(json.load(f), json.load(g))
    # a keyframe's file holds its member cells
    rec = tsvc.keyframes[0]
    with open(os.path.join(tsvc.dump_dir, f"keyframe_{rec.ending_frame_idx}.json")) as f:
        assert len(json.load(f)) == len(key_set(rec.keys))
    assert tsvc.counts["dump"] >= len(names) + 2


@pytest.mark.parametrize("source", ["port", "jax"])
def test_refine_mapping_matches_jax(closed_pair, source):
    """The offline rebuild (`loop.map_refine.refine_mapping`) of one dump
    directory, written by either package, gives the JAX package's points
    (host numpy on the same files: within 1e-5 m), written as a PCD."""
    import os

    from loam_livox_tpu.loop.map_refine import refine_mapping as jrefine

    from loam_livox_tpu_torch.io.serialization import load_pcd
    from loam_livox_tpu_torch.loop.map_refine import refine_mapping as trefine

    jsvc, tsvc = closed_pair
    d = tsvc.dump_dir if source == "port" else jsvc.dump_dir
    out = os.path.join(d, "refined.pcd")
    for stride, res in ((1, 0.0), (2, 0.2)):
        got = trefine(d, out_pcd=out, stride=stride, resolution=res)
        want = jrefine(d, stride=stride, resolution=res)
        assert got.shape == want.shape and len(got) > 100
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(load_pcd(out)[0], got)
