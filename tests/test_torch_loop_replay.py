"""The port's loop gates replayed over the committed unscaled artifact.

``scripts/loop_unscaled_state.npz`` holds the 20 keyframes (descriptors
and era snapshots) of the JAX package's 2,600-frame run at the shipped
cadence and gates (``scripts/loop_unscaled.py``); it closed at his 0 /
cur 19 with score 0.1953 (``scripts/loop_unscaled_out.json``).  Loaded
with `interop.loop_state_from_npz` (numpy alone), the keyframes go one at
a time through a fresh port `LoopCloser`'s gate scan (ratio, ROI,
similarity, cell balance, scene alignment): the same pair must close,
with the score within 0.05 of the record and under the 0.20 gate, the
gate trace must match ``scripts/loop_unscaled_trace.json`` within 0.02,
and the replayed pose-graph solve must pass `payoff_verdict` against the
recorded keyframe ground truth.  The JAX package's own replay
(tests/test_loop_unscaled_guard.py) stays; this is the port's.

The replay writes a dump directory (``map_alignment_if_dump_matching_result``
on): per scene alignment ``{i}_a/b/c.pcd`` and ``{i}_pair.json``, and on
the accepted loop ``loop.g2o``, ``poses_ori.txt`` and ``poses_opm.txt``.
The JAX package's service writes its own from the same keyframes and the
port's alignment results (read back from the pair files, so no second
scene alignment runs): the keyframe clouds and the original poses are
byte-equal, the moved cloud within 1e-4 m, the g2o graph's edges within
1e-5, the optimised poses within 1e-3 (each package's solve).
"""
import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from loam_livox_tpu_torch.eval.ate import ate_rmse
from loam_livox_tpu_torch.eval.loop_payoff import payoff_verdict
from loam_livox_tpu_torch.interop import config_from_dict, loop_state_from_npz
from loam_livox_tpu_torch.runtime.loop_service import LoopCloser

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
STATE = os.path.join(SCRIPTS, "loop_unscaled_state.npz")


def run_config():
    """The artifact run's configuration (scripts/loop_unscaled.py), inline."""
    spec = importlib.util.spec_from_file_location(
        "loop_unscaled", os.path.join(SCRIPTS, "loop_unscaled.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cfg = config_from_dict(dataclasses.asdict(mod.make_cfg()))
    return cfg.replace(loop_closure={"if_loop_service_async": 0})


def recorded(name):
    with open(os.path.join(SCRIPTS, name)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def dump_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("port_dump"))


@pytest.fixture(scope="module")
def replay(dump_dir):
    saved = loop_state_from_npz(STATE, "cpu")
    cfg = run_config().replace(loop_closure={"map_alignment_if_dump_matching_result": 1})
    closer = LoopCloser(cfg, device="cpu", dump_dir=dump_dir)
    closed_at = None
    for i, rec in enumerate(saved.keyframes):
        closer.keyframes.append(rec)
        if not closer.closed:
            closer._scan_for_loop()
        if closer.closed and closed_at is None:
            closed_at = i
    return saved, closer, closed_at


def test_artifact_loads_without_jax(replay):
    saved, _, _ = replay
    assert len(saved.keyframes) == 20 and len(saved.waiting) == 1
    assert saved.closed and saved.result.his_idx == 0 and saved.result.cur_idx == 19
    assert [acc.frames for acc in saved.updating] == [234, 134, 34]
    d = saved.keyframes[0].descriptor
    assert d.img_plane.shape == (60, 60) and isinstance(d.n_cells, int)
    assert isinstance(d.ratio_nonzero_plane, np.float32)
    assert saved.keyframes[0].snap_plane.shape[1] == 3 and saved.keyframes[0].snap_full is None


def test_replay_closes_at_the_recorded_pair(replay):
    _, closer, closed_at = replay
    out = recorded("loop_unscaled_out.json")
    assert closer.closed, "the port's gates do not close the artifact's loop"
    assert closed_at == out["loop"]["cur"] == 19
    assert (closer.result.his_idx, closer.result.cur_idx) == (0, 19)
    assert abs(closer.result.icp_score - out["loop"]["icp_score"]) < 0.05
    assert closer.result.icp_score < closer.lc.map_alignment_inlier_threshold


def test_replay_gate_trace_matches_the_record(replay):
    _, closer, _ = replay
    want_all = recorded("loop_unscaled_trace.json")
    assert len(closer.gate_trace) == len(want_all)
    for got, want in zip(closer.gate_trace, want_all):
        assert (got["stage"], got["cur"], got["his"]) == (want["stage"], want["cur"], want["his"])
        for k in ("sim_plane", "sim_line", "score"):
            if k in want:
                assert abs(float(got[k]) - float(want[k])) < 0.02, (k, got, want)


def test_replay_payoff_verdict(replay):
    saved, closer, _ = replay
    out = recorded("loop_unscaled_out.json")
    gt = np.asarray(out["kf_gt_positions"], np.float64)
    kt = np.stack([k.t.numpy() for k in saved.keyframes])
    n = min(len(gt), len(kt))
    payoff = dict(out["payoff"],
                  ate_kf_raw_before_loop=ate_rmse(kt[:n], gt[:n], align=False),
                  ate_kf_raw_after_loop=ate_rmse(closer.result.t_opt[:n], gt[:n], align=False))
    verdict = payoff_verdict(payoff)
    assert verdict["ok"], (verdict, payoff)
    # the replayed solve lands near the recorded one
    np.testing.assert_allclose(closer.result.t_opt, saved.result.t_opt, rtol=0, atol=0.05)


def test_loop_path_imports_no_jax():
    """The artifact loader and a few frames of the loop path (inline
    service, keyframes of 2 frames) load nothing of JAX."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import numpy as np\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from loam_livox_tpu_torch import SlamConfig, run_odometry\n"
        "from loam_livox_tpu_torch.interop import loop_state_from_npz\n"
        "from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig\n"
        "saved = loop_state_from_npz('scripts/loop_unscaled_state.npz', 'cpu')\n"
        "assert len(saved.keyframes) == 20\n"
        "cfg = SlamConfig().replace(\n"
        "    capacity={'max_raw_points': 4096, 'map_corner_capacity': 1024,\n"
        "              'map_surf_capacity': 4096, 'history_window': 4, 'cell_capacity': 1024,\n"
        "              'cell_point_capacity': 8},\n"
        "    mapping={'init_accumulate_frames': 1}, optimization={'icp_maximum_iteration': 2},\n"
        "    loop_closure={'if_enable_loop_closure': 1, 'if_loop_service_async': 0,\n"
        "                  'scans_of_each_keyframe': 2, 'scans_between_two_keyframe': 1})\n"
        "pipe, sim, wall = run_odometry(cfg, 4, LivoxSimulator(SimConfig(points_per_frame=3000)),\n"
        "                               device='cpu')\n"
        "assert len(pipe.loop_closer.keyframes) == 3\n"
        "assert pipe.get_surround_map().shape[1] == 3\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'loam_livox_tpu' or m.startswith('loam_livox_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=os.path.join(SCRIPTS, ".."),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


# --------------------------------------------------------------- dumps --

@pytest.fixture(scope="module")
def jax_dump(replay, dump_dir, tmp_path_factory):
    """The JAX package's service writes its dumps from the artifact's
    keyframes and the port's alignment results."""
    import jax.numpy as jnp

    from loam_livox_tpu.runtime.checkpoint import load_loop_state as jload_loop
    from loam_livox_tpu.runtime.loop_service import LoopCloser as JCloser

    spec = importlib.util.spec_from_file_location(
        "loop_unscaled", os.path.join(SCRIPTS, "loop_unscaled.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    jcfg = mod.make_cfg().replace(loop_closure={"if_loop_service_async": 0})
    keyframes = jload_loop(STATE, jcfg).keyframes
    out = str(tmp_path_factory.mktemp("jax_dump"))
    jsvc = JCloser(jcfg, dump_dir=out)
    _, closer, _ = replay
    icp = [e for e in closer.gate_trace if e["stage"] == "icp"]

    class Align:
        def __init__(self, i):
            with open(os.path.join(dump_dir, f"{i}_pair.json")) as f:
                d = json.load(f)
            self.q = jnp.asarray(d["q_wxyz"], jnp.float32)
            self.t = jnp.asarray(d["t"], jnp.float32)
            self.inlier_threshold = jnp.float32(d["inlier_threshold"])

    for i, e in enumerate(icp):
        jsvc._dump_matching_pair(keyframes[e["cur"]], keyframes[e["his"]], Align(i))
    jsvc.keyframes = list(keyframes)
    res = closer.result
    jsvc._accept_loop(res.his_idx, res.cur_idx, Align(len(icp) - 1))
    return out, len(icp)


def test_dump_writes_the_reference_artifacts(replay, dump_dir):
    _, closer, _ = replay
    names = set(os.listdir(dump_dir))
    n_pairs = sum(e["stage"] == "icp" for e in closer.gate_trace)
    assert n_pairs >= 1 and closer.counts["dump"] == n_pairs + 1
    assert {"loop.g2o", "poses_ori.txt", "poses_opm.txt"} <= names
    assert {f"{i}_{s}" for i in range(n_pairs) for s in ("a.pcd", "b.pcd", "c.pcd", "pair.json")} \
        <= names
    from loam_livox_tpu_torch.io.serialization import load_g2o, load_poses_txt

    t, q, edges = load_g2o(os.path.join(dump_dir, "loop.g2o"))
    assert len(t) == 20 and len(edges) == 20       # the chain and the loop edge
    assert (edges[-1]["id_begin"], edges[-1]["id_end"]) == (19, 0)
    t_opt, _ = load_poses_txt(os.path.join(dump_dir, "poses_opm.txt"))
    np.testing.assert_allclose(t_opt, closer.result.t_opt, rtol=0, atol=1e-5)


def test_dumps_match_jax(dump_dir, jax_dump):
    from loam_livox_tpu_torch.io.serialization import load_g2o, load_pcd, load_poses_txt

    jdir, n_pairs = jax_dump
    for i in range(n_pairs):
        for s in ("a", "b"):
            with open(os.path.join(dump_dir, f"{i}_{s}.pcd"), "rb") as f, \
                    open(os.path.join(jdir, f"{i}_{s}.pcd"), "rb") as g:
                assert f.read() == g.read(), (i, s)
        a, _ = load_pcd(os.path.join(dump_dir, f"{i}_c.pcd"))
        b, _ = load_pcd(os.path.join(jdir, f"{i}_c.pcd"))
        assert a.shape == b.shape and len(a) > 1000
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert recorded_json(dump_dir, f"{i}_pair.json") == recorded_json(jdir, f"{i}_pair.json")
    with open(os.path.join(dump_dir, "poses_ori.txt")) as f, \
            open(os.path.join(jdir, "poses_ori.txt")) as g:
        assert f.read() == g.read()
    (t1, q1, e1), (t2, q2, e2) = (load_g2o(os.path.join(d, "loop.g2o")) for d in (dump_dir, jdir))
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_array_equal(q1, q2)
    assert [(e["id_begin"], e["id_end"]) for e in e1] == [(e["id_begin"], e["id_end"]) for e in e2]
    for a, b in zip(e1, e2):
        np.testing.assert_allclose(a["t"], b["t"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(a["q_wxyz"], b["q_wxyz"], rtol=0, atol=1e-5)
    (ta, qa), (tb, qb) = (load_poses_txt(os.path.join(d, "poses_opm.txt")) for d in (dump_dir, jdir))
    np.testing.assert_allclose(ta, tb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(qa, qb, rtol=0, atol=1e-3)


def recorded_json(d, name):
    with open(os.path.join(d, name)) as f:
        return json.load(f)
