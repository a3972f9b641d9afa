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
def replay():
    saved = loop_state_from_npz(STATE, "cpu")
    closer = LoopCloser(run_config(), device="cpu")
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
