"""The port's command line (``loam_livox_tpu_torch.cli.run_odometry``)
against the JAX package's, on the CPU (``--device cpu``).

* `build_config` gives the JAX command line's configuration for the
  same arguments: every profile, ``--caps bounded``, ``--piecewise``,
  ``--loop-closure``, ``--config`` and ``--set``, and refuses what it
  refuses.
* Sources: ``pcd:`` (the native prefetch queue) and ``lvx:`` give the
  written frames; an empty ``pcd:`` directory exits.
* ``--follow`` prints one JSON line a trajectory row before the summary,
  which keeps the JAX command line's keys; the rows are read after every
  raw frame (one ``drain`` read a frame).  ``--mesh 2`` is refused
  (multi-GPU is not ported).
* The fixture bag (``tests/fixtures/sim_livox.bag``, 24 Livox frames)
  through ``main``: all 24 frames under the 0.30 m golden of
  tests/test_bag_replay.py at its capacities, and, at cut matching
  buffers (1,024 / 4,096), within 0.05 m of the JAX command line's
  replay with accepted rows within 3.  Reflectivity goes in as the bag
  holds it (0-255), as in the JAX command line.
* ``cli.read_camera`` replays an image directory without OpenCV.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from loam_livox_tpu.cli import run_odometry as jcli
from loam_livox_tpu.io.serialization import load_poses_txt as jload_poses

from loam_livox_tpu_torch.cli import run_odometry as tcli
from loam_livox_tpu_torch.eval.ate import ate_rmse
from loam_livox_tpu_torch.io.serialization import load_cell_map_json, load_poses_txt, save_pcd

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
BAG, GT = os.path.join(FIXTURES, "sim_livox.bag"), os.path.join(FIXTURES, "sim_livox_gt.txt")


def sets(pairs):
    out = []
    for kv in pairs:
        out += ["--set", kv]
    return out


ARGVS = {
    "precision": [],
    "realtime": ["--profile", "realtime"],
    "realtime_racing": ["--profile", "realtime_racing"],
    "largescale": ["--profile", "largescale", "--caps", "bounded"],
    "bounded": ["--caps", "bounded", "--piecewise", "2"],
    "loop": ["--loop-closure", "--mesh", "1"],
    "config": ["--config", "configs/performance_realtime.yaml", "--piecewise", "4"],
    "set": sets(["loop_closure/minimum_keyframe_differen=20",
                 "optimization.knn_precision=highest",
                 "mapping/maximum_pointcloud_delay_time=1.0", "common/if_motion_deblur=1"]),
}


@pytest.mark.parametrize("name", list(ARGVS))
def test_build_config_matches_jax(name):
    argv = ARGVS[name]
    port = tcli.build_config(tcli.parse_args(argv + ["--device", "cpu"]))
    ref = jcli.build_config(jcli.parse_args(argv))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert tcli.parse_args(argv).device == "cuda"


def test_set_rejects_unknown_and_malformed():
    with pytest.raises(AttributeError):
        tcli.build_config(tcli.parse_args(["--set", "nope/foo=1"]))
    with pytest.raises(SystemExit):
        tcli.build_config(tcli.parse_args(["--set", "garbage"]))


def test_pcd_and_lvx_sources(tmp_path):
    rng = np.random.default_rng(0)
    frames = []
    for i in range(3):
        xyz = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
        frames.append(xyz)
        save_pcd(str(tmp_path / f"frame_{i:04d}.pcd"), xyz)
    args = tcli.parse_args(["--source", f"pcd:{tmp_path}", "--frames", "2"])
    got = list(tcli.frame_stream(args, tcli.build_config(args)))
    assert len(got) == 2
    for (gx, gi, gt), xyz, i in zip(got, frames, range(2)):
        np.testing.assert_array_equal(gx, xyz)
        np.testing.assert_array_equal(gi, np.ones(100, np.float32))
        assert gt == pytest.approx(0.1 * i)
    empty = tmp_path / "empty"
    empty.mkdir()
    args = tcli.parse_args(["--source", f"pcd:{empty}"])
    with pytest.raises(SystemExit):
        list(tcli.frame_stream(args, tcli.build_config(args)))

    from loam_livox_tpu_torch.io.lvx import LvxReader, LvxWriter

    path = str(tmp_path / "c.lvx")
    with LvxWriter(path) as w:
        for i in range(3):
            w.add_points(rng.uniform(1, 20, (960, 3)), rng.uniform(0, 200, 960),
                         timestamp_ns=int(i * 1e8))
    args = tcli.parse_args(["--source", f"lvx:{path}", "--frames", "5"])
    got = list(tcli.frame_stream(args, tcli.build_config(args)))
    want = list(LvxReader(path).frames())
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a[0], b[0])


SMALL = sets(["capacity/max_raw_points=2048", "capacity/max_corner=128",
              "capacity/max_surface=512", "capacity/max_corner_ds=128",
              "capacity/max_surface_ds=512", "capacity/map_corner_capacity=2048",
              "capacity/map_surf_capacity=8192", "capacity/hist_corner_capacity=128",
              "capacity/hist_surf_capacity=512", "capacity/history_window=4",
              "mapping/init_accumulate_frames=2", "optimization/icp_maximum_iteration=2",
              "optimization/full_iterations=2"])


def test_follow_streams_pose_lines(capsys):
    assert tcli.main(["--frames", "3", "--quiet", "--follow", "--device", "cpu"] + SMALL) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    pose_lines, summary = lines[:-1], lines[-1]
    # the precision profile registers 3 pieces a frame: one row each
    assert [p["frame"] for p in pose_lines] == list(range(9))
    assert all(len(p["t"]) == 3 and len(p["q"]) == 4 for p in pose_lines)
    assert set(summary) >= {"frames", "mesh_devices", "wall_s", "fps", "accepted", "steps",
                            "loop_closed"}
    assert summary["frames"] == 3 and summary["steps"] == 9 and summary["device"] == "cpu"
    assert summary["host_syncs"]["drain"] == 3 and summary["host_syncs"]["log"] == 0


def test_mesh_refused(monkeypatch):
    """``--mesh 2`` runs product mode (queue 1 item 15) under a launcher
    (tests/test_torch_parallel_mode.py runs it on 2 ranks); outside one
    it is refused with what it needs."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="under a launcher"):
        tcli.main(["--frames", "1", "--quiet", "--mesh", "2", "--device", "cpu"] + SMALL)


# the capacities of tests/test_bag_replay.py
BAG_CAPS = ["capacity/max_raw_points=4096", "capacity/max_corner=256",
            "capacity/max_surface=1024", "capacity/max_corner_ds=256",
            "capacity/max_surface_ds=1024", "capacity/hist_corner_capacity=128",
            "capacity/hist_surf_capacity=512", "capacity/history_window=16",
            "mapping/init_accumulate_frames=8", "optimization/icp_maximum_iteration=5",
            "optimization/full_iterations=3"]


def bag_argv(tmp_path, buffers, tag):
    return (["--source", f"bag:{BAG}", "--frames", "100", "--piecewise", "1", "--quiet",
             "--save-poses", str(tmp_path / f"{tag}_poses.txt")]
            + sets(BAG_CAPS + [f"capacity/map_corner_capacity={buffers[0]}",
                               f"capacity/map_surf_capacity={buffers[1]}"]))


def test_fixture_bag_replays_under_golden(tmp_path, capsys):
    argv = bag_argv(tmp_path, (4096, 16384), "port") + [
        "--device", "cpu", "--follow", "--log-dir", str(tmp_path / "logs"),
        "--save-map", str(tmp_path / "map.json")]
    assert tcli.main(argv) == 0
    out = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    est, q = load_poses_txt(str(tmp_path / "port_poses.txt"))
    gt, _ = load_poses_txt(GT)
    assert est.shape == gt.shape == (24, 3) and out[-1]["frames"] == 24
    ate = ate_rmse(est, gt)
    assert ate < 0.30, f"bag-replay ATE {ate:.4f} m"
    follow = out[:-1]
    np.testing.assert_allclose([f["t"] for f in follow], est, rtol=0, atol=1e-6)
    np.testing.assert_allclose([f["q"] for f in follow], q, rtol=0, atol=1e-6)
    with open(tmp_path / "logs" / "mapping.log") as f:
        assert len(f.read().splitlines()) == 24
    # history matching without loop closure keeps no plane map: the empty
    # document, as the JAX package writes for its 1-slot map
    assert json.load(open(tmp_path / "map.json")) == []
    assert int(load_cell_map_json(str(tmp_path / "map.json"), device="cpu").n_cells()) == 0


def test_fixture_bag_replay_matches_jax(tmp_path, capsys):
    assert jcli.main(bag_argv(tmp_path, (1024, 4096), "jax")) == 0
    assert tcli.main(bag_argv(tmp_path, (1024, 4096), "port") + ["--device", "cpu"]) == 0
    sj, st = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    gt, _ = load_poses_txt(GT)
    est_j, _ = jload_poses(str(tmp_path / "jax_poses.txt"))
    est_t, _ = load_poses_txt(str(tmp_path / "port_poses.txt"))
    assert est_j.shape == est_t.shape == gt.shape == (24, 3)
    ate_j, ate_t = ate_rmse(est_j, gt), ate_rmse(est_t, gt)
    assert abs(ate_t - ate_j) < 0.05 and ate_t < 0.30, (ate_t, ate_j)
    assert abs(st["accepted"] - sj["accepted"]) <= 3 and st["steps"] == sj["steps"] == 24


def test_save_map_with_loop_closure_writes_the_plane_map(tmp_path, capsys):
    argv = ["--frames", "6", "--quiet", "--loop-closure", "--device", "cpu",
            "--save-map", str(tmp_path / "map.json")] + SMALL
    assert tcli.main(argv) == 0
    cells = json.load(open(tmp_path / "map.json"))
    assert len(cells) > 20 and {"Pt_num", "Res", "Center", "Mean", "Cov"} <= set(cells[0])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["loop_closed"] is False


def test_read_camera_replays_a_directory(tmp_path):
    from loam_livox_tpu_torch.cli import read_camera

    src, out = tmp_path / "imgs", tmp_path / "out"
    src.mkdir()
    for i in range(3):
        np.save(src / f"img_{i}.npy", np.full((2, 2), i))
    assert read_camera.main(["--source", f"dir:{src}", "--out", str(out), "--fps", "1000",
                             "--frames", "2"]) == 0
    names = sorted(os.listdir(out))
    assert len(names) == 2 and names[0].endswith("img_0.npy") and names[1].endswith("img_1.npy")
    with pytest.raises(SystemExit):
        next(read_camera.camera_stream("nope:0"))
