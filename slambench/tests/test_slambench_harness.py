"""CPU tests of the benchmark's harness: the stream, the manifest and the
files it finds by name, the plain reference, the result line, the
replay window's fixed recording, its cap and the frames the check
follows, the span readers, the modules a run loads, a run without a
card, and the check's verdict on a sound run and on runs with the timed
path broken underneath.

    python -m pytest slambench/tests -q

Nothing here times anything: a run on the CPU drives the program's
plain path at a small size (`tiny`)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from slambench import harness
from slambench.gen.stream import Site, make_frames
from slambench.tests.tiny import BENCH, REPLAY_FRAMES, make_bench, tiny_config
from slambench.trace import UNTRACED, reduce_events

ROOT = BENCH.parent
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
    harness.recorder().on = False


def _run(tmp_path, cell_name, trace=False, seconds=None, seed=2 ** 31 + 17):
    """One run of a tiny cell: a replay cell's whole recording (its cap
    far off), a live cell's 0.6 s."""
    if seconds is None:
        seconds = 0.6 if cell_name.endswith("_live") else 600.0
    bench, manifest = make_bench(tmp_path)
    cell = harness.cell_of(manifest, cell_name)
    return harness.run_cell(cell, seed, seconds, trace, 0.0, bench=bench, device="cpu",
                            manifest=manifest)


def test_stream_repeats_a_seed_and_redraws_the_noise_of_another():
    site = Site.from_dict(tiny_config(3)["site"])
    a = make_frames(site, 2 ** 31 + 5, 3, 4096, "cpu")
    b = make_frames(site, 2 ** 31 + 5, 3, 4096, "cpu")
    c = make_frames(site, 12, 3, 4096, "cpu")
    assert torch.equal(a.xyz, b.xyz) and torch.equal(a.inten, b.inten)
    assert not torch.equal(a.xyz, c.xyz)
    # the site is fixed: another seed moves a point by its noise, not more
    both = (a.xyz[..., 0] != 0) & (c.xyz[..., 0] != 0)
    gap = (a.xyz - c.xyz).norm(dim=-1)[both]
    assert float(gap.median()) < 0.05
    assert a.mask[..., :3000].all() and not a.mask[..., 3000:].any()
    assert a.xyz.shape == (3, 3, 4096, 3)


def test_manifest_finds_every_file_by_name():
    """Every cell's configuration, traffic, limits, check (where its
    configuration names one) and metric readers are there; the first
    three cells are among them (a later cell is added by files alone)."""
    manifest = harness.load_manifest(ROOT)
    configs = {c["name"]: c for c in manifest["configs"]}
    for cell in manifest["workloads"]:
        doc = harness.load_config(cell["config"])
        assert doc["site"]
        assert harness.load_traffic(cell["traffic"])["mode"] in ("replay", "live")
        assert (ROOT / configs[cell["config"]]["file"]).exists()
        assert (BENCH / "limits" / f"{cell['name']}.json").exists()
        if "check" in doc:
            assert callable(harness.load_check(doc["check"]).judge)
        else:
            assert {"pose_gap_m", "map_gap_m"} <= set(harness.load_limits(cell["name"]))
        for trace in (False, True):
            for m in harness.metrics_of(manifest, cell["name"], trace):
                assert callable(harness.load_reader(m["name"]))
    assert {"mid40_replay", "mid100_replay", "mid40_live"} <= {
        c["name"] for c in manifest["workloads"]}


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix and per-layer metric: new files and
    manifest entries, no edit of an existing file."""
    bench, manifest = make_bench(tmp_path)
    cfg = tiny_config(1)
    cfg["slam"]["mapping"]["init_accumulate_frames"] = 4
    (bench / "configs" / "tiny_new.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "slow_live.json").write_text(json.dumps(
        {"mode": "live", "rate_hz": 3.0, "warmup_frames": 6, "start_registered": 1,
         "check_samples": 1}))
    (bench / "limits" / "tiny_new_live.json").write_text(json.dumps(
        {"pose_gap_m": 0.0, "map_gap_m": 0.0}))
    (bench / "metrics" / "frames_late.py").write_text(
        "def read(rec):\n"
        "    return None if rec.latencies_ms is None else "
        "sum(x > 100.0 for x in rec.latencies_ms)\n")
    manifest["workloads"].append({"name": "tiny_new_live", "config": "tiny_new",
                                  "traffic": "slow_live", "chips": 1, "why": "test"})
    manifest["end_to_end"][1]["workloads"].append("tiny_new_live")
    manifest["per_layer"].append({"name": "frames_late", "unit": "count", "better": "lower",
                                  "source": "host_clock", "layer": "pipeline",
                                  "moves": "latency_ms_mean", "workloads": ["tiny_new_live"]})
    cell = harness.cell_of(manifest, "tiny_new_live")
    out = harness.run_cell(cell, 5, 1.0, True, 0.0, bench=bench, device="cpu",
                           manifest=manifest)
    assert "frames_late" in out["metrics"] and out["correct"]


def test_the_reference_ends_on_a_tiny_stream():
    from slambench.reference import config as RC
    from slambench.reference.pipeline import PlainOdometry

    doc = tiny_config(1)
    site = Site.from_dict(doc["site"])
    fr = make_frames(site, 3, 6, 4096, "cpu")
    ref = PlainOdometry(RC.SlamConfig().replace(**doc["slam"]), "cpu")
    for i in range(6):
        ref.process_raw(fr.xyz[i, 0], fr.inten[i, 0], fr.mask[i, 0], fr.t0[i])
    rows = ref.rows()
    assert rows.shape == (6, 10) and torch.isfinite(rows).all()
    assert ref.ladder


@pytest.mark.parametrize("cell, trace", [("tiny1_replay", False), ("tiny1_replay", True),
                                         ("tiny3_replay", False), ("tiny1_live", True)])
def test_result_line_keys_and_a_sound_run_is_correct(tmp_path, cell, trace):
    out = _run(tmp_path, cell, trace)
    out.pop("_ate_m")
    assert out.pop("_outputs") == {}    # no loop service, no frame program on the CPU
    replay = cell.endswith("_replay")
    want = KEYS + (["breakdown"] if trace else []) + (["capped"] if replay else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    if replay:
        assert out["attempted"] == REPLAY_FRAMES and out["capped"] is False
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    e2e = {"tiny1_replay": "frames_per_s", "tiny3_replay": "frames_per_s",
           "tiny1_live": "latency_ms_mean"}[cell]
    assert (e2e in out["metrics"]) is (not trace)
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
    assert json.loads(json.dumps(out)) == out


def test_the_live_tail_leaves_out_the_profiled_frames(tmp_path, monkeypatch):
    """``latency_tail_ms_p95`` reads every frame but the profiled slice's;
    a negative ``trace_after_frames`` puts the slice at the window's end."""
    import slambench.trace as T

    reader = harness.load_reader("latency_tail_ms_p95")
    rec = harness.Records(mode="live", setup_s=0.0, latencies_ms=[10.0] * 90 + [500.0] * 10)
    assert reader(rec) == pytest.approx(500.0)
    rec.trace = SimpleNamespace(frames=(90, 100))
    assert reader(rec) == pytest.approx(10.0)

    made = []

    class Spy(T.Tracer):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    monkeypatch.setattr(T, "Tracer", Spy)
    bench, manifest = make_bench(tmp_path)
    path = bench / "traffic" / "live.json"
    traffic = dict(json.loads(path.read_text()), trace_after_frames=-2)
    path.write_text(json.dumps(traffic))
    seconds = 1.0
    out = harness.run_cell(harness.cell_of(manifest, "tiny1_live"), 2 ** 31 + 5, seconds, True,
                           0.0, bench=bench, device="cpu", manifest=manifest)
    n = int(round(seconds * traffic["rate_hz"]))
    assert (made[0].k0, made[0].k1) == (n - 2, n)
    assert out["correct"] and "latency_tail_ms_p95" in out["metrics"]


def test_trace_reduction_unites_intervals_and_labels_gaps():
    events = [("k1", 100, 200), ("k2", 150, 300), ("k1", 500, 600)]
    spans = [("dispatch", 300 - 7, 450 - 7)]
    busy, ops, gaps = reduce_events(events, 0, 1000, spans, 7)
    assert busy == pytest.approx(300e-9)
    assert ops["k1"] == pytest.approx(200e-9)
    assert gaps[0] == ("harness", pytest.approx(400e-9))     # 600-1000
    assert ("dispatch", pytest.approx(200e-9)) in gaps        # 300-500
    # a graph launch's interval is busy; what no recorded kernel covers
    # inside it is reported as one operation
    busy, ops, gaps = reduce_events(events, 0, 1000, spans, 7, launches=[(250, 450)])
    assert busy == pytest.approx(450e-9)
    assert ops[UNTRACED] == pytest.approx(150e-9)


class _Stub:
    """A program that maps nothing: each frame returns at once, or after
    ``delay`` seconds."""

    def __init__(self, delay: float = 0.0):
        self.delay = delay
        self.t0s = []

    def frame(self, xyz, inten, mask, t0, keep_features=False):
        self.t0s.append(t0)
        if self.delay:
            time.sleep(self.delay)

    def state(self):
        return None

    def scale(self):
        return 1

    def drain_background(self):
        return False


def _stream(n):
    return SimpleNamespace(xyz=torch.zeros((n, 1, 4, 3)), inten=torch.zeros((n, 1, 4)),
                           mask=torch.ones((n, 1, 4), dtype=torch.bool),
                           t0=[0.1 * i for i in range(n)])


def _replay(prog, first, count, seconds, sampler=None):
    return harness.replay_window(prog, _stream(first + count), first, count, seconds, 2,
                                 torch.device("cpu"), harness.HostSpans(), sampler)


@pytest.mark.parametrize("delay", [0.0, 0.002])
def test_a_replay_window_maps_exactly_its_recording(delay):
    """The window dispatches the recording's frames, each once, in order,
    from a stream that holds nothing more, and closes after the last,
    however fast the program returns."""
    prog = _Stub(delay)
    frames, seconds, capped = _replay(prog, 6, 40, 600.0)
    assert frames == 40 and seconds > 0 and not capped
    assert prog.t0s == [0.1 * i for i in range(6, 46)]


def test_the_check_follows_the_same_frames_at_any_speed():
    seed = 2 ** 31 + 41
    picked = []
    for delay in (0.0, 0.01):
        sampler = harness.Sampler(seed, 6, 60, 0)
        _replay(_Stub(delay), 6, 60, 600.0, sampler)
        picked.append([s.frame for s in sampler.all()])
    assert picked[0] == picked[1]
    assert picked[0][-1] == 6 + 59                      # the recording's last frame
    assert len(picked[0]) >= 3 and all(6 <= f <= 6 + 54 for f in picked[0][:-1])
    # another seed follows other frames
    other = harness.Sampler(seed + 1, 6, 60, 0)
    _replay(_Stub(), 6, 60, 600.0, other)
    assert [s.frame for s in other.all()] != picked[0]


def test_the_cap_ends_a_slow_window_and_says_so(capsys):
    """A window still dispatching at its cap makes the next frame its
    last: the check follows that frame's state, and the run says it was
    capped."""
    prog = _Stub(0.05)
    sampler = harness.Sampler(2 ** 31 + 41, 6, 100, 0)
    frames, seconds, capped = _replay(prog, 6, 100, 0.3, sampler)
    assert capped and 1 <= frames < 100 and len(prog.t0s) == frames
    assert seconds >= 0.3
    assert sampler.last is not None and sampler.last.frame == 6 + frames - 1
    assert all(s.frame < 6 + frames - 1 for s in sampler.snaps)
    assert f"after {frames} of its 100 frames" in capsys.readouterr().err


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_span_readers_read_a_traced_window_only(tmp_path, device):
    """``voxel_ms_per_frame`` and ``device_ms_per_pass`` read the program's
    spans: nothing without a trace, a positive time with one (on the
    card where one is present)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device spans of the card")
    names = ("voxel_ms_per_frame", "device_ms_per_pass")
    bench, manifest = make_bench(tmp_path)
    bare = harness.Records(mode="replay", setup_s=1.0, frames=REPLAY_FRAMES, seconds=1.0)
    for n in names:
        assert harness.load_reader(n, bench)(bare) is None
    cell = harness.cell_of(manifest, "tiny1_replay")
    out = harness.run_cell(cell, 2 ** 31 + 23, 600.0, True, 0.0, bench=bench, device=device,
                           manifest=manifest)
    assert out["correct"] is True and not harness.recorder().on
    for n in names:
        assert out["metrics"][n]["value"] > 0
    untraced = harness.run_cell(cell, 2 ** 31 + 23, 600.0, False, 0.0, bench=bench,
                                device=device, manifest=manifest)
    assert not set(names) & set(untraced["metrics"])


def _faulty(monkeypatch, fault):
    import loam_livox_tpu_torch.runtime.odometry as odo
    import loam_livox_tpu_torch.runtime.pipeline as pl

    if fault == "state_unchanged":
        real = odo.commit_frame

        def commit(state, frame, corner_in, surf_in, reg, cfg, *a, **k):
            new, reg = real(state, frame, corner_in, surf_in, reg, cfg, *a, **k)
            return state, reg
        monkeypatch.setattr(odo, "commit_frame", commit)
    elif fault == "half_the_points":
        real = pl.OdometryPipeline.process_raw

        def process_raw(self, xyz, intensity, base_time, mask=None):
            mask = mask.clone()
            valid = mask.nonzero().flatten()
            mask[valid[len(valid) // 2:]] = False
            return real(self, xyz, intensity, base_time, mask=mask)
        monkeypatch.setattr(pl.OdometryPipeline, "process_raw", process_raw)
    elif fault == "answer_altered":
        real = pl.trajectory_rows

        def rows(regs, frames):
            out = real(regs, frames).clone()
            out[:, 1] += 0.01
            return out
        monkeypatch.setattr(pl, "trajectory_rows", rows)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_points", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    _faulty(monkeypatch, fault)
    out = _run(tmp_path, "tiny1_replay")
    assert out["correct"] is False


def _subprocess_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return env


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "slambench/run.py", "--workload", "mid40_replay",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, env=_subprocess_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_bench_files_alone_give_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(_subprocess_env(), PYTHONPATH="")
    proc = subprocess.run([sys.executable, "slambench/run.py", "--workload", "mid40_replay",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "not in this checkout" in proc.stderr


def test_a_run_loads_no_jax_and_not_the_jax_package(tmp_path):
    code = (
        "import sys, torch; torch.set_num_threads(2)\n"
        "from pathlib import Path\n"
        "from slambench import harness\n"
        "from slambench.tests.tiny import make_bench\n"
        f"bench, manifest = make_bench(Path({str(tmp_path)!r}))\n"
        "cell = harness.cell_of(manifest, 'tiny1_replay')\n"
        "out = harness.run_cell(cell, 3, 1.0, True, 0.0, bench=bench, device='cpu',"
        " manifest=manifest)\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'loam_livox_tpu'}), "
        "'loam_livox_tpu_torch' in tops, harness.forbidden_loaded())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_subprocess_env(),
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[] True []"


def test_search_work_counts_the_pairs_within_reach():
    from slambench.yardstick.knn_work import GROUP, build_ref_operand, search_work

    g = torch.Generator().manual_seed(0)
    ref = torch.rand((3 * GROUP, 3), generator=g) * 10
    mask = torch.ones(3 * GROUP, dtype=torch.bool)
    mask[-10:] = False
    q = torch.rand((40, 3), generator=g) * 10
    op = build_ref_operand(ref, mask)
    pairs, nbytes = search_work(q, 30, op, None)
    assert pairs == 30 * int(mask.sum())
    assert nbytes == 30 * 12 + 3 * GROUP * 16 - 10 * 16 + 3 * 32 + 30 * 5 * 8
    near, _ = search_work(q, 30, op, 0.5)
    assert 0 < near <= pairs
