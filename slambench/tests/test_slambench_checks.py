"""CPU tests of a configuration's own check and of the program's outputs
the harness keeps: a loop-closure cell added to the tiny bench by new
files alone (`tiny.add_loop_cell`), the replay window's close after the
loop service drains, and the default path of a configuration that
names no check.

    python -m pytest slambench/tests/test_slambench_checks.py -q
"""
from __future__ import annotations

import importlib.util
import json

import pytest
import torch

from slambench import check, harness
from slambench.tests.tiny import add_loop_cell, make_bench, tiny_config

SEED = 2 ** 31 + 17


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
    harness.recorder().on = False


def test_a_loop_closure_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A configuration with loop closure on, its own check, its limits and
    a metric of the loop service's outputs: new files and manifest
    entries.  The run is correct with every gap 0.0, the metric is read,
    and the TF32 control is judged by the configuration's check."""
    controls = []
    judge = check.judge

    def spy(*args, control=None):
        controls.append(control)
        return judge(*args, control=control)
    monkeypatch.setattr(check, "judge", spy)
    bench, manifest = make_bench(tmp_path)
    cell = add_loop_cell(bench, manifest)
    out = harness.run_cell(cell, SEED, 600.0, True, 0.0, bench=bench, device="cpu",
                           manifest=manifest, controls=("tf32",))
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["checks"]) == {"pose_gap_m", "map_gap_m", "touched_unadmitted",
                                  "keyframes_short"}
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert out["metrics"]["loop_keyframes"]["value"] >= 1
    assert controls == [None, "tf32"]
    assert set(out["_controls"]["tf32"]) == set(out["checks"])


def test_a_replay_window_closes_after_the_loop_service_drains(tmp_path, monkeypatch):
    """With the service on its worker thread, the window's close finds no
    keyframe waiting or in work, and the counts read there are those
    after the pipeline's flush."""
    flushed = []
    load_check = harness.load_check

    def load(name, bench):
        mod = load_check(name, bench)
        keep = mod.keep

        def after_flush(pipe):
            closer = pipe.loop_closer
            flushed.append({"counts": dict(closer.counts), "keyframes": len(closer.keyframes)})
            return keep(pipe)
        mod.keep = after_flush
        return mod
    monkeypatch.setattr(harness, "load_check", load)
    bench, manifest = make_bench(tmp_path)
    cell = add_loop_cell(bench, manifest, async_service=True)
    out = harness.run_cell(cell, SEED, 600.0, False, 0.0, bench=bench, device="cpu",
                           manifest=manifest)
    assert out["correct"] is True
    service = out["_outputs"]["loop_service"]
    assert service["waiting"] == 0 and service["busy"] is False
    assert service["drain_s"] is not None and service["drain_s"] >= 0.0
    assert service["counts"] == flushed[0]["counts"]
    assert service["keyframes"] == flushed[0]["keyframes"] >= 1


@pytest.mark.parametrize("heads", [1, 3])
def test_a_configuration_without_a_check_runs_as_before(tmp_path, monkeypatch, heads):
    """Without ``"check"`` the harness loads nothing from ``checks/`` and
    keeps no outputs on the CPU; its checks and its traced result line's
    counters equal those of the same configuration naming a check that is
    the default one."""
    loaded = []
    spec_from_file = importlib.util.spec_from_file_location

    def spec(name, path, *a, **k):
        loaded.append(path)
        return spec_from_file(name, path, *a, **k)
    monkeypatch.setattr(importlib.util, "spec_from_file_location", spec)
    bench, manifest = make_bench(tmp_path)
    cell = harness.cell_of(manifest, f"tiny{heads}_replay")
    plain = harness.run_cell(cell, SEED, 600.0, True, 0.0, bench=bench, device="cpu",
                             manifest=manifest)
    assert not [p for p in loaded if (bench / "checks") in p.parents]

    (bench / "checks" / "default.py").write_text(
        "from slambench import check\n"
        "to_reference_state = check.to_reference_state\n\n\n"
        "def judge(cfg_doc, frames, dev, rows, per_frame, start, snaps, n_frames_run, kept,\n"
        "          control=None):\n"
        "    return check.judge(cfg_doc, frames, dev, rows, per_frame, start, snaps,\n"
        "                       n_frames_run, control=control)\n")
    doc = dict(tiny_config(heads), check="default")
    (bench / "configs" / "named.json").write_text(json.dumps(doc))
    (bench / "limits" / "named_replay.json").write_text(
        (bench / "limits" / f"{cell['name']}.json").read_text())
    manifest["workloads"].append(dict(cell, name="named_replay", config="named"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if cell["name"] in m.get("workloads", []):
            m["workloads"].append("named_replay")
    named = harness.run_cell(harness.cell_of(manifest, "named_replay"), SEED, 600.0, True,
                             0.0, bench=bench, device="cpu", manifest=manifest)
    assert bench / "checks" / "default.py" in loaded
    assert plain["correct"] is True and plain["checks"] == named["checks"]
    counters = [m["name"] for m in manifest["per_layer"] if m["source"] == "program_counter"
                and cell["name"] in m.get("workloads", [])]
    assert counters and {n: plain["metrics"].get(n) for n in counters} == {
        n: named["metrics"].get(n) for n in counters}
    assert any(n in plain["metrics"] for n in counters)
    assert plain["_outputs"] == named["_outputs"] == {}
