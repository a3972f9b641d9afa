"""The program's span recorder (`loam_livox_tpu_torch.utils.logging.spans`)
on the CPU, where a device span reads ``perf_counter_ns`` at its ends.

* Off, a few frames record nothing, and the rows, iterations and state
  are bit-equal with the recorder on and off.
* On, each unit's tree nests as the recorder's table says (a Mid-40-style
  raw frame, and a Mid-100-style frame: its heads' front end, then a
  step a piece), every child lies inside its parent and siblings do not
  overlap; the ICP pass spans are the loops' passes, each with two
  searches, two target builds and one solve.
* A ring that fills reports its loss, and a record with a loss is not
  complete; inside `core.accounting.charged_to`, or on a tensor of
  neither device, nothing is recorded.
* The per-layer reductions of ``scripts/torch_layer_spans.py``, one
  case a metric, on a synthetic window.

The stamps a card places (their count in a capture, their agreement with
CUDA events) are checked on the card, in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from loam_livox_tpu_torch.core import accounting
from loam_livox_tpu_torch.core.config import SlamConfig
from loam_livox_tpu_torch.eval.scenarios import SMALL_CAPS
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
from loam_livox_tpu_torch.utils import logging as L
from scripts import torch_layer_spans as S

CPU = torch.device("cpu")
UNIT = L.SPAN_UNIT + "."
#: the span each span nests in (module doc of `utils.logging`)
PARENTS = {
    L.SPAN_FRONT_END: {UNIT + "frame", UNIT + "heads"},
    L.SPAN_VOXEL: {UNIT + "frame", UNIT + "heads", L.SPAN_SETUP, L.SPAN_ADD_FRAME,
                   L.SPAN_BUILD_TREE, L.SPAN_FRONT_END},
    L.SPAN_SETUP: {UNIT + "frame", UNIT + "step"},
    L.SPAN_PASS: {UNIT + "frame", UNIT + "step"},
    L.SPAN_QUERY: {L.SPAN_PASS},
    L.SPAN_TARGETS: {L.SPAN_PASS},
    L.SPAN_POSE_OPT: {L.SPAN_PASS},
    L.SPAN_ADD_FRAME: {UNIT + "frame", UNIT + "step"},
    L.SPAN_BUILD_TREE: {UNIT + "frame", UNIT + "step"},
    L.SPAN_UPDATE_BUFF: {UNIT + "frame", UNIT + "step"},
}


@pytest.fixture(autouse=True)
def recorder():
    torch.set_num_threads(2)
    L.spans.on = False
    L.spans.reset()
    yield L.spans
    L.spans.on = False
    L.spans.capacity = L.RING_RECORDS
    L.spans.reset()


def mid40_config():
    return SlamConfig().replace(capacity={**SMALL_CAPS, "auto_schedule": 0},
                                mapping={"init_accumulate_frames": 3},
                                optimization={"icp_maximum_iteration": 5, "full_iterations": 3})


def run_mid40(n_frames=6):
    sim = LivoxSimulator(SimConfig(points_per_frame=3000, seed=2), traj=Trajectory(ramp_t0=0.3))
    pipe = OdometryPipeline(mid40_config(), device="cpu")
    for i in range(n_frames):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    return pipe


def run_mid100(n_frames=5):
    from slambench.gen.stream import Site, make_frames
    from slambench.tests.tiny import tiny_config

    doc = tiny_config(3)
    fr = make_frames(Site.from_dict(doc["site"]), 7, n_frames,
                     doc["slam"]["capacity"]["max_raw_points"], "cpu")
    pipe = OdometryPipeline(SlamConfig().replace(**doc["slam"]), device="cpu")
    for i in range(n_frames):
        for piece in pipe.head_frames(fr.xyz[i], fr.inten[i], fr.mask[i], fr.t0[i]):
            pipe.process_feature_frame(piece)
    pipe.flush()
    return pipe


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for part in tree for x in leaves(part)]
    return []


def test_off_records_nothing_and_on_changes_no_output(recorder):
    off = run_mid40()
    assert L.spans.read(CPU).spans == [] and L.spans.host_spans().spans == []
    recorder.on = True
    on = run_mid40()
    assert len(L.spans.read(CPU).spans) > 0 and len(L.spans.host_spans().spans) > 0
    assert off.trajectory.times == on.trajectory.times and off.iterations == on.iterations
    assert np.array_equal(off.trajectory.positions_array(), on.trajectory.positions_array())
    assert np.array_equal(np.asarray(off.trajectory.quaternions),
                          np.asarray(on.trajectory.quaternions))
    for a, b in zip(leaves(off.state), leaves(on.state), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("style", ["mid40", "mid100"])
def test_each_unit_nests_as_the_table_says(recorder, style):
    recorder.on = True
    pipe = run_mid40() if style == "mid40" else run_mid100()
    rec = L.spans.read(CPU)
    assert rec.complete
    spans = rec.spans
    for s in spans:
        if s.name.startswith(UNIT):
            assert s.depth == 0 and s.parent == -1
        else:
            assert s.parent >= 0 and spans[s.parent].name in PARENTS[s.name], s
            assert s.depth == spans[s.parent].depth + 1
    units = S.units(spans)
    kinds = [u.name for u in units]
    n = len(pipe.trajectory.times)
    if style == "mid40":
        assert kinds == [UNIT + "frame"] * n
    else:
        assert kinds == [UNIT + "heads", UNIT + "step", UNIT + "step"] * (n // 2)
    # one front end a raw frame; every step sets up, commits and updates
    assert sum(s.name == L.SPAN_FRONT_END for s in spans) == len(pipe.trajectory.times) // (
        1 if style == "mid40" else 2)
    for name in (L.SPAN_SETUP, L.SPAN_ADD_FRAME, L.SPAN_BUILD_TREE, L.SPAN_UPDATE_BUFF):
        assert sum(s.name == name for s in spans) == n


@pytest.mark.parametrize("style", ["mid40", "mid100"])
def test_passes_are_the_loops_passes(recorder, style):
    recorder.on = True
    pipe = run_mid40() if style == "mid40" else run_mid100()
    spans = L.spans.read(CPU).spans
    passes = [i for i, s in enumerate(spans) if s.name == L.SPAN_PASS]
    assert len(passes) == sum(pipe.iterations) == pipe.loop_iterations > 0
    for i in passes:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == [L.SPAN_QUERY, L.SPAN_QUERY, L.SPAN_TARGETS, L.SPAN_TARGETS,
                        L.SPAN_POSE_OPT]


def test_children_lie_inside_their_parents(recorder):
    recorder.on = True
    run_mid40()
    for rec in (L.spans.read(CPU), L.spans.host_spans()):
        spans = rec.spans
        assert spans and all(0 <= s.t0 <= s.t1 for s in spans)
        last_end = {}
        for s in spans:
            if s.parent >= 0:
                p = spans[s.parent]
                assert p.t0 <= s.t0 <= s.t1 <= p.t1
            # siblings in order, none overlapping
            assert s.t0 >= last_end.get(s.parent, -1)
            last_end[s.parent] = s.t1


def test_host_spans_nest_in_the_pipelines_calls(recorder):
    recorder.on = True
    pipe = run_mid40()
    host = L.spans.host_spans().spans
    names = [s.name for s in host]
    n = len(pipe.trajectory.times)
    assert names.count("process_raw") == names.count("copy-up") == n
    for s in host:
        if s.name == "copy-up":
            assert host[s.parent].name == "process_raw"
        if s.name == "drain":
            assert host[s.parent].name == "flush"
    assert names[-2:] == ["flush", "drain"]


def test_a_full_ring_reports_its_loss(recorder):
    recorder.on = True
    recorder.capacity = 40
    run_mid40(4)
    rec = L.spans.read(CPU)
    assert rec.lost > 0 and not rec.complete
    # the first 40 stamps kept: every span's open and each closed one's close
    assert len(rec.spans) + sum(s.t1 >= 0 for s in rec.spans) == 40
    recorder.reset()
    assert L.spans.read(CPU) == L.Recorded([])


def test_nothing_recorded_inside_charged_to_or_off_the_devices(recorder):
    recorder.on = True
    x = torch.zeros(3)
    with accounting.charged_to({}):
        with L.spans.device(L.SPAN_VOXEL, x), L.spans.host("load"):
            pass
    with L.spans.device(L.SPAN_VOXEL, torch.zeros(3, device="meta")):
        pass
    assert L.spans.read(CPU).spans == [] and L.spans.host_spans().spans == []
    with L.spans.device(L.SPAN_VOXEL, x):
        pass
    assert [s.name for s in L.spans.read(CPU).spans] == [L.SPAN_VOXEL]


def test_decode_rebuilds_nesting_and_counts_broken_stamps():
    names = ["a", "b"]
    a, b = 0, 2
    rec = L.decode([(1, a), (2, b), (3, b | 1), (4, b), (5, b | 1), (6, a | 1), (7, b | 1)],
                   names)
    assert rec.spans == [L.Span("a", 1, 6, -1, 0), L.Span("b", 2, 3, 0, 1),
                         L.Span("b", 4, 5, 0, 1)]
    assert rec.broken == 1 and not rec.complete
    cut = L.decode([(1, a), (2, b)], names, lost=2)
    assert cut.spans[1].t1 == -1 and cut.lost == 2 and not cut.complete


# ---- the reductions of scripts/torch_layer_spans.py ------------------------

def _window():
    """Two frames of one unit each: a front end (1 ms) with a source voxel
    filter (0.5 ms), set-up with an input filter (0.25 ms), two passes of
    two searches (0.1 ms each), two target builds (0.05 ms each) and a
    solve (2 ms) in 3 ms, a commit with a voxel filter (0.5 ms) and a
    rebuild with one (1 ms)."""
    ms = 1_000_000
    out = []

    def add(name, t0, t1, parent):
        depth = 0 if parent < 0 else out[parent].depth + 1
        out.append(L.Span(name, int(t0 * ms), int(t1 * ms), parent, depth))
        return len(out) - 1

    for f, t in enumerate((100.0, 200.0)):
        u = add(UNIT + "frame", t, t + 20, -1)
        add(L.SPAN_FRONT_END, t, t + 1, u)
        add(L.SPAN_VOXEL, t + 1, t + 1.5, u)
        st = add(L.SPAN_SETUP, t + 2, t + 3, u)
        add(L.SPAN_VOXEL, t + 2, t + 2.25, st)
        for k in range(2):
            p = add(L.SPAN_PASS, t + 3 + 3 * k, t + 6 + 3 * k, u)
            c = t + 3 + 3 * k
            add(L.SPAN_QUERY, c, c + 0.1, p)
            add(L.SPAN_QUERY, c + 0.1, c + 0.2, p)
            add(L.SPAN_TARGETS, c + 0.2, c + 0.25, p)
            add(L.SPAN_TARGETS, c + 0.25, c + 0.3, p)
            add(L.SPAN_POSE_OPT, c + 0.3, c + 2.3, p)
        a = add(L.SPAN_ADD_FRAME, t + 10, t + 11, u)
        add(L.SPAN_VOXEL, t + 10, t + 10.5, a)
        r = add(L.SPAN_BUILD_TREE, t + 12, t + 14, u)
        add(L.SPAN_VOXEL, t + 12, t + 13, r)
    return out


LAYER_CASES = {
    "frontend_ms_per_frame": 1.0,
    "voxel_ms_per_frame": 0.5 + 0.25 + 0.5 + 1.0,
    "knn_ms_per_pass": 0.2,
    "solver_ms_per_pass": 2.0,
}


@pytest.mark.parametrize("metric", list(LAYER_CASES) + ["pass_kernels", "start_lag_ms_p95",
                                                       "frame_device_ms_p95"])
def test_each_reduction_on_a_synthetic_window(metric):
    spans = _window()
    if metric in LAYER_CASES:
        out = S.layer_metrics(spans, frames=2)
        assert out[metric] == pytest.approx(LAYER_CASES[metric])
        assert out["passes"] == 4
        if metric == "voxel_ms_per_frame":
            assert out["voxel_ms_per_frame_by_site"] == pytest.approx(
                {"source filter": 0.5, "input filter": 0.25, "commit": 0.5, "rebuild": 1.0})
        if metric == "knn_ms_per_pass":
            assert out["pass_split_pct"] == pytest.approx(
                {"search": 20 / 3, "targets": 10 / 3, "solve": 200 / 3, "self": 70 / 3})
    elif metric == "pass_kernels":
        summary = [{"held": False, "launches": 90, "pass_kernels": 4000},
                   {"held": True, "launches": 300, "pass_kernels": 5100},
                   {"held": True, "launches": 12, "pass_kernels": 5300},
                   {"held": True, "launches": 900, "pass_kernels": None}]
        assert S.pass_kernels_of(summary) == 5100
        assert S.pass_kernels_of([]) is None
    else:
        # the card's clock 1,000 ns behind the host's, drifting 10 ppm
        pairs = (L.ClockPair(0, 1_000, 50), L.ClockPair(10 ** 9, 10 ** 9 + 11_000, 50))
        to_host = S.clock_map(*pairs)
        assert to_host(5 * 10 ** 8) == pytest.approx(5 * 10 ** 8 + 6_000)
        units = S.units(spans)
        due = [u.t0 - 4_000_000 for u in units]          # each started 4 ms late
        out = S.live_metrics(units, due, to_host)
        if metric == "start_lag_ms_p95":
            assert out[metric] == pytest.approx(4.00295)
        else:
            assert out[metric] == pytest.approx(20.0)


def test_coverage_and_gap_labels_of_the_slice():
    assert S.subtract([(0, 10), (20, 30)], [(5, 22), (25, 26)]) == [(0, 5), (22, 25), (26, 30)]
    assert S.covered_share([(0, 10)], [(2, 4), (3, 6)]) == pytest.approx(0.4)
    assert S.covered_share([], [(0, 1)]) is None
    host = [L.Span("process_raw", 0, 100, -1, 0), L.Span("launch", 40, 60, 0, 1)]
    assert S.innermost_first(host) == [("launch", 40, 60), ("process_raw", 0, 100)]
    lead = S.launch_lead([L.Span(UNIT + "frame", 45, 90, -1, 0)], [host[1]], lambda t: t, 0)
    assert lead == {"launches": 1, "min_us": 0.005, "before_launch": 0}
