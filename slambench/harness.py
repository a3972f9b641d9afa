"""The benchmark's harness: one cell, one process.

    python3 slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix;
each is a data file found by its name (``configs/<name>.json``,
``traffic/<name>.json``), and each metric a reader found by its name
(``metrics/<name>.py``, a function ``read(rec)`` of the run's
`Records`).  A run: make the stream on the card from the seed (set-up),
build the program's pipeline and run the stream's first frames through
it (warm-up: every shape the window uses, every capture), then measure
a fixed amount of work, ``--seconds`` long or capped by it:

* ``replay``: a recording of ``replay_frames`` raw frames (the
  configuration's) mapped back to back, as a recorded survey is mapped
  offline; the host dispatches each frame as soon as the last is
  dispatched, with at most ``in_flight`` frames not yet done, and the
  window closes when the last is done, so every program maps the same
  frames (a run still dispatching when ``--seconds`` have passed makes
  the next frame its last, and its result says ``"capped": true``);
* ``live``: frame k handed over at k / ``rate_hz`` after the window
  opens (open loop), from pinned host memory, where a sensor's
  frames wait; a frame's pose is done when a CUDA event recorded after it
  completes, timed on the card from an event recorded at the window's
  open (no host thread's wake-up in the reading).

A replay window closes after the program's background work too: where
the pipeline has a loop service, the window waits for it to drain (its
queued keyframes processed) before the closing synchronise, so a
recorded survey is mapped when its loop closure is done.  The drain
covers the keyframes of frames already dispatched: a configuration that
buffers raw frames into chunks or racing groups may hold a partial one
at the close, which reaches the service only in the pipeline's flush,
after the window.  A live window
keeps its close at the synchronise after its last frame: its metric is
each frame's staleness, and work left after the last due frame is no
frame's latency.

With ``--trace 1`` the program's span recorder
(``loam_livox_tpu_torch.utils.logging.spans``) records the whole window,
read once after it closes, and a slice of the window runs under
``torch.profiler`` (`trace`): ``trace_frames`` frames from the
traffic's ``trace_after_frames``, counted back from the window's end
where that is negative (a live window's last frames, so that no frame
after the slice waits on the profiler's close).  At the window's close the harness also
keeps what the program's outputs say (`Records.outputs`: the loop
service's counts, the frame program's captures), for metrics to read.
After the window the program's outputs are judged against the plain
reference (`check`), or by the configuration's own check where its file
names one (``"check": "<name>"``: ``checks/<name>.py``, `load_check`),
and one JSON line is printed last.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run of the port may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "loam_livox_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a malformed cell): it
    exits non-zero and prints no result."""


# ---- the manifest and the files it names ---------------------------------

def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"{path} not found")
    return json.loads(path.read_text())


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise BenchError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, bench: Path = HERE) -> dict:
    return json.loads((bench / "configs" / f"{name}.json").read_text())


def load_traffic(name: str, bench: Path = HERE) -> dict:
    return json.loads((bench / "traffic" / f"{name}.json").read_text())


def load_limits(cell: str, bench: Path = HERE) -> dict:
    path = bench / "limits" / f"{cell}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def metrics_of(manifest: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``.  A metric
    with a ``workloads`` key belongs to the cells it lists; one without
    belongs to every cell (per-layer: every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in manifest["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def _load_module(sub: str, name: str, bench: Path):
    """The module ``<sub>/<name>.py`` of the bench, loaded from its file."""
    path = bench / sub / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_{sub}_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench: Path = HERE):
    """``read(rec)`` of ``metrics/<name>.py``."""
    return _load_module("metrics", name, bench).read


def load_check(name: str, bench: Path = HERE):
    """The check module ``checks/<name>.py`` that a configuration names
    (``"check": "<name>"``).  It provides ``judge(cfg_doc, frames, dev,
    rows, per_frame, start, snaps, n_frames_run, kept, control=None) ->
    (checks, window_gaps)``, as `check.judge` with ``kept``; it may
    provide ``to_reference_state(state)`` (applied to every kept state in
    place of `check.to_reference_state`) and ``keep(pipe)`` (called after
    the pipeline's flush, before the program is freed: what it returns
    owns its memory and reaches ``judge`` as ``kept``)."""
    return _load_module("checks", name, bench)


# ---- what a run records ---------------------------------------------------

@dataclass
class Records:
    """What the metrics read, all of the measured window unless named a
    trace's."""
    mode: str                          # "replay" or "live"
    setup_s: float                     # process start to the window's open
    frames: int = 0                    # raw frames of the window
    seconds: float = 0.0               # the window's length (host clock)
    capped: bool = False               # replay: the cap ended the window before its last frame
    latencies_ms: Optional[List[float]] = None   # live: each frame's, due to done
    syncs: Dict[str, int] = field(default_factory=dict)    # host syncs by place
    graphs: Dict[str, float] = field(default_factory=dict)  # graph launches, captures
    knn_runs: int = 0                  # knn_fused runs counted on the card
    trace: Optional[object] = None     # `trace.TraceSlice` of a traced run
    spans: Optional[object] = None     # a traced run's device spans (the recorder's `Recorded`)
    outputs: Dict[str, object] = field(default_factory=dict)  # `program_outputs` at the close


@dataclass
class Snapshot:
    """The program's state around one raw frame of the window (or, for
    the start, after the first frames), kept for the check."""
    frame: int                         # stream index of the frame
    pre: Optional[object] = None       # state before it (the program's OdometryState)
    post: Optional[object] = None      # state after it
    scale: int = 1                     # the schedule's tier before it
    features: Optional[list] = None    # the multi-head pieces it produced


# ---- the program --------------------------------------------------------

class Program:
    """The port's pipeline behind the two entries the window drives:
    `OdometryPipeline.process_raw` (one head) or ``head_frames`` and then
    ``process_feature_frame`` a piece (several heads, as the port's
    ``eval/scenarios.multi_head_frame`` does)."""

    def __init__(self, slam: dict, n_heads: int, device):
        from loam_livox_tpu_torch.core.config import SlamConfig
        from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

        self.cfg = SlamConfig().replace(**slam)
        self.pipe = OdometryPipeline(self.cfg, device=device)
        self.n_heads = n_heads
        self.drain_s: Optional[float] = None   # `drain_background`'s seconds

    def frame(self, xyz, inten, mask, t0: float, keep_features: bool = False):
        """One raw frame: ``xyz`` (S, C, 3), ``inten`` and ``mask`` (S, C)
        on the device.  Returns the multi-head pieces (copied) when asked."""
        pipe = self.pipe
        if self.n_heads == 1:
            pipe.process_raw(xyz[0], inten[0], t0, mask=mask[0])
            return None
        pieces = pipe.head_frames(xyz, inten, mask, t0)
        kept = None
        if keep_features:
            import torch

            kept = [type(p)(*(type(b)(*(torch.clone(x) for x in b))
                              if isinstance(b, tuple) else torch.clone(b) for b in p))
                    for p in pieces]
        for piece in pieces:
            pipe.process_feature_frame(piece)
        return kept

    def scale(self) -> int:
        sched = self.pipe.scheduler
        return 1 if sched is None else int(sched.scale)

    def state(self):
        """A copy of the state (`OdometryPipeline.state`)."""
        return self.pipe.state

    def rows_per_frame(self) -> int:
        from loam_livox_tpu_torch.runtime.pipeline import steps_per_frame

        return steps_per_frame(self.cfg)

    def drain_background(self) -> bool:
        """Wait until the loop service has processed every queued keyframe
        (`LoopCloser.drain`, the call `OdometryPipeline.flush` makes), the
        seconds kept in ``drain_s``; False, at once, without a service.
        A partial chunk or racing group still buffered is not dispatched
        here (`flush` does that): its keyframe is not waited for."""
        closer = self.pipe.loop_closer
        if closer is None:
            return False
        t0 = time.perf_counter()
        closer.drain()
        self.drain_s = time.perf_counter() - t0
        return True


def recorder():
    """The program's span recorder."""
    from loam_livox_tpu_torch.utils.logging import spans

    return spans


def reset_counters() -> None:
    from loam_livox_tpu_torch.ops import knn_fused
    from loam_livox_tpu_torch.runtime.pipeline import reset_host_syncs

    reset_host_syncs()
    knn_fused.runs.reset()
    recorder().reset()


def read_counters(rec: Records) -> None:
    from loam_livox_tpu_torch.ops import knn_fused
    from loam_livox_tpu_torch.runtime.pipeline import graph_counts, host_syncs

    rec.syncs = host_syncs()
    rec.graphs = graph_counts()
    rec.knn_runs = knn_fused.runs.read()


def program_outputs(prog: Program) -> Dict[str, object]:
    """What the program's outputs say at the window's close (host copies):
    ``"loop_service"`` where the pipeline has one (its ``counts`` by
    place, the keyframes processed and still waiting, whether one is in
    work, those dropped from a full waiting list, whether it closed,
    whether a loop was accepted, and ``drain_s``, the replay close's wait
    for it); on the card ``"frame_program"``, `FrameProgram.summary` (a
    dict a captured key: its kind, launches, ``pass_kernels``, ...)."""
    pipe = prog.pipe
    out: Dict[str, object] = {}
    closer = pipe.loop_closer
    if closer is not None:
        result = closer.result
        out["loop_service"] = {
            "counts": dict(closer.counts), "keyframes": len(closer.keyframes),
            "waiting": len(closer.waiting), "busy": closer.busy,
            "dropped_keyframes": closer.dropped_keyframes, "closed": closer.closed,
            "accepted": result is not None and result.accepted,
            "drain_s": prog.drain_s}
    if pipe.program is not None:
        out["frame_program"] = pipe.program.summary()
    return out


# ---- the window ---------------------------------------------------------

class _Done:
    """A frame's completion on the CPU (the tests' device): at once."""

    def synchronize(self) -> None:
        pass


def _mark(dev):
    """An event recorded on the card's current stream (or `_Done`)."""
    import torch

    if dev.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class HostSpans:
    """The harness's own host spans around its calls into the program
    (perf_counter_ns), labelled after the call."""

    def __init__(self):
        self.spans: List[tuple] = []
        self.on = False

    def add(self, label: str, t0: int, t1: int) -> None:
        if self.on:
            self.spans.append((label, t0, t1))


def _dispatch(prog: Program, frames, i: int, spans: HostSpans, dev=None,
              keep_features: bool = False):
    """Frame ``i`` of the stream into the program (copied up first when
    the stream is on the host), under a host span."""
    from loam_livox_tpu_torch.runtime.pipeline import host_syncs

    t0 = time.perf_counter_ns()
    before = host_syncs().get("schedule", 0)
    xyz, inten, mask = frames.xyz[i], frames.inten[i], frames.mask[i]
    if dev is not None:
        xyz, inten, mask = (a.to(dev, non_blocking=True) for a in (xyz, inten, mask))
    kept = prog.frame(xyz, inten, mask, frames.t0[i], keep_features)
    label = "dispatch+schedule_check" if host_syncs().get("schedule", 0) != before else "dispatch"
    spans.add(label, t0, time.perf_counter_ns())
    return kept


class Sampler:
    """Which window frames the check follows, by a position that grows
    frame by frame: a replay window's frame index (so the same frames
    whatever the program's speed), a live window's seconds since the
    open (frame k is due k / rate after it).  The first frame at or after
    each of ``n`` positions drawn from the seed over the first ``reach``
    of ``span``, and the window's last: the frame its window calls final
    (a replay window's last dispatched frame, capped or not), else the
    latest at or past ``span - tail`` (the state the window leaves)."""

    def __init__(self, seed: int, n: int, span: float, tail: float, reach: float = 0.9):
        import numpy as np

        rng = np.random.default_rng([int(seed) % (1 << 63), 7])
        self.marks = sorted(rng.uniform(0.02, reach, n) * span)
        self.last_from = span - tail
        self.snaps: List[Snapshot] = []
        self.last: Optional[Snapshot] = None

    def wants(self, at: float, final: bool = False) -> str:
        due = bool(self.marks) and at >= self.marks[0]
        while self.marks and at >= self.marks[0]:
            self.marks.pop(0)
        if final or (not due and at >= self.last_from):
            return "last"
        return "sample" if due else ""

    def keep(self, kind: str, snap: Snapshot) -> None:
        if kind == "sample":
            self.snaps.append(snap)
        else:
            self.last = snap

    def all(self) -> List[Snapshot]:
        return self.snaps + ([self.last] if self.last is not None else [])


def run_frame(prog: Program, frames, i: int, spans: HostSpans, sampler: Optional[Sampler],
              at: float, dev=None, final: bool = False) -> None:
    """One window frame, at the sampler's position ``at`` (``final``: the
    window's last), its state kept around it where the sampler asks."""
    kind = sampler.wants(at, final) if sampler is not None else ""
    if not kind:
        _dispatch(prog, frames, i, spans, dev)
        return
    snap = Snapshot(frame=i, pre=prog.state(), scale=prog.scale())
    snap.features = _dispatch(prog, frames, i, spans, dev, keep_features=True)
    snap.post = prog.state()
    sampler.keep(kind, snap)


def replay_window(prog: Program, frames, first: int, count: int, seconds: float,
                  in_flight: int, dev, spans: HostSpans, sampler: Optional[Sampler],
                  tracer=None):
    """Raw frames ``first`` .. ``first + count - 1`` back to back, at most
    ``in_flight`` not done; ends, once the program's loop service has
    drained (`Program.drain_background`), with a synchronise after the last.
    ``seconds`` caps the window: the frame dispatched once it has passed
    is the last (the sampler follows it), and the run says so.  The
    sampler's position is the frame's index in the window.  Returns
    (frames, seconds from the open to the closing synchronise, capped)."""
    events: deque = deque()
    k = 0
    capped = False
    waited_ns = 0
    t_open = time.perf_counter()
    while k < count and not capped:
        if tracer is not None:
            tracer.at_frame(k)
        if len(events) >= in_flight:
            t0 = time.perf_counter_ns()
            events.popleft().synchronize()
            t1 = time.perf_counter_ns()
            waited_ns += t1 - t0
            spans.add("wait_in_flight", t0, t1)
        capped = k < count - 1 and time.perf_counter() - t_open >= seconds
        run_frame(prog, frames, first + k, spans, sampler, k, final=capped or k == count - 1)
        events.append(_mark(dev))
        k += 1
    if tracer is not None:
        tracer.at_frame(k, closing=True)
    t0 = time.perf_counter_ns()
    if prog.drain_background():
        spans.add("loop_drain", t0, time.perf_counter_ns())
        print(f"slambench: the loop service drained {prog.drain_s:.3f} s after the last "
              f"frame's dispatch", file=sys.stderr)
    _sync(dev)
    seconds_open = time.perf_counter() - t_open
    print(f"slambench: the host waited {waited_ns * 1e-9:.3f} s of the window's "
          f"{seconds_open:.3f} s on frames in flight", file=sys.stderr)
    if capped:
        print(f"slambench: the window reached its cap of {seconds:g} s after {k} of its "
              f"{count} frames; the rate is over those {k}, and the result says capped",
              file=sys.stderr)
    return k, seconds_open, capped


def units_busy(spans) -> tuple:
    """(busy, extent) seconds of the top-level spans, one a launch of the
    frame program (``unit.<kind>``): their summed durations, and the
    first start to the last end.  Busy well under the extent is the card
    waiting on the host between launches."""
    units = [s for s in spans if s.depth == 0 and s.name.startswith("unit.")]
    if not units:
        return 0.0, 0.0
    busy = sum(s.t1 - s.t0 for s in units)
    return busy * 1e-9, (max(s.t1 for s in units) - min(s.t0 for s in units)) * 1e-9


class DeviceClock:
    """When work queued on the card finished, on the host's clock: events
    with timing, measured from an origin event recorded while the card
    was idle at host time ``t0`` (on the CPU, the host clock at once)."""

    def __init__(self, dev):
        import torch

        self.cuda = dev.type == "cuda"
        self.t0 = time.perf_counter()
        if self.cuda:
            self.origin = torch.cuda.Event(enable_timing=True)
            self.origin.record()

    def mark(self):
        import torch

        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def seconds(self, mark) -> float:
        """The host time at which ``mark``'s work was done (after a
        synchronise)."""
        if not self.cuda:
            return mark
        return self.t0 + self.origin.elapsed_time(mark) * 1e-3


def live_window(prog: Program, frames, first: int, seconds: float, rate_hz: float,
                dev, spans: HostSpans, sampler: Optional[Sampler], tracer=None):
    """Frame k of the window handed over at k / ``rate_hz`` after the
    window opens, ``seconds`` × ``rate_hz`` frames, the stream on the
    host (the card idle when it opens).  Each frame's pose is done when
    an event recorded after it on the card completes (`DeviceClock`);
    the window closes with a synchronise after the last frame, not
    waiting for a loop service (module doc).
    Returns (frames, seconds, latencies ms)."""
    n = int(round(seconds * rate_hz))
    if first + n > frames.xyz.shape[0]:
        raise BenchError(f"the stream holds {frames.xyz.shape[0]} frames; the window "
                         f"needs {first + n}")
    marks = []
    clock = DeviceClock(dev)
    t_open = clock.t0
    due = [t_open + k / rate_hz for k in range(n)]
    for k in range(n):
        if tracer is not None:
            tracer.at_frame(k)
        wait = due[k] - time.perf_counter()
        if wait > 0:
            t0 = time.perf_counter_ns()
            time.sleep(wait)
            spans.add("sensor_wait", t0, time.perf_counter_ns())
        run_frame(prog, frames, first + k, spans, sampler, time.perf_counter() - t_open, dev)
        marks.append(clock.mark())
    if tracer is not None:
        tracer.at_frame(n, closing=True)
    _sync(dev)
    done = [clock.seconds(m) for m in marks]
    lat = [(d - u) * 1e3 for d, u in zip(done, due)]
    return n, max(done) - t_open, lat


# ---- one run --------------------------------------------------------------

def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def env_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / ".slambench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, t_start: float,
             bench: Path = HERE, device: str = "cuda", manifest: Optional[dict] = None,
             limits: Optional[dict] = None, controls: tuple = ()) -> dict:
    """One run of ``cell``; returns the result line's object.  ``device``
    other than "cuda" serves the CPU tests only: nothing is timed there.
    Each of ``controls`` (``judge``'s ``control``) is judged after the
    run's own check, by the same check on the same kept states, its
    numbers under ``"_controls"`` (the control script; the benchmark's
    runs pass none).  ``"_outputs"`` holds `Records.outputs` for the
    tests and probes; `main` prints neither it nor ``"_ate_m"``."""
    import numpy as np
    import torch

    from . import check
    from .gen.stream import Site, make_frames

    cfg_doc = load_config(cell["config"], bench)
    own = load_check(cfg_doc["check"], bench) if "check" in cfg_doc else None
    to_reference_state = getattr(own, "to_reference_state", check.to_reference_state)
    keep = getattr(own, "keep", None)
    traffic = load_traffic(cell["traffic"], bench)
    mode = traffic["mode"]
    site = Site.from_dict(cfg_doc["site"])
    n_heads = len(site.heads_yaw_deg)
    slam = cfg_doc["slam"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if on_card:
        torch.cuda.set_device(dev)

    # set-up: the stream, the pipeline, the warm-up (a traced run records
    # spans: the recorder is on before the pipeline captures its graphs)
    if trace:
        recorder().on = True
    prog = Program(slam, n_heads, dev)
    init = prog.cfg.mapping.init_accumulate_frames
    warmup = int(traffic["warmup_frames"])
    start_frames = min(warmup, init + int(traffic.get("start_registered", 8)))
    if mode == "replay":
        n_window = int(cfg_doc["replay_frames"])
    else:
        n_window = int(round(seconds * float(traffic["rate_hz"])))
    n_stream = warmup + n_window
    cap = prog.cfg.capacity.max_raw_points
    frames = make_frames(site, seed, n_stream, cap, dev)
    host_stream = None
    if mode == "live":
        pin = on_card
        host_stream = frames._replace(**{k: getattr(frames, k).cpu().pin_memory() if pin
                                         else getattr(frames, k).cpu()
                                         for k in ("xyz", "inten", "mask")})
        frames = None
    stream = frames if frames is not None else host_stream
    copy_to = dev if mode == "live" else None
    spans = HostSpans()
    start = Snapshot(frame=start_frames - 1)
    for i in range(warmup):
        if trace and i == warmup - 1:
            # the profiler's first session starts its tracer (slow): here,
            # not in the window
            from .trace import warm_profiler

            with warm_profiler():
                _dispatch(prog, stream, i, spans, copy_to)
        else:
            _dispatch(prog, stream, i, spans, copy_to)
        if i == start_frames - 1:
            start.post = prog.state()
    _sync(dev)
    reset_counters()
    _sync(dev)
    rec = Records(mode=mode, setup_s=time.perf_counter() - t_start)

    # the window
    n_samples = int(traffic.get("check_samples", 6))
    if mode == "replay":
        sampler = Sampler(seed, n_samples, n_window, 0)
    else:
        sampler = Sampler(seed, n_samples, seconds, 0.25)
    tracer = None
    if trace:
        from .trace import Tracer

        after = int(traffic.get("trace_after_frames", 30))
        if after < 0:       # counted back from the window's end
            after = max(0, n_window + after)
        tracer = Tracer(spans, after, int(traffic.get("trace_frames", 8)))
    if mode == "replay":
        rec.frames, rec.seconds, rec.capped = replay_window(
            prog, stream, warmup, n_window, seconds, int(traffic["in_flight"]), dev, spans,
            sampler, tracer)
    else:
        rec.frames, rec.seconds, rec.latencies_ms = live_window(
            prog, stream, warmup, seconds, float(traffic["rate_hz"]), dev, spans, sampler,
            tracer)
    read_counters(rec)
    rec.outputs = program_outputs(prog)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if tracer is not None:
        rec.trace = tracer.result()
    if trace:
        rec.spans = recorder().read(dev)
        recorder().on = False
        if not rec.spans.complete:
            print(f"slambench: the span record is not whole (lost {rec.spans.lost}, broken "
                  f"{rec.spans.broken}): no span metric", file=sys.stderr)
        else:
            busy, extent = units_busy(rec.spans.spans)
            print(f"slambench: the program's units busy {busy:.3f} s of the {extent:.3f} s "
                  f"from the first unit's start to the last's end; window {rec.seconds:.3f} s",
                  file=sys.stderr)

    # the program's outputs; then the program is freed
    prog.pipe.flush()
    kept = keep(prog.pipe) if keep is not None else None
    print(f"slambench: schedule ladder {prog.pipe.ladder}, window syncs {rec.syncs}, "
          f"graphs {rec.graphs}, knn runs {rec.knn_runs}", file=sys.stderr)
    traj = prog.pipe.trajectory
    rows = np.concatenate([np.asarray(traj.times, np.float64)[:, None],
                           traj.positions_array(),
                           np.asarray(traj.quaternions, np.float64).reshape(-1, 4),
                           np.asarray(traj.accepted, np.float64)[:, None]], axis=1)
    per_frame = prog.rows_per_frame()
    snaps = sampler.all()
    for s in snaps:
        s.pre, s.post = to_reference_state(s.pre), to_reference_state(s.post)
    start.post = to_reference_state(start.post)
    n_frames_run = warmup + rec.frames
    if frames is None:
        frames = host_stream
    del prog, sampler
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # the check
    def judge(control=None):
        args = (cfg_doc, frames, dev, rows, per_frame, start, snaps, n_frames_run)
        if own is None:
            return check.judge(*args, control=control)
        return own.judge(*args, kept, control=control)

    ate = check.window_ate(site, rows, warmup * per_frame)
    t_check = time.perf_counter()
    checks, window_gaps = judge()
    print(f"slambench: window {rec.frames} frames in {rec.seconds:.3f} s; the check took "
          f"{time.perf_counter() - t_check:.1f} s over {len(snaps)} window frames",
          file=sys.stderr)
    limits = load_limits(cell["name"], bench) if limits is None else limits
    pose_limit = limits.get("pose_gap_m", 0.0)
    failed = sum(1 for g in window_gaps if not g <= pose_limit)
    correct = True
    for name, value in checks.items():
        lim = limits.get(name)
        if lim is None or not value <= lim:
            correct = False
    result = {
        "correct": bool(correct),
        "attempted": int(rec.frames),
        "failed": int(failed),
        "metrics": {},
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1,
                   "memory_peak_bytes": int(peak)},
    }
    manifest = manifest if manifest is not None else load_manifest(bench.parent)
    for m in metrics_of(manifest, cell["name"], trace):
        value = load_reader(m["name"], bench)(rec)
        if value is not None:
            result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = rec.trace.breakdown()
    if mode == "replay":
        result["capped"] = rec.capped
    result["checks"] = {k: {"value": v if math.isfinite(v) else 1e30, "limit": limits.get(k)}
                        for k, v in checks.items()}
    result["_ate_m"] = ate
    result["_outputs"] = rec.outputs
    if controls:
        result["_controls"] = {c: judge(control=c)[0] for c in controls}
    return result


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    env_caches(ROOT)
    try:
        manifest = load_manifest(ROOT)
        cell = cell_of(manifest, args.workload)
        if importlib.util.find_spec("loam_livox_tpu_torch") is None:
            raise BenchError("the port's package, loam_livox_tpu_torch, is not in this checkout")
        import torch

        if not torch.cuda.is_available():
            raise BenchError("no CUDA device: the benchmark runs on the card only")
        # one process, few threads: the host's other work stays off the
        # frame thread's cores
        torch.set_num_threads(1)
        if torch.cuda.device_count() < int(cell["chips"]):
            raise BenchError(f"{cell['name']} needs {cell['chips']} cards, "
                             f"{torch.cuda.device_count()} present")
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                          manifest=manifest)
    except BenchError as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"slambench: modules loaded that the port must not load: {found}",
              file=sys.stderr)
        return 3
    print(f"slambench: window ATE (aligned, m) {result.pop('_ate_m')}", file=sys.stderr)
    result.pop("_outputs")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
