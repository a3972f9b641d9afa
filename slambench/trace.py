"""The traced slice of a window: ``torch.profiler`` over a run of
consecutive frames, reduced to the device's busy time (the union of its
operations' intervals), each operation's time by name, and the idle
gaps labelled by the harness's host span that covers each.

The profiler's CUPTI records do not hold the kernels that run inside a
CUDA graph's conditional (WHILE and SWITCH) bodies, which is where the
frame program runs its ICP passes.  So the slice also brackets each
frame-graph launch with two CUDA events (the program's
``ops.graph_cond.FrameGraph.launch`` wrapped for the slice only): a
launch's interval is busy time, and the busy time no recorded operation
covers is reported as one operation, `UNTRACED`.

The slice opens ``after`` frames into the window, after a synchronise,
and closes ``count`` frames later (or when the window closes) after
another.  It keeps which window frames it covered (`TraceSlice.frames`):
their latencies carry the profiler's cost.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import torch

#: the name of the busy time inside graph launches that no recorded
#: operation covers (the kernels of the conditional bodies)
UNTRACED = "frame graph: kernels in conditional bodies (not recorded one by one)"


@dataclass
class TraceSlice:
    busy_s: float                  # device busy time inside the slice
    window_s: float                # the slice's length
    op_s: Dict[str, float] = field(default_factory=dict)   # operation name -> seconds
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest idle gaps
    frames: Tuple[int, int] = (0, 0)   # the window frames it covered, first and past the last

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _clip(intervals, lo: int, hi: int):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def reduce_events(events, open_ns: int, close_ns: int, host_spans, offset_ns: int,
                  launches=()):
    """``(busy_s, op_s, gaps)`` of the device events and graph launches
    ((start, end)) inside [open_ns, close_ns] (the profiler's clock);
    ``host_spans`` are (label, t0, t1) on the host clock, ``offset_ns``
    the profiler's clock minus the host's."""
    ivs = []
    op_s: Dict[str, float] = {}
    for name, a, b in events:
        a, b = max(a, open_ns), min(b, close_ns)
        if b <= a:
            continue
        ivs.append((a, b))
        op_s[name] = op_s.get(name, 0.0) + (b - a) * 1e-9
    recorded_s = sum(b - a for a, b in _union(ivs)) * 1e-9
    busy = _union(ivs + _clip(launches, open_ns, close_ns))
    busy_s = sum(b - a for a, b in busy) * 1e-9
    if busy_s > recorded_s:
        op_s[UNTRACED] = busy_s - recorded_s
    holes = []
    cur = open_ns
    for a, b in busy:
        if a > cur:
            holes.append((cur, a))
        cur = max(cur, b)
    if close_ns > cur:
        holes.append((cur, close_ns))
    holes.sort(key=lambda h: h[0] - h[1])
    spans = [(lbl, t0 + offset_ns, t1 + offset_ns) for lbl, t0, t1 in host_spans]
    gaps = []
    for a, b in holes[:10]:
        mid = (a + b) // 2
        label = next((lbl for lbl, t0, t1 in spans if t0 <= mid <= t1), "harness")
        gaps.append((label, (b - a) * 1e-9))
    return busy_s, op_s, gaps


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation that ran on the card:
    kernels, copies and fills, not the annotations of host ranges."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = getattr(e, "activity_type", None)
        if (e.is_user_annotation() or e.name().startswith("slambench.")
                or (kind is not None and "annotation" in str(kind()).lower())):
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def _marker(prof, name: str) -> int:
    for e in prof.profiler.kineto_results.events():
        if e.name() == name:
            return e.start_ns()
    raise RuntimeError(f"the profile holds no {name} marker")


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def warm_profiler():
    """A profiler session whose records are dropped (set-up of a traced
    run, so that the slice's session starts warm)."""
    return torch.profiler.profile(activities=_activities())


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class LaunchClock:
    """CUDA events around each frame-graph launch while it is installed."""

    def __init__(self):
        self.pairs: List[tuple] = []
        self._orig = None

    def install(self) -> None:
        from loam_livox_tpu_torch.ops import graph_cond

        cls, orig, pairs = graph_cond.FrameGraph, graph_cond.FrameGraph.launch, self.pairs

        def launch(graph) -> None:
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            orig(graph)
            b.record()
            pairs.append((a, b))

        self._cls, self._orig = cls, orig
        cls.launch = launch

    def remove(self) -> None:
        if self._orig is not None:
            self._cls.launch = self._orig
            self._orig = None

    def intervals(self, origin, origin_ns: int) -> List[Tuple[int, int]]:
        """Each launch's (start, end) on the profiler's clock, from its
        events' distance to ``origin``, an event recorded on an idle card
        at ``origin_ns``."""
        return [(origin_ns + int(origin.elapsed_time(a) * 1e6),
                 origin_ns + int(origin.elapsed_time(b) * 1e6)) for a, b in self.pairs]


class Tracer:
    """Opens and closes the profiler around a slice of the window
    (`harness.replay_window`, `harness.live_window` call `at_frame`)."""

    def __init__(self, spans, after: int, count: int):
        self.spans = spans
        self.after = after
        self.count = count
        self.prof = None
        self.closed = False
        self.clock = LaunchClock() if torch.cuda.is_available() else None

    def at_frame(self, k: int, closing: bool = False) -> None:
        if self.closed:
            return
        if self.prof is None:
            if closing or k < self.after:
                return
            _sync()
            self.k0 = k
            self.prof = torch.profiler.profile(activities=_activities())
            self.prof.__enter__()
            with torch.profiler.record_function("slambench.slice_open"):
                self.open_host = time.perf_counter_ns()
                if self.clock is not None:
                    self.origin = torch.cuda.Event(enable_timing=True)
                    self.origin.record()
                    self.clock.install()
            self.spans.on = True
            return
        if closing or k >= self.k0 + self.count:
            self.k1 = k
            _sync()
            with torch.profiler.record_function("slambench.slice_close"):
                pass
            self.spans.on = False
            if self.clock is not None:
                self.clock.remove()
            self.prof.__exit__(None, None, None)
            self.closed = True

    def result(self) -> TraceSlice | None:
        if self.prof is None or not self.closed:
            return None
        open_ns = _marker(self.prof, "slambench.slice_open")
        close_ns = _marker(self.prof, "slambench.slice_close")
        offset = open_ns - self.open_host
        launches = (self.clock.intervals(self.origin, open_ns)
                    if self.clock is not None else [])
        busy_s, op_s, gaps = reduce_events(_device_events(self.prof), open_ns, close_ns,
                                           self.spans.spans, offset, launches)
        return TraceSlice(busy_s=busy_s, window_s=(close_ns - open_ns) * 1e-9,
                          op_s=op_s, gaps=gaps, frames=(self.k0, self.k1))
