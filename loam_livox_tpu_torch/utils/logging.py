"""Observability: multi-stream file logger, tic/toc span timer and the
program's span recorder, the counterpart of
``loam_livox_tpu/utils/logging.py`` and, like it, the equivalents of
`Common_tools::File_logger` (reference:
``include/tools/tools_logger.hpp:113-242``) and `Common_tools::Timer`
(``include/tools/tools_timer.hpp:25-117``).

Same surface the reference exposes:

* named log streams written under one directory — ``mapping.log``,
  ``timer.log``, ``match_buff.log``, ``pcd_log.log``,
  ``loop_closure.log`` (reference laser_mapping.hpp:716-734, 909-910),
* spans keyed by (label, thread-id), dumped as "label: X.XX ms"
  strings (`SpanTimer.tic` / `toc`); the reference's span names are
  reused where the port's work of that name runs ("Frame process",
  "Query points for match", "Pose optimization", "Build kdtree" →
  the matching buffer's rebuild, "Add new frame", "Update buff for
  matching"; reference laser_mapping.hpp:1318-1319 etc.).

`spans`, the module's one `SpanTimer`, is also the program's span
recorder: the pipeline's ``timer`` is this instance, and the ops reach
it as they reach the tallies of `core.accounting`.  It records nothing
until ``spans.on`` is set, which must happen before a pipeline captures
its graphs; off, each span costs one attribute check and places nothing,
so the captured graphs are node for node those of a program without it.

* **Device spans** (``with spans.device(name, tensor):``) on the
  tensor's device.  On a card the block is bracketed by two launches of
  a one-thread stamp kernel (``csrc/graph_cond.cu``: the card's
  globaltimer and the span's tag into a device ring of `RING_RECORDS`
  records, 16 MB); captured into a CUDA graph a stamp is a kernel node
  that records at every replay and never at capture.  The frame work
  runs on one stream, so the ring holds the stamps in execution order
  and `read` rebuilds the nesting from the open / close pairs; one host
  read, after the work.  On the CPU the block's ends are read from
  ``perf_counter_ns`` (CPU ops are synchronous), into a host list of the
  same capacity.  A ring that filled reports the stamps it lost
  (`Recorded.lost`).  Nothing is recorded inside
  `core.accounting.charged_to` (the loop service's work).  The spans and
  where they are placed:

  ==========================  =======================================  ==================
  span                        placed in                                nests in
  ==========================  =======================================  ==================
  ``unit.<kind>``             a frame-program launch's first and last  —
                              nodes (kind: frame, step, heads, chunk,
                              group); the plain program's unit
  ``front end``               `frontend.livox.extract_frame`,          unit
                              `frontend.multi.extract_multi_lidar`,
                              `frontend.velodyne.extract_velodyne_features`
  ``voxel filter``            `ops.voxel.voxel_downsample`             its caller's span
  ``registration set-up``     `runtime.odometry.prepare_step`,         unit
                              `runtime.batched.prepare_group`
  ``ICP pass``                `registration.icp.prepare_registration`  unit
                              's pass (a WHILE body on the card)
  ``Query points for match``  the pass's corner and surface searches   ICP pass
  ``targets``                 `registration.residuals.build_line_      ICP pass
                              targets` / ``build_plane_targets``
  ``Pose optimization``       `registration.gauss_newton.solve_two_    ICP pass
                              phase`
  ``Add new frame``           `runtime.odometry.commit_history`        unit
  ``Build kdtree``            `runtime.odometry.rebuilt_matching`      unit
                              (the SWITCH node's rebuild body)
  ``Update buff for           `runtime.odometry.appended_matching`     unit
  matching``                  (its append body)
  ==========================  =======================================  ==================

* **Host spans** (``with spans.host(name):``): (name, t0, t1, parent)
  on ``perf_counter_ns``, on the frame thread: ``process_raw``,
  ``head_frames`` and ``process_feature_frame`` (`runtime.pipeline`),
  ``copy-up`` (a frame's host arrays to the card), ``load`` (a key's
  static buffers), ``launch`` (a unit's graph launch), ``capture`` (a
  new key), ``schedule`` (the capacity schedule's host read),
  ``flush`` and ``drain``.

`clock_pair` relates the card's globaltimer to ``perf_counter_ns`` (and
to CUDA events), so device and host spans share a clock.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, TextIO

# The reference's instrumented span names (SURVEY.md §5.1)
SPAN_FRAME = "Frame process"
SPAN_QUERY = "Query points for match"
SPAN_POSE_OPT = "Pose optimization"
SPAN_BUILD_TREE = "Build kdtree"
SPAN_ADD_FRAME = "Add new frame"
SPAN_UPDATE_BUFF = "Update buff for matching"
# The port's own device spans (module doc)
SPAN_UNIT = "unit"
SPAN_FRONT_END = "front end"
SPAN_VOXEL = "voxel filter"
SPAN_SETUP = "registration set-up"
SPAN_PASS = "ICP pass"
SPAN_TARGETS = "targets"

#: records of a card's span ring (16 bytes each), and of the CPU's list
RING_RECORDS = 1 << 20


class Span(NamedTuple):
    """One span: ``t0`` / ``t1`` in ns on its clock (the card's
    globaltimer, or ``perf_counter_ns``; ``t1`` is -1 for a span never
    closed), ``parent`` the index of the enclosing span in its list (-1
    at the top) and ``depth`` its nesting (0 at the top)."""
    name: str
    t0: int
    t1: int
    parent: int
    depth: int


class Recorded(NamedTuple):
    """What `SpanTimer.read` returns: the spans in the order they
    opened, the stamps the ring lost, and the stamps that closed no open
    span of their name.  Only a ``complete`` record gives sound times."""
    spans: List[Span]
    lost: int = 0
    broken: int = 0

    @property
    def complete(self) -> bool:
        return self.lost == 0 and self.broken == 0 and all(s.t1 >= 0 for s in self.spans)


class ClockPair(NamedTuple):
    """One reading of the card's globaltimer (``device_ns``) and the
    ``perf_counter_ns`` of the same instant (``host_ns``), within
    ``uncertainty_ns``; ``events`` are CUDA events recorded on the stream
    just before and after the stamp that read the globaltimer (None on
    the CPU)."""
    device_ns: int
    host_ns: int
    uncertainty_ns: int
    events: Optional[tuple] = None

    @property
    def offset_ns(self) -> int:
        """``perf_counter_ns`` minus the globaltimer."""
        return self.host_ns - self.device_ns


def decode(records, names: List[str], lost: int = 0) -> Recorded:
    """Spans from stamps ``(ns, tag)`` in execution order (a tag is a
    name's index shifted left by one, its low bit set on a close)."""
    spans: List[list] = []
    stack: List[int] = []
    broken = 0
    for t, tag in records:
        name = names[tag >> 1]
        if not tag & 1:
            spans.append([name, t, -1, stack[-1] if stack else -1, len(stack)])
            stack.append(len(spans) - 1)
        elif stack and spans[stack[-1]][0] == name:
            spans[stack.pop()][2] = t
        else:
            broken += 1
    return Recorded([Span(*s) for s in spans], lost, broken)


#: the span of a recorder that is off: nothing
_OFF = contextlib.nullcontext()


class _DeviceSpan:
    __slots__ = ("rec", "tag", "dev")

    def __init__(self, rec: "SpanTimer", tag: int, dev):
        self.rec, self.tag, self.dev = rec, tag, dev

    def __enter__(self):
        self.rec._stamp(self.dev, self.tag)

    def __exit__(self, *exc):
        self.rec._stamp(self.dev, self.tag | 1)
        return False


class _HostSpan:
    __slots__ = ("rec", "name", "index")

    def __init__(self, rec: "SpanTimer", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        stack = self.rec._stack()
        self.index = len(self.rec._host)
        self.rec._host.append([self.name, time.perf_counter_ns(), -1,
                               stack[-1] if stack else -1, len(stack)])
        stack.append(self.index)

    def __exit__(self, *exc):
        self.rec._host[self.index][2] = time.perf_counter_ns()
        self.rec._stack().pop()
        return False


class SpanTimer:
    """tic/toc profiler keyed by (label, thread id), and the program's
    span recorder (module doc), off until ``on`` is set."""

    def __init__(self, capacity: int = RING_RECORDS):
        self._start: Dict[tuple, float] = {}
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)
        self._lock = threading.Lock()
        #: record spans (set before a pipeline captures its graphs)
        self.on = False
        #: records a ring (and the CPU's list, and the host spans) keeps
        self.capacity = capacity
        #: stamps launched on a card (under a capture: stamp nodes placed)
        self.stamps = 0
        self._names: List[str] = []
        self._ids: Dict[str, int] = {}
        self._rings: dict = {}          # device -> graph_cond.Ring
        self._clock_rings: dict = {}    # device -> a one-record Ring for clock_pair
        self._cpu: List[tuple] = []     # (perf_counter_ns, tag) of CPU device spans
        self._cpu_stamps = 0
        self._host: List[list] = []     # [name, t0, t1, parent, depth]
        self._host_lost = 0
        self._local = threading.local()

    def _key(self, label: str):
        return (label, threading.get_ident())

    def tic(self, label: str) -> None:
        self._start[self._key(label)] = time.perf_counter()

    def toc(self, label: str) -> float:
        """Elapsed ms since the matching tic (0 if missing)."""
        t0 = self._start.get(self._key(label))
        if t0 is None:
            return 0.0
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self._totals[label] += ms
            self._counts[label] += 1
        return ms

    def toc_string(self, label: str) -> str:
        return f"{label}: {self.toc(label):.3f} ms"

    @contextlib.contextmanager
    def span(self, label: str):
        self.tic(label)
        try:
            yield
        finally:
            self.toc(label)

    def summary(self) -> str:
        with self._lock:
            lines = []
            for label in sorted(self._totals):
                n = self._counts[label]
                tot = self._totals[label]
                lines.append(
                    f"{label}: total {tot:.1f} ms, n={n}, "
                    f"mean {tot / max(n, 1):.3f} ms")
        return "\n".join(lines)

    # ---- the recorder ----------------------------------------------------

    def device(self, name: str, like):
        """A device span ``name`` around the block, on the device of the
        tensor ``like`` (module doc)."""
        if not self.on:
            return _OFF
        from ..core import accounting

        if accounting.charged() is not None or like.device.type not in ("cuda", "cpu"):
            return _OFF
        return _DeviceSpan(self, self.tag(name), like.device)

    def host(self, name: str):
        """A host span ``name`` around the block (module doc)."""
        if not self.on:
            return _OFF
        from ..core import accounting

        if accounting.charged() is not None:
            return _OFF
        if len(self._host) >= self.capacity:
            self._host_lost += 1
            return _OFF
        return _HostSpan(self, name)

    def unit(self, kind: str, device):
        """``(ring, open tag, close tag)`` of a frame-program launch of
        ``kind`` on ``device`` (`ops.graph_cond.build_frame_graph`'s
        ``unit``), or None when off."""
        if not self.on:
            return None
        tag = self.tag(f"{SPAN_UNIT}.{kind}")
        return self.ring(device), tag, tag | 1

    def tag(self, name: str) -> int:
        """The open stamp's tag of ``name`` (its close sets the low bit)."""
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self._names)
            self._names.append(name)
        return i << 1

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _stamp(self, dev, tag: int) -> None:
        if dev.type == "cpu":
            self._cpu_stamps += 1
            if len(self._cpu) < self.capacity:
                self._cpu.append((time.perf_counter_ns(), tag))
            return
        from ..ops import graph_cond

        graph_cond.stamp(self.ring(dev), tag)
        self.stamps += 1

    @staticmethod
    def _card(device):
        import torch

        device = torch.device(device)
        return device if device.index is not None else torch.device(
            "cuda", torch.cuda.current_device())

    def _make_ring(self, rings: dict, device, capacity: int):
        import torch

        from ..ops.graph_cond import Ring

        device = self._card(device)
        ring = rings.get(device)
        if ring is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("spans: a card's ring is made outside any capture: switch "
                                   "the recorder on before the pipeline captures its graphs")
            ring = rings[device] = Ring(
                torch.zeros((capacity, 2), dtype=torch.int64, device=device),
                torch.zeros((), dtype=torch.int64, device=device))
        return ring

    def ring(self, device):
        """The span ring on the card ``device`` (made at its first use,
        which must not fall under a graph capture)."""
        return self._make_ring(self._rings, device, self.capacity)

    def warm(self, device) -> None:
        """With the recorder on: make the ring on the card ``device`` and
        launch the stamp kernel once (its library's first call), before
        any capture, into `clock_pair`'s own one-record ring."""
        if not self.on or device.type != "cuda":
            return
        from ..ops import graph_cond

        self.ring(device)
        graph_cond.stamp(self._make_ring(self._clock_rings, device, 1), 0)

    def reset(self) -> None:
        """Forget every span recorded (each ring's cursor zeroed on the
        current stream, behind the work queued there)."""
        for ring in self._rings.values():
            ring.cursor.zero_()
        self._cpu.clear()
        self._cpu_stamps = 0
        self._host.clear()
        self._host_lost = 0

    def read(self, device) -> Recorded:
        """The device spans recorded on ``device`` since the last `reset`
        (on a card one host read of its ring)."""
        import torch

        device = torch.device(device)
        if device.type == "cpu":
            records, count = list(self._cpu), self._cpu_stamps
        else:
            ring = self._rings.get(self._card(device))
            if ring is None:
                return Recorded([])
            count = int(ring.cursor)
            records = ring.records[:min(count, self.capacity)].cpu().tolist()
        return decode(records, self._names, max(0, count - self.capacity))

    def host_spans(self) -> Recorded:
        """The host spans recorded since the last `reset`, in the order
        they opened (``lost``: those past the capacity)."""
        return Recorded([Span(*s) for s in self._host], self._host_lost)

    def clock_pair(self, device, reps: int = 16) -> ClockPair:
        """The card's globaltimer against ``perf_counter_ns``: after a
        synchronise, a lone stamp launched between two CUDA events and
        two host readings, the one of ``reps`` with the narrowest host
        bracket; the host time is the bracket's middle and the
        uncertainty its half (on the CPU both clocks are one)."""
        import torch

        device = torch.device(device)
        if device.type != "cuda":
            now = time.perf_counter_ns()
            return ClockPair(now, now, 0)
        from ..ops import graph_cond

        device = self._card(device)
        ring = self._make_ring(self._clock_rings, device, 1)
        best = None
        with torch.cuda.device(device):
            for _ in range(reps):
                before = torch.cuda.Event(enable_timing=True)
                after = torch.cuda.Event(enable_timing=True)
                ring.cursor.zero_()
                torch.cuda.synchronize(device)
                h0 = time.perf_counter_ns()
                before.record()
                graph_cond.stamp(ring, 0)
                after.record()
                after.synchronize()
                h1 = time.perf_counter_ns()
                if best is None or h1 - h0 < best[1] - best[0]:
                    best = (h0, h1, int(ring.records[0, 0]), (before, after))
        h0, h1, g, events = best
        return ClockPair(g, (h0 + h1) // 2, (h1 - h0 + 1) // 2, events)


#: the program's one span recorder (module doc)
spans = SpanTimer()


class FileLogger:
    """Named log streams under one directory (lazy-opened).

    ``screen=True`` additionally echoes every line to stdout — the
    analogue of the reference's screen_out path, enabled when
    ``common/if_verbose_screen_printf == 0`` (the reference's semantics
    are inverted: 1 swallows prints, 0 shows them —
    tools_logger.hpp:51-80)."""

    STREAMS = ("mapping", "timer", "match_buff", "pcd_log", "loop_closure")

    def __init__(self, log_dir: Optional[str] = None, screen: bool = False):
        self.log_dir = log_dir
        self.screen = screen
        self._files: Dict[str, TextIO] = {}
        self._lock = threading.Lock()
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)

    def enabled(self) -> bool:
        return self.log_dir is not None or self.screen

    def _stream(self, name: str) -> Optional[TextIO]:
        if not self.log_dir:
            return None
        with self._lock:
            if name not in self._files:
                self._files[name] = open(
                    os.path.join(self.log_dir, f"{name}.log"), "a")
            return self._files[name]

    def write(self, stream: str, msg: str) -> None:
        line = msg.rstrip("\n")
        f = self._stream(stream)
        if f is not None:
            f.write(line + "\n")
            f.flush()
        if self.screen:
            print(f"[{stream}] {line}", flush=True)

    def printf(self, stream: str, fmt: str, *args) -> None:
        self.write(stream, fmt % args if args else fmt)

    def close(self) -> None:
        with self._lock:
            for f in self._files.values():
                f.close()
            self._files.clear()
