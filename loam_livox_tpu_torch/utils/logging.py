"""Observability: multi-stream file logger + tic/toc span profiler, the
counterpart of ``loam_livox_tpu/utils/logging.py`` and, like it, the
equivalents of `Common_tools::File_logger` (reference:
``include/tools/tools_logger.hpp:113-242``) and `Common_tools::Timer`
(``include/tools/tools_timer.hpp:25-117``).

Same surface the reference exposes:

* named log streams written under one directory — ``mapping.log``,
  ``timer.log``, ``match_buff.log``, ``pcd_log.log``,
  ``loop_closure.log`` (reference laser_mapping.hpp:716-734, 909-910),
* spans keyed by (label, thread-id), dumped as "label: X.XX ms"
  strings — the reference's span names are reused verbatim ("Frame
  process", "Query points for match", "Wait sync", "Pose optimization",
  "Build kdtree" → buffer/grid build, "Add new frame", "Update buff for
  matching", "New keyframe", "Find loop"; reference
  laser_mapping.hpp:1318-1319 etc.),
* a `torch.profiler` hook for device-side traces (`device_trace`).

Host-side by design: logging is I/O, not compute.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional, TextIO

# The reference's instrumented span names (SURVEY.md §5.1)
SPAN_FRAME = "Frame process"
SPAN_QUERY = "Query points for match"
SPAN_WAIT_SYNC = "Wait sync"
SPAN_POSE_OPT = "Pose optimization"
SPAN_BUILD_TREE = "Build kdtree"
SPAN_ADD_FRAME = "Add new frame"
SPAN_UPDATE_BUFF = "Update buff for matching"
SPAN_NEW_KEYFRAME = "New keyframe"
SPAN_FIND_LOOP = "Find loop"


class SpanTimer:
    """tic/toc profiler keyed by (label, thread id)."""

    def __init__(self):
        self._start: Dict[tuple, float] = {}
        self._totals = defaultdict(float)
        self._counts = defaultdict(int)
        self._lock = threading.Lock()

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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block, the CPU's activity and, where
    a card is present, its kernels, written as a Chrome trace
    ``<log_dir>/torch_trace.json`` (a no-op when log_dir is None)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "torch_trace.json"))
