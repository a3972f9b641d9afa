"""Which tally the calling thread's host syncs and kernel launches count
against, and the frame program's graph counters.

The frame path counts into module-level tallies: the host-sync audit
(`runtime.pipeline.host_syncs`) and ``ops.knn_fused.launches``.  The
loop-closure service runs its device work inside ``charged_to(counts)``
with a dict of its own, on its worker thread or inline on the frame
thread, so its syncs and launches never move the frame path's audit.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

_local = threading.local()

#: the frame program's (`runtime.frame_program`) graph launches (one a
#: dispatch unit: a raw frame, a chunk, a racing group, a feature-frame
#: step, or a multi-head frame's front end), captures (one a shape key)
#: and the seconds the captures took, in all and by the key's kind, since
#: the last `runtime.pipeline.reset_host_syncs`
GRAPH_KINDS = ("frame", "chunk", "group", "step", "heads")
GRAPHS = {"graph_launch": 0, "graph_capture": 0, "graph_capture_s": 0.0,
          **{f"{what}_{kind}": 0 for what in ("launch", "capture")
             for kind in GRAPH_KINDS}}


@contextmanager
def charged_to(counts: dict):
    """Count this thread's syncs and launches into ``counts`` inside the
    block."""
    prev = getattr(_local, "counts", None)
    _local.counts = counts
    try:
        yield counts
    finally:
        _local.counts = prev


def charged() -> dict | None:
    """The dict set by the innermost `charged_to` of this thread, if any."""
    return getattr(_local, "counts", None)


def count(default: dict, key: str) -> None:
    """Add one to ``key`` of the charged dict, or else of ``default``."""
    target = charged()
    if target is None:
        target = default
    target[key] = target.get(key, 0) + 1
