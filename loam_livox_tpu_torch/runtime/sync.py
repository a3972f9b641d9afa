"""Stream synchronization — the `Data_pair` equivalent (reference:

A copy of ``loam_livox_tpu/runtime/sync.py`` (numpy only; the port
imports nothing of the JAX package).
``laser_mapping.hpp:89-120, 749-780``).

The reference's mapping node receives corner / surface / full clouds on
three separate topics and admits a frame into the work queue only once
all three with the same header stamp have arrived.  The in-process
pipeline doesn't need this (the front-end hands over complete
`FeatureFrame`s), but streaming integrations that deliver the three
clouds independently (e.g. replaying recorded per-topic dumps) do.

Also reproduces the queue-overflow drop policy
(`mapping/maximum_mapping_buffer`, reference :1697-1707).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np


class FrameAssembler:
    """Joins per-stamp corner/surface/full clouds into complete frames."""

    CORNER, SURFACE, FULL = "corner", "surface", "full"

    def __init__(self, max_buffer: int = 20000000):
        self._pending: "OrderedDict[float, Dict[str, np.ndarray]]" = OrderedDict()
        self._ready: List[Tuple[float, Dict[str, np.ndarray]]] = []
        self.max_buffer = max_buffer
        self.dropped = 0

    @classmethod
    def from_config(cls, cfg) -> "FrameAssembler":
        """Queue capacity from ``mapping/maximum_mapping_buffer``
        (reference: the drop-oldest bound on the mapping work queue,
        laser_mapping.hpp:1697-1707; realtime profile ships 50)."""
        return cls(max_buffer=int(cfg.mapping.maximum_mapping_buffer))

    def add(self, kind: str, stamp: float, xyz: np.ndarray,
            time: Optional[np.ndarray] = None) -> None:
        assert kind in (self.CORNER, self.SURFACE, self.FULL)
        slot = self._pending.setdefault(round(float(stamp), 6), {})
        slot[kind] = xyz if time is None else (xyz, time)
        if len(slot) == 3:
            key = round(float(stamp), 6)
            self._ready.append((key, self._pending.pop(key)))
            # drop-oldest beyond the buffer (reference :1702-1707)
            while len(self._ready) > self.max_buffer:
                self._ready.pop(0)
                self.dropped += 1

    def pop(self):
        """(stamp, {corner, surface, full}) of the oldest complete
        frame, or None."""
        if not self._ready:
            return None
        return self._ready.pop(0)

    def pending_count(self) -> int:
        return len(self._pending)
