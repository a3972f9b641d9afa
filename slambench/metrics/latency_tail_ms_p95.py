"""latency_tail_ms_p95: the 95th percentile, over the frames of a live
window, of (its pose done on the card, on the host's clock) - (its due
time): the tail of `latency_ms_mean`'s samples, a few heavy frames.  The
frames of the profiled slice (`trace.TraceSlice.frames`, the window's
last in a live cell) are left out: their latencies carry the profiler's
cost."""
import numpy as np


def read(rec):
    if rec.mode != "live" or not rec.latencies_ms:
        return None
    lat = list(rec.latencies_ms)
    if rec.trace is not None:
        k0, k1 = rec.trace.frames
        lat = lat[:k0] + lat[k1:]
    return float(np.percentile(np.asarray(lat, np.float64), 95)) if lat else None
