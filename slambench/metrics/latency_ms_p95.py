"""latency_ms_p95: the 95th percentile, over every frame of a live
window, of (its pose done on the card, on the host's clock) - (its due
time)."""
import numpy as np


def read(rec):
    if rec.mode != "live" or not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms, np.float64), 95))
