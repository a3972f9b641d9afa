"""latency_ms_p50: the median of the live window's per-frame latencies
(`latency_ms_mean`'s samples)."""
import numpy as np


def read(rec):
    if rec.mode != "live" or not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms, np.float64), 50))
