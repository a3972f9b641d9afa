"""latency_ms_mean: the mean, over every frame of a live window, of (its
pose done on the card, on the host's clock) - (its due time): how stale
the pose is that a controller reads, over all the window's frames."""
import numpy as np


def read(rec):
    if rec.mode != "live" or not rec.latencies_ms:
        return None
    return float(np.mean(np.asarray(rec.latencies_ms, np.float64)))
