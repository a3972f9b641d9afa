"""device_idle_pct.live: the share of the traced slice of a live window in
which no operation ran on the card (torch.profiler)."""


def read(rec):
    t = rec.trace
    if rec.mode != "live" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
