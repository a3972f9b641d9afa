"""device_idle_pct.replay: the share of the traced slice of a replay window in
which no operation ran on the card (torch.profiler)."""


def read(rec):
    t = rec.trace
    if rec.mode != "replay" or t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
