"""device_ms_per_pass: the mean device time of one ICP pass: the
duration of the window's ``ICP pass`` spans (the program's span
recorder, one around every pass: a WHILE body on the card), averaged.
A traced run's whole window."""
PASS = "ICP pass"


def read(rec):
    r = rec.spans
    if r is None or not r.complete:
        return None
    ns = [s.t1 - s.t0 for s in r.spans if s.name == PASS]
    return sum(ns) * 1e-6 / len(ns) if ns else None
