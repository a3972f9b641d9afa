"""device_ms_per_pass: the card's busy time in the traced slice of a
replay window over the ICP passes in it (the pass's small kernels, and
the front end and commit, which the slice cannot yet tell apart)."""


def read(rec):
    t = rec.trace
    if rec.mode != "replay" or t is None or t.passes <= 0:
        return None
    return 1e3 * t.busy_s / t.passes
