"""frames_per_s: raw frames whose pose completed in a replay window,
over the window's seconds (the window ends with a synchronise): all the
work over all the time, host clock."""


def read(rec):
    if rec.mode != "replay" or rec.seconds <= 0:
        return None
    return rec.frames / rec.seconds
