"""frames_per_s: the raw frames of a replay window over its seconds: the
window maps the configuration's fixed recording (``replay_frames``) and
ends with a synchronise after its last frame, so this is the inverse of
the time to map the recording; all the work over all the time, host
clock."""


def read(rec):
    if rec.mode != "replay" or rec.seconds <= 0:
        return None
    return rec.frames / rec.seconds
