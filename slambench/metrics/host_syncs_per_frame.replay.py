"""host_syncs_per_frame.replay: the program's host syncs over the replay window
(every place of its audit, `runtime/pipeline.host_syncs`), a raw frame."""


def read(rec):
    if rec.mode != "replay" or rec.frames <= 0:
        return None
    return sum(rec.syncs.values()) / rec.frames
