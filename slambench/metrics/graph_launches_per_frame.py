"""graph_launches_per_frame: the frame program's CUDA graph launches
(`core/accounting.GRAPHS`) over the replay window's raw frames."""


def read(rec):
    if rec.mode != "replay" or rec.frames <= 0 or "graph_launch" not in rec.graphs:
        return None
    return rec.graphs["graph_launch"] / rec.frames
