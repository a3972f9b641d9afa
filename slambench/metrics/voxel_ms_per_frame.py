"""voxel_ms_per_frame: the device time of the voxel filters a raw frame:
the summed durations of the window's ``voxel filter`` spans (the
program's span recorder, every call site: the sources, the registration
input, the commit and the matching buffer's rebuild under the SWITCH
node) over the window's frames.  A traced run's whole window."""
VOXEL = "voxel filter"


def read(rec):
    r = rec.spans
    if r is None or not r.complete or rec.frames <= 0:
        return None
    ns = sum(s.t1 - s.t0 for s in r.spans if s.name == VOXEL)
    return ns * 1e-6 / rec.frames if ns > 0 else None
