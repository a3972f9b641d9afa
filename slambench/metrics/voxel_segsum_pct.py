"""voxel_segsum_pct: the share of the card's busy time in the traced
slice of a replay window spent in the voxel filters' segment sums
(index_put_ with accumulate: its sort-based kernels)."""
from slambench.trace import SEGMENT_SUM_KERNELS


def read(rec):
    t = rec.trace
    if rec.mode != "replay" or t is None or t.busy_s <= 0:
        return None
    s = t.op_share_s(SEGMENT_SUM_KERNELS)
    return 100.0 * s / t.busy_s if s > 0 else None
