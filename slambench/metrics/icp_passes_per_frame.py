"""icp_passes_per_frame: ICP passes over the replay window's raw frames,
the passes being the knn_fused kernel's runs counted on the card, halved
(a corner and a surface search a pass)."""


def read(rec):
    if rec.mode != "replay" or rec.frames <= 0 or rec.knn_runs <= 0:
        return None
    return rec.knn_runs / 2.0 / rec.frames
