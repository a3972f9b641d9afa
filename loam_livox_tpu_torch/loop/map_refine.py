"""Post-loop map refinement (reference `Mapping_refine`,
``source/ceres_pose_graph_3d.hpp:367-583``), the counterpart of
``loam_livox_tpu/loop/map_refine.py``.

After a pose-graph solve, every keyframe's world-frame cloud is moved by
its pose correction T_opt · T_ori⁻¹ (reference `refine_pts`,
``:437-452``) and the clouds merge into one corrected map, what the
reference republishes on /pc_aft_loop_closure (``laser_mapping.hpp:
1091-1100``, every 2nd keyframe).  Host-side numpy with the rotation
from `core.se3` on the CPU: a once-a-loop path over host clouds.
The offline rebuild from dump files, `refine_mapping`, reads the JSON
and pose-file formats of ``io/serialization`` (not ported).
"""
from __future__ import annotations

import glob
import json
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import se3


def correction_transform(q_ori, t_ori, q_opt, t_opt) -> Tuple[np.ndarray, np.ndarray]:
    """(R, t) of T_corr = T_opt · T_ori⁻¹ (reference `refine_pts`,
    ceres_pose_graph_3d.hpp:437-452)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    q_corr = se3.quat_multiply(f32(q_opt), se3.quat_conjugate(f32(q_ori)))
    R = se3.quat_to_matrix(q_corr).numpy()
    t = np.asarray(t_opt, np.float32) + se3.quat_rotate(q_corr, -f32(t_ori)).numpy()
    return R, t


def refine_points(xyz: np.ndarray, q_ori, t_ori, q_opt, t_opt) -> np.ndarray:
    """One keyframe's world-frame cloud moved by its pose correction."""
    R, t = correction_transform(q_ori, t_ori, q_opt, t_opt)
    return np.asarray(xyz, np.float32) @ R.T + t


def _merge_downsample(clouds: List[np.ndarray], resolution: float) -> np.ndarray:
    """Concatenation and a centroid voxel filter (no capacity to honour)."""
    if not clouds:
        return np.zeros((0, 3), np.float32)
    pts = np.concatenate(clouds).astype(np.float32)
    if resolution <= 0 or not len(pts):
        return pts
    keys = np.floor(pts / resolution).astype(np.int64)
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv.reshape(-1), pts)
    return (sums / counts[:, None]).astype(np.float32)


def rebuild_corrected_map(clouds: Sequence[np.ndarray],
                          poses_ori: Tuple[np.ndarray, np.ndarray],
                          poses_opt: Tuple[np.ndarray, np.ndarray],
                          stride: int = 2, resolution: float = 0.0) -> np.ndarray:
    """The corrected global map from per-keyframe world-frame clouds.
    ``poses_*`` are (t (N, 3), q_wxyz (N, 4)); ``stride`` is the
    reference's every-2nd-keyframe republish (laser_mapping.hpp:1094)."""
    t_ori, q_ori = poses_ori
    t_opt, q_opt = poses_opt
    n = min(len(clouds), len(t_ori), len(t_opt))
    out = [refine_points(clouds[i], q_ori[i], t_ori[i], q_opt[i], t_opt[i])
           for i in range(0, n, max(1, stride))]
    return _merge_downsample(out, resolution)


def _keyframe_cloud_from_json(path: str) -> np.ndarray:
    """World-frame points of one dumped keyframe: the Pt_vec arrays of
    its cells (reference schema, cell_map_keyframe.hpp:107-162)."""
    with open(path) as f:
        cells = json.load(f)
    parts = [np.asarray(c["Pt_vec"], np.float32).reshape(-1, 3)
             for c in cells if c.get("Pt_vec")]
    if not parts:
        return np.zeros((0, 3), np.float32)
    return np.concatenate(parts)


def refine_mapping(path: str, out_pcd: Optional[str] = None, stride: int = 1,
                   resolution: float = 0.0) -> np.ndarray:
    """The corrected map rebuilt from a dump directory of
    ``keyframe_<frame>.json`` files and ``poses_ori.txt`` /
    ``poses_opm.txt`` (the reference's `refine_mapping` resume path,
    ceres_pose_graph_3d.hpp:502-583).  Returns the points; also writes
    ``out_pcd`` if given."""
    from ..io.serialization import load_poses_txt, save_pcd

    t_ori, q_ori = load_poses_txt(os.path.join(path, "poses_ori.txt"))
    t_opt, q_opt = load_poses_txt(os.path.join(path, "poses_opm.txt"))

    def frame_no(p):
        m = re.search(r"keyframe_(\d+)\.json$", p)
        return int(m.group(1)) if m else -1

    files = sorted(glob.glob(os.path.join(path, "keyframe_*.json")), key=frame_no)
    if not files:
        raise FileNotFoundError(f"no keyframe_*.json dumps in {path}")
    clouds = [_keyframe_cloud_from_json(p) for p in files]
    refined = rebuild_corrected_map(clouds, (t_ori, q_ori), (t_opt, q_opt),
                                    stride=stride, resolution=resolution)
    if out_pcd:
        save_pcd(out_pcd, refined)
    return refined


if __name__ == "__main__":
    #   python -m loam_livox_tpu_torch.loop.map_refine <dump_dir> \
    #       [--out refined.pcd] [--resolution 0.2] [--stride 1]
    import argparse

    p = argparse.ArgumentParser(description="Rebuild the loop-corrected global map from disk dumps")
    p.add_argument("path", help="dump dir: keyframe_*.json + poses_{ori,opm}.txt")
    p.add_argument("--out", default="refined_map.pcd")
    p.add_argument("--resolution", type=float, default=0.0,
                   help="voxel leaf for the merged map (0 = keep all points)")
    p.add_argument("--stride", type=int, default=1)
    a = p.parse_args()
    pts = refine_mapping(a.path, out_pcd=a.out, stride=a.stride, resolution=a.resolution)
    print(f"refined map: {len(pts)} points -> {a.out}")
