"""Reference-compatible persistence: cell-map JSON, PCD clouds, g2o
pose graphs and pose text files, the counterpart of
``loam_livox_tpu/io/serialization.py`` (the reference's
checkpoint/resume surface):

* cell map <-> JSON (reference `Points_cloud_cell::to_json_string`
  ``cell_map_keyframe.hpp:107-162``, `save_to_file` /
  `load_mapping_from_file` ``:818-914``): the same field names
  (Pt_num/Res/Center/Mean/Cov/Icov/Eig_vec/Eig_val/Pt_vec), so a map
  written by either package, or by the reference, loads in the others;
* g2o VERTEX_SE3:QUAT / EDGE_SE3:QUAT with identity information
  (reference `save_edge_and_vertex_to_g2o` ``scene_alignment.hpp:132-212``,
  `G2O_reader` ``ceres_pose_graph_3d.hpp:93-167``);
* pose text files "id px py pz qx qy qz qw" (reference `OutputPoses`
  ``ceres_pose_graph_3d.hpp:259-278``);
* minimal PCD (ascii / binary float32) for cloud dumps.

The g2o, pose and PCD functions are copies of the JAX module's (numpy);
the two cell-map functions read and build the port's `CellMap`.  Files
written from the same arrays are byte-equal in both packages.  Host
side on purpose: this is the I/O boundary, not the compute path.
"""
from __future__ import annotations

import json
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.types import PointBatch, resolve_device
from ..map.cell_map import CellMap, append_cloud, cell_features, empty_cell_map, point_keys


# --------------------------------------------------------------------------
# Cell map JSON
# --------------------------------------------------------------------------

def cell_map_to_json(m: Optional[CellMap], select: Optional[torch.Tensor] = None
                     ) -> List[dict]:
    """CellMap -> list of reference-format cell dicts, of the cells in
    ``select`` ((C,) bool) if given.  ``None`` (the port's placeholder
    where the JAX package keeps a 1-slot map that no cell ever enters)
    gives the empty list, as that map does."""
    if m is None:
        return []
    feats = cell_features(m)
    C, P = m.capacity, m.pool_size
    # one transfer to the host (the loop service counts it as one read)
    keep = m.valid() if select is None else m.valid() & select
    host = torch.cat([t.reshape(C, -1).to(torch.float32) for t in (
        keep, m.count, m.centers(), feats.mean, feats.cov, feats.eig_val, feats.eig_vec,
        m.pts)], dim=1).cpu().numpy()
    cols = np.cumsum([0, 1, 1, 3, 3, 9, 3, 9, 3 * P])
    valid, count, centers, mean, cov, eig_val, eig_vec, pts = (
        host[:, a:b] for a, b in zip(cols[:-1], cols[1:]))
    valid, count = valid[:, 0] > 0, count[:, 0]
    cov, eig_vec, pts = cov.reshape(C, 3, 3), eig_vec.reshape(C, 3, 3), pts.reshape(C, P, 3)
    pool = m.pool_size
    cell_size = float(m.cell_size)

    out = []
    eye = np.eye(3)
    for i in np.nonzero(valid)[0]:
        n = int(count[i])
        have = min(n, pool)
        cell = {
            # reference invariant: Pt_num == the points serialized in
            # Pt_vec (load_mapping_from_file, cell_map_keyframe.hpp:899-907);
            # the exact full-count moments stay in Mean / Cov
            "Pt_num": have,
            "Res": cell_size,
            "Center": centers[i].tolist(),
            "Mean": mean[i].tolist(),
        }
        if n > 5:
            c = cov[i]
            try:
                ic = np.linalg.inv(c)
            except np.linalg.LinAlgError:
                ic = eye
            cell["Cov"] = c.flatten().tolist()
            cell["Icov"] = ic.flatten().tolist()
            # Eigen reads matrices column-major (tools_json.hpp:28)
            cell["Eig_vec"] = eig_vec[i].T.flatten().tolist()
            cell["Eig_val"] = eig_val[i].tolist()
        else:
            cell["Cov"] = eye.flatten().tolist()
            cell["Icov"] = eye.flatten().tolist()
            cell["Eig_vec"] = eye.flatten().tolist()
            cell["Eig_val"] = [1.0, 1.0, 1.0]
        cell["Pt_vec"] = np.round(pts[i, :have].flatten(), 3).tolist()
        out.append(cell)
    return out


def save_cell_map_json(m: Optional[CellMap], path: str) -> int:
    cells = cell_map_to_json(m)
    with open(path, "w") as f:
        json.dump(cells, f)
    return len(cells)


def load_cell_map_json(path: str, capacity: int = 8192, pool_size: int = 32,
                       device=None) -> CellMap:
    """JSON -> CellMap on ``device`` (the card unless the CPU is asked
    for).  Reads files written by either
    package or by the reference (same schema).  The directory and pools
    come from Pt_vec (cut to ``pool_size``) through `append_cloud`; the
    moments are then set from Pt_num / Mean / Cov."""
    device = resolve_device(device)
    with open(path) as f:
        cells = json.load(f)
    if not cells:
        return empty_cell_map(1.0, capacity, pool_size, device)
    if len(cells) > capacity:
        warnings.warn(
            f"cell-map JSON has {len(cells)} cells > capacity {capacity}; "
            "excess cells are dropped: raise `capacity` to load all")
    m = empty_cell_map(float(cells[0]["Res"]), capacity, pool_size, device)

    # every cell's pool points in one cloud, so the directory forms in one pass
    all_pts = []
    for c in cells:
        pv = np.asarray(c.get("Pt_vec", []), np.float32).reshape(-1, 3)
        if len(pv) == 0:
            pv = np.asarray([c["Mean"]], np.float32)
        all_pts.append(pv[:pool_size])
    flat = np.concatenate(all_pts)
    cap_pts = max(1, 1 << int(np.ceil(np.log2(max(len(flat), 2)))))
    padded = np.zeros((cap_pts, 3), np.float32)
    mask = np.zeros((cap_pts,), bool)
    padded[:len(flat)] = flat
    mask[:len(flat)] = True
    batch = PointBatch(xyz=torch.from_numpy(padded).to(device),
                       time=torch.zeros(cap_pts, device=device),
                       mask=torch.from_numpy(mask).to(device))
    m, _ = append_cloud(m, batch, 10 ** 9, max_new=capacity)

    # the recorded moments in place of the pools' own
    centers = np.asarray([c["Center"] for c in cells], np.float32)
    keys = point_keys(m, torch.from_numpy(centers).to(device),
                      torch.ones(len(cells), dtype=torch.bool, device=device)).cpu().numpy()
    keys_np = m.keys.cpu().numpy()
    count = m.count.cpu().numpy().copy()
    sum_p = m.sum_p.cpu().numpy().copy()
    sum_pp = m.sum_pp.cpu().numpy().copy()
    for c, key in zip(cells, keys):
        slot = int(np.searchsorted(keys_np, key))
        if slot >= len(keys_np) or keys_np[slot] != key:
            continue
        n = float(c["Pt_num"])
        mean = np.asarray(c["Mean"], np.float64)
        cov = np.asarray(c["Cov"], np.float64).reshape(3, 3)
        count[slot] = n
        sum_p[slot] = (mean * n).astype(np.float32)
        sum_pp[slot] = (cov * max(n - 1.0, 1.0) + n * np.outer(mean, mean)).astype(np.float32)
    return m._replace(count=torch.from_numpy(count).to(device),
                      sum_p=torch.from_numpy(sum_p).to(device),
                      sum_pp=torch.from_numpy(sum_pp).to(device))


# --------------------------------------------------------------------------
# g2o
# --------------------------------------------------------------------------

def save_g2o(path: str, poses_t: np.ndarray, poses_q_wxyz: np.ndarray,
             edges: List[dict]) -> None:
    """Write VERTEX_SE3:QUAT / EDGE_SE3:QUAT lines (quaternion order in
    the file is x y z w, like the reference / g2o convention).

    edges: dicts with id_begin, id_end, t (3,), q_wxyz (4,), and
    optional 'info' (6, 6)."""
    with open(path, "w") as f:
        for i in range(len(poses_t)):
            p = poses_t[i]
            q = poses_q_wxyz[i]
            f.write(f"VERTEX_SE3:QUAT {i} {p[0]:f} {p[1]:f} {p[2]:f} "
                    f"{q[1]:f} {q[2]:f} {q[3]:f} {q[0]:f}\n")
        for e in edges:
            p = e["t"]
            q = e["q_wxyz"]
            f.write(f"EDGE_SE3:QUAT {e['id_begin']} {e['id_end']} "
                    f"{p[0]:f} {p[1]:f} {p[2]:f} "
                    f"{q[1]:f} {q[2]:f} {q[3]:f} {q[0]:f}")
            info = e.get("info", np.eye(6))
            for c in range(6):
                for r in range(c, 6):
                    f.write(f" {info[c, r]:f}")
            f.write("\n")


def load_g2o(path: str):
    """Read a g2o file → (poses_t (N,3), poses_q_wxyz (N,4), edges)."""
    poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    edges: List[dict] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                i = int(parts[1])
                x, y, z, qx, qy, qz, qw = map(float, parts[2:9])
                poses[i] = (np.array([x, y, z]),
                            np.array([qw, qx, qy, qz]))
            elif parts[0] == "EDGE_SE3:QUAT":
                ib, ie = int(parts[1]), int(parts[2])
                x, y, z, qx, qy, qz, qw = map(float, parts[3:10])
                vals = list(map(float, parts[10:]))
                info = np.eye(6)
                k = 0
                for c in range(6):
                    for r in range(c, 6):
                        if k < len(vals):
                            info[c, r] = info[r, c] = vals[k]
                        k += 1
                edges.append({"id_begin": ib, "id_end": ie,
                              "t": np.array([x, y, z]),
                              "q_wxyz": np.array([qw, qx, qy, qz]),
                              "info": info})
    n = max(poses) + 1 if poses else 0
    t = np.zeros((n, 3))
    q = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    for i, (p, qq) in poses.items():
        t[i] = p
        q[i] = qq
    return t, q, edges


# --------------------------------------------------------------------------
# Pose text files (reference OutputPoses: "id px py pz qx qy qz qw")
# --------------------------------------------------------------------------

def save_poses_txt(path: str, poses_t: np.ndarray,
                   poses_q_wxyz: np.ndarray) -> None:
    with open(path, "w") as f:
        for i in range(len(poses_t)):
            p = poses_t[i]
            q = poses_q_wxyz[i]
            f.write(f"{i} {p[0]} {p[1]} {p[2]} "
                    f"{q[1]} {q[2]} {q[3]} {q[0]}\n")


def load_poses_txt(path: str):
    ts, qs = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8:
                continue
            x, y, z, qx, qy, qz, qw = map(float, parts[1:8])
            ts.append([x, y, z])
            qs.append([qw, qx, qy, qz])
    return np.asarray(ts), np.asarray(qs)


# --------------------------------------------------------------------------
# PCD
# --------------------------------------------------------------------------

def save_pcd(path: str, xyz: np.ndarray,
             intensity: Optional[np.ndarray] = None,
             binary: bool = True) -> None:
    n = len(xyz)
    fields = "x y z" + (" intensity" if intensity is not None else "")
    count = "1 1 1" + (" 1" if intensity is not None else "")
    size = "4 4 4" + (" 4" if intensity is not None else "")
    types = "F F F" + (" F" if intensity is not None else "")
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {fields}\n"
        f"SIZE {size}\n"
        f"TYPE {types}\n"
        f"COUNT {count}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    cols = [np.asarray(xyz, np.float32)]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32)[:, None])
    data = np.concatenate(cols, axis=1)
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode())
            f.write(data.astype("<f4").tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for row in data:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def load_pcd(path: str):
    """Returns (xyz (N,3), intensity (N,) or None).  Supports the
    ascii/binary float32 layouts this module writes plus PCL's default
    xyz[i] dumps."""
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.find(b"DATA ")
    line_end = raw.find(b"\n", header_end)
    header = raw[: line_end].decode(errors="replace")
    body = raw[line_end + 1:]
    fields, n, mode = [], 0, "ascii"
    for line in header.splitlines():
        if line.startswith("FIELDS"):
            fields = line.split()[1:]
        elif line.startswith("POINTS"):
            n = int(line.split()[1])
        elif line.startswith("DATA"):
            mode = line.split()[1]
    k = len(fields)
    if mode == "binary":
        data = np.frombuffer(body[: n * k * 4], dtype="<f4").reshape(n, k)
    elif body:
        data = np.asarray(body.decode().split(), np.float32).reshape(n, k)
    else:
        data = np.zeros((0, k), np.float32)
    xyz = data[:, :3].astype(np.float32)
    inten = None
    if "intensity" in fields:
        inten = data[:, fields.index("intensity")].astype(np.float32)
    return xyz, inten
