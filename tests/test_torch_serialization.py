"""The port's persistence formats (``loam_livox_tpu_torch.io.serialization``)
against the JAX package's, on the CPU.

* g2o, pose text and PCD (binary and ascii, with and without
  intensity): the files each package writes from the same seed-made
  arrays are byte-equal, and each package loads the other's with equal
  values.
* Cell-map JSON: the same points inserted into each package's cell map
  give equal `cell_map_to_json` documents: keys, counts, centres and
  each cell's pool points equal (as sets: the order of a cell's points
  in the JAX package's pool follows XLA's sort, which differs between
  XLA configurations); means and eigenvalues within f32 tolerance
  (rtol 1e-4, atol 1e-5: the moments are float32 sums); covariances
  within 1e-4 of their largest entry plus 2e-7 |mean|^2 (the f32 sums
  Σppᵀ − n·mean·meanᵀ cancel), their inverses within 2 max|Icov|^2
  times that, eigenvectors within 4 times that over the gap to the
  nearest other eigenvalue where this bound is under 0.1, up to the
  sign of each column (LAPACK's sign is not fixed across libraries).
  Each package's `load_cell_map_json` reads the
  other's file into an equal map.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.types import PointBatch as JBatch
from loam_livox_tpu.io import serialization as jser
from loam_livox_tpu.map.cell_map import append_cloud as jappend
from loam_livox_tpu.map.cell_map import empty_cell_map as jempty

from loam_livox_tpu_torch.core.types import PointBatch as TBatch
from loam_livox_tpu_torch.io import serialization as tser
from loam_livox_tpu_torch.map.cell_map import append_cloud as tappend
from loam_livox_tpu_torch.map.cell_map import empty_cell_map as tempty

torch.set_num_threads(2)
STAT_TOL = dict(rtol=1e-4, atol=1e-5)
# a pool larger than any cell's points: with more in one frame, the JAX
# package's ring write has duplicate indices, whose winner XLA leaves open
POOL = 64


def graph(seed=0, n=7):
    rng = np.random.default_rng(seed)
    t = rng.normal(scale=5.0, size=(n, 3))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    edges = [{"id_begin": i, "id_end": i + 1, "t": rng.normal(size=3),
              "q_wxyz": q[i] * np.sign(q[i, 0])} for i in range(n - 1)]
    info = np.eye(6)
    info[0, 3] = info[3, 0] = 0.25
    edges.append({"id_begin": n - 1, "id_end": 0, "t": rng.normal(size=3),
                  "q_wxyz": q[0], "info": info})
    return t, q, edges


def cross_write(tmp_path, name, write):
    """``write(module, path)`` with each package; returns the two paths
    after checking that the files are byte-equal."""
    pj, pt = str(tmp_path / f"jax_{name}"), str(tmp_path / f"port_{name}")
    write(jser, pj)
    write(tser, pt)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    return pj, pt


def test_g2o_files_equal_and_cross_load(tmp_path):
    t, q, edges = graph()
    pj, pt = cross_write(tmp_path, "loop.g2o", lambda m, p: m.save_g2o(p, t, q, edges))
    for load, path in ((tser.load_g2o, pj), (jser.load_g2o, pt)):
        t2, q2, e2 = load(path)
        np.testing.assert_allclose(t2, t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q2, q, rtol=0, atol=1e-6)
        assert [(e["id_begin"], e["id_end"]) for e in e2] == \
            [(e["id_begin"], e["id_end"]) for e in edges]
        np.testing.assert_allclose(e2[-1]["info"], edges[-1]["info"])
    a, b = tser.load_g2o(pj), jser.load_g2o(pt)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pose_files_equal_and_cross_load(tmp_path, dtype):
    t, q, _ = graph(1)
    t, q = t.astype(dtype), q.astype(dtype)
    pj, pt = cross_write(tmp_path, "poses.txt", lambda m, p: m.save_poses_txt(p, t, q))
    for load, path in ((tser.load_poses_txt, pj), (jser.load_poses_txt, pt)):
        t2, q2 = load(path)
        np.testing.assert_array_equal(t2, t.astype(np.float64))
        np.testing.assert_array_equal(q2, q.astype(np.float64))


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("with_intensity", [True, False], ids=["intensity", "xyz"])
def test_pcd_files_equal_and_cross_load(tmp_path, binary, with_intensity):
    rng = np.random.default_rng(2)
    xyz = rng.normal(scale=10.0, size=(257, 3)).astype(np.float32)
    inten = rng.uniform(size=257).astype(np.float32) if with_intensity else None
    pj, pt = cross_write(tmp_path, "c.pcd",
                         lambda m, p: m.save_pcd(p, xyz, inten, binary=binary))
    for load, path in ((tser.load_pcd, pj), (jser.load_pcd, pt)):
        x2, i2 = load(path)
        tol = dict(rtol=0, atol=0 if binary else 1e-6)
        np.testing.assert_allclose(x2, xyz, **tol)
        if with_intensity:
            np.testing.assert_allclose(i2, inten, **tol)
        else:
            assert i2 is None


def cloud(seed=0):
    """Points in a few cells: two planes, a line, a dense blob and a
    cell of 3 points (identity moments in the file), and a padded tail."""
    rng = np.random.default_rng(seed)
    plane = np.c_[rng.uniform(0, 3, (300, 2)), 0.02 * rng.normal(size=300)]
    wall = np.c_[rng.uniform(4, 6, 200), 0.02 * rng.normal(size=200) + 5, rng.uniform(0, 2, 200)]
    line = np.c_[np.linspace(-3, -1, 60), 0.01 * rng.normal(size=(60, 2)) + 2]
    blob = rng.normal(scale=0.1, size=(50, 3)) + [7.4, -2.3, 1.1]
    few = rng.normal(scale=0.05, size=(3, 3)) + [9.5, 9.5, 9.5]
    pts = np.concatenate([plane, wall, line, blob, few]).astype(np.float32)
    cap = 1024
    padded = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    padded[:len(pts)], mask[:len(pts)] = pts, True
    return padded, mask


@pytest.fixture(scope="module")
def maps():
    xyz, mask = cloud()
    jm, _ = jappend(jempty(1.0, 256, POOL),
                    JBatch(xyz=jnp.asarray(xyz), time=jnp.zeros(len(xyz)),
                           mask=jnp.asarray(mask)), 10 ** 9, max_new=256)
    tm, _ = tappend(tempty(1.0, 256, POOL, "cpu"),
                    TBatch(xyz=torch.from_numpy(xyz), time=torch.zeros(len(xyz)),
                           mask=torch.from_numpy(mask)), 10 ** 9, max_new=256)
    return jm, tm


def pool_rows(cell):
    """A cell's Pt_vec as its points in row order."""
    rows = np.asarray(cell["Pt_vec"]).reshape(-1, 3)
    return rows[np.lexsort(rows.T[::-1])]


def assert_cells_match(port, ref):
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert a["Pt_num"] == b["Pt_num"] and a["Res"] == b["Res"]
        assert a["Center"] == b["Center"]
        np.testing.assert_array_equal(pool_rows(a), pool_rows(b))
        for key in ("Mean", "Eig_val"):
            np.testing.assert_allclose(a[key], b[key], **STAT_TOL, err_msg=key)
        cov_b, icov_b = np.asarray(b["Cov"]), np.asarray(b["Icov"])
        # f32 moment sums cancel: sum_pp - n mean mean^T keeps ~eps |p|^2
        cov_tol = 1e-4 * np.abs(cov_b).max() + 2e-7 * (1.0 + np.sum(np.square(b["Mean"])))
        np.testing.assert_allclose(a["Cov"], cov_b, rtol=0, atol=cov_tol, err_msg="Cov")
        # the inverse moves by Icov dCov Icov
        np.testing.assert_allclose(a["Icov"], icov_b, rtol=0,
                                   atol=2 * np.abs(icov_b).max() ** 2 * cov_tol, err_msg="Icov")
        # an eigenvector moves by at most the covariance's change over the
        # gap to the nearest other eigenvalue (Davis-Kahan); checked where
        # that bound is small
        va = np.asarray(a["Eig_vec"]).reshape(3, 3)    # rows: eigenvectors
        vb = np.asarray(b["Eig_vec"]).reshape(3, 3)
        lam = np.asarray(b["Eig_val"])
        sign = np.where(np.sum(va * vb, axis=1) < 0, -1.0, 1.0)[:, None]
        for i in range(3):
            gap = min(abs(lam[i] - lam[j]) for j in range(3) if j != i)
            bound = 4 * cov_tol / max(gap, 1e-30)
            if bound < 0.1:
                np.testing.assert_allclose(va[i] * sign[i], vb[i], rtol=0, atol=bound)


def test_cell_map_json_matches_jax(maps):
    jm, tm = maps
    cells_t, cells_j = tser.cell_map_to_json(tm), jser.cell_map_to_json(jm)
    assert_cells_match(cells_t, cells_j)
    assert any(c["Pt_num"] <= 5 for c in cells_t) and any(c["Pt_num"] > 5 for c in cells_t)
    # a selection of cells keeps the document's order
    sel = torch.zeros(tm.capacity, dtype=torch.bool)
    sel[::3] = True
    picked = tser.cell_map_to_json(tm, sel)
    keep = [i for i, v in enumerate(tm.valid().tolist()) if v and sel[i]]
    order = [i for i, v in enumerate(tm.valid().tolist()) if v]
    assert picked == [cells_t[order.index(i)] for i in keep]
    assert tser.cell_map_to_json(None) == []


def test_cell_map_json_cross_loads(maps, tmp_path):
    jm, tm = maps
    pj, pt = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jser.save_cell_map_json(jm, pj) == tser.save_cell_map_json(tm, pt)
    from_jax = tser.load_cell_map_json(pj, capacity=256, pool_size=POOL, device="cpu")
    from_port = jser.load_cell_map_json(pt, capacity=256, pool_size=POOL)
    np.testing.assert_array_equal(from_jax.keys.numpy(), np.asarray(from_port.keys))
    np.testing.assert_array_equal(from_jax.count.numpy(), np.asarray(from_port.count))
    have = np.minimum(from_jax.count.numpy(), POOL).astype(int)
    for i in np.nonzero(from_jax.valid().numpy())[0]:
        a, b = from_jax.pts.numpy()[i, :have[i]], np.asarray(from_port.pts)[i, :have[i]]
        np.testing.assert_array_equal(a[np.lexsort(a.T[::-1])], b[np.lexsort(b.T[::-1])])
    for f in ("sum_p", "sum_pp"):
        np.testing.assert_allclose(getattr(from_jax, f).numpy(),
                                   np.asarray(getattr(from_port, f)), rtol=1e-5, atol=1e-4)
    # the two loaded maps write equal documents
    assert_cells_match(tser.cell_map_to_json(from_jax), jser.cell_map_to_json(from_port))
    empty = str(tmp_path / "empty.json")
    tser.save_cell_map_json(None, empty)
    assert json.load(open(empty)) == [] and \
        int(tser.load_cell_map_json(empty, 8, 4, device="cpu").n_cells()) == 0
