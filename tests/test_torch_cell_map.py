"""The port's cell map (``loam_livox_tpu_torch.map.cell_map``) against
the JAX package's on the CPU.

Sequences of point batches, made with numpy from fixed seeds, go into
both maps through ``append_cloud``.  After every append the directory,
counts, update and creation frames, the touched-cell mask and the point
pools must be equal; the moment sums agree within rtol 1e-6 / atol
1e-5 (f32 sums of ≤ a few hundred products of ±10 m coordinates; both
packages sum each cell in input order, so they are equal in practice).
The cases drive every branch of the merge: more points than the pool
into one cell in one frame, more new cells than ``max_new``, directory
overflow, revisit resets, and masked and padded points.

The radius, field-of-view and gather selections must be equal away
from their boundaries (cells within 1e-4 m or 1e-4 of the cosine gate
are left out).  ``cell_features``, with both ``incremental`` settings:
means, covariances and eigenvalues within 1e-5 (the port's ``eigh``
and XLA's differ in round-off), classes equal where no eigenvalue ratio
lies within 1e-3 of its threshold, directions equal up to sign within
1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.types import PointBatch as JBatch
from loam_livox_tpu.map import cell_map as jcm

from loam_livox_tpu_torch.core.types import PointBatch as TBatch
from loam_livox_tpu_torch.interop import CELL_MAP_ARRAYS, cell_map_from_numpy
from loam_livox_tpu_torch.map import cell_map as tcm

torch.set_num_threads(2)
MOMENT_TOL = dict(rtol=1e-6, atol=1e-5)
FEATURE_TOL = dict(rtol=0, atol=1e-5)


def batches(xyz, mask):
    xyz = np.asarray(xyz, np.float32)
    mask = np.asarray(mask, bool)
    time = np.zeros(len(xyz), np.float32)
    return (JBatch(jnp.asarray(xyz), jnp.asarray(time), jnp.asarray(mask)),
            TBatch(torch.from_numpy(xyz), torch.from_numpy(time), torch.from_numpy(mask)))


def padded(pts, cap, rng=None, n_masked=0):
    """``pts`` in the first rows of a ``cap``-row batch, the rest padding;
    ``n_masked`` of the points (random ones) masked out."""
    pts = np.asarray(pts, np.float32)
    xyz = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    xyz[:len(pts)] = pts
    mask[:len(pts)] = True
    if n_masked:
        mask[rng.choice(len(pts), n_masked, replace=False)] = False
    return xyz, mask


def jax_fields(m) -> dict:
    out = {name: np.array(getattr(m, name)) for name in CELL_MAP_ARRAYS}
    out.update(cell_size=np.array(m.cell_size), frame_idx=np.array(m.frame_idx))
    return out


def assert_maps_equal(tm, jm, t3=None, j3=None):
    j = jax_fields(jm)
    assert tm.frame_idx == int(j["frame_idx"])
    for name in ("keys", "count", "last_update_frame", "create_frame", "pts"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), j[name], err_msg=name)
    for name in ("sum_p", "sum_pp"):
        np.testing.assert_allclose(getattr(tm, name).numpy(), j[name], **MOMENT_TOL,
                                   err_msg=name)
    if t3 is not None:
        np.testing.assert_array_equal(t3.numpy(), np.array(j3))


def cluster(rng, center, n, spread):
    return center + rng.uniform(-spread, spread, (n, 3))


def case_frames(name, rng):
    """(capacity, pool, max_new, revisit, [(xyz, mask)])."""
    if name == "more_than_pool_in_one_cell":
        # 40 and 37 points into the cell centred at (0.25, 0.25, 0.25)
        f1 = np.vstack([cluster(rng, 0.25, 40, 0.2), cluster(rng, 3.25, 5, 0.2)])
        f2 = np.vstack([cluster(rng, 0.25, 37, 0.2), cluster(rng, -2.25, 20, 0.2)])
        frames = [padded(rng.permutation(f1), 64), padded(rng.permutation(f2), 64)]
        return 64, 16, 32, 10 ** 9, frames
    if name == "more_than_max_new":
        frames = [padded(rng.uniform(-4, 4, (120, 3)), 128) for _ in range(3)]
        return 512, 8, 24, 10 ** 9, frames
    if name == "directory_overflow":
        frames = [padded(rng.uniform(-6, 6, (100, 3)), 128) for _ in range(3)]
        return 48, 8, 64, 10 ** 9, frames
    if name == "revisit_reset":
        home = cluster(rng, 1.25, 12, 0.2)
        away = cluster(rng, -5.25, 12, 0.2)
        seq = [home, away, away, np.vstack([home + 0.01, away]), away, home, home]
        frames = [padded(f, 32) for f in seq]
        return 64, 8, 16, 3, frames
    if name == "masked_and_padded":
        frames = [padded(rng.uniform(-3, 3, (90, 3)), 128, rng, n_masked=30)
                  for _ in range(3)]
        # a masked point carries a finite far coordinate that must not count
        for xyz, mask in frames:
            xyz[~mask] = 50.0
        return 256, 16, 64, 10 ** 9, frames
    raise KeyError(name)


CASES = ("more_than_pool_in_one_cell", "more_than_max_new", "directory_overflow",
         "revisit_reset", "masked_and_padded")


@pytest.mark.parametrize("name", CASES)
def test_append_cloud_matches_jax(name):
    rng = np.random.default_rng(CASES.index(name))
    cap, pool, max_new, revisit, frames = case_frames(name, rng)
    jm = jcm.empty_cell_map(0.5, cap, pool)
    tm = tcm.empty_cell_map(0.5, cap, pool)
    for xyz, mask in frames:
        jb, tb = batches(xyz, mask)
        jm, j3 = jcm.append_cloud(jm, jb, revisit, max_new=max_new)
        tm, t3 = tcm.append_cloud(tm, tb, revisit, max_new=max_new)
        assert_maps_equal(tm, jm, t3, j3)
    n_cells = int(tm.n_cells())
    if name == "more_than_max_new":
        assert n_cells == 3 * max_new        # every frame hit the cap
    if name == "directory_overflow":
        assert n_cells == cap
    if name == "more_than_pool_in_one_cell":
        assert int(tm.count.max()) == 77 and bool(t3.any())
    if name == "revisit_reset":                # the home cells restarted at frame 3
        assert 3 in tm.create_frame[tm.valid()].tolist()


def test_jax_scatter_keeps_the_last_duplicate():
    """The JAX pool write scatters duplicate positions when a cell takes
    more than P points in one frame; XLA on the CPU applies them in
    order, so the highest rank wins.  The port writes only those ranks."""
    rng = np.random.default_rng(7)
    pts = cluster(rng, 0.25, 21, 0.2).astype(np.float32)
    m = jcm.empty_cell_map(0.5, 8, 4)
    m, _ = jcm.append_cloud(m, batches(*padded(pts, 32))[0], 10 ** 9, max_new=8)
    slot = int(np.nonzero(np.array(m.keys) != jcm.EMPTY_KEY)[0][0])
    want = np.stack([pts[max(r for r in range(21) if r % 4 == p)] for p in range(4)])
    np.testing.assert_array_equal(np.array(m.pts)[slot], want)


@pytest.fixture(scope="module")
def feature_maps():
    """Both packages' maps over planes, lines and blobs in 0.5 m cells,
    and the port's map carried over from the JAX one through interop."""
    rng = np.random.default_rng(11)
    u = rng.uniform(-2, 2, (600, 2))
    plane = np.c_[u, 0.3 + rng.normal(0, 2e-3, 600)]
    t = rng.uniform(-2, 2, 300)
    line = np.c_[t, 1.2 + rng.normal(0, 5e-3, 300), 1.2 + rng.normal(0, 5e-3, 300)]
    blob = rng.normal(0, 0.6, (300, 3)) + [0.0, -1.5, 1.0]
    pts = rng.permutation(np.vstack([plane, line, blob]))
    jm = jcm.empty_cell_map(0.5, 512, 32)
    tm = tcm.empty_cell_map(0.5, 512, 32)
    for chunk in np.array_split(pts, 3):
        jb, tb = batches(*padded(chunk, 512))
        jm, _ = jcm.append_cloud(jm, jb, 10 ** 9, max_new=256)
        tm, _ = tcm.append_cloud(tm, tb, 10 ** 9, max_new=256)
    fields = {f"m.{k}": v for k, v in jax_fields(jm).items()}
    carried = cell_map_from_numpy(fields, "m", "cpu")
    return jm, tm, carried


def test_interop_carries_the_map(feature_maps):
    jm, tm, carried = feature_maps
    assert_maps_equal(carried, jm)
    assert carried.cell_size == tm.cell_size == 0.5
    assert cell_map_from_numpy({"m.keys": np.zeros(1, np.int32)}, "m", "cpu") is None


@pytest.mark.parametrize("incremental", [True, False])
def test_cell_features_match_jax(feature_maps, incremental):
    jm, tm, _ = feature_maps
    jf = jcm.cell_features(jm, incremental=incremental)
    tf = tcm.cell_features(tm, incremental=incremental)
    for name in ("mean", "cov", "eig_val"):
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.array(getattr(jf, name)),
                                   **FEATURE_TOL, err_msg=name)
    val = np.array(jf.eig_val)
    margin = np.minimum(np.abs(val[:, 1] / 3.0 - val[:, 0]),
                        np.abs(val[:, 2] / 3.0 - val[:, 1])) / np.maximum(val[:, 2], 1e-12)
    clear = margin > 1e-3
    jt, tt = np.array(jf.feature_type), tf.feature_type.numpy()
    np.testing.assert_array_equal(tt[clear], jt[clear])
    assert {tcm.FEATURE_PLANE, tcm.FEATURE_LINE} <= set(jt[clear].tolist())
    same = clear & (tt == jt) & (jt != tcm.FEATURE_SPHERE)
    jd, td = np.array(jf.feature_dir)[same], tf.feature_dir.numpy()[same]
    sign = np.sign(np.sum(jd * td, axis=1))[:, None]
    np.testing.assert_allclose(td * sign, jd, rtol=0, atol=1e-3)


@pytest.mark.parametrize("pose", range(3))
def test_selections_match_jax(feature_maps, pose):
    jm, tm, _ = feature_maps
    rng = np.random.default_rng(100 + pose)
    # behind the map's -X side, facing roughly +X
    t_w = (np.array([-2.5, 0.0, 0.5]) + rng.uniform(-0.5, 0.5, 3)).astype(np.float32)
    yaw = rng.uniform(-0.6, 0.6)
    q = np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32)
    radius, angle = 3.0, 45.0
    jr = np.array(jcm.cells_in_radius(jm, jnp.asarray(t_w), radius))
    tr = tcm.cells_in_radius(tm, torch.from_numpy(t_w), radius).numpy()
    jv = np.array(jcm.cells_in_fov(jm, jnp.asarray(t_w), jnp.asarray(q), angle))
    tv = tcm.cells_in_fov(tm, torch.from_numpy(t_w), torch.from_numpy(q), angle).numpy()
    # boundaries in float64
    c = np.array(jm.centers()).astype(np.float64)
    rel = c - t_w
    d = np.linalg.norm(rel, axis=1)
    w, x, y, z = q.astype(np.float64)   # the body +X axis in the world
    fwd = np.array([1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)])
    cosang = rel @ fwd / np.maximum(d, 1e-9)
    clear_r = np.abs(d - radius) > 1e-4
    clear_v = np.abs(cosang - np.cos(np.deg2rad(angle))) > 1e-4
    np.testing.assert_array_equal(tr[clear_r], jr[clear_r])
    np.testing.assert_array_equal(tv[clear_v], jv[clear_v])
    assert 0 < tr.sum() < tm.n_cells() and 0 < tv.sum() < tm.n_cells()
    sel = jr & jv & clear_r & clear_v
    jg = jcm.gather_cell_points(jm, jnp.asarray(sel))
    tg = tcm.gather_cell_points(tm, torch.from_numpy(sel))
    np.testing.assert_array_equal(tg.mask.numpy(), np.array(jg.mask))
    np.testing.assert_array_equal(tg.xyz.numpy(), np.array(jg.xyz))
    assert tg.capacity == 512 * 32 and int(tg.mask.sum()) > 0


def test_member_mask_from_keys_matches_jax(feature_maps):
    jm, tm, _ = feature_maps
    keys = np.array(jm.keys)
    rng = np.random.default_rng(5)
    valid = keys[keys != jcm.EMPTY_KEY]
    pick = np.concatenate([rng.choice(valid, 20, replace=False),
                           [valid.max() + 1, jcm.EMPTY_KEY, jcm.EMPTY_KEY]]).astype(np.int32)
    jmask = np.array(jcm.member_mask_from_keys(jm, jnp.asarray(pick)))
    tmask = tcm.member_mask_from_keys(tm, torch.from_numpy(pick)).numpy()
    np.testing.assert_array_equal(tmask, jmask)
    assert tmask.sum() == 20
