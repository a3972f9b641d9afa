"""The port's bucket grid (``loam_livox_tpu_torch.ops.bucket_grid``, the
``grid`` correspondence engine) against the JAX package's
``ops/bucket_grid.py`` on the CPU, and against the exact kNN inside the
grid's correctness domain.

Inputs are made from a numpy seed: points voxel-filtered at a 0.5 m
leaf (so a 1.25 m bucket holds at most a few), or clustered so that
buckets overflow their slots and the directory overflows its buckets.

* `build_bucket_grid`: directory keys, slot masks, source indices and
  slotted points equal to the JAX package's, bit for bit, with and
  without overflow (the overflow drops the later points in sort order
  and the buckets past the directory's size).
* `grid_knn`: indices equal to the JAX package's and distances within
  1e-6 relative (the JAX side sums the three squared differences as one
  XLA reduce, which may contract a product into an FMA); ties go to
  the lower candidate position, as ``lax.top_k`` breaks them.
* Inside the correctness domain (every true neighbour within one bucket
  of the query's bucket, no overflow) `grid_knn` equals the exact kNN
  (`ops.knn.knn`): the same neighbours, distances within 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.ops import bucket_grid as jbg

from loam_livox_tpu_torch.ops import bucket_grid as tbg
from loam_livox_tpu_torch.ops.knn import knn

torch.set_num_threads(2)


def voxel_points(rng, n, extent=8.0, leaf=0.5):
    """At most one point a ``leaf`` voxel: the density the grid assumes."""
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    _, first = np.unique(np.floor(pts / leaf).astype(np.int64), axis=0, return_index=True)
    return pts[np.sort(first)]


def padded(pts, cap, n_masked=5):
    xyz = np.zeros((cap, 3), np.float32)
    mask = np.zeros(cap, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    mask[:n_masked] = False                      # holes in the prefix
    return xyz, mask


CASES = {
    # (points, capacity, bucket size, buckets, slots)
    "sparse": (lambda rng: voxel_points(rng, 3000), 4096, 1.25, 2048, 16),
    # 40 tight clusters: buckets overflow their 4 slots, and 40 > 24 buckets
    "overflow": (lambda rng: (rng.integers(0, 40, 3000)[:, None] * 1.7
                              + rng.normal(0, 0.2, (3000, 3))).astype(np.float32),
                 4096, 1.0, 24, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_bucket_grid_matches_jax(case):
    make, cap, size, nb, slots = CASES[case]
    xyz, mask = padded(make(np.random.default_rng(7)), cap)
    j = jbg.build_bucket_grid(jnp.asarray(xyz), jnp.asarray(mask), size, nb, slots)
    g = tbg.build_bucket_grid(torch.from_numpy(xyz), torch.from_numpy(mask), size, nb, slots)
    assert (g.n_buckets, g.bucket_cap) == (nb, slots)
    np.testing.assert_array_equal(g.keys.numpy(), np.asarray(j.keys))
    np.testing.assert_array_equal(g.slot_mask.numpy(), np.asarray(j.slot_mask))
    np.testing.assert_array_equal(g.src_idx.numpy(), np.asarray(j.src_idx))
    np.testing.assert_array_equal(g.pts.numpy(), np.asarray(j.pts))
    used = int(g.slot_mask.sum())
    if case == "overflow":
        assert bool((g.keys != tbg.EMPTY_KEY).all()) and used < int(mask.sum())
        assert bool(g.slot_mask.all(dim=1).any())
    else:
        assert used == int(mask.sum())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("k", [5, 9])
def test_grid_knn_matches_jax(case, k):
    make, cap, size, nb, slots = CASES[case]
    rng = np.random.default_rng(8)
    xyz, mask = padded(make(rng), cap)
    q = (xyz[rng.integers(0, cap // 2, 500)] + rng.normal(0, 0.3, (500, 3))).astype(np.float32)
    q[:3] = 1e4                                   # far from every bucket
    j = jbg.build_bucket_grid(jnp.asarray(xyz), jnp.asarray(mask), size, nb, slots)
    g = tbg.build_bucket_grid(torch.from_numpy(xyz), torch.from_numpy(mask), size, nb, slots)
    jd, ji = jbg.grid_knn(jnp.asarray(q), j, k=k)
    td, ti = tbg.grid_knn(torch.from_numpy(q), g, k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    assert float(td[:3].min()) == float(np.float32(1e30))
    # a lane axis searches each lane alike
    ld, li = tbg.grid_knn(torch.from_numpy(q).reshape(2, 250, 3), g, k=k)
    np.testing.assert_array_equal(li.reshape(500, k).numpy(), ti.numpy())
    np.testing.assert_array_equal(ld.reshape(500, k).numpy(), td.numpy())


def test_grid_knn_ties_go_to_the_lower_position():
    # four references equidistant from the query, two buckets apart
    pts = np.array([[0.5, 0.5, 0.5], [-0.5, 0.5, 0.5], [0.5, -0.5, 0.5],
                    [0.5, 0.5, -0.5], [3.0, 3.0, 3.0]], np.float32)
    xyz, mask = padded(pts, 64, n_masked=0)
    q = np.zeros((1, 3), np.float32)
    j = jbg.build_bucket_grid(jnp.asarray(xyz), jnp.asarray(mask), 1.0, 32, 4)
    g = tbg.build_bucket_grid(torch.from_numpy(xyz), torch.from_numpy(mask), 1.0, 32, 4)
    jd, ji = jbg.grid_knn(jnp.asarray(q), j, k=3)
    td, ti = tbg.grid_knn(torch.from_numpy(q), g, k=3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("seed", [0, 1])
def test_grid_knn_is_exact_inside_its_domain(seed):
    """Voxel-filtered references (at most one a 0.5 m voxel) in 1.25 m
    buckets of 32 slots (none overflows): each query's exact 5 nearest
    within 1.25 m lie within one bucket of its own, so the grid finds
    them."""
    rng = np.random.default_rng(seed)
    pts = voxel_points(rng, 6000, extent=6.0)
    xyz, mask = padded(pts, 8192)
    q = (pts[rng.integers(0, len(pts), 400)] + rng.normal(0, 0.2, (400, 3))).astype(np.float32)
    g = tbg.build_bucket_grid(torch.from_numpy(xyz), torch.from_numpy(mask), 1.25, 4096, 32)
    assert int(g.slot_mask.sum()) == int(mask.sum())           # no overflow
    gd, gi = tbg.grid_knn(torch.from_numpy(q), g, k=5)
    ed, ei = knn(torch.from_numpy(q), torch.from_numpy(xyz), torch.from_numpy(mask), k=5)
    near = (ed[:, -1] < 1.25 ** 2).numpy()                      # the domain
    assert near.sum() > 300
    np.testing.assert_array_equal(gi.numpy()[near], ei.numpy()[near])
    np.testing.assert_allclose(gd.numpy()[near], ed.numpy()[near], rtol=1e-6, atol=0)
