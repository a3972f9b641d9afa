"""The port's correspondence search (``loam_livox_tpu_torch.ops``) against
the JAX package, on the CPU, over the cases of tests/test_pallas_knn.py:
random, voxel-sorted, mask/padding, prefix fill, query count and the
radius gate.

On the CPU `knn_fused` runs its plain version, which computes the same
function as the CUDA kernel bit for bit.  It is held against
* the JAX dense engine ``knn(exact=True)``: that engine ranks by the
  expanded ‖q‖² + ‖r‖² − 2⟨q, r⟩, whose f32 error grows with ‖q‖²
  (measured 5e-5 from the direct distance at ±10 m, 2.8e-4 at ±20 m), so
  distances agree within 1e-4 · (extent / 10 m)², and indices agree
  except where two references lie that close (near-ties);
* the TPU kernel in interpret mode with ``ref_tile == bins == padded M``,
  the only setting in which its binned selection is exact (with 256 bins
  it misses neighbours that share a bin).
The kernel itself runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.types import PointBatch as JPointBatch
from loam_livox_tpu.ops.knn import knn as jknn
from loam_livox_tpu.ops.pallas.knn_fused import build_ref_operand as jbuild_ref
from loam_livox_tpu.ops.pallas.knn_fused import knn_fused as jknn_fused
from loam_livox_tpu.ops.voxel import voxel_downsample as jvoxel

from loam_livox_tpu_torch.ops import knn_fused as tfused_mod
from loam_livox_tpu_torch.ops.knn import BIG, knn as tknn
from loam_livox_tpu_torch.registration import residuals as tres

torch.set_num_threads(2)


def exact64(q, ref, mask, k):
    """numpy float64 brute force: (distances, indices), masked refs inf."""
    d = ((q[:, None, :].astype(np.float64) - ref[None].astype(np.float64)) ** 2).sum(-1)
    d[:, ~mask] = np.inf
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, idx, axis=1), idx


def case(name):
    """(q, ref, mask, k, query_count, max_radius) of one test case."""
    if name == "random":
        rng = np.random.default_rng(0)
        q = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
        ref = rng.uniform(-10, 10, (512, 3)).astype(np.float32)
        return q, ref, np.ones(512, bool), 5, None, None
    if name == "voxel_sorted":
        rng = np.random.default_rng(1)
        raw = rng.uniform(-20, 20, (4096, 3)).astype(np.float32)
        ds = jvoxel(JPointBatch(jnp.asarray(raw), jnp.zeros(4096), jnp.ones(4096, bool)),
                    0.4, capacity=2048)
        ref, mask = np.asarray(ds.xyz), np.asarray(ds.mask)
        q = ref[mask][:256] + rng.normal(0, 0.05, (256, 3)).astype(np.float32)
        return q, ref, mask, 5, None, None
    if name == "mask_padding":
        rng = np.random.default_rng(2)
        q = rng.uniform(-5, 5, (16, 3)).astype(np.float32)
        ref = rng.uniform(-5, 5, (64, 3)).astype(np.float32)
        mask = np.zeros(64, bool)
        mask[:3] = True                 # fewer valid refs than k
        return q, ref, mask, 5, None, None
    if name == "prefix_fill":
        rng = np.random.default_rng(4)
        ref = np.zeros((1024, 3), np.float32)
        ref[:100] = rng.uniform(-10, 10, (100, 3))
        mask = np.zeros(1024, bool)
        mask[:100] = True
        q = ref[:32] + rng.normal(0, 0.05, (32, 3)).astype(np.float32)
        return q, ref, mask, 5, None, None
    if name == "query_count":
        rng = np.random.default_rng(5)
        ref = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
        q = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
        return q, ref, np.ones(256, bool), 5, 20, None
    if name == "radius":
        rng = np.random.default_rng(6)
        ref = rng.uniform(-10, 10, (1024, 3)).astype(np.float32)
        q = rng.uniform(-12, 12, (128, 3)).astype(np.float32)
        return q, ref, rng.uniform(size=1024) < 0.9, 5, None, 2.0 ** 0.5
    raise KeyError(name)


CASES = ["random", "voxel_sorted", "mask_padding", "prefix_fill", "query_count", "radius"]


def port(q, ref, mask, k, count, radius):
    d, i = tfused_mod.knn_fused(torch.from_numpy(q), torch.from_numpy(ref),
                                torch.from_numpy(mask), k=k, query_count=count,
                                max_radius=radius)
    return d.numpy(), i.numpy()


def assert_same_neighbours(d, i, d_ref, i_ref, q, ref, tol):
    """Distances within ``tol``; where the indices differ, the reference's
    choice must lie within ``tol`` of the port's (a near-tie)."""
    live = d_ref < 0.5 * BIG
    np.testing.assert_array_equal(d < 0.5 * BIG, live)
    np.testing.assert_allclose(d[live], d_ref[live], rtol=0, atol=tol)
    diff = live & (i != i_ref)
    if diff.any():
        rows = np.nonzero(diff)[0]
        alt = ((q[rows].astype(np.float64) - ref[i_ref[diff]]) ** 2).sum(-1)
        np.testing.assert_allclose(alt, d[diff], rtol=0, atol=tol)
    assert diff.mean() < 0.02


@pytest.mark.parametrize("name", CASES)
def test_plain_is_exact(name):
    q, ref, mask, k, count, radius = case(name)
    d, i = port(q, ref, mask, k, count, radius)
    de, ie = exact64(q, ref, mask, k)
    n = len(q) if count is None else count
    de, ie = de[:n], ie[:n]
    if radius is not None:
        far = de > radius ** 2
        de[far], ie[far] = np.inf, 0
    live = np.isfinite(de)
    assert np.all(d[n:] == BIG) and np.all(i[n:] == 0)
    np.testing.assert_array_equal(d[:n] < 0.5 * BIG, live)
    np.testing.assert_array_equal(i[:n][~live], 0)
    # f32 distances, relative error ~1e-7 of up to 1e3 m²
    np.testing.assert_allclose(d[:n][live], de[live], rtol=1e-5, atol=1e-6)
    assert (i[:n][live] == ie[live]).mean() > 0.999


@pytest.mark.parametrize("name", CASES)
def test_matches_jax_dense_exact(name):
    q, ref, mask, k, count, radius = case(name)
    d, i = port(q, ref, mask, k, count, radius)
    dj, ij = jknn(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), k=k, exact=True)
    dj, ij = np.asarray(dj).copy(), np.asarray(ij)
    n = len(q) if count is None else count
    dj[n:] = BIG
    if radius is not None:
        dj[dj > radius ** 2] = BIG
    dj[dj >= 0.5 * BIG] = BIG
    extent = max(np.abs(q).max(), np.abs(ref[mask]).max())
    assert_same_neighbours(d, i, dj, ij, q, ref, tol=1e-4 * max(1.0, (extent / 10) ** 2))


@pytest.mark.parametrize("name", CASES)
def test_matches_tpu_kernel_interpreted_exact_bins(name):
    q, ref, mask, k, count, radius = case(name)
    d, i = port(q, ref, mask, k, count, radius)
    mp = -(-len(ref) // 128) * 128
    qt = -(-len(q) // 8) * 8
    kw = dict(k=k, query_tile=qt, ref_tile=mp, bins=mp, interpret=True)
    if count is not None:
        kw["query_count"] = jnp.int32(count)
    if radius is not None:
        op = jbuild_ref(jnp.asarray(ref), jnp.asarray(mask), ref_tile=mp, bins=mp)
        kw.update(ref4=op, max_radius=radius)
    dj, ij = jknn_fused(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), **kw)
    dj, ij = np.asarray(dj).copy(), np.asarray(ij)
    n = len(q) if count is None else count
    dj[n:] = BIG
    if radius is not None:
        dj[dj > radius ** 2] = BIG     # beyond the gate the TPU kernel may report either
    assert_same_neighbours(d, i, dj, ij, q, ref, tol=1e-4)


def test_radius_gate_leaves_icp_targets_identical():
    """Neighbours beyond the gate read BIG, yet the line and plane targets
    built from the gated search equal those of the ungated one."""
    rng = np.random.default_rng(7)
    raw = rng.uniform(-15, 15, (8192, 3)).astype(np.float32)
    ds = jvoxel(JPointBatch(jnp.asarray(raw), jnp.zeros(8192), jnp.ones(8192, bool)),
                0.4, capacity=4096)
    ref, mask = torch.from_numpy(np.asarray(ds.xyz)), torch.from_numpy(np.asarray(ds.mask))
    q = torch.from_numpy(rng.uniform(-18, 18, (512, 3)).astype(np.float32))
    qmask = torch.from_numpy(rng.uniform(size=512) < 0.95)
    for gate, build in ((2.0, tres.build_line_targets), (50.0, tres.build_plane_targets)):
        d0, i0 = tknn(q, ref, mask, k=5)
        d1, i1 = tknn(q, ref, mask, k=5, max_radius=gate ** 0.5)
        assert (d1 == BIG).any() and not torch.equal(d0, d1)
        a = build(d0, i0, ref, qmask, gate)
        b = build(d1, i1, ref, qmask, gate)
        assert torch.equal(a.valid, b.valid) and a.valid.any()
        for x, y in zip(a[:2], b[:2]):
            assert torch.equal(x[a.valid], y[a.valid])


def test_ref_operand_matches_tpu_operand():
    rng = np.random.default_rng(8)
    ref = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    mask = rng.uniform(size=3000) < 0.7
    mask[2500:] = False
    op = tfused_mod.build_ref_operand(torch.from_numpy(ref), torch.from_numpy(mask))
    jop = jbuild_ref(jnp.asarray(ref), jnp.asarray(mask),
                                       ref_tile=tfused_mod.GROUP, bins=tfused_mod.GROUP)
    assert op.ref4.shape == (3072, 4)
    np.testing.assert_allclose(op.ref4.numpy().T, np.asarray(jop.ref4), rtol=1e-6)
    np.testing.assert_array_equal(op.boxes.numpy(), np.asarray(jop.boxes))
    assert int(op.n_ref) == int(np.nonzero(mask)[0][-1]) + 1


def test_cpu_tensors_take_the_plain_version():
    q, ref, mask, k, count, radius = case("radius")
    before = tfused_mod.launches
    d, i = port(q, ref, mask, k, count, radius)
    d2, i2 = tknn(torch.from_numpy(q), torch.from_numpy(ref), torch.from_numpy(mask),
                  k=k, max_radius=radius)
    assert tfused_mod.launches == before
    assert np.array_equal(d, d2.numpy()) and np.array_equal(i, i2.numpy())


@pytest.mark.parametrize("radius", [0.5, None])
@pytest.mark.parametrize("k", [1, 5])
def test_lanes_match_single_lane_and_jax(k, radius):
    """The lane axis of the racing path: (L, Q, 3) queries, one count a
    lane (uneven, one lane empty).  Each lane equals the single-lane
    search bit for bit, and the JAX dense engine per lane within 1e-6
    (coordinates within 1 m, where its expanded form errs by ~1e-7) with
    the same indices away from near-ties."""
    rng = np.random.default_rng(11 + k)
    ref = rng.uniform(-1, 1, (700, 3)).astype(np.float32)
    mask = rng.uniform(size=700) < 0.8
    mask[600:] = False
    q = rng.uniform(-1, 1, (4, 64, 3)).astype(np.float32)
    counts = np.array([64, 17, 0, 40])
    tq, tref, tmask = (torch.from_numpy(a) for a in (q, ref, mask))
    d, i = tfused_mod.knn_fused(tq, tref, tmask, k=k, query_count=torch.from_numpy(counts),
                                max_radius=radius)
    assert d.shape == i.shape == (4, 64, k) and i.dtype == torch.int32
    for lane, count in enumerate(counts):
        d1, i1 = tknn(tq[lane], tref, tmask, k=k, query_count=int(count), max_radius=radius)
        assert torch.equal(d[lane], d1) and torch.equal(i[lane], i1)
        dj, ij = jknn(jnp.asarray(q[lane]), jnp.asarray(ref), jnp.asarray(mask), k=k, exact=True)
        dj, ij = np.asarray(dj).copy(), np.asarray(ij)
        dj[count:] = BIG
        if radius is not None:
            dj[dj > radius ** 2] = BIG
        dj[dj >= 0.5 * BIG] = BIG
        assert_same_neighbours(d[lane].numpy(), i[lane].numpy(), dj, ij, q[lane], ref, tol=1e-6)
    assert (d[2] == BIG).all() and (i[2] == 0).all()


@pytest.mark.parametrize("radius", [2.0, None])
def test_search_work_counts_pairs_by_brute_force(radius):
    """`search_work`, the kernel's implementation-independent yardstick,
    against a count pair by pair: every valid query with every valid
    reference whose group's box lies within the radius of that query."""
    rng = np.random.default_rng(9)
    g = tfused_mod.GROUP
    ref = rng.uniform(-6, 6, (1500, 3)).astype(np.float32)
    ref = ref[np.argsort(ref[:, 0])]        # slab-shaped groups, so boxes differ
    mask = rng.uniform(size=1500) < 0.8
    mask[1300:] = False
    mask[512:768] = False                   # one empty group
    q = rng.uniform(-8, 8, (50, 3)).astype(np.float32)
    count = 40
    op = tfused_mod.build_ref_operand(torch.from_numpy(ref), torch.from_numpy(mask))
    pairs, bytes_ = tfused_mod.search_work(torch.from_numpy(q), count, op, radius)
    n = 0
    for j in np.nonzero(mask)[0]:
        s = slice(j // g * g, j // g * g + g)
        pts = ref[s][mask[s]].astype(np.float64)
        for qi in q[:count].astype(np.float64):
            gap = np.maximum(np.maximum(pts.min(0) - qi, qi - pts.max(0)), 0)
            n += radius is None or gap @ gap <= radius ** 2
    assert pairs == n
    if radius is not None:
        assert 0 < n < count * mask.sum()
    n_ref = int(np.nonzero(mask)[0][-1]) + 1
    assert bytes_ == count * 12 + n_ref * 16 + -(-n_ref // g) * 32 + count * 5 * 8
    # with a lane axis the pairs and the query bytes sum over the lanes;
    # the shared operand counts once
    lanes = torch.from_numpy(np.stack([q, q[::-1].copy()]))
    pairs2, bytes2 = tfused_mod.search_work(lanes, torch.tensor([count, 0]), op, radius)
    assert pairs2 == pairs and bytes2 == bytes_
    pairs3, bytes3 = tfused_mod.search_work(lanes, count, op, radius)
    assert bytes3 == bytes_ + count * (12 + 5 * 8)
    assert pairs3 == pairs + tfused_mod.search_work(lanes[1], count, op, radius)[0]


def test_prefilter_margin_bounds_the_gap():
    """The exact prefilter of csrc/knn_fused.cu, emulated in f32 on points
    100-200 m from the origin.  The kernel ranks first by p = w - 2<q, r>
    (three FMA on w = ||r||^2) and computes the rounded distance d only
    where p <= thr(T), T the query's current k-th distance.  The float64
    gap between p + ||q||^2 and d must lie within the 13 u (T + qq + R2)
    the proof allows, and no pair with d < T may fail the prefilter.  (An
    FMA is emulated in float64, where the product of two f32 is exact; a
    rare double rounding moves it by far less than the margin's slack.)"""
    f32, f64, u = np.float32, np.float64, 2.0 ** -24
    rng = np.random.default_rng(10)
    c = rng.uniform(100, 200, 3) * rng.choice([-1, 1], 3)
    ref = (c + rng.uniform(-4, 4, (256, 3))).astype(f32)
    q = (c + rng.uniform(-4, 4, (96, 3))).astype(f32)
    q[:32] = ref[:32]                        # zero distances
    w = (ref * ref).sum(1, dtype=f32)        # as build_ref_operand

    def fma(a, b, c_):
        return (a.astype(f64) * b.astype(f64) + c_.astype(f64)).astype(f32)

    def sq3(x, y, z):
        return (x * x + y * y) + z * z       # f32, each operation rounded

    a = (-2 * q).astype(f32)
    p = fma(a[:, None, 0], ref[None, :, 0],
            fma(a[:, None, 1], ref[None, :, 1], fma(a[:, None, 2], ref[None, :, 2], w[None])))
    d = sq3(*(q[:, None, i] - ref[None, :, i] for i in range(3)))
    qq = sq3(q[:, 0], q[:, 1], q[:, 2])[:, None]
    mx = np.maximum(np.abs(ref.min(0)), np.abs(ref.max(0)))
    r2 = sq3(mx[0], mx[1], mx[2])
    assert d.dtype == p.dtype == qq.dtype == f32 and (qq > 1e4).all()
    gap = np.abs((p.astype(f64) + qq) - d)
    assert (gap <= 13 * u * (d.astype(f64) + qq + r2)).all()
    assert gap.max() > 0                     # the two forms do differ here
    for t in (np.nextafter(d, f32(np.inf)), np.sort(d, 1)[:, 4:5], np.full_like(d, 1.0)):
        s = (t + qq) + r2
        thr = (t - qq) + (s.astype(f64) * 2.0 ** -19 + 2.0 ** -100).astype(f32)
        assert thr.dtype == f32
        assert (p[d < t] <= np.broadcast_to(thr, d.shape)[d < t]).all()
