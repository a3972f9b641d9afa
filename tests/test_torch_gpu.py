"""The port's CUDA kernel against its plain PyTorch version, and the
card's cell map and Velodyne front end against the CPU's, on the card.

Every test here is marked ``gpu`` and skips where
``torch.cuda.is_available()`` is false: a CUDA kernel has no CPU mode.
This file imports nothing of JAX, so it runs on a machine with a card
and PyTorch alone:

    python -m pytest tests/test_torch_gpu.py -m gpu

The kernel computes the plain version's function bit for bit (same
rounded operations, same tie order), so distances and indices must be
equal, not merely close; with a lane axis, lane by lane.  The cell map
sums each cell in input order and writes its pools at unique indices on
both devices, so the card's map equals the CPU's bit for bit.  The
Velodyne front end's selections must be equal on both devices, its
points equal (copies) and its times and centroids within 1e-6 (CUDA's
atan2 and sqrt may round the last bit differently).
"""
import numpy as np
import pytest
import torch

from chip_smoke import VOXEL_CASES, debounce_tables, sorted_input, vlp16_sweep
from loam_livox_tpu_torch.core.config import SlamConfig
from loam_livox_tpu_torch.core.types import PointBatch
from loam_livox_tpu_torch.frontend.velodyne import extract_velodyne_features
from loam_livox_tpu_torch.map import cell_map as cm
from loam_livox_tpu_torch.ops import knn_fused as kf
from loam_livox_tpu_torch.ops.knn import knn
from loam_livox_tpu_torch.ops.voxel import voxel_downsample

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def voxel_map(rng, m, extent, leaf, fill):
    """A voxel-sorted buffer of capacity m, its first ``fill`` share valid."""
    raw = rng.uniform(-extent, extent, (2 * m, 3)).astype(np.float32)
    b = voxel_downsample(PointBatch(torch.from_numpy(raw), torch.zeros(2 * m),
                                    torch.ones(2 * m, dtype=torch.bool)), leaf, capacity=m)
    mask = b.mask.clone()
    mask[int(fill * m):] = False
    return b.xyz.numpy(), mask.numpy()


CASES = {
    # name: (queries, capacity, extent, leaf, fill, k, radius, query_count)
    "corner_full": (512, 16384, 12.0, 0.1, 1.0, 5, 2.0 ** 0.5, None),
    "surface_prefix": (2048, 65536, 12.0, 0.4, 0.05, 5, 50.0 ** 0.5, 1500),
    "no_radius_ragged": (300, 4000, 10.0, 0.4, 0.7, 5, None, None),
    "few_refs_k8": (130, 2048, 5.0, 0.4, 0.001, 8, None, 77),
}


@pytest.mark.parametrize("name", list(CASES))
def test_kernel_equals_plain(cuda, name):
    nq, m, extent, leaf, fill, k, radius, count = CASES[name]
    rng = np.random.default_rng(len(name))
    ref, mask = voxel_map(rng, m, extent, leaf, fill)
    q = (ref[rng.integers(0, max(int(fill * m), 1), nq)]
         + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    cnt = None if count is None else torch.tensor(count, device=cuda)
    before = kf.launches
    d, i = kf.knn_fused(q, ref, mask, k=k, query_count=cnt, max_radius=radius)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    dp, ip = knn(q, ref, mask, k=k, query_count=count, max_radius=radius)
    assert torch.equal(d, dp)
    assert torch.equal(i, ip)
    assert (d < 1e29).any()


def test_wrapper_rejects_bad_inputs(cuda):
    q = torch.zeros((4, 3), device=cuda)
    ref = torch.zeros((8, 3), device=cuda)
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):
        kf.knn_fused(q.double(), ref, mask)
    with pytest.raises(ValueError):
        kf.knn_fused(q, ref, mask, k=9)
    with pytest.raises(ValueError):
        kf.knn_fused(q.t().contiguous().t(), ref, mask)
    rows = kf._library().knn_fused_max_rows(5) + kf.GROUP
    big = kf.RefOperand(torch.zeros((rows, 4), device=cuda),
                        torch.zeros((rows // kf.GROUP, 8), device=cuda),
                        torch.zeros((), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="largest operand"):
        kf.knn_fused(q, ref, mask, ref_op=big)


def test_operand_above_default_shared_memory(cuda):
    """An operand whose group list needs more than 48 KB of shared memory
    launches whatever limit a smaller launch or `launch_shape` set before."""
    rng = np.random.default_rng(11)
    m = 1 << 19
    ref = np.zeros((m, 3), np.float32)
    ref[:5000] = rng.uniform(-6, 6, (5000, 3))
    mask = np.zeros(m, bool)
    mask[:5000] = True
    q = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    dp, ip = knn(q, ref, mask, k=5, max_radius=2.0)
    assert kf.launch_shape(5, m)["smem_bytes"] > 48 * 1024
    for small in (False, True):
        if small:
            kf.launch_shape(5, 2048)
            kf.knn_fused(q, ref[:2048], mask[:2048], k=5, max_radius=2.0)
        d, i = kf.knn_fused(q, ref, mask, k=5, max_radius=2.0)
        torch.cuda.synchronize()
        assert torch.equal(d, dp) and torch.equal(i, ip)


def split_case(name):
    """(q, ref, mask, k, radius, query_count) of one edge case of the
    kernel's work split (clusters of 8 blocks over 32-query tiles, each
    block a strided share of the tile's 256-reference groups) and of its
    merges (lanes in a block, blocks in a cluster)."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("n_ref_"):
        n = int(name[6:])
        ref = rng.uniform(-4, 4, (10000, 3)).astype(np.float32)
        mask = np.zeros(10000, bool)
        mask[:n] = True
        q = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
        return q, ref, mask, 5, 3.0, None
    ref, mask = voxel_map(rng, 16384, 8.0, 0.25, 0.6)
    valid = np.nonzero(mask)[0]
    q = (ref[rng.choice(valid, 400)] + rng.normal(0, 0.2, (400, 3))).astype(np.float32)
    if name == "duplicates":
        # the same point at a low and a high index, in groups that
        # different blocks scan; queries on and near the copies, and the
        # same query in two tiles
        for a, b in ((3, 9000), (300, 7000), (2100, 2400), (700, 9500)):
            ref[b] = ref[a]
            q[a % 400] = ref[a]
            q[(a + 1) % 400] = ref[a] + np.float32(1e-3)
        q[399] = q[3]
        return q, ref, mask, 5, 2.0 ** 0.5, None
    if name == "all_invalid":
        return q, ref, np.zeros_like(mask), 5, 2.0 ** 0.5, None
    if name == "count_0":
        return q, ref, mask, 5, 2.0 ** 0.5, 0
    if name == "count_over":
        return q, ref, mask, 5, 2.0 ** 0.5, 10 ** 6
    if name in ("k1", "k8"):
        return q, ref, mask, int(name[1]), 2.0 ** 0.5, 333
    if name == "no_radius":
        return q, ref, mask, 5, None, 250
    if name == "far_ties":
        # 100-200 m from the origin, where the prefilter's margin is
        # widest: lattice neighbours at equal and one-ulp-apart distances
        c = np.array([150.0, -120.0, 80.0], np.float32)
        step = np.float32(0.125)
        grid = np.stack(np.meshgrid(*[np.arange(-6, 7)] * 3, indexing="ij"), -1).reshape(-1, 3)
        ref = (c + grid * step).astype(np.float32)
        ref = np.concatenate([ref, ref[::-1]])        # every point twice
        mask = np.ones(len(ref), bool)
        mask[::7] = False
        half = np.float32(0.0625)
        q = np.concatenate([
            c + rng.integers(-5, 6, (150, 3)) * step,            # on lattice points
            c + rng.integers(-5, 6, (150, 3)) * step + half,     # at cell centres: 8-way ties
            c + rng.uniform(-0.7, 0.7, (100, 3)),
        ]).astype(np.float32)
        return q, ref, mask, 8, 1.0, None
    raise KeyError(name)


SPLIT_CASES = ["duplicates", "all_invalid", "count_0", "count_over", "k1", "k8",
               "no_radius", "far_ties"] + [
    f"n_ref_{n}" for n in (1, 255, 256, 257, 2047, 2049, 8193)]


@pytest.mark.parametrize("name", SPLIT_CASES)
def test_split_and_merge_equal_plain(cuda, name):
    q, ref, mask, k, radius, count = split_case(name)
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    # a host count here (test_kernel_equals_plain passes device counts)
    d, i = kf.knn_fused(q, ref, mask, k=k, query_count=count, max_radius=radius)
    torch.cuda.synchronize()
    dp, ip = knn(q, ref, mask, k=k, query_count=count, max_radius=radius)
    assert torch.equal(d, dp)
    assert torch.equal(i, ip)


@pytest.mark.parametrize("lanes", [1, 2, 9])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_lanes_equal_plain(cuda, lanes, k):
    """The lane axis (the racing path's query sets): one launch, each
    lane equal to the plain version with its own count, uneven counts
    and an empty lane among them."""
    rng = np.random.default_rng(100 * lanes + k)
    ref, mask = voxel_map(rng, 16384, 10.0, 0.25, 0.3)
    valid = np.nonzero(mask)[0]
    q = (ref[rng.choice(valid, (lanes, 300))]
         + rng.normal(0, 0.3, (lanes, 300, 3))).astype(np.float32)
    counts = rng.integers(1, 301, lanes)
    counts[lanes // 2] = 0 if lanes > 1 else counts[0]
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    n_q = torch.from_numpy(counts.astype(np.int32)).to(cuda)
    before = kf.launches
    d, i = kf.knn_fused(q, ref, mask, k=k, query_count=n_q, max_radius=2.0)
    torch.cuda.synchronize()
    assert kf.launches == before + 1
    assert d.shape == i.shape == (lanes, 300, k)
    dp, ip = knn(q, ref, mask, k=k, query_count=n_q, max_radius=2.0)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    for lane in range(lanes):
        dl, il = knn(q[lane], ref, mask, k=k, query_count=int(counts[lane]), max_radius=2.0)
        assert torch.equal(d[lane], dl) and torch.equal(i[lane], il)


def test_wrapper_rejects_bad_lane_shapes(cuda):
    ref = torch.zeros((8, 3), device=cuda)
    mask = torch.ones(8, dtype=torch.bool, device=cuda)
    too_many = torch.zeros((kf.MAX_LANES + 1, 1, 3), device=cuda)
    with pytest.raises(ValueError, match="lanes"):
        kf.knn_fused(too_many, ref, mask)
    q = torch.zeros((3, 4, 3), device=cuda)
    with pytest.raises(ValueError, match="counts"):
        kf.knn_fused(q, ref, mask, query_count=torch.ones(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        kf.knn_fused(torch.zeros((2, 3, 4, 3), device=cuda), ref, mask)


def test_voxel_filter_repeats_and_equals_cpu(cuda):
    """The voxel filter's segment sums run in input order on the card
    (not in atomic order), so its centroids equal the CPU's bit for bit
    and a run repeats itself."""
    rng = np.random.default_rng(12)
    xyz = rng.uniform(-12, 12, (60000, 3)).astype(np.float32)
    time = rng.uniform(0, 0.1, 60000).astype(np.float32)
    mask = rng.uniform(size=60000) < 0.9
    host = PointBatch(*(torch.from_numpy(a) for a in (xyz, time, mask)))
    ref = voxel_downsample(host, 0.4, capacity=16384)
    for _ in range(2):
        out = voxel_downsample(PointBatch(*(x.to(cuda) for x in host)), 0.4, capacity=16384)
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b)


# ---- the voxel filter's segmented-centroid kernel ---------------------------

@pytest.mark.parametrize("name", VOXEL_CASES)
def test_voxel_centroid_kernel_equals_index_put(cuda, name):
    """The card's filter (one launch of ``csrc/voxel_centroid.cu``) equals
    the benchmark's plain reference on the card, three
    ``index_put_(accumulate=True)`` sums, bit for bit, and repeats itself
    (`chip_smoke.voxel_inputs`: a Mid-40 source, a
    Mid-100 merged cloud, a mostly empty history source without time,
    more voxels than slots, a coarse leaf of hundreds of points a voxel,
    a last voxel of 3 or 5 points ahead of 40 masked rows, nothing
    valid); one run a filter."""
    from loam_livox_tpu_torch.ops import voxel_centroid as vc
    from slambench.reference import ops as R

    batch, leaf, cap, with_time, _, _ = sorted_input(name, cuda)
    runs, launches = vc.runs.read(), vc.launches
    got = voxel_downsample(batch, leaf, capacity=cap, with_time=with_time)
    again = voxel_downsample(batch, leaf, capacity=cap, with_time=with_time)
    want = R.voxel_downsample(R.PointBatch(*batch), leaf, capacity=cap, with_time=with_time)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert vc.runs.read() - runs == 2 and vc.launches - launches == 2


def test_voxel_centroid_kernel_replays_in_a_graph(cuda):
    """One filter captured in a CUDA graph: each replay runs the kernel
    once (no launch from Python) and gives the eager filter's bits, on
    the captured input and on new points copied into it."""
    from loam_livox_tpu_torch.ops import voxel_centroid as vc

    batch, leaf, cap, _, _, _ = sorted_input("mid40_source", cuda)
    other, _, _, _, _, _ = sorted_input("mid100_merged", cuda)
    first = voxel_downsample(batch, leaf, capacity=cap)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = voxel_downsample(batch, leaf, capacity=cap)
    runs, launches = vc.runs.read(), vc.launches
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert vc.runs.read() - runs == 3 and vc.launches == launches
    for a, b in zip(out, first):
        assert torch.equal(a, b)
    for dst, src in zip(batch, other):
        dst.copy_(src[:dst.shape[0]])
    graph.replay()
    want = voxel_downsample(batch, leaf, capacity=cap)
    for a, b in zip(out, want):
        assert torch.equal(a, b)


def test_voxel_runs_equal_the_voxel_filter_spans(cuda, spans_on):
    """On the frame program (source, input, commit and rebuild filters,
    the rebuild under the SWITCH node), the kernel runs once in every
    ``voxel filter`` span, as many times as the program's summary counts
    (each launch's ``filters``, a rebuild body's once a rebuild: what
    `chip_smoke.graph_row` expects), and nothing launches it from
    Python."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.ops import voxel_centroid as vc
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0})
    _, host = simulate(8, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    pipe.process_raw(*frames[0][:3], mask=frames[0][3])      # the capture, and frame 0
    torch.cuda.synchronize()

    def counted():
        keys = pipe.program.summary()
        return (sum(k["launches"] * k["filters"] for k in keys)
                + pipe.program.rebuilds() * max(k["rebuild_filters"] for k in keys))

    before = counted()
    spans_on.reset()
    vc.runs.reset()
    launches = vc.launches
    for pts, inten, t0, mask in frames[1:]:
        pipe.process_raw(pts, inten, t0, mask=mask)
    pipe.flush()
    torch.cuda.synchronize()
    rec = spans_on.read(cuda)
    filters = sum(1 for s in rec.spans if s.name == "voxel filter")
    assert rec.complete and filters > 0
    assert vc.runs.read() == filters == counted() - before and vc.launches == launches
    assert pipe.program.rebuilds() > 0


def test_launch_shape(cuda):
    shape = kf.launch_shape(5, 65536)
    assert shape["threads"] % 32 == 0 and shape["cluster"] == 8
    assert shape["blocks_per_sm"] >= 1 and shape["max_active_clusters"] >= 1


def cell_frames(rng, n_frames=4, cap=2048):
    """World-frame batches over a 12 m box, with a few dense clusters
    (more points than the pool into one cell in one frame) and masked
    and padded slots."""
    out = []
    for _ in range(n_frames):
        pts = np.vstack([rng.uniform(-6, 6, (1500, 3)),
                         *(c + rng.uniform(-0.2, 0.2, (60, 3))
                           for c in rng.uniform(-5, 5, (4, 3)))]).astype(np.float32)
        xyz = np.zeros((cap, 3), np.float32)
        mask = np.zeros(cap, bool)
        xyz[:len(pts)], mask[:len(pts)] = rng.permutation(pts), True
        mask[rng.choice(len(pts), 100, replace=False)] = False
        out.append(PointBatch(torch.from_numpy(xyz), torch.zeros(cap), torch.from_numpy(mask)))
    return out


def test_append_cloud_equals_cpu(cuda):
    """Directory, counts, moments, pools, frames and the touched mask,
    bit for bit, over frames that overflow pools, hit the new-cell cap
    and reset revisited cells; then the cell-gathered matching source."""
    rng = np.random.default_rng(21)
    host = cm.empty_cell_map(0.5, 4096, 32)
    card = cm.empty_cell_map(0.5, 4096, 32, device=cuda)
    for batch in cell_frames(rng):
        host, h3 = cm.append_cloud(host, batch, 2, max_new=512)
        card, c3 = cm.append_cloud(card, PointBatch(*(x.to(cuda) for x in batch)), 2,
                                   max_new=512)
        assert torch.equal(c3.cpu(), h3)
        for name in cm.CellMap._fields[1:-1]:
            assert torch.equal(getattr(card, name).cpu(), getattr(host, name)), name
        assert card.frame_idx == host.frame_idx
    assert int(host.count.max()) > 32 and int(host.n_cells()) > 512
    # the new-cell cap keeps the smallest keys, so the map lies at x < 0:
    # look back at it from x = 1
    t = torch.tensor([1.0, 0.5, 0.0])
    yaw = np.deg2rad(170.0)
    q = torch.tensor([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], dtype=torch.float32)
    sel_h = cm.cells_in_radius(host, t, 4.0) & cm.cells_in_fov(host, t, q, 45.0)
    sel_c = (cm.cells_in_radius(card, t.to(cuda), 4.0)
             & cm.cells_in_fov(card, t.to(cuda), q.to(cuda), 45.0))
    assert torch.equal(sel_c.cpu(), sel_h) and 0 < int(sel_h.sum()) < int(host.n_cells())
    src_h = voxel_downsample(cm.gather_cell_points(host, sel_h), 0.4, capacity=4096,
                             with_time=False)
    src_c = voxel_downsample(cm.gather_cell_points(card, sel_c), 0.4, capacity=4096,
                             with_time=False)
    for a, b in zip(src_c, src_h):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("pillar", [True, False])
def test_velodyne_extraction_equals_cpu(cuda, pillar):
    pts = vlp16_sweep(pillar=pillar)
    xyz = np.zeros((16384, 3), np.float32)
    mask = np.zeros(16384, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    fe = SlamConfig().replace(feature_extraction={"scan_line": 16}).feature_extraction
    host = extract_velodyne_features(torch.from_numpy(xyz), torch.from_numpy(mask), 1.5, fe)
    card = extract_velodyne_features(torch.from_numpy(xyz).to(cuda),
                                     torch.from_numpy(mask).to(cuda), 1.5, fe)
    for name in ("full", "corners", "surface"):
        h, c = getattr(host, name), getattr(card, name)
        assert torch.equal(c.mask.cpu(), h.mask), name
        tol = dict(rtol=0, atol=1e-6) if name == "surface" else dict(rtol=0, atol=0)
        torch.testing.assert_close(c.xyz.cpu(), h.xyz, **tol)
        torch.testing.assert_close(c.time.cpu(), h.time, rtol=1e-6, atol=0)
    assert int(host.surface.mask.sum()) > 100


# ------------------------------------------------------------ loop closure --

def plane_line_world(seed, n_planes=8, n_lines=6, pts_per=250):
    """Points on planes and lines of distinct orientations, ~4 × 4 cells
    each at 0.5 m (the structured world of tests/test_loop.py)."""
    rng = np.random.default_rng(seed)
    pts = []
    for _ in range(n_planes):
        normal = rng.normal(size=3)
        normal /= np.linalg.norm(normal)
        u = np.cross(normal, [1, 0.3, 0.2])
        u /= np.linalg.norm(u)
        v = np.cross(normal, u)
        c = rng.uniform(-6, 6, 3)
        ab = rng.uniform(-1.1, 1.1, (pts_per, 2))
        pts.append(c + ab[:, :1] * u + ab[:, 1:] * v + rng.normal(scale=1e-3, size=(pts_per, 3)))
    for _ in range(n_lines):
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        c = rng.uniform(-6, 6, 3)
        pts.append(c + rng.uniform(-1.2, 1.2, (pts_per, 1)) * d
                   + rng.normal(scale=2e-3, size=(pts_per, 3)))
    pts = np.concatenate(pts).astype(np.float32)
    xyz = np.zeros((4096, 3), np.float32)
    xyz[:len(pts)] = pts
    mask = np.zeros(4096, bool)
    mask[:len(pts)] = True
    batch = PointBatch(torch.from_numpy(xyz), torch.zeros(4096), torch.from_numpy(mask))
    return cm.append_cloud(cm.empty_cell_map(0.5, 2048, 64), batch, 10 ** 9, max_new=2048)[0]


def map_to(m, device):
    return m._replace(**{f: getattr(m, f).to(device) for f in cm.CellMap._fields[1:-1]})


def test_full_map_insertion_equals_cpu(cuda):
    """The odometry step's full-cloud cell map and touched mask on the
    card, bit for bit, over two admitted frames and one that is not
    (identity rotations, so both devices insert the same world points)."""
    from loam_livox_tpu_torch.core.types import FeatureFrame
    from loam_livox_tpu_torch.registration.icp import RegistrationResult
    from loam_livox_tpu_torch.runtime.odometry import commit_frame, init_state

    cfg = SlamConfig().replace(
        common={"if_motion_deblur": 0, "threshold_cell_revisit": 1},
        capacity={"cell_capacity": 2048, "cell_point_capacity": 16,
                  "map_corner_capacity": 1024, "map_surf_capacity": 4096},
        loop_closure={"if_enable_loop_closure": 1, "if_loop_service_async": 0})
    rng = np.random.default_rng(31)

    def batch(n, cap):
        xyz = np.zeros((cap, 3), np.float32)
        xyz[:n] = rng.uniform(-8, 8, (n, 3))
        mask = np.arange(cap) < n
        return PointBatch(torch.from_numpy(xyz), torch.zeros(cap), torch.from_numpy(mask))

    states = {"cpu": init_state(cfg, "cpu"), "card": init_state(cfg, cuda)}
    for step, accepted in enumerate((True, True, False)):
        frame = FeatureFrame(batch(200, 512), batch(900, 2048), batch(6000, 16384),
                             torch.tensor(0.1 * step), torch.tensor(0.1 * step + 0.1))
        one = torch.ones(())
        reg = RegistrationResult(
            q_w=torch.tensor([1.0, 0, 0, 0]), t_w=torch.tensor([0.3 * step, -0.2, 0.1]),
            q_incre=torch.tensor([1.0, 0, 0, 0]), t_incre=torch.tensor([0.3, -0.2, 0.1]),
            accepted=torch.tensor(accepted), enabled=torch.tensor(True), final_cost=one,
            gate_cost=one, inlier_threshold=one, angular_diff_deg=one, t_diff=one,
            n_blocks=torch.tensor(100), iterations=3)
        for key, dev in (("cpu", "cpu"), ("card", cuda)):
            def to(x, dev=dev):
                return (type(x)(*(to(y) for y in x)) if isinstance(x, tuple)
                        else x.to(dev) if isinstance(x, torch.Tensor) else x)
            fr = to(frame)
            states[key], _ = commit_frame(states[key], fr, fr.corners, fr.surface, to(reg), cfg)
        host, card = states["cpu"].cell_full, states["card"].cell_full
        assert card.frame_idx == host.frame_idx == step + 1
        for name in cm.CellMap._fields[1:-1]:
            assert torch.equal(getattr(card, name).cpu(), getattr(host, name)), name
        touched = states["card"].last_touched.cpu()
        assert torch.equal(touched, states["cpu"].last_touched)
        assert bool(touched.any()) == accepted
    assert int(host.n_cells()) > 500


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_descriptor_and_similarity_equal_cpu(cuda, seed):
    """On the CPU's cell features the card's descriptor equals the CPU's
    (counts, centre and ROI range within 1e-5, images within 1e-5: the
    canonical rotation's 3 × 3 solve runs on the host for both); on its
    own features the counts agree and the images correlate; the
    similarity of two images agrees within 1e-4 (cuDNN picks its own
    algorithm for the 60 × 60 correlation, whose f32 sums over 3,600
    products then run in another order: 3.1e-5 measured on an H100)."""
    from loam_livox_tpu_torch.loop import keyframe as kfm

    host = plane_line_world(seed)
    card = map_to(host, cuda)
    feats = cm.cell_features(host)
    real = kfm.cell_features
    try:
        kfm.cell_features = lambda m, incremental=True: (
            feats if m.keys.device.type == "cpu" else cm.CellFeatures(*(x.to(cuda) for x in feats)))
        dh = kfm.describe_keyframe(host, host.valid())
        dc = kfm.describe_keyframe(card, card.valid())
    finally:
        kfm.cell_features = real
    for f in kfm.KeyframeDescriptor._fields:
        a, b = getattr(dc, f).cpu().double(), getattr(dh, f).double()
        assert (a - b).abs().max() <= 1e-5, f
    own = kfm.describe_keyframe(card, card.valid())
    ref = kfm.describe_keyframe(host, host.valid())
    assert int(own.n_cells) == int(ref.n_cells)
    for f in ("img_plane", "img_line"):
        assert float(kfm.max_similarity(getattr(own, f).cpu(), getattr(ref, f))) > 0.98, f
        s_card = float(kfm.max_similarity(getattr(dc, f), getattr(own, f)))
        s_host = float(kfm.max_similarity(getattr(dh, f), getattr(own, f).cpu()))
        assert abs(s_card - s_host) < 1e-4, f


def drifted_loop_graph(device, n=12, drift=0.3):
    from loam_livox_tpu_torch.core import se3
    from loam_livox_tpu_torch.loop import pose_graph as pg

    ang = 2 * np.pi * np.arange(n) / n
    q = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)], 1).astype(np.float32)
    t = (np.stack([np.cos(ang) - 1, np.sin(ang), 0 * ang], 1) * 3).astype(np.float32)
    est = t + np.linspace(0, drift, n)[:, None] * np.array([1, 0.5, 0.2], np.float32)
    gq, gt = torch.from_numpy(q).to(device), torch.from_numpy(t).to(device)
    g = pg.build_odometry_chain(gq, gt, capacity_edges=n)._replace(
        t=torch.from_numpy(est.astype(np.float32)).to(device))
    qi = se3.quat_conjugate(gq[-1])
    return pg.add_loop_edge(g, n - 1, n - 1, 0, se3.quat_multiply(qi, gq[0]),
                            se3.quat_rotate(qi, gt[0] - gt[-1]))


@pytest.mark.parametrize("solver", ["optimize_pose_graph", "optimize_pose_graph_cg",
                                    "optimize_pose_graph_chain"])
def test_pose_graph_solve_equals_cpu(cuda, solver):
    from loam_livox_tpu_torch.loop import pose_graph as pg

    qc, tc, cost = getattr(pg, solver)(drifted_loop_graph(cuda))
    qh, th, _ = getattr(pg, solver)(drifted_loop_graph("cpu"))
    torch.testing.assert_close(qc.cpu(), qh, rtol=0, atol=1e-4)
    torch.testing.assert_close(tc.cpu(), th, rtol=0, atol=1e-4)
    assert float(cost) < 1e-5


def test_kernel_equals_plain_at_scene_alignment_shape(cuda):
    """The scene alignment's plane search at its finest scale: 8,192
    queries (keyframe 0's plane snapshot of the unscaled artifact at the
    0.1 m leaf, the historical side) against 8,192 voxel-sorted rows
    (keyframe 19's, the current side), within √50 m."""
    from loam_livox_tpu_torch.interop import loop_state_from_npz

    saved = loop_state_from_npz("scripts/loop_unscaled_state.npz", "cpu")

    def filtered(xyz):
        pts = torch.from_numpy(xyz).to(cuda)
        b = PointBatch(pts, torch.zeros(len(xyz), device=cuda),
                       torch.ones(len(xyz), dtype=torch.bool, device=cuda))
        return voxel_downsample(b, 0.1, capacity=8192)

    q = filtered(saved.keyframes[0].snap_plane)
    ref = filtered(saved.keyframes[19].snap_plane)
    n_q = q.mask.sum(dtype=torch.int32)
    assert int(n_q) == 8192 and int(ref.mask.sum()) == 8192
    d, i = kf.knn_fused(q.xyz, ref.xyz, ref.mask, k=5, query_count=n_q,
                        max_radius=50.0 ** 0.5)
    dp, ip = knn(q.xyz, ref.xyz, ref.mask, k=5, query_count=n_q, max_radius=50.0 ** 0.5)
    assert torch.equal(d, dp) and torch.equal(i, ip)


def test_async_service_on_the_card_equals_inline_cpu(cuda):
    """The loop service's worker on its own CUDA stream: the same
    keyframes (keys, descriptor counts, snapshots) as the inline service
    on the CPU, its launches counted apart from the frame path's."""
    from loam_livox_tpu_torch.runtime.loop_service import LoopCloser

    host = plane_line_world(5)
    card = map_to(host, cuda)
    touched = host.valid()
    lc = {"if_enable_loop_closure": 1, "scans_of_each_keyframe": 3,
          "scans_between_two_keyframe": 1, "minimum_keyframe_differen": 4,
          "avail_ratio_plane": 0.001, "avail_ratio_line": 0.0}
    svc_h = LoopCloser(SlamConfig().replace(loop_closure={**lc, "if_loop_service_async": 0}),
                       device="cpu")
    svc_c = LoopCloser(SlamConfig().replace(loop_closure={**lc, "if_loop_service_async": 1}),
                       device=cuda)
    before = kf.launches
    for i in range(12):
        ang = 2 * np.pi * i / 12
        q = torch.tensor([np.cos(ang / 2), 0, 0, np.sin(ang / 2)], dtype=torch.float32)
        t = torch.tensor([np.cos(ang) - 1, np.sin(ang), 0.0], dtype=torch.float32) * 2 \
            + 0.25 * i / 12
        svc_h.on_frame(host, touched, q, t, i)
        svc_c.on_frame(card, touched.to(cuda), q.to(cuda), t.to(cuda), i)
    svc_c.drain(timeout=300.0)
    assert kf.launches == before            # the worker's launches count apart
    assert svc_c.closed == svc_h.closed and svc_c.counts["knn_fused"] > 0
    for a, b in zip(svc_c.keyframes, svc_h.keyframes):
        assert torch.equal(a.keys.cpu(), b.keys)
        assert a.descriptor.n_cells == b.descriptor.n_cells
        assert a.snap_full.shape == b.snap_full.shape
    assert [e["stage"] for e in svc_c.gate_trace] == [e["stage"] for e in svc_h.gate_trace]
    svc_c.shutdown()


@pytest.mark.parametrize("parallel", [{"dispatch_chunk": 4}, {"frame_batch": 2}],
                         ids=["chunked", "racing"])
def test_loop_entries_under_dispatch_equal_cpu(cuda, parallel):
    """The loop service's entries under chunked and racing dispatch (the
    two modes tests/test_torch_loop_dispatch.py runs on the CPU), on the
    card against the CPU: each entry's frame index and touched mask
    equal, the keyframes' member keys equal, and the poses close.  The
    card runs the plain program (the run reads its first Gauss-Newton
    system on the host, which no graph capture allows); the frame
    program's entries equal the plain program's bit for bit
    (`test_frame_program_loop_closure_equals_plain`).

    Where the devices part: the run's first Gauss-Newton system has the
    same mask on both, residuals within 1e-7 and Jacobians within 1e-5
    relative (elementwise rounding), and H, g within 1e-5 relative of
    the CPU's and of the CPU's sum of the card's own inputs (summation
    order); a lane or row out of place would move them by O(1).  Over
    simulator seeds 0-5 (`scripts/torch_dispatch_rounding.py`, PERF.md
    §6) these read at most 1.4e-8, 2.1e-6 and 7.8e-7, and the
    iteration-capped ICP carries them into the poses: racing up to
    2.9e-4 m, chunked up to 1.5e-5 m and 0.27 m on seed 4, where the
    CPU alone, one thread against eight, parts by 0.41 m.  This test
    runs seed 2 (8 frames of 6,000 points, registration from frame 4,
    keyframes of 2 entries every entry, small so that keyframes
    complete; the service on its worker and stream on the card, inline
    on the CPU): poses within 1e-5 up to and including the first
    registered group (read 2.0e-6 m), and racing's later group within
    5e-4 (read 1.5e-4 m; above every seed's reading)."""
    from loam_livox_tpu_torch.registration import gauss_newton as GN
    from scripts.torch_dispatch_rounding import INIT, rel, run

    card, card_kf, (r_c, J_c, m_c, H_c, g_c, delta) = run(cuda, parallel, seed=2)
    host, host_kf, (r_h, J_h, m_h, H_h, g_h, _) = run("cpu", parallel, seed=2)
    n_entries = 2 if "dispatch_chunk" in parallel else 4
    assert [e[0] for e in card] == [e[0] for e in host] and len(card) == n_entries
    for (_, t_c, _), (_, t_h, _) in zip(card, host):
        assert torch.equal(t_c, t_h)
    assert len(card_kf) == len(host_kf) > 0
    for a, b in zip(card_kf, host_kf):
        assert torch.equal(a, b)

    H_o, g_o = GN.system_from_rJ(r_c, J_c, m_c, delta)   # the card's inputs, summed here
    assert torch.equal(m_c, m_h) and r_c.shape == r_h.shape and J_c.shape == J_h.shape
    assert rel(r_c, r_h) < 1e-7 and rel(J_c, J_h) < 1e-5
    assert max(rel(H_c, H_h), rel(g_c, g_h), rel(H_c, H_o), rel(g_c, g_o)) < 1e-5
    first_registered = min(f for f, _, _ in card if f >= INIT)
    for f, (_, _, p_c), (_, _, p_h) in zip([e[0] for e in card], card, host):
        tol = 1e-5 if f <= first_registered else 5e-4
        torch.testing.assert_close(p_c, p_h, rtol=0, atol=tol)


# ------------------------------------------- grid engine, shards, product --

def test_grid_engine_card_equals_cpu(cuda):
    """The bucket grid and its search are sorts, gathers and rounded
    elementwise ops: the card's directory and neighbours equal the CPU's
    bit for bit."""
    from loam_livox_tpu_torch.ops import bucket_grid as bg

    rng = np.random.default_rng(11)
    ref, mask = voxel_map(rng, 16384, 12.0, 0.4, 0.6)
    q = (ref[rng.integers(0, 9000, 2048)] + rng.normal(0, 0.3, (2048, 3))).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        g = bg.build_bucket_grid(torch.from_numpy(ref).to(dev), torch.from_numpy(mask).to(dev),
                                 1.0, 16384, 16)
        out[str(dev)] = (g, bg.grid_knn(torch.from_numpy(q).to(dev), g, k=5))
    (gc, (dc, ic)), (gg, (dg, ig)) = out["cpu"], out[str(cuda)]
    for f in ("keys", "pts", "src_idx", "slot_mask"):
        assert torch.equal(getattr(gg, f).cpu(), getattr(gc, f)), f
    assert torch.equal(dg.cpu(), dc) and torch.equal(ig.cpu(), ic)
    assert (dc < 1e29).any()


def test_shard_input_equals_plain_and_merges(cuda):
    """The kernel on a shard of a buffer (a nonzero base) equals its plain
    version, and the shards' searches merged by (distance, index) equal
    the whole buffer's search."""
    from loam_livox_tpu_torch.ops.knn import finish
    from loam_livox_tpu_torch.parallel.sharded import merge_candidates

    rng = np.random.default_rng(12)
    ref, mask = voxel_map(rng, 65536, 12.0, 0.4, 0.05)
    q = (ref[rng.integers(0, 3000, 2048)] + rng.normal(0, 0.3, (2048, 3))).astype(np.float32)
    q, ref, mask = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    world, radius = 32, 50.0 ** 0.5
    rows = 65536 // world
    n_q = torch.tensor(2000, device=cuda)
    ds, idx = [], []
    for r in range(world):
        sl = slice(r * rows, (r + 1) * rows)
        d, i = kf.knn_fused(q, ref[sl], mask[sl], k=5, query_count=n_q, max_radius=radius)
        dp, ip = knn(q, ref[sl], mask[sl], k=5, query_count=2000, max_radius=radius)
        assert torch.equal(d, dp) and torch.equal(i, ip), r
        ds.append(d)
        idx.append(i + r * rows)
    assert int(mask[rows:2 * rows].sum()) > 0
    d, i = merge_candidates(torch.cat(ds, -1), torch.cat(idx, -1), 5)
    d, i = finish(d, i.long(), None)
    d0, i0 = kf.knn_fused(q, ref, mask, k=5, query_count=n_q, max_radius=radius)
    assert torch.equal(d, d0) and torch.equal(i, i0)


def test_product_mode_on_one_card_equals_plain(cuda, tmp_path):
    """Product mode on an NCCL group of one rank runs the plain pipeline's
    trajectory bit for bit (small capacities, 10 frames).  Product mode
    runs at the configured capacities (the capacity schedule is off
    there), so the plain run turns the schedule off too."""
    import torch.distributed as dist

    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = SlamConfig().replace(
        capacity={"max_raw_points": 16384, "map_corner_capacity": 1024,
                  "map_surf_capacity": 4096, "auto_schedule": 0},
        mapping={"init_accumulate_frames": 4})
    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=1))
    frames = [sim.frame(i) for i in range(10)]

    def run(mesh):
        pipe = OdometryPipeline(cfg, device=cuda, mesh=mesh)
        for f in frames:
            pipe.process_raw(*f)
        pipe.flush()
        return pipe.trajectory

    plain = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        product = run(make_mesh(1))
    finally:
        dist.destroy_process_group()
    assert np.array_equal(product.positions_array(), plain.positions_array())
    assert product.accepted == plain.accepted and sum(plain.accepted) > 0


# ---- the frame program: one CUDA graph launch a raw frame -------------------

def test_debounce_kernel_equals_plain(cuda):
    """The debounce kernel against its plain version, bit for bit: 300
    seeded candidate sets (empty, sparse, the 512-slot table overfull,
    small gaps) at 1, 7 and 512 slots, and `debounce_tables` (random,
    alternating kinds, the longest chain, a single kept slot, empty and
    overfull) at one warp or less, just past one warp, the shipped 512
    slots and past one block of 1,024 threads."""
    from loam_livox_tpu_torch.ops import debounce as db

    rng = np.random.default_rng(11)
    for trial in range(300):
        n = int(rng.integers(8, 16385))
        ns = int(rng.choice([1, 7, 512]))
        idx = np.sort(rng.choice(n, size=int(rng.integers(0, min(n, ns) + 1)), replace=False))
        cand = np.full(ns, n, np.int64)
        cand[:len(idx)] = idx
        edge = np.zeros(ns, bool)
        edge[:len(idx)] = rng.random(len(idx)) < rng.random()
        args = (torch.from_numpy(cand).to(cuda), torch.from_numpy(edge).to(cuda), n,
                torch.tensor(int(rng.integers(0, n + 1)), device=cuda), int(rng.integers(0, 80)))
        s_k, k_k = db.debounce(*args)
        s_p, k_p = db.debounce_plain(*args)
        assert torch.equal(s_k, s_p) and int(k_k) == int(k_p), trial
    for ns in (1, 7, 31, 33, 512, 1000, 1025, 4096):
        for trial, (cand, edge, n, n_valid, gap) in enumerate(
                debounce_tables(rng, ns, int(rng.integers(8, 16385)))):
            args = (torch.from_numpy(cand).to(cuda), torch.from_numpy(edge).to(cuda), n,
                    torch.tensor(n_valid, device=cuda), gap)
            s_k, k_k = db.debounce(*args)
            s_p, k_p = db.debounce_plain(*args)
            assert torch.equal(s_k, s_p) and int(k_k) == int(k_p), (ns, trial)


@pytest.mark.parametrize("ns", [1 << 14, 1 << 15])
def test_debounce_past_shared_memory_equals_plain(cuda, ns):
    """A table whose tables one block's shared memory cannot hold (past
    ~11,900 slots on the H100) runs the kernel's global-memory form, bit
    for bit the plain version (`debounce_tables`: random, alternating
    kinds, the longest chain, one kept, empty and overfull); the next
    launch at 512 slots takes the shared form."""
    from loam_livox_tpu_torch.ops import debounce as db

    assert db.scratch_bytes(ns, cuda if cuda.index is not None
                            else torch.device("cuda", torch.cuda.current_device())) > 0
    rng = np.random.default_rng(ns)
    for trial, (cand, edge, n, n_valid, gap) in enumerate(debounce_tables(rng, ns, 3 * ns)):
        args = (torch.from_numpy(cand).to(cuda), torch.from_numpy(edge).to(cuda), n,
                torch.tensor(n_valid, device=cuda), gap)
        runs = db.runs.read()
        s_k, k_k = db.debounce(*args)
        s_p, k_p = db.debounce_plain(*args)
        assert torch.equal(s_k, s_p) and int(k_k) == int(k_p), trial
        assert db.runs.read() == runs + 1          # the kernel ran, not a plain route
    cand = torch.arange(512, dtype=torch.int64, device=cuda)
    args = (cand, torch.zeros(512, dtype=torch.bool, device=cuda), 512,
            torch.tensor(512, device=cuda), 3)
    s_k, k_k = db.debounce(*args)
    s_p, k_p = db.debounce_plain(*args)
    assert torch.equal(s_k, s_p) and int(k_k) == int(k_p)


def test_front_end_past_shared_memory_equals_cpu(cuda):
    """The Livox front end at ``max_splits`` 16,384 (the debounce's global
    form) on the card against the CPU: split table, kept count and the
    selected features equal."""
    from chip_smoke import simulate
    from loam_livox_tpu_torch.frontend import livox

    cfg = SlamConfig().replace(capacity={"max_splits": 1 << 14})
    _, host = simulate(1, 10000, 2)
    xyz, inten, t0 = host[0]
    n = cfg.capacity.max_raw_points
    pts, it, m = np.zeros((n, 3), np.float32), np.zeros(n, np.float32), np.zeros(n, bool)
    pts[:len(xyz)], it[:len(xyz)], m[:len(xyz)] = xyz, inten, True
    out = {}
    for dev in ("cpu", cuda):
        tables = []
        real = livox.debounce
        livox.debounce = lambda *a: tables.append(real(*a)) or tables[-1]
        try:
            _, _, frames = livox.extract_frame(
                *(torch.from_numpy(a).to(dev) for a in (pts, it, m)), t0,
                cfg.feature_extraction, cfg.capacity)
        finally:
            livox.debounce = real
        out[str(dev)] = (tables[0], frames[0])
    (s_c, k_c), fr_c = out["cpu"]
    (s_g, k_g), fr_g = out[str(cuda)]
    assert s_c.shape == (1 << 14,) and torch.equal(s_g.cpu(), s_c) and int(k_g) == int(k_c)
    for name in ("corners", "surface"):
        a, b = getattr(fr_g, name), getattr(fr_c, name)
        assert torch.equal(a.mask.cpu(), b.mask) and torch.equal(a.xyz.cpu(), b.xyz), name


def test_split_search_past_the_kernels_rows_equals_plain(cuda):
    """A 2,000,000-row buffer, past `knn_fused.max_ref_rows(5)`: the
    searcher runs the kernel on row blocks and merges them, bit for bit
    the plain search of the whole buffer, with valid rows in every
    block."""
    from loam_livox_tpu_torch.parallel.mesh import set_active_mesh
    from loam_livox_tpu_torch.registration import icp

    set_active_mesh(None)           # no product mesh left by an earlier test
    rng = np.random.default_rng(21)
    m = 2_000_000
    assert m > kf.max_ref_rows(5)
    xyz = rng.uniform(-30, 30, (m, 3)).astype(np.float32)
    mask = rng.random(m) < 0.3
    q = (xyz[rng.integers(0, m, 256)] + rng.normal(0, 0.5, (256, 3))).astype(np.float32)
    ref = PointBatch(xyz=torch.from_numpy(xyz).to(cuda), time=torch.zeros(m, device=cuda),
                     mask=torch.from_numpy(mask).to(cuda))
    q = torch.from_numpy(q).to(cuda)
    count = torch.tensor(240, dtype=torch.int32, device=cuda)
    runs = kf.runs.read()
    d, i = icp._searcher("pallas", ref, None, 5, 2.0, 1024)(q, count)
    assert kf.runs.read() - runs == 2            # one launch a block
    dp, ip = knn(q, ref.xyz, ref.mask, k=5, query_count=240, max_radius=2.0)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert (i >= kf.max_ref_rows(5)).any()


def test_loop_condition_kernel_equals_plain(cuda):
    from loam_livox_tpu_torch.ops import graph_cond as gc

    many = [False] * 1100
    many[1099] = True
    for lanes in ([False], [True], [False, False, True], [False] * 9, [False] * 40 + [True],
                  [False] * 40, many, [False] * 1100):
        active = torch.tensor(lanes, device=cuda)
        for loops, max_loops in ((0, 15), (14, 15), (15, 15), (3, 0)):
            n = torch.tensor(loops, dtype=torch.int32, device=cuda)
            assert int(gc.loop_condition(active, n, max_loops)) == \
                int(gc.loop_condition_plain(active, n, max_loops))


def test_switch_index_kernel_equals_plain(cuda):
    """The switch's condition kernel: the first set flag, or the number of
    flags when none is set, for every row of one to three flags and a
    row of 32."""
    from itertools import product

    from loam_livox_tpu_torch.ops import graph_cond as gc

    rows = [list(r) for b in (1, 2, 3) for r in product((False, True), repeat=b)]
    rows += [[False] * 32, [False] * 31 + [True]]
    for row in rows:
        flags = torch.tensor(row, device=cuda)
        got, want = gc.switch_index(flags), gc.switch_index_plain(flags)
        assert got.dtype == want.dtype == torch.int32 and int(got) == int(want), row


def test_switch_node_runs_the_body_its_flags_pick(cuda):
    """A frame graph of a segment and a SWITCH item of two bodies (each
    adds its own amount to a counter) runs exactly the body the flags
    pick: the first (rebuild), the second (append) or neither, and counts
    one condition run a replay."""
    from loam_livox_tpu_torch.ops import graph_cond as gc

    total = torch.zeros((), dtype=torch.int64, device=cuda)
    flags = torch.zeros(2, dtype=torch.bool, device=cuda)
    gc.switch_index(flags)                      # the counter's first use, before capture
    keep = []

    def capture(amount):
        g = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(g):
            total.add_(amount)
        keep.append(g)
        return g.raw_cuda_graph()

    graph = gc.build_frame_graph(cuda, [gc.Item(gc.SEGMENT, capture(1)),
                                        gc.Item(gc.SWITCH, (capture(10), capture(100)),
                                                flags)])
    assert graph.cond_nodes == 1
    for row, body in (([True, False], 10), ([False, True], 100), ([False, False], 0),
                      ([True, True], 10)):
        flags.copy_(torch.tensor(row, device=cuda))
        total.zero_()
        gc.runs.reset()
        gc.switch_runs.reset()
        launches = gc.launches
        graph.launch()
        torch.cuda.synchronize()
        assert int(total) == 1 + body, row
        assert gc.switch_runs.read() == 1 and gc.runs.read() == 0 and gc.launches == launches
    graph.close()
    with pytest.raises(ValueError):             # one flag a body
        gc.build_frame_graph(cuda, [gc.Item(gc.SWITCH, (keep[1].raw_cuda_graph(),), flags)])


def _state_leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(_state_leaves(getattr(tree, f), f"{prefix}.{f}"))
    return out


def _graph_and_plain(cuda, cfg, n_frames, init=10):
    """The same padded frames through a pipeline on the frame program and
    one on the plain program (``program = None``), both on the card (the
    simulator's trajectory starts moving after ``init`` frames)."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.runtime import pipeline as P

    _, host = simulate(n_frames, 10000, init)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    out = []
    for plain in (False, True):
        pipe = P.OdometryPipeline(cfg, device=cuda)
        if plain:
            pipe.program = None
        P.reset_host_syncs()
        for pts, inten, t0, mask in frames:
            pipe.process_raw(pts, inten, t0, mask=mask)
        pipe.flush()
        out.append((pipe, P.host_syncs(), P.graph_counts()))
    return out


def _assert_runs_equal(graph, plain, states=None):
    """Rows, iterations and every state tensor equal (``states``: the
    two pipelines' states read earlier, as a product run's must be while
    its process group is up)."""
    tg, tp = graph.trajectory, plain.trajectory
    assert tg.times == tp.times and tg.accepted == tp.accepted
    assert np.array_equal(tg.positions_array(), tp.positions_array())
    assert np.array_equal(np.asarray(tg.quaternions), np.asarray(tp.quaternions))
    assert graph.iterations == plain.iterations
    sg, sp = states or (graph.state, plain.state)
    lg, lp = _state_leaves(sg), _state_leaves(sp)
    assert lg.keys() == lp.keys()
    for k in lg:
        assert lg[k].dtype == lp[k].dtype and torch.equal(lg[k], lp[k]), k


def test_frame_program_main_equals_plain_across_growths(cuda):
    """The shipped default (deblur, the capacity schedule) over 20 frames,
    two growths: one graph launch a frame, no debounce, ICP-exit or
    admission read, and rows and every state tensor bit-equal to the
    plain program on the card."""
    from loam_livox_tpu_torch.core.config import SlamConfig

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 10})
    (g, sg, cg), (p, sp, cp) = _graph_and_plain(cuda, cfg, 20)
    assert g.program is not None and len(g.ladder) >= 1 and g.ladder == p.ladder
    assert cg["graph_launch"] == 20 and cg["graph_capture"] == len(g.ladder) + 1
    # only the schedule's and the final drain's reads remain (no ICP exit
    # or admission read; the front end has no read left)
    assert {k for k, v in sg.items() if v} == {"schedule", "drain"}
    assert (sg["schedule"], sg["drain"]) == (sp["schedule"], sp["drain"])
    assert sp["icp_exit"] > 0 and cp["graph_launch"] == 0
    # each growth freed the graphs of the tier it left
    assert [k["held"] for k in g.program.summary()] == [False] * len(g.ladder) + [True]
    _assert_runs_equal(g, p)


def test_frame_program_precision_equals_plain(cuda):
    """Three pieces a frame: three WHILE nodes in one graph, 10 frames."""
    from loam_livox_tpu_torch.core.config import precision_profile

    cfg = precision_profile().replace(mapping={"init_accumulate_frames": 4})
    (g, sg, cg), (p, _, _) = _graph_and_plain(cuda, cfg, 10)
    assert cg["graph_launch"] == 10 and len(g.trajectory.times) == 30
    assert {k for k, v in sg.items() if v} <= {"schedule", "drain"}
    _assert_runs_equal(g, p)


def test_while_node_runs_the_host_loops_passes(cuda):
    """The WHILE node's passes, counted on the card, equal the host loop's
    (rows' iterations and the pipelines' loop passes)."""
    from loam_livox_tpu_torch.core.config import realtime_profile

    cfg = realtime_profile().replace(mapping={"init_accumulate_frames": 4})
    (g, _, _), (p, _, _) = _graph_and_plain(cuda, cfg, 8)
    assert g.iterations == p.iterations and sum(g.iterations) > 0
    assert g.loop_iterations == p.loop_iterations == sum(p.iterations)


def test_run_counters_count_the_replays(cuda):
    """The kernels count their own runs on the card: in the replays, the
    kNN kernel runs twice a pass, the debounce once a frame, the loop
    condition once before each step's loop and once a pass, and the
    switch condition once before each step's SWITCH node (rebuild or
    append); captures run nothing."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.ops import debounce as db
    from loam_livox_tpu_torch.ops import graph_cond as gc
    from loam_livox_tpu_torch.ops import knn_fused as kf
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0})
    _, host = simulate(6, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    pipe.process_raw(*frames[0][:3], mask=frames[0][3])      # the capture, and frame 0
    torch.cuda.synchronize()
    passes0 = pipe.loop_iterations
    from loam_livox_tpu_torch.ops import threefry as tf

    for counter in (kf.runs, db.runs, gc.runs, gc.switch_runs, tf.split_runs, tf.mask_runs):
        counter.reset()
    launches = (kf.launches, db.launches, gc.launches, tf.split_launches, tf.mask_launches)
    for pts, inten, t0, mask in frames[1:]:
        pipe.process_raw(pts, inten, t0, mask=mask)
    pipe.flush()
    passes = pipe.loop_iterations - passes0
    assert passes > 0 and kf.runs.read() == 2 * passes
    assert db.runs.read() == 5 and gc.runs.read() == passes + 5 and gc.switch_runs.read() == 5
    # the state's key split once a step and the carry's once a pass; no
    # draw without subsampling
    assert tf.split_runs.read() == passes + 5 and tf.mask_runs.read() == 0
    assert (kf.launches, db.launches, gc.launches, tf.split_launches,
            tf.mask_launches) == launches     # no launch from Python


def test_capture_makes_no_host_sync(cuda):
    """Capture and replay under torch's sync debug mode "error": a read
    on the host anywhere in the frame would raise."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0})
    _, host = simulate(5, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pts, inten, t0, mask in frames:
            pipe.process_raw(pts, inten, t0, mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pipe.flush()
    assert len(pipe.trajectory.times) == 5 and sum(pipe.iterations) > 0


# ---- chunked and racing dispatch on the frame program -----------------------

def _units(cfg, n_frames):
    """Raw frames a pipeline of ``cfg`` dispatches as one unit."""
    par = cfg.parallel
    return max(int(par.frame_batch), int(par.dispatch_chunk), 1)


def test_frame_program_chunked_equals_plain_across_a_growth(cuda):
    """Chunks of 4 (22 frames: five chunks, then a tail of 2 at `flush`)
    with the capacity schedule, which grows at the fourth chunk: one
    graph launch a chunk, the frame captured once a tier and placed four
    (or two) times, no ICP-exit or admission read, and rows, iterations
    and every state tensor bit-equal to the plain program's."""
    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 6},
                               parallel={"dispatch_chunk": 4})
    (g, sg, cg), (p, sp, cp) = _graph_and_plain(cuda, cfg, 22)
    assert g.program is not None and len(g.ladder) == 1 and g.ladder == p.ladder
    assert cg["graph_launch"] == cg["launch_chunk"] == 6 and cg["launch_frame"] == 0
    keys = g.program.summary()
    assert [(k["kind"], k["frames"]) for k in keys] == [
        ("frame", 1), ("chunk", 4), ("frame", 1), ("chunk", 4), ("chunk", 2)]
    assert [k["launches"] for k in keys] == [0, 4, 0, 1, 1]
    assert cg["graph_capture"] == len(keys) and cg["capture_frame"] == 2
    assert {k for k, v in sg.items() if v} == {"schedule", "drain"}
    assert sp["icp_exit"] > 0 and cp["graph_launch"] == 0
    _assert_runs_equal(g, p)


def test_frame_program_racing_equals_plain_across_a_growth(cuda):
    """The realtime racing profile (3 raw frames x 3 pieces a group, 9
    lanes, the motion guard on) over 18 frames with the schedule, its
    watermark lowered to 0.2 so that it grows at the fourth group (at
    0.7 this stream's fills stay under it): one graph launch a raced
    group (and one a fallen-back frame), the group's passes counted on
    the card, no ICP-exit or admission read, and rows, iterations, passes
    and every state tensor bit-equal to the plain program's."""
    from loam_livox_tpu_torch.core.config import realtime_racing_profile

    cfg = realtime_racing_profile().replace(mapping={"init_accumulate_frames": 4},
                                            capacity={"schedule_watermark": 0.2})
    (g, sg, cg), (p, sp, cp) = _graph_and_plain(cuda, cfg, 18)
    assert g.program is not None and len(g.ladder) >= 1 and g.ladder == p.ladder
    assert (g.raced_groups, g.fallback_groups) == (p.raced_groups, p.fallback_groups)
    assert cg["launch_group"] == g.raced_groups > 0
    assert cg["launch_frame"] == 3 * g.fallback_groups
    assert g.raced_loop_iterations == p.raced_loop_iterations > 0
    assert g.loop_iterations == p.loop_iterations
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0
    assert sg["drain"] == sp["drain"] and sg["schedule"] == sp["schedule"]
    _assert_runs_equal(g, p)


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["frame", "chunk", "group"])
def test_unit_capture_makes_no_host_sync(cuda, parallel):
    """Each kind of unit captured and replayed under torch's sync debug
    mode "error": a read on the host anywhere in the unit would raise
    (racing's own read of drained rows comes after the queue fills, past
    these frames)."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0},
                               common={"maximum_parallel_thread": 3}, parallel=parallel)
    n = 4 * _units(cfg, 0) if parallel else 5
    _, host = simulate(n, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    assert pipe.program is not None
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for pts, inten, t0, mask in frames[:3 * _units(cfg, 0)]:
            pipe.process_raw(pts, inten, t0, mask=mask)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for pts, inten, t0, mask in frames[3 * _units(cfg, 0):]:
        pipe.process_raw(pts, inten, t0, mask=mask)
    pipe.flush()
    kind = "group" if "frame_batch" in parallel else "chunk" if parallel else "frame"
    assert [k["kind"] for k in pipe.program.summary()][-1] == kind
    assert len(pipe.trajectory.times) == len(frames)       # one piece a frame


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["frame", "chunk", "group"])
def test_a_state_read_is_not_changed_by_the_next_unit(cuda, parallel):
    """`pipe.state` read after one unit is a snapshot: the next unit
    updates the program's static state in place, never the state read;
    and a state set on the pipeline is what the next unit starts from."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    base = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                                capacity={"auto_schedule": 0})
    # racing: the host reads each group's rows at once, and the motion
    # guard is off, so both pipelines below run the same groups
    cfg = base.replace(parallel={**parallel, "batch_motion_guard_t": 0.0},
                       common={"maximum_parallel_thread": 1})
    k = _units(cfg, 0)
    _, host = simulate(3 * k, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    for f in frames[:2 * k]:
        pipe.process_raw(f[0], f[1], f[2], mask=f[3])
    held = pipe.state
    copy = {n: v.clone() for n, v in _state_leaves(held).items()}
    for f in frames[2 * k:]:
        pipe.process_raw(f[0], f[1], f[2], mask=f[3])
    pipe.flush()
    after = _state_leaves(pipe.state)
    assert int(pipe.state.frame_count) > int(copy[".frame_count"])
    assert any(not torch.equal(after[n], copy[n]) for n in copy)
    for n, v in _state_leaves(held).items():
        assert torch.equal(v, copy[n]), n
    # a state set from outside: the next unit starts from it
    other = OdometryPipeline(cfg, device=cuda)
    other.state = held
    for f in frames[2 * k:]:
        other.process_raw(f[0], f[1], f[2], mask=f[3])
    other.flush()
    for n, v in _state_leaves(other.state).items():
        assert torch.equal(v, after[n]), n


# ---- cell matching and loop closure on the frame program --------------------

def _cell_config(parallel=None):
    """Cell matching (``full_mapping``'s settings at 2,048 cells of 16
    points), registration from frame 4."""
    return SlamConfig().replace(
        mapping={"init_accumulate_frames": 4, "matching_mode": 1},
        capacity={"cell_capacity": 2048, "cell_point_capacity": 16},
        parallel={**(parallel or {}), "batch_motion_guard_t": 0.0})


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["sequential", "chunked", "racing"])
def test_frame_program_cell_mode_equals_plain(cuda, parallel):
    """Cell matching on the frame program (10 frames; chunks of 4 with a
    tail of 2; racing groups of 3 with a tail of 1): one graph launch a
    unit, no ICP-exit or admission read, and rows, iterations and every
    state tensor (the cell maps and their frame indices included)
    bit-equal to the plain program's."""
    cfg = _cell_config(parallel)
    (g, sg, cg), (p, sp, cp) = _graph_and_plain(cuda, cfg, 10, init=4)
    assert g.program is not None and cg["graph_launch"] > 0 and cp["graph_launch"] == 0
    units = {"dispatch_chunk": 3, "frame_batch": 4}.get(next(iter(parallel), None), 10)
    assert cg["graph_launch"] == units
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0 and sp["admit"] == 0
    assert int(g.state.cell_planes.n_cells()) > 0 and int(g.state.cell_planes.frame_idx) == 10
    assert sum(g.iterations) > 0
    _assert_runs_equal(g, p)


def _loop_config(parallel=None, async_service=1):
    """Loop closure with keyframes of 3 entries, one every 2, on the
    schedule with its watermark lowered to 0.2 (a growth, so a capture,
    mid-stream), registration from frame 4."""
    return SlamConfig().replace(
        mapping={"init_accumulate_frames": 4},
        capacity={"schedule_watermark": 0.2},
        loop_closure={"if_enable_loop_closure": 1, "scans_of_each_keyframe": 3,
                      "scans_between_two_keyframe": 2,
                      "if_loop_service_async": async_service},
        parallel={**(parallel or {}), "batch_motion_guard_t": 0.0})


def _hold_worker(monkeypatch):
    """Keep the loop service's worker busy inside each keyframe, running
    and allocating on its own stream, until the returned event is set
    (at most 120 s); returns the event."""
    from loam_livox_tpu_torch.runtime import loop_service as LS

    release, real = __import__("threading").Event(), LS.LoopCloser.process_keyframe

    def held(self, rec, m):
        x = torch.ones(1 << 16, device=m.keys.device)
        while not release.wait(0.002):
            x = (x * 1.0001 + torch.ones_like(x)).clamp_(max=2.0)
        real(self, rec, m)

    monkeypatch.setattr(LS.LoopCloser, "process_keyframe", held)
    return release


def _loop_runs(cuda, cfg, n_frames, monkeypatch, hold=False):
    """The same padded frames through the frame program and the plain
    program on the card, the loop service's entries recorded
    (`chip_smoke.record_loop_entries`); with ``hold`` the worker held
    busy (`_hold_worker`) until every frame is in, and whether it was
    busy at each capture.  Returns ((pipeline, syncs, graphs, entries),
    (the same for the plain run), busy at each capture)."""
    from chip_smoke import on_device, record_loop_entries, simulate
    from loam_livox_tpu_torch.runtime import frame_program as fp
    from loam_livox_tpu_torch.runtime import loop_service as LS
    from loam_livox_tpu_torch.runtime import pipeline as P

    _, host = simulate(n_frames, 10000, 4)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    busy, closers, real_capture = [], [], fp._Pool.capture

    def capture(self, fn):
        busy.append(closers[-1].busy)
        return real_capture(self, fn)

    monkeypatch.setattr(fp._Pool, "capture", capture)
    out = []
    for plain in (False, True):
        release = _hold_worker(monkeypatch) if hold else None
        entries, restore = record_loop_entries(LS)
        try:
            pipe = P.OdometryPipeline(cfg, device=cuda)
            closers.append(pipe.loop_closer)
            if plain:
                pipe.program = None
            P.reset_host_syncs()
            for pts, inten, t0, mask in frames:
                pipe.process_raw(pts, inten, t0, mask=mask)
            if release is not None:
                release.set()
            pipe.flush()
        finally:
            if release is not None:
                release.set()
            restore()
        pipe.loop_closer.shutdown()
        out.append((pipe, P.host_syncs(), P.graph_counts(),
                    entries.get(id(pipe.loop_closer), [])))
    return out[0], out[1], busy


def _assert_entries_equal(graph, plain):
    """The loop service's entries, bit for bit: frame index, touched keys
    and each completed keyframe's member keys, pose and ending frame."""
    assert [e[0] for e in graph] == [e[0] for e in plain] and graph
    assert any(rec is not None for *_, rec in plain)
    for (_, kg, rg), (_, kp, rp) in zip(graph, plain):
        assert torch.equal(kg, kp) and (rg is None) == (rp is None)
        if rg is not None:
            assert rg.ending_frame_idx == rp.ending_frame_idx
            for f in ("keys", "q", "t"):
                assert torch.equal(getattr(rg, f), getattr(rp, f)), f


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["sequential", "chunked", "racing"])
def test_frame_program_loop_closure_equals_plain(cuda, parallel, monkeypatch):
    """Loop closure on the frame program over 18 frames across a growth:
    one graph launch a unit, no ICP-exit or admission read, rows, every
    state tensor (the full-cloud map, its touched mask, the feature maps)
    and the loop service's entries (a chunk's or a group's the OR of its
    frames' touched masks) bit-equal to the plain program's, and the
    keyframes the worker processed the same."""
    cfg = _loop_config(parallel)
    (g, sg, cg, eg), (p, sp, cp, ep), _ = _loop_runs(cuda, cfg, 18, monkeypatch)
    assert g.program is not None and len(g.ladder) >= 1 and g.ladder == p.ladder
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0 and cp["graph_launch"] == 0
    assert cg["graph_launch"] == len(eg) and g.loop_iterations == p.loop_iterations
    _assert_runs_equal(g, p)
    _assert_entries_equal(eg, ep)
    kg, kp = g.loop_closer.keyframes, p.loop_closer.keyframes
    assert len(kg) == len(kp) > 0
    for a, b in zip(kg, kp):
        assert torch.equal(a.keys, b.keys) and a.descriptor.n_cells == b.descriptor.n_cells
        assert np.array_equal(a.snap_full, b.snap_full)


def test_a_waiting_keyframe_keeps_its_map_and_pose(cuda, monkeypatch):
    """With the worker held in its first keyframe, a later keyframe waits:
    its record's pose and keys and its cell map stay as they were when it
    completed while the next frames' graph launches update the static
    state in place, and its map is not the static state's."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg = _loop_config().replace(capacity={"auto_schedule": 0})
    _, host = simulate(14, 10000, 4)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    release = _hold_worker(monkeypatch)
    pipe = OdometryPipeline(cfg, device=cuda)
    closer = pipe.loop_closer
    try:
        item = None
        for i, (pts, inten, t0, mask) in enumerate(frames):
            pipe.process_raw(pts, inten, t0, mask=mask)
            with closer._lock:          # the first keyframe held, a later one waiting
                if closer.busy and closer.waiting:
                    item = closer.waiting[0]
            if item is not None:
                break
        assert item is not None and i + 4 < len(frames)
        rec, m, _ = item
        kept_rec = {f: getattr(rec, f).clone() for f in ("q", "t", "keys")}
        kept_map = {f: getattr(m, f).clone() for f in m._fields[1:]}
        static = pipe._live().cell_full
        for f in m._fields[1:]:
            assert getattr(m, f).data_ptr() != getattr(static, f).data_ptr(), f
        for pts, inten, t0, mask in frames[i + 1:]:
            pipe.process_raw(pts, inten, t0, mask=mask)
        torch.cuda.synchronize()
        assert int(static.frame_idx) == len(frames) and int(m.frame_idx) < len(frames)
        for f, v in kept_rec.items():
            assert torch.equal(getattr(rec, f), v), f
        for f, v in kept_map.items():
            assert torch.equal(getattr(m, f), v), f
    finally:
        release.set()
    pipe.flush()
    closer.shutdown()
    assert any(r is rec for r in closer.keyframes)


def test_capture_while_the_worker_processes_a_keyframe(cuda, monkeypatch):
    """A capacity growth captures a new key while the loop worker runs a
    keyframe on its own stream (held busy, allocating, until every frame
    is in): the capture succeeds, and the run equals the plain program's
    under the same hold (rows, state, loop entries)."""
    cfg = _loop_config()
    (g, sg, cg, eg), (p, _, _, ep), busy = _loop_runs(cuda, cfg, 18, monkeypatch, hold=True)
    assert len(g.ladder) >= 1 and cg["graph_capture"] >= 2
    assert busy[0] is False and any(busy), busy
    assert sg["icp_exit"] == sg["admit"] == 0
    _assert_runs_equal(g, p)
    _assert_entries_equal(eg, ep)


# ---- Velodyne, the multi-head frame and the grid / dense engines -----------

def _warm_up(cuda):
    """The frame program's warm-up, which runs each kernel once."""
    from loam_livox_tpu_torch.runtime.frame_program import _warm_up as warm

    warm(cuda)


def _sweeps(cuda, cfg, n):
    """``n`` VLP-16 sweeps (`chip_smoke.velodyne_sweeps`), padded on the card."""
    from chip_smoke import on_device, velodyne_sweeps

    host, _ = velodyne_sweeps(n)
    return on_device(host, cfg.capacity.max_raw_points, cuda)


def _runs(cuda, cfg, frames, feed=None):
    """``frames`` through a pipeline on the frame program and one on the
    plain program, both on the card; ``feed(pipe, frame)`` runs one
    (default `process_raw` of a padded raw frame).  The graph run's state
    read after its first unit must be unchanged at its end.  Returns
    ((pipeline, syncs, graphs), (the same for the plain run))."""
    from loam_livox_tpu_torch.runtime import pipeline as P

    feed = feed or (lambda pipe, f: pipe.process_raw(f[0], f[1], f[2], mask=f[3]))
    out = []
    for plain in (False, True):
        pipe = P.OdometryPipeline(cfg, device=cuda)
        if plain:
            pipe.program = None
        P.reset_host_syncs()
        unit = max(pipe.frame_batch, pipe.dispatch_chunk)
        for f in frames[:unit]:
            feed(pipe, f)
        held = None if plain else pipe.state
        copy = None if plain else {k: v.clone() for k, v in _state_leaves(held).items()}
        for f in frames[unit:]:
            feed(pipe, f)
        pipe.flush()
        if held is not None:
            for k, v in _state_leaves(held).items():
                assert torch.equal(v, copy[k]), k
        out.append((pipe, P.host_syncs(), P.graph_counts()))
    return out


def _velodyne_config(parallel=None, capacity=None):
    from chip_smoke import velodyne_config
    from loam_livox_tpu_torch.core import config as C

    cfg = velodyne_config(C, capacity)
    return cfg.replace(parallel={**(parallel or {}), "batch_motion_guard_t": 0.0})


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["sequential", "chunked", "racing"])
def test_frame_program_velodyne_equals_plain(cuda, parallel):
    """VLP-16 sweeps through the Velodyne front end on the frame program
    with the capacity schedule (12 sweeps; 20 in chunks of 4, 15 in racing
    groups of 3: five units, so that the schedule grows at the fourth):
    one graph launch a unit, keys freed as the tiers grow, no ICP-exit
    or admission read, no debounce run (the Velodyne front end has none),
    and rows, iterations and every state tensor bit-equal to the plain
    program's."""
    from loam_livox_tpu_torch.ops import debounce as db

    cfg = _velodyne_config(parallel)
    units = {"dispatch_chunk": 5, "frame_batch": 5}.get(next(iter(parallel), None), 12)
    frames = _sweeps(cuda, cfg, units * _units(cfg, 0))
    _warm_up(cuda)          # its own kernel runs come before the count
    db.runs.reset()
    (g, sg, cg), (p, sp, cp) = _runs(cuda, cfg, frames)
    assert g.program is not None and g.ladder == p.ladder and len(g.ladder) >= 1
    assert cg["graph_launch"] == units and cp["graph_launch"] == 0
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0
    assert db.runs.read() == 0 and sum(g.iterations) > 0
    keys = g.program.summary()
    assert keys[-1]["held"] and all(k["debounces"] == 0 for k in keys)
    assert g.loop_iterations == p.loop_iterations
    _assert_runs_equal(g, p)


@pytest.mark.parametrize("engine,parallel", [("grid", {}), ("grid", {"dispatch_chunk": 4}),
                                             ("dense", {}), ("dense", {"frame_batch": 3})],
                         ids=["grid", "grid-chunked", "dense", "dense-racing"])
def test_frame_program_engines_equal_plain(cuda, engine, parallel):
    """The ``grid`` and ``dense`` engines on the frame program (10 frames,
    registration from frame 4): one graph launch a unit, no ``knn_fused``
    run, no ICP-exit or admission read, and rows, iterations and every
    state tensor, the bucket grids included, bit-equal to the plain
    program's."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.ops import knn_fused as kf

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 4},
                               optimization={"correspondence": engine},
                               parallel={**parallel, "batch_motion_guard_t": 0.0})
    _, host = simulate(10, 10000, 4)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    _warm_up(cuda)
    kf.runs.reset()
    (g, sg, cg), (p, sp, cp) = _runs(cuda, cfg, frames)
    units = {"dispatch_chunk": 3, "frame_batch": 4}.get(next(iter(parallel), None), 10)
    assert g.program is not None and cg["graph_launch"] == units and cp["graph_launch"] == 0
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0
    assert kf.runs.read() == 0 and sum(g.iterations) > 0
    assert (g.state.grid_surface is not None) == (engine == "grid")
    if engine == "grid":
        assert int(g.state.grid_surface.slot_mask.sum()) > 0
    _assert_runs_equal(g, p)


def test_frame_program_multi_head_equals_plain(cuda):
    """The ``mid100_trilidar`` scenario (3 heads of 8,192 points, two
    merged pieces a frame, the schedule on; registration from frame 4)
    over 10 frames: 1 + 2 graph
    launches a frame (the heads key, then one step key launch a piece),
    the step keys freed as the tiers grow, the debounce run once a head
    (in the heads graph, and from Python in the plain run),
    no ICP-exit or admission read, and rows, iterations and every state
    tensor bit-equal to the plain program's (`extract_heads` then
    `odometry_step` a piece)."""
    from loam_livox_tpu_torch.eval import scenarios as S
    from loam_livox_tpu_torch.ops import debounce as db

    cfg, kw = S.scenario_config("mid100_trilidar")
    cfg = cfg.replace(mapping={"init_accumulate_frames": 4})
    sims = S.simulators(cfg, kw)
    parts = [[sim.frame(i) for sim in sims] for i in range(10)]
    _warm_up(cuda)
    db.runs.reset()
    (g, sg, cg), (p, sp, cp) = _runs(cuda, cfg, parts, feed=S.multi_head_frame)
    assert cg["launch_heads"] == 10 and cg["launch_step"] == 20
    assert cg["graph_launch"] == 30 and cp["graph_launch"] == 0
    # a head's front end runs the debounce once, in both runs
    assert db.runs.read() == 2 * 30 and g.ladder == p.ladder and len(g.ladder) >= 1
    keys = g.program.summary()
    assert [k["kind"] for k in keys].count("heads") == cg["capture_heads"] == 1
    steps = [k for k in keys if k["kind"] == "step"]
    assert [k["held"] for k in steps] == [False] * (len(steps) - 1) + [True]
    assert sg["icp_exit"] == sg["admit"] == 0 and sp["icp_exit"] > 0
    assert g.loop_iterations == p.loop_iterations == sum(p.iterations) > 0
    _assert_runs_equal(g, p)


def _mid100_padded(cuda, cfg, sims, i):
    """Raw frame ``i`` of every head padded on the card: (S, N, 3)
    points, (S, N) intensities and masks, and the frame time."""
    from loam_livox_tpu_torch.core.types import to_device

    n = cfg.capacity.max_raw_points
    xyz = np.zeros((len(sims), n, 3), np.float32)
    inten = np.zeros((len(sims), n), np.float32)
    mask = np.zeros((len(sims), n), bool)
    for s, sim in enumerate(sims):
        x, it, t0 = sim.frame(i)
        xyz[s, :len(x)], inten[s, :len(x)], mask[s, :len(x)] = x, it, True
    return to_device(xyz, cuda), to_device(inten, cuda), to_device(mask, cuda), t0


def _mid100_feed(pipe, frame) -> None:
    """One padded multi-head raw frame: its front end, then a step a piece."""
    for fr in pipe.head_frames(*frame):
        pipe.process_feature_frame(fr)


def test_step_key_leaves_the_heads_frames_as_they_were(cuda):
    """The heads key's frames are its own static buffers: a step copies
    its frame in and writes nothing back, and the next heads launch
    overwrites them (a caller that keeps one keeps a copy)."""
    from loam_livox_tpu_torch.eval import scenarios as S
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg, kw = S.scenario_config("mid100_trilidar")
    cfg = cfg.replace(capacity={"auto_schedule": 0})
    sims = S.simulators(cfg, kw)
    pipe = OdometryPipeline(cfg, device=cuda)
    frames = pipe.head_frames(*_mid100_padded(cuda, cfg, sims, 0))
    kept = [{k: v.clone() for k, v in _state_leaves(f).items()} for f in frames]
    for f in frames:
        pipe.process_feature_frame(f)
    for f, copy in zip(frames, kept):
        for k, v in _state_leaves(f).items():
            assert torch.equal(v, copy[k]), k
    again = pipe.head_frames(*_mid100_padded(cuda, cfg, sims, 1))
    assert [id(f) for f in again] == [id(f) for f in frames]
    assert not torch.equal(again[0].surface.xyz, kept[0][".surface.xyz"])
    pipe.flush()
    assert len(pipe.trajectory.times) == 2


@pytest.mark.parametrize("case", ["velodyne", "grid", "dense", "heads"])
def test_new_units_capture_makes_no_host_sync(cuda, case):
    """The Velodyne frame, the two engines' frames and the multi-head
    front end and step, captured and replayed under torch's sync debug
    mode "error" (the schedule off): a read on the host anywhere in a
    unit would raise."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.eval import scenarios as S
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    fixed = {"auto_schedule": 0}
    if case == "velodyne":
        cfg = _velodyne_config(capacity=fixed)
        frames = _sweeps(cuda, cfg, 4)
    elif case == "heads":
        cfg, kw = S.scenario_config("mid100_trilidar")
        cfg = cfg.replace(capacity=fixed, mapping={"init_accumulate_frames": 1})
        sims = S.simulators(cfg, kw)
        frames = [_mid100_padded(cuda, cfg, sims, i) for i in range(4)]
    else:
        cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 1}, capacity=fixed,
                                   optimization={"correspondence": case})
        _, host = simulate(4, 10000, 2)
        frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    assert pipe.program is not None
    if case == "heads":
        feed = _mid100_feed
    else:
        def feed(p, f):
            p.process_raw(f[0], f[1], f[2], mask=f[3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in frames:
            feed(pipe, f)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pipe.flush()
    assert sum(pipe.iterations) > 0 and pipe.program.summary()


@pytest.mark.parametrize("case", ["sparse", "overflow"])
def test_captured_bucket_grid_build_equals_eager(cuda, case):
    """`build_bucket_grid` captured in a CUDA graph and replayed on new
    points equals the eager build on the card, and the CPU's, field for
    field, with and without bucket and directory overflow."""
    from loam_livox_tpu_torch.ops.bucket_grid import build_bucket_grid

    rng = np.random.default_rng(3)
    cap, size, nb, slots = (4096, 1.25, 2048, 16) if case == "sparse" else (4096, 1.0, 24, 4)

    def points():
        if case == "sparse":
            xyz = rng.uniform(-8, 8, (cap, 3)).astype(np.float32)
        else:
            xyz = (rng.integers(0, 40, cap)[:, None] * 1.7
                   + rng.normal(0, 0.2, (cap, 3))).astype(np.float32)
        mask = rng.random(cap) < 0.7
        return torch.from_numpy(xyz), torch.from_numpy(mask)

    xyz, mask = (t.to(cuda) for t in points())
    build_bucket_grid(xyz, mask, size, nb, slots)        # first calls outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = build_bucket_grid(xyz, mask, size, nb, slots)
    for _ in range(2):
        new_xyz, new_mask = points()
        xyz.copy_(new_xyz)
        mask.copy_(new_mask)
        graph.replay()
        eager = build_bucket_grid(xyz, mask, size, nb, slots)
        cpu = build_bucket_grid(new_xyz, new_mask, size, nb, slots)
        for f in ("keys", "pts", "src_idx", "slot_mask"):
            assert torch.equal(getattr(out, f), getattr(eager, f)), f
            assert torch.equal(getattr(out, f).cpu(), getattr(cpu, f)), f
    if case == "overflow":
        assert bool((out.keys != 2 ** 31 - 1).all()) and bool(out.slot_mask.all(dim=1).any())


# ---- residual subsampling and product mode on the frame program -------------

@pytest.mark.parametrize("lanes", [1, 9])
@pytest.mark.parametrize("n", [512, 2049, 10240, 16384])
def test_threefry_kernels_equal_plain(cuda, lanes, n):
    """The split and keep-mask kernels against their plain versions, bit
    for bit: split into 2, 3 and 9; masks of every fill, budgets below,
    at and above the count."""
    from loam_livox_tpu_torch.ops import threefry as tf

    rng = np.random.default_rng(n + lanes)
    keys = torch.from_numpy(rng.integers(0, 2 ** 32, (lanes, 2)).astype(np.uint32)).to(cuda)
    for num in (2, 3, 9):
        assert torch.equal(tf.split(keys, num), tf.split_plain(keys, num))
    assert torch.equal(tf.split(keys[0]), tf.split_plain(keys[0]))
    for fill in (0.0, 0.02, 0.4, 1.0):
        mask = torch.from_numpy(rng.uniform(size=(lanes, n)) < fill).to(cuda)
        for budget in (0, 200, n, 10 * n):
            got = tf.keep_mask(keys, mask, budget)
            assert torch.equal(got, tf.keep_mask_plain(keys, mask, budget)), (fill, budget)
            assert not (got & ~mask).any()


class _KeepMaskRecorder:
    """Wraps `ops.threefry.keep_mask`: every mask of ``shape`` it returns is
    written on the card into the next row of a buffer (a device row
    count), so a graph's replays record each pass's mask as the plain
    program's calls do."""

    def __init__(self, monkeypatch, shape, rows, device):
        from loam_livox_tpu_torch.ops import threefry as tf

        self.buf = torch.zeros((rows,) + tuple(shape), dtype=torch.bool, device=device)
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        real = tf.keep_mask

        def keep_mask(key, mask, budget):
            out = real(key, mask, budget)
            if tuple(out.shape) == tuple(shape):
                row = torch.clamp(self.count, max=rows - 1)
                self.buf.index_copy_(0, row, out[None])
                self.count.add_(1)
            return out
        monkeypatch.setattr(tf, "keep_mask", keep_mask)

    def masks(self):
        return self.buf[:int(self.count)]


@pytest.mark.parametrize("parallel", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["sequential", "chunked", "racing"])
def test_frame_program_subsampled_equals_plain(cuda, parallel, monkeypatch):
    """Residual subsampling (``subsample_residuals`` 200) on the frame
    program, bit-equal to the plain program: rows, iterations and every
    state tensor, the key included; no ICP-exit read; and every pass's
    keep mask, recorded on the card, equal to the plain program's and
    different from the pass before (the WHILE body splits the carry's
    key in place)."""
    from loam_livox_tpu_torch.core.config import realtime_racing_profile

    base = realtime_racing_profile() if parallel.get("frame_batch") else SlamConfig()
    cfg = base.replace(mapping={"init_accumulate_frames": 4},
                       capacity={"auto_schedule": 0},
                       optimization={"subsample_residuals": 200},
                       parallel={**parallel, "batch_motion_guard_t": 0.0})
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.runtime import pipeline as P

    caps = cfg.capacity
    lanes = 9 if parallel.get("frame_batch") else 1
    shape = (lanes, caps.max_corner_ds + caps.max_surface_ds)
    _, host = simulate(12, 10000, 4)
    frames = on_device(host, caps.max_raw_points, cuda)
    records = []
    for plain in (False, True):
        rec = _KeepMaskRecorder(monkeypatch, shape, 400, cuda)
        pipe = P.OdometryPipeline(cfg, device=cuda)
        if plain:
            pipe.program = None
        P.reset_host_syncs()
        for pts, inten, t0, mask in frames:
            pipe.process_raw(pts, inten, t0, mask=mask)
        pipe.flush()
        records.append((rec, pipe, P.host_syncs(), P.graph_counts()))
        monkeypatch.undo()
    (rg, g, sg, cg), (rp, p, sp, cp) = records
    assert g.program is not None and p.program is None
    assert sg["icp_exit"] == 0 and sp["icp_exit"] > 0 and cg["graph_launch"] > 0
    _assert_runs_equal(g, p)
    mg, mp = rg.masks(), rp.masks()
    assert mg.shape[0] == mp.shape[0] >= 2 and torch.equal(mg, mp)
    assert any(not torch.equal(mg[i], mg[i + 1]) for i in range(mg.shape[0] - 1))
    assert int(g.state.rng.view(torch.int32).abs().sum()) > 0


def test_peer_gather_kernel_equals_plain(cuda, tmp_path):
    """The candidates' exchange on one NCCL rank against its plain version
    (an all-gather and the merge by (distance, index)): random and tied
    candidates, k 1 to 8, one lane and 9, bit for bit; and a search
    sharded over one rank equal to the whole buffer's."""
    import torch.distributed as dist

    from loam_livox_tpu_torch.ops import peer_gather as pg
    from loam_livox_tpu_torch.parallel.mesh import make_mesh
    from loam_livox_tpu_torch.parallel.sharded import knn_sharded

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        rng = np.random.default_rng(3)
        for lanes, q, k in ((1, 2048, 5), (9, 2048, 5), (1, 513, 1), (2, 4097, 8)):
            d = rng.uniform(0, 50, (lanes, q, k)).astype(np.float32)
            d[:, ::7] = 1.5                                  # exact distance ties
            d = torch.from_numpy(d).to(cuda)
            i = torch.from_numpy(rng.integers(0, 1 << 20, (lanes, q, k)).astype(np.int32)).to(cuda)
            got, want = pg.peer_gather(d, i, mesh, k), pg.peer_gather_plain(d, i, mesh, k)
            torch.cuda.synchronize()
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (lanes, q, k)
        ref, mask = voxel_map(rng, 16384, 8.0, 0.25, 0.6)
        ref_t, mask_t = torch.from_numpy(ref).to(cuda), torch.from_numpy(mask).to(cuda)
        qs = torch.from_numpy(rng.uniform(-8, 8, (600, 3)).astype(np.float32)).to(cuda)
        got = knn_sharded(qs, ref_t, mask_t, mesh, k=5)
        want = kf.knn_fused(qs, ref_t, mask_t, k=5)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1].to(got[1].dtype))
    finally:
        dist.destroy_process_group()


def _product_runs(cuda, tmp_path, cfg, frames, read_after=None):
    """The frames through product mode on one NCCL rank on the frame
    program and on the plain program, and through the single-device
    frame program: for each, the pipeline, its host syncs and graph
    counts, its final state (read while the group is up: a plain
    product run's state read is a collective) and (with ``read_after``
    n) its state read after n frames with a copy of it then."""
    import torch.distributed as dist

    from loam_livox_tpu_torch.parallel.mesh import make_mesh, set_active_mesh
    from loam_livox_tpu_torch.runtime import pipeline as P

    def run(mesh, plain=False):
        pipe = P.OdometryPipeline(cfg, device=cuda, mesh=mesh)
        if plain:
            pipe.program = None
        P.reset_host_syncs()
        held = None
        for i, (pts, inten, t0, mask) in enumerate(frames):
            pipe.process_raw(pts, inten, t0, mask=mask)
            if read_after is not None and i + 1 == read_after:
                held = pipe.state
                held = (held, {n: v.clone() for n, v in _state_leaves(held).items()})
        pipe.flush()
        return pipe, P.host_syncs(), P.graph_counts(), held, pipe.state

    single = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1)
        graph = run(mesh)
        plain = run(mesh, plain=True)
    finally:
        set_active_mesh(None)
        dist.destroy_process_group()
    return graph, plain, single


@pytest.mark.parametrize("sub", [0, 200], ids=["product", "product_subsampled"])
def test_product_frame_program_equals_plain_and_single_device(cuda, tmp_path, sub):
    """Product mode on one NCCL rank on the frame program: one graph
    launch a frame (the gather, the steps with the sharded search inside
    the WHILE body, the copy back), no ICP-exit read, rows and every
    state tensor bit-equal to the plain product run's and to the
    single-device frame program's; and a state read after the first
    frame is left as it was."""
    from chip_smoke import on_device, simulate

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 4},
                               capacity={"auto_schedule": 0},
                               optimization={"subsample_residuals": sub})
    _, host = simulate(10, 10000, 4)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    (g, sg, cg, held, st_g), (p, sp, _, _, st_p), (one, _, _, _, st_1) = _product_runs(
        cuda, tmp_path, cfg, frames, read_after=1)
    assert g.program is not None and p.program is None and g.mesh is not None
    assert cg["graph_launch"] == cg["launch_frame"] == 10
    assert sg["icp_exit"] == 0 and sp["icp_exit"] > 0
    assert [k["mesh"] for k in g.program.summary()] == [1]
    _assert_runs_equal(g, p, (st_g, st_p))
    _assert_runs_equal(g, one, (st_g, st_1))
    state, copy = held
    for n, v in _state_leaves(state).items():
        assert torch.equal(v, copy[n]), n


@pytest.mark.parametrize("parallel", [{"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["chunked", "racing"])
def test_product_dispatch_on_the_frame_program_equals_plain(cuda, tmp_path, parallel):
    """Product mode's chunks and racing groups on the frame program: one
    graph launch a unit, bit-equal to the plain product run."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import realtime_racing_profile

    base = realtime_racing_profile() if parallel.get("frame_batch") else SlamConfig()
    cfg = base.replace(mapping={"init_accumulate_frames": 4}, capacity={"auto_schedule": 0},
                       parallel={**parallel, "batch_motion_guard_t": 0.0})
    _, host = simulate(12, 10000, 4)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    (g, sg, cg, _, st_g), (p, _, _, _, st_p), _ = _product_runs(cuda, tmp_path, cfg, frames)
    assert cg["graph_launch"] == 12 // _units(cfg, 0) and sg["icp_exit"] == 0
    _assert_runs_equal(g, p, (st_g, st_p))


# ---- the span recorder's stamps on the card ------------------------------

@pytest.fixture
def spans_on(cuda):
    """The span recorder on for one test, off and empty after it."""
    from loam_livox_tpu_torch.utils import logging as L

    L.spans.on = True
    L.spans.reset()
    yield L.spans
    L.spans.on = False
    L.spans.reset()


def _globaltimer_resolution(cuda) -> int:
    from loam_livox_tpu_torch.ops import graph_cond as gc

    t = gc.globaltimer_steps(cuda, 100_000)
    steps = t[1:] - t[:-1]
    assert bool((steps >= 0).all())
    return int(steps[steps > 0].min())


def test_globaltimer_resolution(cuda):
    """The least nonzero step over 10^5 back-to-back globaltimer readings
    (printed: ``pytest -s``)."""
    res = _globaltimer_resolution(cuda)
    print(f"globaltimer resolution: {res} ns")
    assert 0 < res <= 2000


def test_span_stamps_lie_inside_their_launches(cuda, spans_on):
    """Every stamp of frame-graph launch i lies inside launch i's CUDA-event
    interval (`slambench.trace.LaunchClock`, mapped onto the globaltimer by
    a clock pair's events), within the globaltimer's resolution + 2 us;
    each unit's first stamp, on the host clock, follows the start of its
    host ``launch`` span; the ring holds one unit a launch and loses
    nothing."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
    from slambench.trace import LaunchClock

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0})
    _, host = simulate(8, 10000, 2)
    frames = on_device(host, cfg.capacity.max_raw_points, cuda)
    pipe = OdometryPipeline(cfg, device=cuda)
    pipe.process_raw(*frames[0][:3], mask=frames[0][3])      # the capture, and frame 0
    torch.cuda.synchronize()
    tol = _globaltimer_resolution(cuda) + 2000
    spans_on.reset()
    pair = spans_on.clock_pair(cuda)
    clock = LaunchClock()
    clock.install()
    try:
        for pts, inten, t0, mask in frames[1:]:
            pipe.process_raw(pts, inten, t0, mask=mask)
        torch.cuda.synchronize()
    finally:
        clock.remove()
    rec = spans_on.read(cuda)
    assert rec.complete and rec.spans
    before, after = pair.events
    bracket = before.elapsed_time(after) * 1e6
    ivs = clock.intervals(before, int(pair.device_ns - bracket / 2))
    units = [i for i, s in enumerate(rec.spans) if s.depth == 0]
    assert len(units) == len(ivs) == len(frames) - 1
    assert {rec.spans[i].name for i in units} == {"unit.frame"}
    for k, (a, b) in enumerate(ivs):
        first, last = units[k], units[k + 1] if k + 1 < len(units) else len(rec.spans)
        for s in rec.spans[first:last]:
            assert a - tol <= s.t0 <= s.t1 <= b + tol, (k, s, a, b, tol, bracket)
    launches = [s for s in spans_on.host_spans().spans if s.name == "launch"]
    assert len(launches) == len(units)
    for i, h in zip(units, launches):
        assert rec.spans[i].t0 + pair.offset_ns >= h.t0 - pair.uncertainty_ns


def test_spans_add_only_their_stamp_nodes(cuda):
    """A key captured with the recorder on holds exactly its stamp nodes
    more than the same key captured with it off, and the same pass body
    besides them; off, it holds none."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline
    from loam_livox_tpu_torch.utils import logging as L

    cfg = SlamConfig().replace(mapping={"init_accumulate_frames": 2},
                               capacity={"auto_schedule": 0})
    _, host = simulate(1, 10000, 2)
    pts, inten, t0, mask = on_device(host, cfg.capacity.max_raw_points, cuda)[0]
    keys = {}
    try:
        for on in (False, True):
            L.spans.on = on
            pipe = OdometryPipeline(cfg, device=cuda)
            pipe.process_raw(pts, inten, t0, mask=mask)
            torch.cuda.synchronize()
            keys[on] = pipe.program.summary()[-1]
    finally:
        L.spans.on = False
        L.spans.reset()
    off, on = keys[False], keys[True]
    assert off["kind"] == on["kind"] == "frame"
    assert off["stamp_nodes"] == 0 and on["stamp_nodes"] > 2
    assert on["kernel_nodes"] - off["kernel_nodes"] == on["stamp_nodes"]
    assert on["pass_kernels"] == off["pass_kernels"] > 0


def test_failed_capture_raises(cuda, monkeypatch):
    """A frame that cannot be captured raises: the card never runs the
    plain program for a configuration on the slice instead."""
    from chip_smoke import on_device, simulate
    from loam_livox_tpu_torch.core.config import SlamConfig
    from loam_livox_tpu_torch.runtime import frame_program as fp
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    real = fp.prepare_step

    def reads_the_host(state, frame, cfg):
        float(frame.time_min)           # a host read: illegal under capture
        return real(state, frame, cfg)

    monkeypatch.setattr(fp, "prepare_step", reads_the_host)
    cfg = SlamConfig().replace(capacity={"auto_schedule": 0})
    _, host = simulate(1, 10000, 2)
    pts, inten, t0, mask = on_device(host, cfg.capacity.max_raw_points, cuda)[0]
    pipe = OdometryPipeline(cfg, device=cuda)
    with pytest.raises(RuntimeError):
        pipe.process_raw(pts, inten, t0, mask=mask)
    assert not pipe.trajectory.times and not pipe._pending
