"""Loop closure op by op: the port (``loam_livox_tpu_torch.loop``,
``eval.loop_payoff``, the rich world of ``io.simulator``) against the JAX
package on the CPU.

Maps come from the structured worlds of tests/test_loop.py, carried over
with `interop.cell_map_from_numpy`.

* Simulator: the same scene planes from one seed, and the same frame
  points bit for bit.
* Descriptors.  Cell directions come from a batched 3 × 3 ``eigh`` of
  covariances whose moments cancel ~3 digits at 6 m, so the two packages'
  directions differ by ~1e-4 and a direction near a bin edge can change
  bins, and an eigenvalue ratio near 1/3 can change a cell's class.  So
  the strict test feeds both descriptors the JAX package's cell features:
  counts equal, centre and ROI range within 1e-5, images within 1e-5 up
  to the four (±e0, ±e1) sign variants of the canonical rotation (the
  3 × 3 ``eigh``'s signs are the solver's; jaxlib's and torch's LAPACK
  calls differ on some inputs, e.g. seed 3 here).  With the port's own
  features the counts, centre and ROI agree and the images correlate.
* Similarity within 1e-5; the cells ``extract_cells_of_type`` selects,
  equal.
* Scene alignment on the known-offset case of tests/test_loop.py:
  rotation within 0.01°, translation within 1 mm, score within 1e-3, the
  same scales run.
* The three pose-graph solvers: poses within 1e-4 (the chain solver on a
  400-node two-pass loop with 4 closures; its JAX test uses 10,000).
* Map refinement within 1e-5; payoff fields within 1e-4.
"""
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core import se3 as jse3
from loam_livox_tpu.core.config import SlamConfig as JConfig
from loam_livox_tpu.eval import loop_payoff as jpay
from loam_livox_tpu.io import simulator as jsim
from loam_livox_tpu.loop import keyframe as jkf
from loam_livox_tpu.loop import map_refine as jref
from loam_livox_tpu.loop import pose_graph as jpg
from loam_livox_tpu.loop import scene_alignment as jsa
from loam_livox_tpu.map import cell_map as jcm

from loam_livox_tpu_torch.core import se3 as tse3
from loam_livox_tpu_torch.core.config import SlamConfig as TConfig
from loam_livox_tpu_torch.core.types import PointBatch
from loam_livox_tpu_torch.eval import loop_payoff as tpay
from loam_livox_tpu_torch.interop import CELL_MAP_ARRAYS, cell_map_from_numpy
from loam_livox_tpu_torch.io import simulator as tsim
from loam_livox_tpu_torch.loop import keyframe as tkf
from loam_livox_tpu_torch.loop import map_refine as tref
from loam_livox_tpu_torch.loop import pose_graph as tpg
from loam_livox_tpu_torch.loop import scene_alignment as tsa
from loam_livox_tpu_torch.map import cell_map as tcm
import test_loop as jtests
from test_loop import map_of, structured_world

torch.set_num_threads(2)


def port_map(jm):
    fields = {f"m.{n}": np.array(getattr(jm, n)) for n in CELL_MAP_ARRAYS + ("cell_size",
                                                                            "frame_idx")}
    return cell_map_from_numpy(fields, "m", "cpu")


def port_batch(b) -> PointBatch:
    return PointBatch(*(torch.from_numpy(np.array(x)) for x in b))


def t_(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- simulator --

RICH = {"half_extent": 28.0, "half_extent_z": 5.0, "n_rot_boxes": 28, "n_rocks": 48,
        "n_ridges": 14}


@pytest.mark.parametrize("seed", [0, 1])
def test_rich_world_matches_jax(seed):
    js = jsim.ConvexScene.random_rich_world(np.random.default_rng(seed), **RICH)
    ts = tsim.ConvexScene.random_rich_world(np.random.default_rng(seed), **RICH)
    for f in ("normals", "dists", "reflectivity"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f), err_msg=f)
    traj = dict(lin_hz=np.array([0.05, 0.05, 0.05]), yaw_hz=0.05, pitch_hz=0.05)
    sims = []
    for mod, scene in ((jsim, js), (tsim, ts)):
        tr = mod.Trajectory(ramp_t0=1.2)
        for k, v in traj.items():
            setattr(tr, k, v)
        sims.append(mod.LivoxSimulator(mod.SimConfig(points_per_frame=4000, seed=seed,
                                                     noise_std=0.01), scene=scene, traj=tr))
    for i in (0, 25, 60):
        for a, b in zip(sims[0].frame(i), sims[1].frame(i)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


# ----------------------------------------------------------- descriptors --

def sign_variants(rot: torch.Tensor):
    for s0 in (1.0, -1.0):
        for s1 in (1.0, -1.0):
            yield torch.stack([s0 * rot[:, 0], s1 * rot[:, 1], s0 * s1 * rot[:, 2]], dim=1)


def jax_features_as_port(jm, incremental=True):
    jf = jcm.cell_features(jm, incremental=incremental)
    return tcm.CellFeatures(*(t_(x) for x in jf))


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for seed in range(4):
        jm = map_of(structured_world(np.random.default_rng(seed)))
        out[seed] = (jm, port_map(jm))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_descriptor_matches_jax_on_its_features(worlds, monkeypatch, seed):
    jm, tm = worlds[seed]
    feats = jax_features_as_port(jm)
    monkeypatch.setattr(tkf, "cell_features", lambda m, incremental=True: feats)
    jd = jkf.describe_keyframe(jm, jm.valid())
    td = tkf.describe_keyframe(tm, tm.valid())
    for f in ("n_cells", "n_line", "n_plane"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    for f in ("center", "roi_range"):
        np.testing.assert_allclose(getattr(td, f).numpy(), np.array(getattr(jd, f)),
                                   rtol=0, atol=1e-5, err_msg=f)

    member = tm.valid()
    d = torch.linalg.vector_norm(tm.centers() - td.center, dim=-1)
    plane = member & (feats.feature_type == tcm.FEATURE_PLANE)
    line = member & (feats.feature_type == tcm.FEATURE_LINE)
    in_roi = member & (d < td.roi_range)
    cases = ((plane, (("img_line", line), ("img_plane", plane))),
             (plane & in_roi, (("img_line_roi", line & in_roi),
                               ("img_plane_roi", plane & in_roi))))
    for rot_mask, images in cases:
        rot = tkf._alignment_rotation(feats.feature_dir, rot_mask)
        # one variant of the rotation must give both of its images
        errs = [max(float(np.abs(tkf._hist_image(feats.feature_dir, m, variant)[0].numpy()
                                 - np.array(getattr(jd, name))).max())
                    for name, m in images)
                for variant in sign_variants(rot)]
        assert min(errs) < 1e-5, (images[0][0], errs)
        for name, m in images:
            # the port's descriptor is the unflipped variant
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          tkf._hist_image(feats.feature_dir, m, rot)[0].numpy())
    for f in ("ratio_nonzero_line", "ratio_nonzero_plane"):
        assert abs(float(getattr(td, f)) - float(getattr(jd, f))) < 1e-6, f


@pytest.mark.parametrize("seed", [1, 2])
def test_descriptor_on_its_own_features(worlds, seed):
    """Seeds whose cells lie clear of the class thresholds: the port's own
    features give the same counts, centre and ROI range, and images that
    correlate with the JAX package's (bin-edge flips aside)."""
    jm, tm = worlds[seed]
    jd = jkf.describe_keyframe(jm, jm.valid())
    td = tkf.describe_keyframe(tm, tm.valid())
    for f in ("n_cells", "n_line", "n_plane"):
        assert int(getattr(td, f)) == int(getattr(jd, f)), f
    np.testing.assert_allclose(td.center.numpy(), np.array(jd.center), rtol=0, atol=1e-5)
    assert abs(float(td.roi_range) - float(jd.roi_range)) < 1e-5
    for f in ("img_plane", "img_line"):
        s = float(tkf.max_similarity(getattr(td, f), t_(getattr(jd, f))))
        assert s > 0.98, (f, s)


def test_max_similarity_matches_jax(worlds):
    descs = [(jkf.describe_keyframe(jm, jm.valid()), tkf.describe_keyframe(tm, tm.valid()))
             for jm, tm in worlds.values()]
    for ja, ta in descs:
        for jb, tb in descs:
            for f in ("img_plane", "img_line"):
                js = float(jkf.max_similarity(getattr(ja, f), getattr(jb, f)))
                ts = float(tkf.max_similarity(t_(getattr(ja, f)), t_(getattr(jb, f))))
                assert abs(ts - js) < 1e-5, (f, ts, js)
                # and on the port's own images
                own = float(tkf.max_similarity(getattr(ta, f), getattr(tb, f)))
                assert np.isfinite(own) and -1e-6 <= own <= 1 + 1e-5


@pytest.mark.parametrize("incremental", [True, False])
def test_extract_cells_of_type_matches_jax(worlds, incremental):
    """Member cells clear of the class thresholds (as in
    tests/test_torch_cell_map.py) select the same pools."""
    for jm, tm in worlds.values():
        val = np.array(jcm.cell_features(jm, incremental=incremental).eig_val)
        margin = np.minimum(np.abs(val[:, 1] / 3.0 - val[:, 0]),
                            np.abs(val[:, 2] / 3.0 - val[:, 1])) / np.maximum(val[:, 2], 1e-12)
        member = np.array(jm.valid()) & (margin > 1e-3)
        member[::3] = False
        for ftype in (tcm.FEATURE_LINE, tcm.FEATURE_PLANE):
            jb = jsa.extract_cells_of_type(jm, jnp.asarray(member), ftype, incremental)
            tb = tsa.extract_cells_of_type(tm, torch.from_numpy(member), ftype, incremental)
            jmask = np.array(jb.mask)
            np.testing.assert_array_equal(tb.mask.numpy(), jmask)
            np.testing.assert_array_equal(tb.xyz.numpy()[jmask], np.array(jb.xyz)[jmask])


# ------------------------------------------------------- scene alignment --

def test_align_keyframes_known_offset_matches_jax():
    world = structured_world(np.random.default_rng(4))
    ang = 0.06
    q_off = np.array([np.cos(ang / 2), 0, 0, np.sin(ang / 2)], np.float32)
    t_off = np.array([0.4, -0.25, 0.1], np.float32)
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(q_off)))
    world_b = world @ R.T + t_off
    maps = [map_of(world), map_of(world_b)]
    jb = [jsa.extract_cells_of_type(m, m.valid(), f)
          for m in maps for f in (tcm.FEATURE_LINE, tcm.FEATURE_PLANE)]
    ca, cb = world.mean(0).astype(np.float32), world_b.mean(0).astype(np.float32)
    jr = jsa.align_keyframes(*jb, jnp.asarray(ca), jnp.asarray(cb), JConfig(),
                             work_capacity=2048)
    tr = tsa.align_keyframes(*[port_batch(b) for b in jb], t_(ca), t_(cb), TConfig(),
                             work_capacity=2048)
    ang_err = float(tse3.quat_angular_distance(tr.q, t_(jr.q))) * 57.3
    assert ang_err < 0.01, ang_err
    np.testing.assert_allclose(tr.t.numpy(), np.array(jr.t), rtol=0, atol=1e-3)
    assert abs(float(tr.inlier_threshold) - float(jr.inlier_threshold)) < 1e-3
    assert tr.scales_run == jr.scales_run == 3
    # and it recovers the offset, as the JAX test asks
    t_ba = -(R.T @ t_off)
    assert np.linalg.norm(tr.t.numpy() - t_ba) < 0.1 and float(tr.inlier_threshold) < 0.2


# ------------------------------------------------------------ pose graph --

def port_graph(g) -> tpg.PoseGraph:
    return tpg.PoseGraph(*(t_(x).long() if x.dtype == np.int32 else t_(x)
                           for x in (np.array(v) for v in g)))


def drifted_loop():
    g, _ = jtests.TestPoseGraphCG()._drifted_loop_graph()
    return g


def two_pass_loop():
    g, _ = jtests.TestPoseGraphCG()._big_drifted_graph(400, n_loops=4)
    return g


@pytest.mark.parametrize("solver, graph, kw", [
    ("optimize_pose_graph", drifted_loop, {"iterations": 25}),
    ("optimize_pose_graph_cg", drifted_loop, {"iterations": 25, "cg_iterations": 60}),
    ("optimize_pose_graph_chain", drifted_loop, {"iterations": 10}),
    ("optimize_pose_graph_chain", two_pass_loop, {"iterations": 10}),
])
def test_pose_graph_solvers_match_jax(solver, graph, kw):
    g = graph()
    jq, jt, jc = getattr(jpg, solver)(g, **kw)
    tq, tt, tc = getattr(tpg, solver)(port_graph(g), **kw)
    np.testing.assert_allclose(tq.numpy(), np.array(jq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.array(jt), rtol=0, atol=1e-4)
    assert float(tc) < 1e-5


def test_pose_graph_construction_and_residuals_match_jax():
    gt_q, gt_t, est_t = jtests.TestPoseGraph().make_drifted_loop()
    n = gt_q.shape[0]
    jg = jpg.build_odometry_chain(gt_q, gt_t, capacity_edges=n + 2)._replace(t=est_t)
    tg = tpg.build_odometry_chain(t_(gt_q), t_(gt_t), capacity_edges=n + 2)._replace(t=t_(est_t))
    rel_q, rel_t = jnp.asarray([0.0, 0.6, 0.8, 0.0]), jnp.asarray([1.0, 2.0, 3.0])
    jg = jpg.add_loop_edge(jg, n, n - 1, 0, rel_q, rel_t, weight_t=2.0)
    tg = tpg.add_loop_edge(tg, n, n - 1, 0, t_(rel_q), t_(rel_t), weight_t=2.0)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpg.edge_residuals(tg, tg.q, tg.t).numpy(),
                               np.array(jpg.edge_residuals(jg, jg.q, jg.t)), rtol=0, atol=1e-5)


def test_unported_loop_pieces_raise(tmp_path):
    """The edge-sharded pose graph (item 15) is ported: on a group of one
    rank it is the CG solve up to the order of its sums
    (tests/test_torch_parallel.py runs 2 ranks against the JAX package)."""
    import torch.distributed as dist

    from loam_livox_tpu_torch.parallel.mesh import make_mesh

    g = port_graph(drifted_loop())
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        sq, st, sc = tpg.optimize_pose_graph_sharded(g, make_mesh(1), iterations=20,
                                                     cg_iterations=60)
    finally:
        dist.destroy_process_group()
    cq, ct, _ = tpg.optimize_pose_graph_cg(g, iterations=20, cg_iterations=60)
    np.testing.assert_allclose(sq.numpy(), cq.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), ct.numpy(), rtol=0, atol=1e-5)
    assert float(sc) < 1e-5
    # the offline rebuild is ported (item 13): a directory without dumps raises
    with pytest.raises(FileNotFoundError):
        tref.refine_mapping(str(tmp_path))


# ------------------------------------------------------ map refinement --

def test_refine_points_and_corrected_map_match_jax():
    rng = np.random.default_rng(7)
    n = 5
    clouds = [rng.uniform(-5, 5, (300 + 10 * i, 3)).astype(np.float32) for i in range(n)]
    q_ori = rng.normal(size=(n, 4)).astype(np.float32)
    q_ori /= np.linalg.norm(q_ori, axis=1, keepdims=True)
    q_opt = q_ori + 0.02 * rng.normal(size=(n, 4)).astype(np.float32)
    q_opt /= np.linalg.norm(q_opt, axis=1, keepdims=True)
    t_ori = rng.normal(size=(n, 3)).astype(np.float32)
    t_opt = t_ori + 0.1 * rng.normal(size=(n, 3)).astype(np.float32)
    for i in range(n):
        np.testing.assert_allclose(
            tref.refine_points(clouds[i], q_ori[i], t_ori[i], q_opt[i], t_opt[i]),
            jref.refine_points(clouds[i], q_ori[i], t_ori[i], q_opt[i], t_opt[i]),
            rtol=0, atol=1e-5)
    for stride, res in ((2, 0.0), (1, 0.5)):
        a = tref.rebuild_corrected_map(clouds, (t_ori, q_ori), (t_opt, q_opt), stride, res)
        b = jref.rebuild_corrected_map(clouds, (t_ori, q_ori), (t_opt, q_opt), stride, res)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


# --------------------------------------------------------------- payoff --

def fake_closer(rng, tensors: bool):
    n = 6
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    snaps = [rng.uniform(-3, 3, (2000 + 50 * i, 3)).astype(np.float32) for i in range(n)]
    wrap = torch.from_numpy if tensors else (lambda x: x)
    kfs = [types.SimpleNamespace(q=wrap(q[i]), t=wrap(t[i]), ending_frame_idx=3 * i + 2,
                                 snap_full=snaps[i]) for i in range(n)]
    result = types.SimpleNamespace(his_idx=1, cur_idx=5, q_opt=q, t_opt=t + 0.05)
    return types.SimpleNamespace(closed=True, result=result, keyframes=kfs)


def test_payoff_matches_jax():
    times = [0.1 * i for i in range(20)]

    def gt(tm):
        return np.array([1.0, 0, 0, 0]), np.array([np.sin(tm), np.cos(tm), 0.1 * tm])

    jp = jpay.score_loop_payoff(fake_closer(np.random.default_rng(3), False), times, gt)
    tp = tpay.score_loop_payoff(fake_closer(np.random.default_rng(3), True), times, gt)
    assert set(tp) == set(jp) and len(tp) == 4
    for k in jp:
        assert abs(tp[k] - jp[k]) < 1e-4, (k, tp[k], jp[k])
    assert tpay.payoff_verdict(tp) == jpay.payoff_verdict(jp)
    for before, after in ((0.5, 0.3), (0.5, 0.6), (0.1, 0.25), (0.1, 0.2)):
        p = {"ate_kf_raw_before_loop": before, "ate_kf_raw_after_loop": after}
        assert tpay.payoff_verdict(p) == jpay.payoff_verdict(p)
    assert tpay.ALIGNMENT_FLOOR_M == jpay.ALIGNMENT_FLOOR_M
    assert tpay.score_loop_payoff(None, times, gt) == {}
