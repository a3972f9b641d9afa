"""The CPU side of the frame program's wider slice (`runtime.frame_program`):
the Velodyne front end, the multi-head frame and the ``grid`` / ``dense``
engines, each made safe to capture, against the JAX package and the
port's earlier forms.

* `frontend.velodyne.extract_velodyne_features` takes ``base_time`` as a
  float or as a float64 scalar tensor (the frame program's device
  scalar): the two give bit-equal clouds and times, and the tensor form
  matches the JAX extractor's full cloud (mask and points equal, times
  within rtol 1e-6, as tests/test_torch_velodyne.py holds the float form).
* `ops.bucket_grid.build_bucket_grid`, built at fixed shapes (dump rows
  sliced off, no boolean indexing), equals the JAX build field for field
  and the port's earlier boolean-indexed build (kept here as
  `masked_build`), on seeded points past ``bucket_cap`` in one bucket,
  past ``n_buckets`` buckets, with nothing valid and sparse.
* Both run on ``meta`` tensors, which raise wherever a function reads a
  value on the host or makes a shape from data: what a CUDA graph
  capture would refuse.
* `pipeline.extract_heads` (the multi-head front end the ``heads`` key
  captures) equals `frontend.multi.extract_multi_lidar` followed by each
  piece's source voxel filter, with a float and a tensor frame time.
* A step split as the frame program's step and frame keys run it
  (`runtime.odometry.prepare_step`, the host loop, `commit_history`,
  then the update the SWITCH node's index picks) is bit-equal to
  `odometry_step`, the bucket grids included, under ``grid``, ``dense``
  and the Velodyne front end.
* `frame_program.on_slice` admits the Velodyne front end and the two
  engines under sequential, chunked and racing dispatch on the card,
  and still refuses the CPU, a mesh and residual subsampling.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.core.config import SlamConfig as JaxConfig
from loam_livox_tpu.frontend import velodyne as jvel
from loam_livox_tpu.ops import bucket_grid as jbg

from chip_smoke import vlp16_sweep
from loam_livox_tpu_torch.core.config import SlamConfig, realtime_racing_profile
from loam_livox_tpu_torch.frontend import velodyne as tvel
from loam_livox_tpu_torch.frontend.multi import extract_multi_lidar
from loam_livox_tpu_torch.interop import config_from_dict
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig
from loam_livox_tpu_torch.ops import bucket_grid as tbg
from loam_livox_tpu_torch.ops.graph_cond import switch_index_plain
from loam_livox_tpu_torch.ops.voxel import voxel_downsample
from loam_livox_tpu_torch.registration.icp import run_host_loop
from loam_livox_tpu_torch.runtime import pipeline as P
from loam_livox_tpu_torch.runtime.frame_program import on_slice
from loam_livox_tpu_torch.runtime.odometry import (appended_matching, commit_history,
                                                   init_state, odometry_step, prepare_step,
                                                   rebuilt_matching)

torch.set_num_threads(2)
CAP = 16384
META = torch.device("meta")


def leaves(tree, prefix=""):
    out = {}
    if isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), f"{prefix}.{f}"))
    return out


def assert_trees_equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


# ---------------------------------------------------------------- Velodyne --

def padded_sweep(pillar: bool):
    pts = vlp16_sweep(pillar=pillar)
    xyz = np.zeros((CAP, 3), np.float32)
    mask = np.zeros(CAP, bool)
    xyz[:len(pts)], mask[:len(pts)] = pts, True
    xyz[100] = np.nan
    mask[3000:3010] = False
    return xyz, mask


def velodyne_fe():
    cfg = JaxConfig().replace(feature_extraction={"scan_line": 16})
    return cfg, config_from_dict(dataclasses.asdict(cfg)).feature_extraction


@pytest.mark.parametrize("base_time", [1.5, 1234.56789, 0.1 * 7])
@pytest.mark.parametrize("pillar", [True, False], ids=["plate", "room"])
def test_velodyne_tensor_base_time_is_bit_equal_to_the_float(pillar, base_time):
    xyz, mask = padded_sweep(pillar)
    jcfg, fe = velodyne_fe()
    args = (torch.from_numpy(xyz), torch.from_numpy(mask))
    by_float = tvel.extract_velodyne_features(*args, base_time, fe)
    by_tensor = tvel.extract_velodyne_features(
        *args, torch.tensor(base_time, dtype=torch.float64), fe)
    assert_trees_equal(by_float, by_tensor)
    # and the JAX extractor's full cloud at the same time
    j = jvel.extract_velodyne_features(jnp.asarray(xyz), jnp.asarray(mask),
                                       jnp.float32(base_time), jcfg.feature_extraction,
                                       jcfg.capacity)
    np.testing.assert_array_equal(by_tensor.full.mask.numpy(), np.asarray(j.full.mask))
    np.testing.assert_array_equal(by_tensor.full.xyz.numpy(), np.asarray(j.full.xyz))
    np.testing.assert_allclose(by_tensor.full.time.numpy(), np.asarray(j.full.time),
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("base_time", ["float", "tensor"])
def test_velodyne_runs_on_meta_tensors(base_time):
    _, fe = velodyne_fe()
    t0 = 1.5 if base_time == "float" else torch.empty((), dtype=torch.float64, device=META)
    f = tvel.extract_velodyne_features(torch.empty((CAP, 3), device=META),
                                       torch.empty(CAP, dtype=torch.bool, device=META), t0, fe)
    for b in (f.corners, f.surface, f.full):
        assert b.xyz.shape == (CAP, 3) and b.mask.shape == (CAP,)


# ------------------------------------------------------------- bucket grid --

def masked_build(xyz, mask, bucket_size, n_buckets, bucket_cap):
    """The port's earlier build: boolean-mask indexing (a host read and
    a shape from data)."""
    dev = xyz.device
    n = xyz.shape[0]
    empty = torch.full((), tbg.EMPTY_KEY, dtype=torch.int32, device=dev)
    keys = torch.where(mask, tbg._pack(tbg._coords(xyz, bucket_size)), empty)
    order = torch.argsort(keys, stable=True)
    ks = keys[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ks[1:] != ks[:-1]])
    first = first & (ks != tbg.EMPTY_KEY)
    bucket_of = torch.cumsum(first.to(torch.int32), 0) - 1
    idx_all = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(first, idx_all, torch.zeros_like(idx_all)), 0).values
    rank = idx_all - seg_start
    valid = (ks != tbg.EMPTY_KEY) & (bucket_of < n_buckets) & (rank < bucket_cap)
    flat = bucket_of.to(torch.int64) * bucket_cap + rank
    head = first & (bucket_of < n_buckets)
    dir_keys = torch.full((n_buckets,), tbg.EMPTY_KEY, dtype=torch.int32, device=dev)
    dir_keys[bucket_of[head].to(torch.int64)] = ks[head]
    pts = torch.zeros((n_buckets * bucket_cap, 3), dtype=torch.float32, device=dev)
    src = torch.zeros((n_buckets * bucket_cap,), dtype=torch.int32, device=dev)
    smask = torch.zeros((n_buckets * bucket_cap,), dtype=torch.bool, device=dev)
    rows = flat[valid]
    pts[rows] = xyz[order][valid].to(torch.float32)
    src[rows] = order[valid].to(torch.int32)
    smask[rows] = True
    return tbg.BucketGrid(float(bucket_size), dir_keys,
                          pts.reshape(n_buckets, bucket_cap, 3),
                          src.reshape(n_buckets, bucket_cap),
                          smask.reshape(n_buckets, bucket_cap))


def grid_case(name, rng):
    """(xyz, mask, bucket size, buckets, slots) of a seeded case."""
    cap = 2048
    if name == "sparse":
        xyz = rng.uniform(-8, 8, (cap, 3))
        return xyz, rng.random(cap) < 0.8, 1.25, 2048, 16
    if name == "past_bucket_cap":       # 600 points in one bucket of 8 slots
        xyz = rng.uniform(-8, 8, (cap, 3))
        xyz[:600] = rng.uniform(0.1, 0.9, (600, 3))
        return xyz, np.ones(cap, bool), 1.0, 4096, 8
    if name == "past_n_buckets":        # ~1,000 occupied buckets, 300 kept
        return rng.uniform(-6, 6, (cap, 3)), rng.random(cap) < 0.9, 1.0, 300, 4
    if name == "nothing_valid":
        return rng.uniform(-6, 6, (cap, 3)), np.zeros(cap, bool), 1.0, 64, 4
    raise KeyError(name)


GRID_CASES = ["sparse", "past_bucket_cap", "past_n_buckets", "nothing_valid"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", GRID_CASES)
def test_bucket_grid_build_matches_jax_and_the_masked_build(case, seed):
    xyz, mask, size, nb, slots = grid_case(case, np.random.default_rng(seed))
    xyz = xyz.astype(np.float32)
    t_xyz, t_mask = torch.from_numpy(xyz), torch.from_numpy(mask)
    g = tbg.build_bucket_grid(t_xyz, t_mask, size, nb, slots)
    old = masked_build(t_xyz, t_mask, size, nb, slots)
    j = jbg.build_bucket_grid(jnp.asarray(xyz), jnp.asarray(mask), size, nb, slots)
    assert (g.n_buckets, g.bucket_cap, g.bucket_size) == (nb, slots, float(size))
    for f in ("keys", "pts", "src_idx", "slot_mask"):
        assert torch.equal(getattr(g, f), getattr(old, f)), f
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
    used = int(g.slot_mask.sum())
    if case == "past_bucket_cap":
        assert bool(g.slot_mask.all(dim=1).any()) and used < int(mask.sum())
    if case == "past_n_buckets":
        assert bool((g.keys != tbg.EMPTY_KEY).all()) and used < int(mask.sum())
    if case == "nothing_valid":
        assert used == 0 and bool((g.keys == tbg.EMPTY_KEY).all())


def test_bucket_grid_runs_on_meta_tensors():
    g = tbg.build_bucket_grid(torch.empty((4096, 3), device=META),
                              torch.empty(4096, dtype=torch.bool, device=META), 1.0, 512, 8)
    assert g.keys.shape == (512,) and g.pts.shape == (512, 8, 3)
    assert g.src_idx.shape == g.slot_mask.shape == (512, 8)
    d, i = tbg.grid_knn(torch.empty((100, 3), device=META), g, k=5)
    assert d.shape == i.shape == (100, 5)


# --------------------------------------------------------- multi-head frame --

def heads_input(n_heads=3, n=4096, points=3000):
    sims = [LivoxSimulator(SimConfig(points_per_frame=points, seed=s)) for s in range(n_heads)]
    xyz = np.zeros((n_heads, n, 3), np.float32)
    inten = np.zeros((n_heads, n), np.float32)
    mask = np.zeros((n_heads, n), bool)
    for s, sim in enumerate(sims):
        x, it, t0 = sim.frame(3)
        xyz[s, :len(x)], inten[s, :len(x)], mask[s, :len(x)] = x, it, True
    return torch.from_numpy(xyz), torch.from_numpy(inten), torch.from_numpy(mask), t0


@pytest.mark.parametrize("base_time", ["float", "tensor"])
def test_extract_heads_equals_the_front_end_then_the_source_filters(base_time):
    cfg = SlamConfig().replace(common={"if_motion_deblur": 0, "piecewise_number": 2},
                               capacity={"max_raw_points": 4096, "max_corner": 256,
                                         "max_surface": 1024})
    xyz, inten, mask, t0 = heads_input()
    fe = cfg.feature_extraction
    t = t0 if base_time == "float" else torch.tensor(t0, dtype=torch.float64)
    got = P.extract_heads(xyz, inten, mask, t, cfg)
    want = [fr._replace(
        corners=voxel_downsample(fr.corners, fe.mapping_line_resolution,
                                 capacity=fr.corners.capacity),
        surface=voxel_downsample(fr.surface, fe.mapping_plane_resolution / 2.0,
                                 capacity=fr.surface.capacity))
        for fr in extract_multi_lidar(xyz, inten, mask, t0, fe, cfg.capacity,
                                      piecewise_number=2)]
    assert len(got) == 2
    for a, b in zip(got, want):
        assert a.full.capacity == 3 * 4096       # S times a head's
        assert_trees_equal(a, b)


# ------------------------------------------------- a step as the keys run it --

SMALL = {"max_raw_points": 4096, "max_corner": 256, "max_surface": 1024,
         "max_corner_ds": 256, "max_surface_ds": 1024, "map_corner_capacity": 1024,
         "map_surf_capacity": 4096, "hist_corner_capacity": 128, "hist_surf_capacity": 512,
         "history_window": 8, "auto_schedule": 0}


def split_step(state, frame, cfg):
    """One step as `frame_program._StepsKey` runs it: set-up, the loop,
    the commit, then the update the SWITCH node's index picks (body 0 the
    rebuild, body 1 the append, else none)."""
    corner_in, surf_in, icp_pass, carry, finish, rng = prepare_step(state, frame, cfg)
    carry, _ = run_host_loop(icp_pass, carry, cfg.optimization.icp_maximum_iteration)
    new, reg, upd = commit_history(state._replace(rng=rng), frame, corner_in, surf_in,
                                   finish(carry), cfg)
    flags = [upd.rebuild] + ([] if upd.append is None else [upd.append])
    pick = int(switch_index_plain(torch.stack(flags)))
    if pick == 0:
        c, s, gc, gs = rebuilt_matching(new, cfg)
        new = new._replace(map_corners=c, map_surface=s, grid_corners=gc, grid_surface=gs)
    elif pick == 1 and upd.append is not None:
        c, s = appended_matching(new, upd)
        new = new._replace(map_corners=c, map_surface=s)
    return new, reg


def frames_of(case, cfg, n):
    """``n`` feature frames through the configuration's front end."""
    if case == "velodyne":
        raw = []
        for i in range(n):
            pts = vlp16_sweep(origin=(0.03 * i, 0.02 * i, 0.0))
            raw.append((pts, np.zeros(len(pts), np.float32), 0.1 * i))
    else:
        sim = LivoxSimulator(SimConfig(points_per_frame=3000, seed=0))
        raw = [sim.frame(i) for i in range(n)]
    cap = cfg.capacity.max_raw_points
    out = []
    for x, it, t0 in raw:
        xyz = np.zeros((cap, 3), np.float32)
        inten = np.zeros(cap, np.float32)
        mask = np.zeros(cap, bool)
        xyz[:len(x)], inten[:len(x)], mask[:len(x)] = x, it, True
        out += P.extract_pieces(torch.from_numpy(xyz), torch.from_numpy(inten),
                                torch.from_numpy(mask), t0, cfg, P.steps_per_frame(cfg))
    return out


@pytest.mark.parametrize("case", ["grid", "dense", "velodyne"])
def test_a_step_split_as_the_keys_run_it_equals_odometry_step(case):
    opt = {"icp_maximum_iteration": 4, "full_iterations": 2}
    if case == "velodyne":
        cfg = SlamConfig().replace(common={"lidar_type": "velodyne", "if_motion_deblur": 0},
                                   feature_extraction={"scan_line": 16},
                                   capacity={**SMALL, "max_raw_points": CAP},
                                   mapping={"init_accumulate_frames": 1}, optimization=opt)
    else:
        cfg = SlamConfig().replace(capacity={**SMALL, "corner_bucket_count": 1024,
                                             "surf_bucket_count": 2048},
                                   mapping={"init_accumulate_frames": 2},
                                   optimization={**opt, "correspondence": case})
    a = b = init_state(cfg, "cpu")
    rebuilt = 0
    for frame in frames_of(case, cfg, 6):
        a, reg_a = odometry_step(a, frame, cfg)
        b, reg_b = split_step(b, frame, cfg)
        assert_trees_equal(a, b)
        assert torch.equal(reg_a.q_w, reg_b.q_w) and torch.equal(reg_a.t_w, reg_b.t_w)
        rebuilt += int(a.map_surface.mask.sum()) > 0
    assert rebuilt and int(a.frame_count) == 6
    assert (a.grid_surface is not None) == (case == "grid")


# ------------------------------------------------------------------ on_slice --

@pytest.mark.parametrize("dispatch", [{}, {"dispatch_chunk": 4}, {"frame_batch": 3}],
                         ids=["sequential", "chunked", "racing"])
def test_on_slice_admits_velodyne_and_the_engines(dispatch):
    card = torch.device("cuda")
    base = SlamConfig().replace(parallel=dispatch)
    velodyne = base.replace(common={"lidar_type": "velodyne"})
    for cfg in (velodyne, base.replace(optimization={"correspondence": "grid"}),
                base.replace(optimization={"correspondence": "dense"}),
                velodyne.replace(optimization={"correspondence": "grid"}),
                base.replace(optimization={"correspondence": "dense"},
                             mapping={"matching_mode": 1},
                             loop_closure={"if_enable_loop_closure": 1})):
        assert on_slice(cfg, card)
        assert not on_slice(cfg, torch.device("cpu"))
        # a product mesh and residual subsampling run on the frame program too
        assert on_slice(cfg, card, mesh=object())
        assert on_slice(cfg.replace(parallel={"mesh_devices": 2}), card)
        assert on_slice(cfg.replace(optimization={"subsample_residuals": 64}), card)
        assert not on_slice(cfg.replace(parallel={"mesh_devices": 2},
                                        optimization={"subsample_residuals": 64}),
                            torch.device("cpu"), mesh=object())
    racing = realtime_racing_profile().replace(optimization={"correspondence": "grid"})
    assert on_slice(racing, card)
