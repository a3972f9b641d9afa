"""The port's threefry key (``ops/threefry.py``) against ``jax.random``
and the JAX package's residual subsampling, on the CPU.

* `split`, `random_bits` and `uniform` bit-equal to ``jax.random`` (jax
  0.9, ``jax_threefry_partitionable``) for several keys and shapes, odd
  lengths and a lane axis (``jax.vmap`` over keys) included;
* `random_keep_mask` drawn from a key bit-equal to the JAX package's
  ``ops/masked.random_keep_mask``, lane by lane;
* the carry's key split every ICP pass, as the JAX loop splits it;
* a teacher-forced step with ``subsample_residuals`` = 200 from a JAX
  state carried across by `interop.state_from_numpy` (its key included)
  against the JAX step, under ``first_match``
  (``tests/test_torch_odometry.py``: the port must land where the JAX
  step lands from the input or the input one float32 ulp away), and the
  port's own 6-step subsampled stream over the same feature frames
  within 0.05 m of the JAX run, its key equal to JAX's;
* on ``meta`` tensors (no data, so any host read raises), the draw and
  product mode's in-place gather and copy back.

The JAX stream is the first 6 frames of ``test_torch_odometry.py``'s
(registration from frame 4), with the JAX dense engine standing in for
the port's search as there (`jax_correspondences`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loam_livox_tpu.ops import masked as jmasked
from loam_livox_tpu.runtime.odometry import init_state as jinit_state
from loam_livox_tpu.runtime.odometry import odometry_step as jstep

from loam_livox_tpu_torch.interop import config_from_dict, state_from_numpy, state_to_numpy
from loam_livox_tpu_torch.ops import masked as tmasked
from loam_livox_tpu_torch.ops import threefry as T
from loam_livox_tpu_torch.parallel import layout
from loam_livox_tpu_torch.parallel.mesh import Mesh
from loam_livox_tpu_torch.registration import icp as ticp
from loam_livox_tpu_torch.runtime.odometry import init_state, odometry_step

from test_torch_odometry import (INIT, first_match, jax_config, jax_correspondences,  # noqa: F401
                                 jax_frames, nudged_frame, state_fields, to_port_frame)

N_STEPS = 6
BUDGET = 200


def jkey(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def tkey(k) -> torch.Tensor:
    return torch.from_numpy(np.array(k))


# ------------------------------------------------------------ the bits --

@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 + 5, 4_000_000_000])
def test_prng_key_and_split_match_jax(seed):
    k = jkey(seed)
    assert torch.equal(T.prng_key(seed), tkey(k))
    for num in (1, 2, 3, 8, 33):
        np.testing.assert_array_equal(T.split(tkey(k), num).numpy(),
                                      np.asarray(jax.random.split(k, num)))
    # split's default, and a chain of splits (the state's key over steps)
    a, b = tkey(k), k
    for _ in range(4):
        a, b = T.split(a)[0], jax.random.split(b)[0]
    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("shape", [(1,), (5,), (2047,), (4096,), (3, 7), (2, 3, 5)])
def test_bits_and_uniform_match_jax(shape):
    for seed in (0, 3, 99):
        k = jkey(seed)
        np.testing.assert_array_equal(T.random_bits(tkey(k), shape).numpy().astype(np.uint32),
                                      np.asarray(jax.random.bits(k, shape)))
        u = T.uniform(tkey(k), shape)
        assert u.dtype == torch.float32 and u.shape == shape
        np.testing.assert_array_equal(u.numpy(), np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("lanes, n", [(1, 513), (3, 1000), (9, 257)])
def test_lane_axis_matches_vmap(lanes, n):
    keys = jax.random.split(jkey(lanes), lanes)
    tk = tkey(keys)
    np.testing.assert_array_equal(
        T.uniform(tk, (n,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys)))
    np.testing.assert_array_equal(T.split(tk, 3).numpy(),
                                  np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    # lanes on two leading axes
    np.testing.assert_array_equal(T.split(tk.reshape(lanes, 1, 2), 2).numpy()[:, 0],
                                  T.split(tk, 2).numpy())


@pytest.mark.parametrize("budget, fill", [(200, 0.5), (50, 0.05), (4000, 0.9), (10, 0.0),
                                          (200, 1.0), (0, 0.3)])
def test_keep_mask_from_a_key_matches_jax(budget, fill):
    rng = np.random.default_rng(budget + int(100 * fill))
    mask = rng.uniform(size=(3, 2049)) < fill
    keys = jax.random.split(jkey(budget), 3)
    want = np.stack([np.asarray(jmasked.random_keep_mask(k, jnp.asarray(m), budget))
                     for k, m in zip(keys, mask)])
    got = tmasked.random_keep_mask(torch.from_numpy(mask), budget, tkey(keys))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(T.keep_mask_plain(tkey(keys), torch.from_numpy(mask),
                                                    budget).numpy(), want)


def test_keep_probability_is_one_division():
    """The keep probability is budget / count rounded once, as XLA divides
    (a reciprocal times the budget, torch's ``int / tensor``, rounds
    twice and differs from it at a quarter of the counts)."""
    counts = np.arange(1, 2049)
    for budget in (200, 1000, 7):
        want = np.minimum(np.float32(1.0), np.float32(budget) / counts.astype(np.float32))
        # one lane a count, each with exactly that many valid entries, the
        # draws on the keep probability and one ulp below it
        mask = torch.from_numpy(np.arange(len(counts))[None, :] < counts[:, None])
        draws = torch.from_numpy(np.broadcast_to(want[:, None], mask.shape).copy())
        below = torch.from_numpy(np.nextafter(want, np.float32(0))[:, None].repeat(len(counts), 1))
        assert not tmasked.random_keep_mask(mask, budget, draws).any()
        np.testing.assert_array_equal(tmasked.random_keep_mask(mask, budget, below).numpy(),
                                      mask.numpy())


def test_wrapper_checks_the_key():
    with pytest.raises(ValueError, match="uint32"):
        T.split(torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="uint32"):
        T.keep_mask(torch.zeros(3, dtype=torch.uint32), torch.ones(4, dtype=torch.bool), 2)


# ------------------------------------------------------------ the steps --

@pytest.fixture(scope="module")
def sub_stream():
    """The JAX package's subsampled stream: (state before, frame, state
    after, registration) of each step, and the configuration."""
    cfg = jax_config().replace(optimization={"subsample_residuals": BUDGET})
    st = jinit_state(cfg)
    steps = []
    for fr in jax_frames(cfg, N_STEPS):
        new, reg = jstep(st, fr, cfg)
        steps.append((st, fr, new, reg))
        st = new
    return cfg, steps


def test_state_key_comes_across_both_ways(sub_stream):
    _, steps = sub_stream
    st = steps[-1][2]
    fields = state_fields(st)
    port = state_from_numpy(fields, "cpu")
    assert port.rng.dtype == torch.uint32
    np.testing.assert_array_equal(port.rng.numpy(), np.asarray(st.rng))
    back = state_to_numpy(port)
    for name in ("rng", "q_w", "frame_count", "map_surface.mask", "hist_surf_xyz"):
        np.testing.assert_array_equal(back[name], fields[name], err_msg=name)
    # a new state's key is PRNGKey(0), as the JAX package's init
    np.testing.assert_array_equal(init_state(config_from_dict(dataclasses.asdict(
        jax_config())), "cpu").rng.numpy(), np.asarray(jkey(0)))


def test_every_icp_pass_splits_the_carry_key():
    """The carry holds the registration's key and each pass splits it,
    keeping the first half, whether or not subsampling is on
    (loam_livox_tpu/registration/icp.py:235)."""
    from loam_livox_tpu_torch.core.types import PointBatch

    rng = np.random.default_rng(5)

    def batch(n, extent):
        xyz = torch.from_numpy(rng.uniform(-extent, extent, (n, 3)).astype(np.float32))
        return PointBatch(xyz, torch.zeros(n), torch.ones(n, dtype=torch.bool))

    cfg = config_from_dict(dataclasses.asdict(jax_config()))
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0])
    for budget in (0, 8):
        icp_pass, carry, _ = ticp.prepare_frame(
            batch(16, 2.0), batch(32, 2.0), batch(64, 2.0), batch(128, 2.0), ident,
            torch.zeros(3), torch.zeros(()), torch.ones(()), True,
            cfg.replace(optimization={"subsample_residuals": budget}), rng=tkey(jkey(11)))
        want = jkey(11)
        for _ in range(3):
            carry = icp_pass(carry)
            want = jax.random.split(want)[0]
            np.testing.assert_array_equal(carry.key[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("t", range(INIT, N_STEPS))
def test_teacher_forced_subsampled_step_matches_jax(sub_stream, jax_correspondences, t):
    cfg, steps = sub_stream
    st, fr, _, _ = steps[t]
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    new, reg = odometry_step(state_from_numpy(state_fields(st), "cpu"), to_port_frame(fr), tcfg)
    assert bool(reg.enabled) and reg.iterations > 0

    def check(jax_result):
        after, jreg = jax_result
        assert bool(reg.accepted) == bool(jreg.accepted)
        assert reg.iterations == int(jreg.iterations)
        assert int(reg.n_blocks) == int(jreg.n_blocks)
        np.testing.assert_array_equal(new.rng.numpy(), np.asarray(after.rng))
        for name in ("q_w", "t_w", "last_q_incre", "last_t_incre"):
            np.testing.assert_allclose(getattr(new, name).numpy(), np.asarray(getattr(after, name)),
                                       rtol=0, atol=1e-4, err_msg=name)
        for name in ("map_corners", "map_surface"):
            np.testing.assert_array_equal(getattr(new, name).mask.numpy(),
                                          np.asarray(getattr(after, name).mask), err_msg=name)

    def jax_results():
        for f in (fr, nudged_frame(fr, 1), nudged_frame(fr, -1)):
            yield jstep(st, f, cfg)

    first_match(check, jax_results())


def test_subsampled_stream_stays_with_jax(sub_stream, jax_correspondences):
    """The port's own stream over the JAX feature frames, from its own new
    state: within 0.05 m of the JAX run at every step, the same accept
    flags and iterations, the same key."""
    cfg, steps = sub_stream
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    state = init_state(tcfg, "cpu")
    for st, fr, after, jreg in steps:
        state, reg = odometry_step(state, to_port_frame(fr), tcfg)
        assert bool(reg.accepted) == bool(jreg.accepted)
        gap = float(np.linalg.norm(state.t_w.numpy() - np.asarray(after.t_w)))
        assert gap < 0.05, gap
        np.testing.assert_array_equal(state.rng.numpy(), np.asarray(after.rng))
    assert int(state.frame_count) == N_STEPS


# ------------------------------------------------------- no host reads --

def test_draw_and_in_place_layout_read_nothing_on_the_host(monkeypatch):
    """On ``meta`` tensors (shapes, no data) the draws and the product
    mode's in-place gather and copy back run through: any host read of a
    device value would raise."""
    meta = torch.device("meta")
    key = torch.zeros(2, dtype=torch.uint32, device=meta)
    keys = T.split_plain(key, 9)
    assert keys.shape == (9, 2) and keys.dtype == torch.uint32
    mask = torch.zeros((9, 1001), dtype=torch.bool, device=meta)
    assert T.keep_mask_plain(keys, mask, BUDGET).shape == mask.shape
    assert tmasked.random_keep_mask(mask, BUDGET, torch.zeros((9, 1001), device=meta)).shape \
        == mask.shape

    cfg = config_from_dict(dataclasses.asdict(jax_config()))
    mesh = Mesh(rank=1, size=2, backend="nccl")
    whole = init_state(cfg, meta)
    slices, axes = layout.shard_state(whole, mesh)

    def gather(x, _mesh, out=None):          # every rank's part, as NCCL stacks them
        parts = x.new_empty((2,) + tuple(x.shape))
        if out is not None:
            out.copy_(parts)
            return out
        return parts

    monkeypatch.setattr(layout, "all_gather", gather)
    layout.gather_state_into(slices, whole, axes, mesh)
    layout.shard_state_into(whole, slices, axes, mesh)
    assert slices.rng is whole.rng and slices.q_w is whole.q_w
    assert slices.map_surface.xyz.shape[0] * 2 == whole.map_surface.xyz.shape[0]
    assert slices.hist_surf_xyz.shape[1] * 2 == whole.hist_surf_xyz.shape[1]
