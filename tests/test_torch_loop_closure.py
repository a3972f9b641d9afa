"""The ``loop_closure`` scenario through the port's runner and the JAX
package's on the CPU.

Its CI variant (``small=True``: 3,072 points a frame, ``SMALL_CAPS``,
keyframes of 12 frames every 6, candidates 2 keyframes apart, loosened
admission ratios, the default room) runs 40 frames in the port under its
golden (0.45 m aligned ATE, at least 20 accepted,
tests/test_scenarios_ci.py:24).

The two packages are compared over the first 20 frames: the stream's
registrations start at frame 6, and at this point budget with 5 ICP
iterations the two runs part at frame 11 (6 mm) and by frame 14 are
centimetres apart.  Both run the capacity schedule (tier 16, then 2
from frame 4) and both lose track later: the JAX run rejects every
frame from 25 on (25 of 40 accepted), the port frame 23 and every frame
from 27 on (26 of 40; it rejected 6 of 40 when it ran at the configured
capacities).  Over 20
frames both track: the aligned ATE must agree within 0.05 m, with the
same number of keyframes (2, at frames 12 and 18) and the same first
gate record (the similarity
of keyframes 1 and 0).  Its value differs: a keyframe image depends on
the signs of a 3 × 3 ``eigh``, and the packages' LAPACK calls pick
different signs on these keyframes, a mirrored image (0.968 against
0.825; ROADMAP.md §3), so the port's run closes that loop and the JAX
run does not.
"""
import numpy as np
import pytest
import torch

from loam_livox_tpu.eval import scenarios as jscenarios
from loam_livox_tpu.runtime import pipeline as jpipeline

from loam_livox_tpu_torch.eval import scenarios as tscenarios

torch.set_num_threads(2)
INLINE = {"loop_closure": {"if_loop_service_async": 0}}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's small run over 20 frames, and its loop service."""
    seen = []
    flush = jpipeline.OdometryPipeline.flush

    def keep(self):
        flush(self)
        seen.append(self)

    jpipeline.OdometryPipeline.flush = keep
    try:
        res = jscenarios.run_scenario("loop_closure", small=True, frames=20, overrides=INLINE)
    finally:
        jpipeline.OdometryPipeline.flush = flush
    return res, seen[-1].loop_closer


def test_loop_closure_small_under_golden():
    res = tscenarios.run_scenario("loop_closure", small=True, device="cpu", overrides=INLINE)
    assert res["rows"] == res["frames"] == 40
    assert res["ate_aligned"] < 0.45 and res["accepted"] >= 20, res
    assert res["keyframes"] >= 2
    if res["loop_closed"]:
        assert {"ate_kf_raw_before_loop", "ate_kf_raw_after_loop"} <= set(res)


def test_loop_closure_small_matches_jax(jax_run):
    jres, jcloser = jax_run
    tres = tscenarios.run_scenario("loop_closure", small=True, frames=20, device="cpu",
                                   overrides=INLINE)
    assert tres["rows"] == 20 and tres["accepted"] == jres["accepted"] == 20
    assert abs(tres["ate_aligned"] - jres["ate_aligned"]) < 0.05, (tres, jres)
    assert tres["keyframes"] == len(jcloser.keyframes) == 2


def test_first_gate_record_matches_jax(jax_run):
    _, jcloser = jax_run
    seen = []
    from loam_livox_tpu_torch.runtime import pipeline as tpipeline

    flush = tpipeline.OdometryPipeline.flush

    def keep(self):
        flush(self)
        seen.append(self)

    tpipeline.OdometryPipeline.flush = keep
    try:
        tscenarios.run_scenario("loop_closure", small=True, frames=20, device="cpu",
                                overrides=INLINE)
    finally:
        tpipeline.OdometryPipeline.flush = flush
    got, want = seen[-1].loop_closer.gate_trace[0], jcloser.gate_trace[0]
    assert (got["stage"], got["cur"], got["his"]) == (want["stage"], want["cur"], want["his"]) \
        == ("similarity", 1, 0)
    assert np.isfinite(got["sim_plane"]) and np.isfinite(want["sim_plane"])
