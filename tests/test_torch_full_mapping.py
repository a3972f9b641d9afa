"""The ``full_mapping`` scenario (cell matching mode) through the port's
runner and the JAX package's on the CPU.

Its CI variant (24 frames of 3,072 points, ``SMALL_CAPS``, registration
after 6 frames) with the matching buffers cut to 1,024 / 4,096 points in
both (the stream fills less than that: the port's run at the scenario's
own 4,096 / 16,384 is the same trajectory, which the second test
checks; the cut keeps the JAX CPU search near a second an iteration).
The port's aligned ATE stays under the 0.40 m golden
(tests/test_scenarios_ci.py:22) and within 0.05 m of the JAX run's, and
the accepted rows differ by at most 2.
"""
import numpy as np
import torch

from loam_livox_tpu.eval import scenarios as jscenarios

from loam_livox_tpu_torch.eval import scenarios as tscenarios

torch.set_num_threads(2)
CUT = {"capacity": {"map_corner_capacity": 1024, "map_surf_capacity": 4096}}


def test_full_mapping_small_matches_jax():
    jres = jscenarios.run_scenario("full_mapping", small=True, overrides=CUT)
    tres = tscenarios.run_scenario("full_mapping", small=True, overrides=CUT, device="cpu")
    assert tres["rows"] == tres["frames"] == 24
    assert tres["ate_aligned"] < 0.40, (tres, jres)
    assert abs(tres["ate_aligned"] - jres["ate_aligned"]) < 0.05, (tres, jres)
    assert abs(tres["accepted"] - jres["accepted"]) <= 2, (tres, jres)
    assert tres["accepted"] >= 6, tres


def test_buffer_cut_leaves_the_trajectory_alone():
    cut = tscenarios.run_scenario("full_mapping", small=True, overrides=CUT, device="cpu")
    own = tscenarios.run_scenario("full_mapping", small=True, device="cpu")
    for key in ("ate_aligned", "ate_raw", "accepted"):
        assert own[key] == cut[key], (own, cut)
    assert np.isfinite(own["ate_aligned"])
