"""The port's scenario runner (``loam_livox_tpu_torch.eval.scenarios``)
against the JAX package's: the scenarios' configurations field for
field, an unported option of the loop scenario refused by ROADMAP
item, and the ``odometry_only`` CI variant on the CPU under its golden
(tests/test_scenarios_ci.py:21).  The ``full_mapping``,
``mid100_trilidar`` and ``loop_closure`` streams are in
tests/test_torch_full_mapping.py, tests/test_torch_multi.py and
tests/test_torch_loop_closure.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from loam_livox_tpu.eval import scenarios as jscenarios

from loam_livox_tpu_torch.eval import scenarios as tscenarios

torch.set_num_threads(2)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("name", ["odometry_only", "largescale_realtime", "full_mapping",
                                  "mid100_trilidar", "loop_closure"])
def test_scenario_configs_match_jax(name, small):
    jcfg, jkw = jscenarios.scenario_config(name, small=small)
    tcfg, tkw = tscenarios.scenario_config(name, small=small)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jtraj, ttraj = jkw.pop("traj", {}), tkw.pop("traj", {})
    assert tkw == jkw
    assert set(ttraj) == set(jtraj)
    for key, val in jtraj.items():
        np.testing.assert_array_equal(ttraj[key], val)
    assert tscenarios.SMALL_CAPS == jscenarios.SMALL_CAPS


@pytest.mark.parametrize("name, item", [("loop_closure", 15)])
def test_unported_scenarios_raise(name, item, tmp_path):
    """Every scenario is ported, the loop scenario over several devices
    too (queue 1 item 15): its first 12 small frames on 2 gloo ranks
    equal the 1-rank run's (product mode runs the step on the gathered
    state, and the sharded search is exact).  Product mode runs at the
    configured capacities (the capacity schedule is off there, as in
    the JAX package), so the 1-rank run turns the schedule off too.
    Without a process group the product mode says what it needs."""
    from test_torch_dist_worker import launch

    with pytest.raises(RuntimeError, match="torch.distributed initialised"):
        tscenarios.run_scenario(name, small=True, device="cpu",
                                overrides={"parallel": {"mesh_devices": 2}})
    one = launch("scenario", 1, tmp_path / "1", timeout=150, name=name, frames=12,
                 mesh_devices=1, auto_schedule=0)[0]
    for out in launch("scenario", 2, tmp_path / "2", timeout=150, name=name, frames=12,
                      mesh_devices=2):
        for key in ("ate_aligned", "ate_raw", "accepted", "rows", "keyframes"):
            assert out[key] == one[key], key
    assert int(one["rows"]) == 12 and int(one["accepted"]) > 0
    assert name in tscenarios.SCENARIOS


@pytest.mark.parametrize("name", ["full_mapping", "mid100_trilidar"])
def test_new_scenarios_run_on_the_card_by_default(monkeypatch, name):
    """Without a card and without ``device='cpu'`` the new paths raise
    instead of falling back to the CPU; the cell-mode pipeline too."""
    from loam_livox_tpu_torch import OdometryPipeline, SlamConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscenarios.run_scenario(name, small=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        OdometryPipeline(SlamConfig().replace(mapping={"matching_mode": 1}))


def test_odometry_only_small_under_golden():
    res = tscenarios.run_scenario("odometry_only", small=True, device="cpu")
    assert res["rows"] == res["frames"] == 24
    assert res["ate_aligned"] < 0.35 and res["accepted"] >= 12, res
