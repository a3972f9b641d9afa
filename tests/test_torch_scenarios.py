"""The port's scenario runner (``loam_livox_tpu_torch.eval.scenarios``)
against the JAX package's: the ported scenarios' configurations field
for field, the unported one refused by ROADMAP item, and the
``odometry_only`` CI variant on the CPU under its golden
(tests/test_scenarios_ci.py:21).  The ``full_mapping`` and
``mid100_trilidar`` streams are in tests/test_torch_full_mapping.py and
tests/test_torch_multi.py.
"""
import dataclasses

import pytest
import torch

from loam_livox_tpu.eval import scenarios as jscenarios

from loam_livox_tpu_torch.eval import scenarios as tscenarios

torch.set_num_threads(2)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("name", ["odometry_only", "largescale_realtime", "full_mapping",
                                  "mid100_trilidar"])
def test_scenario_configs_match_jax(name, small):
    jcfg, jkw = jscenarios.scenario_config(name, small=small)
    tcfg, tkw = tscenarios.scenario_config(name, small=small)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tkw == jkw
    assert tscenarios.SMALL_CAPS == jscenarios.SMALL_CAPS


@pytest.mark.parametrize("name, item", [("loop_closure", 12)])
def test_unported_scenarios_raise(name, item):
    with pytest.raises(NotImplementedError, match=f"item {item} "):
        tscenarios.run_scenario(name, small=True, device="cpu")
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
