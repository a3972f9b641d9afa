"""The check's control on the card, at a size a test run holds: the plain
reference computed with TF32 matrix products, put in the program's
place, must come out not correct under the limits of the cells, while
the program itself comes out correct.  Needs the card (marker ``gpu``);
at the cells' own size the same readings come from
``slambench/control.py``.

    python -m pytest slambench/tests/test_slambench_control.py -q
"""
from __future__ import annotations

import pytest
import torch

from slambench import harness
from slambench.tests.tiny import make_bench


@pytest.mark.gpu
@pytest.mark.parametrize("cell, limits_of", [("tiny1_replay", "mid40_replay"),
                                             ("tiny3_replay", "mid100_replay")])
def test_tf32_control_is_not_correct(tmp_path, cell, limits_of):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is TF32 matrix products on the card")
    bench, manifest = make_bench(tmp_path)
    limits = harness.load_limits(limits_of)
    out = harness.run_cell(harness.cell_of(manifest, cell), 2 ** 31 + 99, 2.0, False, 0.0,
                           bench=bench, device="cuda", manifest=manifest, limits=limits,
                           controls=("tf32",))
    assert out["correct"] is True
    control = out["_controls"]["tf32"]
    assert any(not control[k] <= limits[k] for k in control), control
