"""The two kernel-alone timers of ``chip_smoke.py`` side by side.

``chip_smoke.device_ms`` times the ``knn_fused`` kernel from
torch.profiler's kernel records, and falls back to
``chip_smoke.queued_ms`` (calls queued behind a spin kernel, timed by
CUDA events) where the profiler records no kernel.  This script runs
the kernel phase's inputs (``chip_smoke.KERNEL_INPUTS``) once with each
timer, one JSON line an input with both times, then the first two
inputs under a profiler that records no device activity, which must
switch ``chip_smoke.KERNEL_TIMER`` to the fallback.  Then the card's
name and power limit.  Needs one CUDA card:

    python scripts/torch_kernel_timers.py
"""
import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.profiler  # noqa: E402

import chip_smoke as cs  # noqa: E402


def kernel_lines(dev) -> list[dict]:
    """The kernel phase's JSON lines, captured."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cs.kernel_phase(dev)
    return [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith("{") and '"phase": "kernel"' in line]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_timers: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    by = {}
    for timer in ("profiler", "queued events"):
        cs.KERNEL_TIMER["by"] = timer
        by[timer] = kernel_lines(dev)
    for a, b in zip(by["profiler"], by["queued events"]):
        print(json.dumps({"search": a["search"], "fill": a["fill"],
                          "profiler_ms": a["kernel_ms"], "queued_ms": b["kernel_ms"],
                          "queued_minus_profiler_ms": b["kernel_ms"] - a["kernel_ms"]}))

    # a profiler without device records, as on a host whose CUPTI
    # delivers none
    real = torch.profiler.profile

    def cpu_only(*args, **kw):
        kw["activities"] = [torch.profiler.ProfilerActivity.CPU]
        return real(*args, **kw)

    torch.profiler.profile = cpu_only
    cs.KERNEL_TIMER["by"] = "profiler"
    inputs, cs.KERNEL_INPUTS = cs.KERNEL_INPUTS, cs.KERNEL_INPUTS[:2]
    try:
        lines = kernel_lines(dev)
    finally:
        torch.profiler.profile, cs.KERNEL_INPUTS = real, inputs
    switched = cs.KERNEL_TIMER["by"] == "queued events" and all(
        line["kernel_ms_by"] == "queued events" and line["kernel_ms"] > 0 for line in lines)
    print(json.dumps({"switch_without_device_records": switched}))
    print(cs.card_line())
    return 0 if switched else 1


if __name__ == "__main__":
    sys.exit(main())
