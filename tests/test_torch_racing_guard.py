"""The racing pipeline's motion guard against the JAX pipeline on the
CPU: guard at 1e-9, queue depth 1 (every group read at once), so any
observed motion trips it.  12 raw frames make four groups of the
realtime racing profile; the first registers nothing (the matching
buffer is still empty), the second registers and moves, so the third
and fourth fall back to sequential dispatch.  Both pipelines must take
the same decisions and agree as streams
(tests/test_torch_racing_stream.py).  tests/test_torch_racing_lag.py
holds the guard's lag at a deeper queue.
"""
import torch

from loam_livox_tpu.core.config import realtime_racing_profile
from loam_livox_tpu.runtime import pipeline as jpipe

from test_torch_racing_stream import assert_racing_agrees, stream_config

torch.set_num_threads(2)


def count_batched_dispatches(monkeypatch) -> dict:
    calls = {"batched": 0}
    batched = jpipe.process_raw_frames_batched

    def counting(*a, **k):
        calls["batched"] += 1
        return batched(*a, **k)

    monkeypatch.setattr(jpipe, "process_raw_frames_batched", counting)
    return calls


def test_guard_falls_back_to_sequential(monkeypatch):
    calls = count_batched_dispatches(monkeypatch)
    cfg = stream_config(realtime_racing_profile().replace(common={"maximum_parallel_thread": 1}),
                        batch_motion_guard_t=1e-9)
    port = assert_racing_agrees(cfg, 12)
    assert (port.raced_groups, port.fallback_groups) == (calls["batched"], 2) == (2, 2)
    assert 0 < port.raced_loop_iterations < port.loop_iterations
