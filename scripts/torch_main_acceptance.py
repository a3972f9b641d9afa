"""Accepted frames and aligned ATE of the JAX package and of the PyTorch
port, both on the CPU, over the main-path stream of `chip_smoke.py`
(phase 5: `SlamConfig()`, registration after 10 frames, 40 simulator
frames of 10,000 points, seed 0).  Each package runs at its own
defaults (the JAX one with its capacity schedule).

    JAX_PLATFORMS=cpu python scripts/torch_main_acceptance.py jax|port

Prints one JSON line: seconds, aligned ATE, accepted rows, the rejected
rows.  The JAX run takes ~10 minutes on two cores.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main(which: str) -> None:
    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory

    sim = LivoxSimulator(SimConfig(points_per_frame=10000, seed=0),
                         traj=Trajectory(ramp_t0=0.1 * 10 + 0.2))
    frames = [sim.frame(i) for i in range(40)]
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from loam_livox_tpu.core.config import SlamConfig
        from loam_livox_tpu.runtime.pipeline import OdometryPipeline

        pipe = OdometryPipeline(SlamConfig().replace(mapping={"init_accumulate_frames": 10}))
    else:
        import torch

        torch.set_num_threads(2)
        from loam_livox_tpu_torch.core.config import SlamConfig
        from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

        pipe = OdometryPipeline(SlamConfig().replace(mapping={"init_accumulate_frames": 10}),
                                device="cpu")
    t0 = time.perf_counter()
    for f in frames:
        pipe.process_raw(*f)
    pipe.flush()
    est = pipe.trajectory.positions_array()
    gt = np.stack([sim.gt_pose_at(t)[1] for t in pipe.trajectory.times])
    acc = [bool(a) for a in pipe.trajectory.accepted]
    print(json.dumps({"package": which, "seconds": time.perf_counter() - t0,
                      "ate_aligned": ate_rmse(est, gt), "accepted": sum(acc),
                      "rejected_rows": [i for i, a in enumerate(acc) if not a]}))


if __name__ == "__main__":
    main(sys.argv[1])
