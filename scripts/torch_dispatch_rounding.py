"""How far the loop service's entries part between the card and the CPU
under chunked and racing dispatch, and where the difference enters.

Runs the stream that `tests/test_torch_gpu.py::
test_loop_entries_under_dispatch_equal_cpu` runs at seed 2 (8 frames of
6,000 points, registration from frame 4, keyframes of 2 entries) for
simulator seeds 0-5 under ``dispatch_chunk`` 4 and ``frame_batch`` 2: on the card (the
plain program, which the frame program equals bit for bit; the service
on its worker and stream), on the CPU with all threads and on
the CPU with one thread.  One JSON line a seed and mode:

* each entry's frame index, whether its touched mask equals the CPU's,
  and its pose's largest difference from the CPU's, on the card and on
  the one-thread CPU run (the CPU's own reduction order);
* the first Gauss-Newton system of the run (`gauss_newton.system_from_rJ`):
  the card's inputs (residuals, Jacobians, mask) against the CPU's,
  its H and g against the CPU's, and against the CPU's sum of the
  card's own inputs (summation order alone); relative to the largest
  entry of the CPU's array.

Then the card's name and power limit.  Needs one CUDA card:

    python scripts/torch_dispatch_rounding.py
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from loam_livox_tpu_torch.core.config import SlamConfig  # noqa: E402
from loam_livox_tpu_torch.eval.scenarios import SMALL_CAPS  # noqa: E402
from loam_livox_tpu_torch.io.simulator import LivoxSimulator, SimConfig, Trajectory  # noqa: E402
from loam_livox_tpu_torch.map.cell_map import EMPTY_KEY  # noqa: E402
from loam_livox_tpu_torch.registration import gauss_newton as GN  # noqa: E402
from loam_livox_tpu_torch.runtime.loop_service import LoopCloser  # noqa: E402
from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline  # noqa: E402

CAPS = {**SMALL_CAPS, "auto_schedule": 0, "max_raw_points": 16384,
        "map_corner_capacity": 1024, "map_surf_capacity": 4096,
        "cell_capacity": 2048, "cell_point_capacity": 16}
MODES = {"chunked": {"dispatch_chunk": 4}, "racing": {"frame_batch": 2}}
INIT = 4          # registration from this frame


def run(device, parallel, seed):
    """The loop entries (frame index, touched mask, pose), the keyframes'
    member keys and the first Gauss-Newton system (r0, J, mask, H, g,
    delta), on the host."""
    cfg = SlamConfig().replace(
        capacity=CAPS, mapping={"init_accumulate_frames": INIT},
        optimization={"icp_maximum_iteration": 3, "full_iterations": 3},
        loop_closure={"if_enable_loop_closure": 1,
                      "if_loop_service_async": int(torch.device(device).type == "cuda"),
                      "scans_of_each_keyframe": 2, "scans_between_two_keyframe": 1},
        parallel={"batch_motion_guard_t": 0.0, **parallel})
    entries, first = [], []
    on_frame, system = LoopCloser.on_frame, GN.system_from_rJ

    def record(self, cell_full, touched, q_w, t_w, frame_idx):
        entries.append((frame_idx, touched.cpu(), torch.cat([q_w, t_w]).cpu()))
        return on_frame(self, cell_full, touched, q_w, t_w, frame_idx)

    def first_system(r0, J, mask, delta):
        H, g = system(r0, J, mask, delta)
        if not first:
            first.extend([*(x.detach().cpu() for x in (r0, J, mask, H, g)), delta])
        return H, g

    sim = LivoxSimulator(SimConfig(points_per_frame=6000, seed=seed),
                         traj=Trajectory(ramp_t0=0.3))
    LoopCloser.on_frame, GN.system_from_rJ = record, first_system
    try:
        pipe = OdometryPipeline(cfg, device=device)
        # the plain program on the card: the first system is read on the
        # host inside the step, which a graph capture cannot do (the frame
        # program equals the plain program bit for bit, tests/test_torch_gpu.py)
        pipe.program = None
        for i in range(8):
            pipe.process_raw(*sim.frame(i))
        pipe.flush()
    finally:
        LoopCloser.on_frame, GN.system_from_rJ = on_frame, system
    keys = [k.keys.cpu() for k in pipe.loop_closer.keyframes]
    pipe.loop_closer.shutdown()
    return entries, [k[k != EMPTY_KEY].unique() for k in keys], first


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_dispatch_rounding: no CUDA device", file=sys.stderr)
        return 1
    threads = torch.get_num_threads()
    for mode, parallel in MODES.items():
        for seed in range(6):
            card, _, (r_c, J_c, m_c, H_c, g_c, delta) = run(torch.device("cuda"), parallel, seed)
            host, _, (r_h, J_h, m_h, H_h, g_h, _) = run("cpu", parallel, seed)
            torch.set_num_threads(1)
            one, _, _ = run("cpu", parallel, seed)
            torch.set_num_threads(threads)
            H_o, g_o = GN.system_from_rJ(r_c, J_c, m_c, delta)
            print(json.dumps({
                "mode": mode, "seed": seed, "frames": [e[0] for e in card],
                "same_frames": [e[0] for e in card] == [e[0] for e in host] == [e[0] for e in one],
                "touched_equal": [bool(torch.equal(a[1], b[1])) for a, b in zip(card, host)],
                "pose_card_vs_cpu": [float((a[2] - b[2]).abs().max()) for a, b in zip(card, host)],
                "pose_cpu_1_vs_all_threads": [float((a[2] - b[2]).abs().max())
                                              for a, b in zip(one, host)],
                "cpu_threads": threads,
                "first_system": {
                    "lanes": list(r_c.shape[:-2]), "rows": r_c.shape[-2],
                    "mask_equal": bool(torch.equal(m_c, m_h)),
                    "r0_rel": rel(r_c, r_h), "J_rel": rel(J_c, J_h),
                    "H_rel": rel(H_c, H_h), "g_rel": rel(g_c, g_h),
                    "H_order_rel": rel(H_c, H_o), "g_order_rel": rel(g_c, g_o)}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
