"""Where the port's main path parts between the card and the CPU.

Runs the main-path stream of `chip_smoke.py` (phase 5: `SlamConfig()`,
registration after 10 frames, 40 simulator frames of 10,000 points,
seed 0) frame by frame on the card and on the CPU, printing each
frame's registration (accepted, ICP iterations, gate cost, angular
step, pose).  Then every registered frame is stepped on both devices
from the CPU run's state (teacher-forced), and the first frame whose
accept flags part is stepped from the CPU state with ICP caps of 1 to
15 iterations.  Needs a card:

    python scripts/torch_card_vs_cpu_steps.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import simulate  # noqa: E402
from loam_livox_tpu_torch.core.config import SlamConfig  # noqa: E402
from loam_livox_tpu_torch.core.types import PointBatch  # noqa: E402
from loam_livox_tpu_torch.frontend import livox  # noqa: E402
from loam_livox_tpu_torch.runtime.odometry import OdometryState, init_state, odometry_step  # noqa: E402
from loam_livox_tpu_torch.runtime.pipeline import process_raw_frame, source_downsample  # noqa: E402

CFG = SlamConfig().replace(mapping={"init_accumulate_frames": 10})
N = 40


def padded(frame, dev):
    xyz, inten, t0 = frame
    n = CFG.capacity.max_raw_points
    p, i, m = np.zeros((n, 3), np.float32), np.zeros(n, np.float32), np.zeros(n, bool)
    p[:len(xyz)], i[:len(xyz)], m[:len(xyz)] = xyz, inten, True
    return (*(torch.from_numpy(a).to(dev) for a in (p, i, m)), t0)


def moved(state, dev) -> OdometryState:
    def mv(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, PointBatch):
            return PointBatch(*(y.to(dev) for y in x))
        if isinstance(x, torch.Generator):
            return torch.Generator(device=dev).manual_seed(0)
        return x
    return OdometryState(*(mv(x) for x in state))


def summary(reg) -> dict:
    def f(x):
        return float(torch.as_tensor(x).float().cpu())
    return dict(accepted=bool(reg.accepted.cpu()), iterations=int(reg.iterations),
                gate_cost=f(reg.gate_cost), angle_deg=f(reg.angular_diff_deg),
                t=[round(v, 5) for v in reg.t_w.cpu().tolist()])


def feature_frame(frame, dev):
    p, i, m, t0 = padded(frame, dev)
    _, _, (fr,) = livox.extract_frame(p, i, m, t0, CFG.feature_extraction, CFG.capacity, 1)
    return source_downsample(fr, CFG)


def stream(frames, dev):
    state, rows, states = init_state(CFG, dev), [], []
    for frame in frames:
        states.append(moved(state, "cpu"))
        state, regs, _ = process_raw_frame(state, *padded(frame, dev), CFG)
        rows.append(summary(regs[0]))
    return rows, states


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, frames = simulate(N, 10000, 10)
    card, _ = stream(frames, "cuda")
    cpu, cpu_states = stream(frames, "cpu")
    for k in range(N):
        print(json.dumps({"frame": k, "card": card[k], "cpu": cpu[k]}))
    print(json.dumps({"accepted_card": sum(r["accepted"] for r in card),
                      "accepted_cpu": sum(r["accepted"] for r in cpu)}))
    flips = 0
    for k in range(10, N):
        c = summary(odometry_step(moved(cpu_states[k], "cuda"), feature_frame(frames[k], "cuda"),
                                  CFG)[1])
        h = summary(odometry_step(cpu_states[k], feature_frame(frames[k], "cpu"), CFG)[1])
        flips += c["accepted"] != h["accepted"]
        print(json.dumps({"teacher_forced_frame": k, "card": c, "cpu": h}))
    first = next((k for k in range(N) if card[k]["accepted"] != cpu[k]["accepted"]), None)
    print(json.dumps({"teacher_forced_accept_flips": flips, "first_run_difference": first}))
    if first is not None:
        for cap in range(1, 16):
            cfg = CFG.replace(optimization={"icp_maximum_iteration": cap})
            c = summary(odometry_step(moved(cpu_states[first], "cuda"),
                                      feature_frame(frames[first], "cuda"), cfg)[1])
            h = summary(odometry_step(cpu_states[first], feature_frame(frames[first], "cpu"),
                                      cfg)[1])
            print(json.dumps({"cap": cap, "card": c, "cpu": h}))


if __name__ == "__main__":
    main()
