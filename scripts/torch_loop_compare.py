"""The ``loop_closure`` scenario's loop decision: the port's run on the
card, replayed through the JAX package's loop service on the CPU.

    python scripts/torch_loop_compare.py --card OUT.npz      # a GPU machine, PyTorch alone
    JAX_PLATFORMS=cpu python scripts/torch_loop_compare.py --replay OUT.npz

``--card`` runs the scenario at its own configuration through the port
on the card (170 frames; the service on its worker, as `chip_smoke.py`
runs it) and writes the service's keyframe records in the JAX package's
``runtime/checkpoint.save_loop_state`` format, with the run's trajectory
times, the ground-truth positions of its rows, and the port's result,
gate trace and payoff.

``--replay`` feeds those keyframes one at a time through a fresh JAX
``LoopCloser``'s gate scan and a fresh port one (both inline, on the
CPU) and prints, beside the card's, each gate trace, the closing pair,
the alignment score, the optimised keyframe positions and the payoff
(`eval.loop_payoff`) with its verdict.  It separates the loop decision
from the odometry: both packages judge the same keyframes.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def card_run(path: str) -> None:
    import torch

    from loam_livox_tpu_torch.eval import scenarios as S
    from loam_livox_tpu_torch.eval.loop_payoff import payoff_verdict, score_loop_payoff
    from loam_livox_tpu_torch.map.cell_map import EMPTY_KEY
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    cfg, kw = S.scenario_config("loop_closure")
    sim = S.simulators(cfg, kw)[0]
    pipe = OdometryPipeline(cfg, device="cuda")
    for i in range(kw["frames"]):
        pipe.process_raw(*sim.frame(i))
    pipe.flush()
    torch.cuda.synchronize()
    closer = pipe.loop_closer
    closer.shutdown()
    times = list(pipe.trajectory.times)
    gt = np.stack([sim.gt_pose_at(t)[1] for t in times])

    arrays = {"times": np.asarray(times), "gt": gt,
              "est": pipe.trajectory.positions_array()}
    for i, rec in enumerate(closer.keyframes):
        p = f"kf{i}"
        keys = rec.keys.cpu().numpy()
        arrays[f"{p}_keys"] = keys[keys != EMPTY_KEY].astype(np.int32)
        arrays[f"{p}_q"] = rec.q.cpu().numpy().astype(np.float32)
        arrays[f"{p}_t"] = rec.t.cpu().numpy().astype(np.float32)
        arrays[f"{p}_end"] = np.int64(rec.ending_frame_idx)
        for name, val in zip(rec.descriptor._fields, rec.descriptor):
            arrays[f"{p}_d_{name}"] = np.asarray(val.cpu() if isinstance(val, torch.Tensor)
                                                 else val)
        for s in ("snap_line", "snap_plane", "snap_full"):
            arrays[f"{p}_{s}"] = getattr(rec, s)
    for i, acc in enumerate(closer.updating):
        arrays[f"acc{i}_keys"] = np.zeros((0,), np.int64)
    res = closer.result
    payoff = score_loop_payoff(closer, times, sim.gt_pose_at)
    meta = {"closed": closer.closed, "dropped_keyframes": closer.dropped_keyframes,
            "pair_idx": 0, "n_keyframes": len(closer.keyframes), "n_waiting": 0,
            "updating": [{"frames": acc.frames} for acc in closer.updating],
            "result": None if res is None else {
                "accepted": res.accepted, "his_idx": res.his_idx, "cur_idx": res.cur_idx,
                "icp_score": res.icp_score},
            "gate_trace": closer.gate_trace, "payoff": payoff,
            "payoff_verdict": payoff_verdict(payoff) if payoff else None}
    if res is not None:
        arrays["result_q_opt"], arrays["result_t_opt"] = res.q_opt, res.t_opt
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    print(json.dumps({"card": meta, "keyframes": len(closer.keyframes)}))


def replay(path: str) -> None:
    import dataclasses

    from loam_livox_tpu.eval import loop_payoff as jpay
    from loam_livox_tpu.eval import scenarios as jscen
    from loam_livox_tpu.map.cell_map import empty_cell_map
    from loam_livox_tpu.runtime.checkpoint import load_loop_state
    from loam_livox_tpu.runtime.loop_service import LoopCloser as JCloser

    from loam_livox_tpu_torch.eval import loop_payoff as tpay
    from loam_livox_tpu_torch.interop import config_from_dict, loop_state_from_npz
    from loam_livox_tpu_torch.runtime.loop_service import LoopCloser as TCloser

    z = np.load(path)
    card = json.loads(bytes(z["meta_json"]).decode())
    times, gt = list(z["times"]), z["gt"]

    def gt_pose_at(t):
        return None, gt[times.index(t)]

    jcfg = jscen.scenario_config("loop_closure")[0].replace(
        loop_closure={"if_loop_service_async": 0})
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    out = {"card": {k: card[k] for k in ("result", "gate_trace", "payoff", "payoff_verdict")}}
    jsaved = load_loop_state(path, jcfg)
    tsaved = loop_state_from_npz(path, "cpu")
    for label, closer, saved, pay in (
            ("jax_cpu", JCloser(jcfg), jsaved.keyframes, jpay),
            ("port_cpu", TCloser(tcfg, device="cpu"), tsaved.keyframes, tpay)):
        for rec in saved:
            closer.keyframes.append(rec)
            if not closer.closed:
                if label == "jax_cpu":
                    # the live map only sizes the alignment's buffers
                    closer._scan_for_loop(empty_cell_map(
                        jcfg.mapping.cell_resolution * 0.5, jcfg.capacity.cell_capacity,
                        jcfg.capacity.cell_point_capacity))
                else:
                    closer._scan_for_loop()
        res = closer.result
        payoff = pay.score_loop_payoff(closer, times, gt_pose_at) if res else {}
        out[label] = {
            "result": None if res is None else {"his_idx": res.his_idx, "cur_idx": res.cur_idx,
                                                "icp_score": res.icp_score},
            "gate_trace": closer.gate_trace, "payoff": payoff,
            "payoff_verdict": pay.payoff_verdict(payoff) if payoff else None,
            "t_opt": None if res is None else np.asarray(res.t_opt).round(4).tolist()}
    out["card"]["t_opt"] = np.asarray(z["result_t_opt"]).round(4).tolist() \
        if "result_t_opt" in z else None
    out["keyframe_t"] = [np.asarray(r.t).round(4).tolist() for r in jsaved.keyframes]
    print(json.dumps(out, default=float))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--card", metavar="OUT.npz")
    g.add_argument("--replay", metavar="IN.npz")
    a = ap.parse_args()
    if a.card:
        card_run(a.card)
    else:
        replay(a.replay)


if __name__ == "__main__":
    main()
