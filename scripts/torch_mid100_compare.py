"""The `mid100_trilidar` scenario through the JAX package and the
PyTorch port on the CPU, row by row.

    JAX_PLATFORMS=cpu python scripts/torch_mid100_compare.py small|cpu_scale [frames]

``small`` is the CI variant (3 heads x 3,072 points, 24 frames);
``cpu_scale`` the scenario's own 3 x 8,192 points with the CI
variant's capacities, registration after 6 pieces and 5 / 3 ICP
iterations (16 frames by default), as tests/test_torch_multi.py runs
it.  Both runs: one device, no capacity schedule, matching buffers cut
to 1,024 / 4,096 points.  Prints one JSON line a trajectory row (each
package's accept flag and position) and a summary line (aligned ATE,
accepted rows).
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CUT = {"map_corner_capacity": 1024, "map_surf_capacity": 4096}


def main(variant: str, frames: int | None) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    torch.set_num_threads(2)
    from loam_livox_tpu.eval import scenarios as js
    from loam_livox_tpu.frontend.multi import extract_multi_lidar
    from loam_livox_tpu.ops.voxel import voxel_downsample
    from loam_livox_tpu.runtime.pipeline import OdometryPipeline as JaxPipeline
    from loam_livox_tpu_torch.eval import scenarios as ts
    from loam_livox_tpu_torch.eval.ate import ate_rmse
    from loam_livox_tpu_torch.interop import config_from_dict
    from loam_livox_tpu_torch.runtime.pipeline import OdometryPipeline

    small = variant == "small"
    over = {"capacity": {**CUT, "auto_schedule": 0}, "parallel": {"mesh_devices": 1}}
    if not small:
        over = {"capacity": {**js.SMALL_CAPS, **over["capacity"], "max_raw_points": 8192},
                "parallel": over["parallel"], "mapping": {"init_accumulate_frames": 6},
                "optimization": {"icp_maximum_iteration": 5, "full_iterations": 3}}
    cfg, kw = js.scenario_config("mid100_trilidar", small=small)
    cfg = cfg.replace(**over)
    n = frames or (kw["frames"] if small else 16)
    tcfg = config_from_dict(dataclasses.asdict(cfg))

    port = OdometryPipeline(tcfg, device="cpu")
    sims = ts.simulators(tcfg, kw)
    for i in range(n):
        ts.multi_head_frame(port, [s.frame(i) for s in sims])
    port.flush()

    ref = JaxPipeline(cfg)
    fe, caps = cfg.feature_extraction, cfg.capacity
    sims = ts.simulators(tcfg, kw)
    for i in range(n):
        parts = [s.frame(i) for s in sims]
        nr = caps.max_raw_points
        xyz = np.zeros((len(parts), nr, 3), np.float32)
        inten = np.zeros((len(parts), nr), np.float32)
        mask = np.zeros((len(parts), nr), bool)
        for s, (x, it, _) in enumerate(parts):
            m = min(len(x), nr)
            xyz[s, :m], inten[s, :m], mask[s, :m] = x[:m], it[:m], True
        for fr in extract_multi_lidar(jnp.asarray(xyz), jnp.asarray(inten), jnp.asarray(mask),
                                      jnp.float32(parts[0][2]), fe, caps,
                                      piecewise_number=cfg.common.piecewise_number):
            ref.process_feature_frame(fr._replace(
                corners=voxel_downsample(fr.corners, fe.mapping_line_resolution,
                                         capacity=fr.corners.capacity),
                surface=voxel_downsample(fr.surface, fe.mapping_plane_resolution / 2.0,
                                         capacity=fr.surface.capacity)))

    out = {}
    for name, pipe in (("jax", ref), ("port", port)):
        est = pipe.trajectory.positions_array()
        gt = np.stack([sims[0].gt_pose_at(t)[1] for t in pipe.trajectory.times])
        out[name] = dict(est=est, accepted=list(map(bool, pipe.trajectory.accepted)),
                         ate=ate_rmse(est, gt))
    for k in range(len(out["port"]["est"])):
        print(json.dumps({"row": k, **{f"{p}_accepted": out[p]["accepted"][k] for p in out},
                          **{f"{p}_t": np.round(out[p]["est"][k], 4).tolist() for p in out}}))
    print(json.dumps({"variant": variant, "frames": n,
                      **{f"{p}_ate_aligned": out[p]["ate"] for p in out},
                      **{f"{p}_accepted": sum(out[p]["accepted"]) for p in out}}))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else None)
