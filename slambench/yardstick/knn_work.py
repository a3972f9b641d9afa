"""The k-NN search's roofline yardstick, frozen here: the work any exact
search that skips whole GROUP-point groups must spend on given inputs
(a copy of the program's ``ops.knn_fused.search_work`` and the operand
it reads), and the H100 data-sheet peaks it is held against.

A kernel's roofline share is its least time, the larger of pairs x
`FLOPS_PER_PAIR` / `PEAK_FP32_FLOPS` and bytes / `PEAK_BYTES`, over its
measured time.  Inside a graph replay the per-pass inputs are not
visible from outside the program, so no cell reports it yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: H100 SXM data-sheet peaks (dense, no sparsity) at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
#: float32 operations of one query-reference pair: 3 subtractions,
#: 3 multiplications, 2 additions
FLOPS_PER_PAIR = 8
BIG = 1e30
GROUP = 256    # references per bounding box and operand padding


class RefOperand(NamedTuple):
    ref4: torch.Tensor    # (Mp, 4) rows (x, y, z, ||r||² + mask penalty)
    boxes: torch.Tensor   # (Mp // GROUP, 8) rows (lo_xyz, 0, hi_xyz, 0)
    n_ref: torch.Tensor   # () int32: one past the last valid reference


def build_ref_operand(ref_xyz: torch.Tensor, ref_mask: torch.Tensor) -> RefOperand:
    """Pad the references to a multiple of GROUP and precompute the
    kernel's rows, the per-group boxes (an all-invalid group gets an
    empty box, lo > hi) and the valid prefix, without a host sync."""
    m = ref_xyz.shape[0]
    mp = -(-max(m, 1) // GROUP) * GROUP
    dev = ref_xyz.device
    ref = torch.zeros((mp, 3), dtype=torch.float32, device=dev)
    ref[:m] = ref_xyz
    mask = torch.zeros((mp,), dtype=torch.bool, device=dev)
    mask[:m] = ref_mask
    r2 = (ref * ref).sum(dim=1) + torch.where(
        mask, torch.zeros((), device=dev), torch.full((), BIG, device=dev))
    ref4 = torch.cat([ref, r2[:, None]], dim=1).contiguous()
    grp = ref.reshape(mp // GROUP, GROUP, 3)
    gmask = mask.reshape(mp // GROUP, GROUP, 1)
    inf = torch.full((), float("inf"), device=dev)
    lo = torch.where(gmask, grp, inf).amin(dim=1)
    hi = torch.where(gmask, grp, -inf).amax(dim=1)
    pad = torch.zeros((mp // GROUP, 1), dtype=torch.float32, device=dev)
    boxes = torch.cat([lo, pad, hi, pad], dim=1).contiguous()
    iota = torch.arange(1, mp + 1, dtype=torch.int32, device=dev)
    n_ref = torch.where(mask, iota, torch.zeros_like(iota)).amax()
    return RefOperand(ref4=ref4, boxes=boxes, n_ref=n_ref)


def search_work(query_xyz: torch.Tensor, query_count, ref_op: RefOperand,
                max_radius: float | None, k: int = 5) -> tuple[int, int]:
    """(pairs, bytes) that any exact search skipping whole GROUP-point
    groups must spend on these inputs, whatever its tiling.

    Pairs: each valid query (row < ``query_count``) against each valid
    reference of every group whose box lies within ``max_radius`` of
    that query's own point (every group when it is None), box distances
    in float64.  Bytes: the valid queries, the reference rows up to the
    last valid one and their boxes read once, the (n_q, k) lists written
    once.  With a lane axis, pairs, queries and lists sum over the lanes
    and the shared operand counts once.  Reads the counts on the host: a
    yardstick, not a device path.
    """
    lanes = query_xyz.reshape(-1, query_xyz.shape[-2], 3)
    counts = ([lanes.shape[1]] * lanes.shape[0] if query_count is None else
              torch.as_tensor(query_count).reshape(-1).expand(lanes.shape[0]).tolist())
    n_ref = int(ref_op.n_ref)
    valid = (ref_op.ref4[:, 3] < 0.5 * BIG).reshape(-1, GROUP).sum(1)
    live = valid > 0
    lo = ref_op.boxes[live, 0:3].double()
    hi = ref_op.boxes[live, 4:7].double()
    pairs = n_q_all = 0
    for q_lane, count in zip(lanes, counts):
        n_q = min(max(int(count), 0), q_lane.shape[0])
        n_q_all += n_q
        if max_radius is None:
            pairs += n_q * int(valid.sum())
            continue
        for q in q_lane[:n_q].double().split(256):
            gap = torch.clamp(torch.maximum(lo[None] - q[:, None], q[:, None] - hi[None]), min=0)
            near = (gap * gap).sum(-1) <= float(max_radius) ** 2
            pairs += int((near.to(valid.dtype) * valid[live][None]).sum())
    n_groups = -(-n_ref // GROUP)
    return pairs, n_q_all * 12 + n_ref * 16 + n_groups * 32 + n_q_all * k * 8
