"""Exact k-nearest-neighbour search, written plainly in PyTorch.

This is the CPU path of the correspondence search and the plain
version of the hand-written kernel in `ops.knn_fused`: both compute the
same function, bit for bit.

* Squared distances are ``(dx·dx + dy·dy) + dz·dz`` in f32, each product
  and sum rounded on its own (the kernel uses the same rounded
  operations, so it emits the same bits).
* The k smallest per query, ascending; equal distances go to the lower
  reference index.
* Masked-out references never match.  Queries at or past
  ``query_count``, missing neighbours (fewer than k valid references)
  and, when ``max_radius`` is given, neighbours farther than it read
  ``BIG`` with index 0.
* Queries may carry a leading lane axis, (L, Q, 3) with one count per
  lane: L query sets against the same references (the racing path).
"""
from __future__ import annotations

import torch

BIG = 1e30


def sq_dist(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(Q, 3) x (M, 3) -> (Q, M) exact f32 squared distances."""
    dx = q[:, None, 0] - r[None, :, 0]
    dy = q[:, None, 1] - r[None, :, 1]
    dz = q[:, None, 2] - r[None, :, 2]
    d = dx * dx
    d = d + dy * dy
    return d + dz * dz


def finish(d: torch.Tensor, idx: torch.Tensor, max_radius: float | None):
    """Apply the radius gate and the BIG/index-0 convention to selected
    (Q, k) distances and indices."""
    far = d >= 0.5 * BIG
    if max_radius is not None:
        far = far | (d > float(max_radius) ** 2)
    d = torch.where(far, torch.full_like(d, BIG), d)
    idx = torch.where(far, torch.zeros_like(idx), idx)
    return d, idx.to(torch.int32)


def knn(query_xyz: torch.Tensor, ref_xyz: torch.Tensor,
        ref_mask: torch.Tensor, k: int = 5,
        query_count: torch.Tensor | int | None = None,
        max_radius: float | None = None):
    """(Q, k) ascending squared distances and int32 indices (module doc);
    (L, Q, k) for (L, Q, 3) queries, each lane searched on its own with
    its own count (an (L,) tensor or sequence; a single count or None
    applies to every lane).

    Reads the valid prefixes on the host, so on CUDA it synchronises:
    it is the reference the kernel is held against, not a device path.
    """
    if query_xyz.dim() == 3:
        n_lanes, n_rows = query_xyz.shape[:2]
        counts = ([None] * n_lanes if query_count is None else
                  torch.as_tensor(query_count).reshape(-1).expand(n_lanes).tolist())
        out_d = torch.empty((n_lanes, n_rows, k), device=query_xyz.device)
        out_i = torch.empty((n_lanes, n_rows, k), dtype=torch.int32, device=query_xyz.device)
        for lane, count in enumerate(counts):
            out_d[lane], out_i[lane] = knn(query_xyz[lane], ref_xyz, ref_mask, k, count,
                                           max_radius)
        return out_d, out_i
    nq_rows = query_xyz.shape[0]
    dev = query_xyz.device
    out_d = torch.full((nq_rows, k), BIG, dtype=torch.float32, device=dev)
    out_i = torch.zeros((nq_rows, k), dtype=torch.int64, device=dev)
    valid = torch.nonzero(ref_mask).flatten()
    n_ref = int(valid[-1]) + 1 if valid.numel() else 0
    n_q = nq_rows if query_count is None else min(max(int(query_count), 0), nq_rows)
    if n_ref and n_q:
        d = sq_dist(query_xyz[:n_q].float(), ref_xyz[:n_ref].float())
        d = torch.where(ref_mask[None, :n_ref], d,
                        torch.full_like(d, float("inf")))
        kk = min(k, n_ref)
        d_s, i_s = torch.sort(d, dim=1, stable=True)
        out_d[:n_q, :kk] = d_s[:, :kk]
        out_i[:n_q, :kk] = i_s[:, :kk]
    return finish(out_d, out_i, max_radius)


def knn_dense(query_xyz: torch.Tensor, ref_xyz: torch.Tensor, ref_mask: torch.Tensor,
              k: int = 5, query_tile: int = 1024):
    """The ``dense`` correspondence engine: what the JAX package's dense
    engine computes off the TPU (``loam_livox_tpu/ops/knn.py:119``,
    exact top-k).  Distances are the expanded ``‖q‖² + ‖r‖² − 2⟨q, r⟩``
    (masked references ``+ BIG``), floored at 0; the k smallest per
    query, ties to the lower index; no radius gate, no query count.
    Queries are taken ``query_tile`` rows at a time, each a (tile, M)
    block; (L, Q, 3) queries are searched lane by lane."""
    if query_xyz.dim() == 3:
        out = [knn_dense(q, ref_xyz, ref_mask, k, query_tile) for q in query_xyz]
        return torch.stack([d for d, _ in out]), torch.stack([i for _, i in out])
    ref = ref_xyz.float()

    def sq3(x):
        return (x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2]

    ref2 = sq3(ref) + torch.where(ref_mask, 0.0, BIG)
    ds, idxs = [], []
    for q in query_xyz.float().split(max(1, query_tile)):
        d = (sq3(q)[:, None] + ref2[None, :]) - 2.0 * (q @ ref.T)
        d_s, i_s = torch.sort(d, dim=1, stable=True)
        ds.append(torch.clamp(d_s[:, :k], min=0.0))
        idxs.append(i_s[:, :k].to(torch.int32))
    return torch.cat(ds), torch.cat(idxs)
