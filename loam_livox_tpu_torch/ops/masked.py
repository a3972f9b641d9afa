"""Masked-array helpers: fixed-capacity stand-ins for the reference's
dynamically sized vectors and sets.  Reductions run over the last axis,
so a leading lane axis batches them."""
from __future__ import annotations

import torch

BIG = 1e30


def masked_quantile_l1(values: torch.Tensor, mask: torch.Tensor,
                       ratio: float) -> torch.Tensor:
    """Value at position ``floor(ratio * n_valid)`` of the ascending
    valid entries along the last axis (reference
    ``point_cloud_registration.hpp:153-161``)."""
    vals = torch.where(mask, values, torch.full_like(values, BIG))
    svals = torch.sort(vals, dim=-1).values
    n = mask.sum(dim=-1, dtype=torch.int32)
    idx = torch.clamp((ratio * n.float()).to(torch.int32), 0, values.shape[-1] - 1)
    idx = torch.minimum(idx, torch.clamp(n - 1, min=0))
    # gather, not svals[idx]: indexing with a 0-dim tensor reads it on the host
    return torch.gather(svals, -1, idx.long()[..., None])[..., 0]


def masked_mean(values: torch.Tensor, mask: torch.Tensor, axis=None) -> torch.Tensor:
    """Mean of the valid entries (over ``axis``, default all); 0 where
    none is valid."""
    w = mask.to(values.dtype)
    if axis is None:
        return (values * w).sum() / torch.clamp(w.sum(), min=1.0)
    return (values * w).sum(dim=axis) / torch.clamp(w.sum(dim=axis), min=1.0)


def masked_min(values: torch.Tensor, mask: torch.Tensor, axis=None,
               initial: float = BIG) -> torch.Tensor:
    """Minimum of the valid entries; ``initial`` where none is valid."""
    v = torch.where(mask, values, torch.full_like(values, initial))
    return v.amin() if axis is None else v.amin(dim=axis)


def masked_max(values: torch.Tensor, mask: torch.Tensor, axis=None,
               initial: float = -BIG) -> torch.Tensor:
    """Maximum of the valid entries; ``initial`` where none is valid."""
    v = torch.where(mask, values, torch.full_like(values, initial))
    return v.amax() if axis is None else v.amax(dim=axis)


def random_keep_mask(mask: torch.Tensor, budget: int, draw: torch.Tensor) -> torch.Tensor:
    """Thin ``mask`` so that about ``budget`` entries of the last axis
    survive when more are valid: each is kept where its uniform draw in
    [0, 1) lies below budget / count, divided as one float32 division
    (reference residual-block subsampling,
    ``point_cloud_registration.hpp:438-458``; the JAX package's
    ``ops/masked.py:73-84``).  ``draw`` is either the uniforms (the shape
    of ``mask``) or a (..., 2) uint32 threefry key a lane, from which the
    JAX package's uniforms are drawn (`ops.threefry.keep_mask`: the
    kernel on the card)."""
    if draw.dtype == torch.uint32:
        from .threefry import keep_mask

        return keep_mask(draw, mask, budget)
    count = torch.clamp(mask.sum(dim=-1, dtype=torch.int32).float(), min=1.0)
    keep_prob = torch.clamp(torch.full_like(count, float(budget)) / count, max=1.0)
    return mask & (draw < keep_prob[..., None])


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Move the valid rows to the front, keeping their order.  Returns
    ``(new_mask, *compacted)`` at the input capacity."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return (mask[order],) + tuple(a[order] for a in arrays)
