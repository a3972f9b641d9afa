"""Masked-array helpers: fixed-capacity stand-ins for the reference's
dynamically sized vectors and sets."""
from __future__ import annotations

import torch

BIG = 1e30


def masked_quantile_l1(values: torch.Tensor, mask: torch.Tensor,
                       ratio: float) -> torch.Tensor:
    """Value at position ``floor(ratio * n_valid)`` of the ascending
    valid entries (reference ``point_cloud_registration.hpp:153-161``)."""
    vals = torch.where(mask, values, torch.full_like(values, BIG))
    svals = torch.sort(vals).values
    n = mask.sum(dtype=torch.int32)
    idx = torch.clamp((ratio * n.float()).to(torch.int32), 0, values.shape[0] - 1)
    idx = torch.minimum(idx, torch.clamp(n - 1, min=0))
    # gather, not svals[idx]: indexing with a 0-dim tensor reads it on the host
    return torch.gather(svals, 0, idx.long().reshape(1)).reshape(())


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Move the valid rows to the front, keeping their order.  Returns
    ``(new_mask, *compacted)`` at the input capacity."""
    order = torch.argsort((~mask).to(torch.uint8), stable=True)
    return (mask[order],) + tuple(a[order] for a in arrays)
