"""The Livox split debounce: the hand-written CUDA kernel
``csrc/debounce.cu`` (one block of pointer doubling in shared memory, or,
for a table past one block's shared memory, in a global scratch
allocated here) on the card, its plain version on the CPU.

It ports the JAX package's greedy ``lax.scan`` over the turning-point
candidates (``loam_livox_tpu/frontend/livox.py:186-205``; reference
``livox_feature_extractor.hpp:541-566``): a candidate (slot order) is
kept when it is valid (index < n) and is the first kept of its kind
(edge or zero), or lies more than ``gap`` samples past the last kept
one.  Both versions return the sorted split table (kept indices, the
terminator ``n_valid - 1`` in the first free slot, padding ``n``) and
the number kept, without a host read.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

#: kernel launches made from Python since the last reset (a call
#: recorded into a CUDA graph launches nothing)
launches = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
runs = build.RunCounter()


def debounce_plain(cand_idx: torch.Tensor, cand_is_edge: torch.Tensor, n: int,
                   n_valid: torch.Tensor, gap: int):
    """The debounce as tensor operations (any device, no host read).

    The first candidate of each kind is always kept, so from a kept slot
    ``a`` the next kept slot is the first that lies more than ``gap``
    past it, or the first slot of the other kind when that comes sooner
    and after ``a``.  The kept slots are the chain of that map from slot
    0, walked by pointer doubling."""
    ns = cand_idx.shape[0]
    dev = cand_idx.device
    slots = torch.arange(ns, device=dev)
    valid = cand_idx < n
    far = torch.searchsorted(cand_idx, cand_idx + gap, right=True)
    kind0 = cand_is_edge[0]
    other = valid & (cand_is_edge != kind0)
    f_other = torch.where(other, slots, torch.full_like(slots, ns)).amin()
    nxt = torch.where(slots < f_other, torch.minimum(far, f_other), far)
    # slot ns is a sink past the table
    jump = torch.cat([torch.clamp(nxt, max=ns), torch.full((1,), ns, device=dev)])
    chain = torch.zeros(1, dtype=torch.int64, device=dev)
    while chain.shape[0] < ns:
        chain = torch.cat([chain, jump[chain]])
        jump = jump[jump]
    on_chain = torch.zeros(ns + 1, dtype=torch.bool, device=dev)
    on_chain[chain] = True
    accepted = on_chain[:ns] & valid
    splits = torch.where(accepted, cand_idx, torch.full_like(cand_idx, n))
    free = ~accepted
    first_free = (torch.cumsum(free.to(torch.int64), 0) == 1) & free
    splits = torch.where(first_free, n_valid.to(torch.int64) - 1, splits)
    return torch.sort(splits).values, accepted.sum()


def _library() -> ctypes.CDLL:
    lib = build.load("debounce")
    fn = lib.debounce_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.debounce_table_bytes.argtypes = [ctypes.c_int]
        lib.debounce_table_bytes.restype = ctypes.c_longlong
        lib.debounce_shared_limits.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.debounce_shared_limits.restype = ctypes.c_int
    return lib


#: device index -> (one block's opt-in shared bytes, the kernel's static
#: shared bytes), read at a device's first launch (never under a capture)
_limits: dict = {}


def scratch_bytes(ns: int, device: torch.device) -> int:
    """The global scratch an ``ns``-slot table takes on ``device``: 0 where
    the kernel's tables fit one block's opt-in shared memory (the shared
    form), else their bytes (the global form)."""
    lib = _library()
    if device.index not in _limits:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("debounce: launch it once on a device before capturing")
        out = (ctypes.c_longlong * 2)()
        err = lib.debounce_shared_limits(device.index, out)
        if err != 0:
            raise RuntimeError(f"debounce_shared_limits failed: CUDA error {err}")
        _limits[device.index] = (out[0], out[1])
    optin, static = _limits[device.index]
    table = lib.debounce_table_bytes(ns)
    return 0 if static + table <= optin else table


def debounce(cand_idx: torch.Tensor, cand_is_edge: torch.Tensor, n: int,
             n_valid: torch.Tensor, gap: int):
    """``(splits, n_accepted)``: (ns,) int64 sorted split table and an
    int64 scalar.  ``cand_idx`` (ns,) int64, ``cand_is_edge`` (ns,) bool
    and ``n_valid`` (a scalar tensor) on one device.  A CUDA tensor
    launches the kernel (its global form past one block's shared
    memory); a CPU tensor runs the plain version."""
    if cand_idx.device.type == "cpu":
        return debounce_plain(cand_idx, cand_is_edge, n, n_valid, gap)
    if cand_idx.device.type != "cuda":
        raise ValueError(f"debounce: unsupported device {cand_idx.device}")
    ns = cand_idx.shape[0]
    if (cand_idx.dtype != torch.int64 or cand_idx.dim() != 1 or ns == 0
            or cand_is_edge.dtype != torch.bool or cand_is_edge.shape != cand_idx.shape
            or cand_is_edge.device != cand_idx.device or n_valid.device != cand_idx.device
            or n_valid.numel() != 1):
        raise ValueError("debounce: cand_idx (ns,) int64, cand_is_edge (ns,) bool and a "
                         "scalar n_valid on one device")
    if not 0 <= n < 2 ** 31:
        raise ValueError(f"debounce: n = {n} outside the kernel's int32 tables")
    dev = cand_idx.device
    idx = cand_idx.contiguous()
    edge = cand_is_edge.contiguous()
    nv = n_valid.to(torch.int64).reshape(())
    splits = torch.empty(ns, dtype=torch.int64, device=dev)
    kept = torch.empty((), dtype=torch.int64, device=dev)
    n_scratch = scratch_bytes(ns, dev)
    tables = (torch.empty(n_scratch, dtype=torch.uint8, device=dev) if n_scratch else None)
    global launches
    err = _library().debounce_launch(idx.data_ptr(), edge.data_ptr(), ns, n, nv.data_ptr(),
                                     gap, splits.data_ptr(), kept.data_ptr(),
                                     runs.address(dev),
                                     None if tables is None else tables.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"debounce kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return splits, kept
