"""Product mode's candidate exchange: every rank's (..., k) kNN candidates
gathered from the other ranks and merged by (distance, index), as one
hand-written CUDA kernel (``csrc/peer_gather.cu``) on the card; its plain
version, an all-gather and `parallel.sharded.merge_candidates`, on the
CPU (gloo ranks).

The kernel reads its peers' candidates through peer pointers: each rank
allocates one symmetric buffer (and its signal pad) with torch's
symmetric memory and exchanges the pointers once, at the rendezvous
(`rendezvous`, a collective every rank makes outside any CUDA graph
capture).  It is a kernel node, so the frame program can place it
inside an ICP pass's WHILE body, whose conditional graph admits kernel
nodes (and not every node NCCL's captured all-gather makes: across
ranks the card refused a frame graph with one there).
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from . import build

#: kernel launches made from Python since the last reset (a call recorded
#: into a CUDA graph launches nothing)
launches = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
runs = build.RunCounter()
#: the symmetric buffer's bytes a rank: room for (rows, k) candidates of
#: float32 distances and int32 indices, rows * k * 8 bytes
BUFFER_BYTES = 32 << 20
MAX_K = 8
MAX_WORLD = 8
#: the most blocks (one signal-pad channel each) of one launch
MAX_BLOCKS = 64


def peer_gather_plain(d: torch.Tensor, i: torch.Tensor, mesh, k: int):
    """Every rank's (..., k) distances and int32 indices all-gathered and
    merged to the k smallest by (distance, index), on any device (a
    collective)."""
    from ..parallel.sharded import all_gather, concat_ranks, merge_candidates

    return merge_candidates(concat_ranks(all_gather(d, mesh), -1),
                            concat_ranks(all_gather(i, mesh), -1), k)


class Peers(NamedTuple):
    """One rank's side of the rendezvous on one device."""
    buffer: torch.Tensor      # this rank's symmetric buffer (kept alive here)
    handle: object            # torch's symmetric-memory handle
    buffers: int              # device array of every rank's buffer pointer
    pads: int                 # device array of every rank's signal-pad pointer
    max_blocks: int           # blocks a launch may take: one pad channel each


_peers: Dict[tuple, Peers] = {}


def _key(mesh, device: torch.device) -> tuple:
    index = device.index if device.index is not None else torch.cuda.current_device()
    return (mesh.rank, mesh.size, index)


def rendezvous(mesh, device: torch.device) -> Peers:
    """This rank's symmetric buffer on ``device``, rendezvoused with every
    rank of ``mesh`` (the world group) at its first call; a collective
    that must not fall under a CUDA graph capture."""
    key = _key(mesh, device)
    peers = _peers.get(key)
    if peers is not None:
        return peers
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("peer_gather: rendezvous on the mesh before capturing")
    import torch.distributed as dist
    import torch.distributed._symmetric_memory as symm_mem

    buffer = symm_mem.empty(BUFFER_BYTES // 4, dtype=torch.int32, device=device)
    handle = symm_mem.rendezvous(buffer, dist.group.WORLD)
    pad_slots = int(handle.signal_pad_size) // 4
    max_blocks = min(MAX_BLOCKS, pad_slots // mesh.size)
    if handle.world_size != mesh.size or handle.rank != mesh.rank or max_blocks < 1:
        raise RuntimeError(f"peer_gather: rendezvous of rank {handle.rank} of "
                           f"{handle.world_size} for mesh rank {mesh.rank} of {mesh.size}, "
                           f"{pad_slots} signal-pad slots")
    peers = _peers[key] = Peers(buffer, handle, int(handle.buffer_ptrs_dev),
                                int(handle.signal_pad_ptrs_dev), max_blocks)
    return peers


def _library() -> ctypes.CDLL:
    lib = build.load("peer_gather")
    fn = lib.peer_gather_launch
    if fn.argtypes is None:
        p, n = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, n, n, p, p, n, n, n, p, p, p, p]
        fn.restype = n
    return lib


def peer_gather(d: torch.Tensor, i: torch.Tensor, mesh, k: int):
    """The k smallest of every rank's (..., k) candidates ``d`` (float32)
    and ``i`` (int32, indices into the whole reference set) by (distance,
    index): (..., k) float32 and int32.  A CUDA tensor under an NCCL mesh
    launches the kernel (every rank must call it alike); a CPU tensor runs
    the plain version."""
    if d.device.type == "cpu":
        return peer_gather_plain(d, i, mesh, k)
    if d.device.type != "cuda" or mesh.backend != "nccl":
        raise ValueError(f"peer_gather: {d.device} tensors on a {mesh.backend} mesh")
    if (d.dtype != torch.float32 or i.dtype != torch.int32 or d.shape != i.shape
            or d.dim() == 0 or d.shape[-1] != k or i.device != d.device):
        raise ValueError("peer_gather: (..., k) float32 distances and int32 indices on one "
                         "device")
    rows = d.numel() // k
    if not (0 < k <= MAX_K and 0 < mesh.size <= MAX_WORLD and 0 < rows
            and rows * k * 8 <= BUFFER_BYTES):
        raise ValueError(f"peer_gather: {rows} rows of {k} from {mesh.size} ranks outside the "
                         "kernel's range")
    dev = d.device
    peers = rendezvous(mesh, dev)
    d_out = torch.empty_like(d, memory_format=torch.contiguous_format)
    i_out = torch.empty_like(i, memory_format=torch.contiguous_format)
    global launches
    err = _library().peer_gather_launch(
        d.contiguous().data_ptr(), i.contiguous().data_ptr(), rows, k, peers.buffers,
        peers.pads, mesh.rank, mesh.size, peers.max_blocks, d_out.data_ptr(),
        i_out.data_ptr(), runs.address(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"peer_gather kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return d_out, i_out
