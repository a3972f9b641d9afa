"""The product mesh: a `torch.distributed` process group of ranks, one
device each (the counterpart of ``loam_livox_tpu/parallel/mesh.py``).

A JAX mesh is one program over many devices; here it is one process a
device.  The ranks run the same code on the same inputs; the matching
buffer's point axis is what they split (`parallel.layout`), and the
kNN over it crosses the group as one all-gather
(`parallel.sharded.knn_sharded`).  NCCL serves CUDA ranks and gloo CPU
ranks.  One card cannot host two NCCL ranks (a communicator refuses the
same device twice), so on one card the product mesh has one rank.

The pipeline registers its mesh for the registration code to read
(`set_active_mesh`, per thread), as the JAX package registers its mesh
at trace time, together with the deterministic-numerics flag that
``parallel/deterministic`` sets (``parallel/det_solver`` has nothing to
harden here: the solve runs whole on every rank).  The loop
service's worker thread sees no mesh: every rank runs its own service
on the gathered state, alike.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """The world process group: ``size`` ranks, this process ``rank``."""

    rank: int
    size: int
    backend: str


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The world process group as a 1-D mesh.  The group must be up
    (`initialize_multihost`, or the caller's ``init_process_group``);
    ``n_devices`` other than the world size is a ``ValueError``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("the product mesh needs torch.distributed initialised "
                           "(initialize_multihost, or a launcher such as torchrun)")
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"parallel/mesh_devices={n_devices} but the process group has "
                         f"{size} ranks: run one process a device")
    return Mesh(rank=dist.get_rank(), size=size, backend=dist.get_backend())


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The rank's device: its own card under NCCL (``LOCAL_RANK``), the
    given device under gloo."""
    device = torch.device(device)
    if mesh.backend == "nccl" and device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", mesh.rank)))
    return device


def warm_up(mesh: Mesh, device) -> None:
    """One small all-gather on the mesh from ``device``, waited for: the
    NCCL communicator is created at a group's first collective, which must
    not fall under a CUDA graph capture (the frame program captures the
    product mode's gathers).  Every rank calls it."""
    x = torch.full((1,), mesh.rank, dtype=torch.int32, device=device)
    out = torch.empty((mesh.size,), dtype=torch.int32, device=device)
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, x)
    else:
        dist.all_gather(list(out.unbind(0)), x)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _Active(threading.local):
    """The registration, per thread: the frame thread's mesh is not the
    loop worker's (its scene alignment searches on its own rank)."""
    mesh: Optional[Mesh] = None
    deterministic: bool = False


_ACTIVE = _Active()


def set_active_mesh(mesh: Optional[Mesh], deterministic: Optional[bool] = None) -> None:
    """Register the product mesh (or None) and the deterministic-numerics
    flag for this thread (``deterministic`` None follows the mesh)."""
    _ACTIVE.mesh = mesh
    _ACTIVE.deterministic = mesh is not None if deterministic is None else bool(deterministic)


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh


def det_active() -> bool:
    """Whether sums that feed a gate must not depend on the world size
    (`parallel.sharded.normal_system_psum` takes fixed-size blocks)."""
    return _ACTIVE.deterministic


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> Mesh:
    """``init_process_group`` and the world mesh.  Without arguments it
    reads the launcher's environment (``torchrun``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a coordinator address
    ``host:port`` with the process count and id starts a group by hand.
    The backend is NCCL, one card a rank; without a card that raises
    unless the caller asks for the CPU with ``backend="gloo"``."""
    if not dist.is_initialized():
        backend = backend or "nccl"
        if backend == "nccl":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device for the NCCL backend: pass "
                                   "backend='gloo' to run the ranks on the CPU")
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", process_id or 0)))
        if coordinator_address is not None:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=int(num_processes), rank=int(process_id))
        elif all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                                           "RANK")):
            dist.init_process_group(backend)
        else:
            raise RuntimeError("product mode needs its process group: run one process a "
                               "device under a launcher (torchrun), or give the "
                               "coordinator address, process count and id")
    return make_mesh()
