"""The frame graph's condition kernels and the graph's assembly
(``csrc/graph_cond.cu``): the card's counterpart of the JAX package's
``lax.while_loop`` (``loam_livox_tpu/registration/icp.py:324-331``) and
of the ``lax.cond`` that picks the matching-buffer update
(``loam_livox_tpu/runtime/odometry.py:421-458``).

`loop_condition` runs the loop's condition kernel alone (``any(active)
and loops < max_loops`` into a device int) and `switch_index` the
switch's (the first set flag of a row, or the row's length), or their
plain versions on the CPU; `build_frame_graph` places the loop condition
before each CUDA graph WHILE node of a raw frame's graph
(`runtime.frame_program`) and at the end of each pass, and the switch
condition before each SWITCH node, where each sets its node's
conditional handle on the device.  SWITCH nodes need CUDA 12.8: an older
toolkit fails the build, an older driver the assembly.

The same library holds the span recorder's stamp (`stamp`: the card's
globaltimer and a span's tag into a device ring, `utils.logging.spans`),
which `build_frame_graph` also places as a graph's first and last nodes
when given a ring, a probe of the globaltimer's resolution
(`globaltimer_steps`) and the count of a captured piece's kernel nodes
(`kernel_nodes`).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch

from . import build

#: condition kernels launched alone from Python since the last reset
launches = 0
#: the loop condition's runs on the card, counted by the kernel: launched
#: alone or run by a frame graph's replays
runs = build.RunCounter()
#: the switch condition's runs on the card, counted the same way
switch_runs = build.RunCounter()
#: the most bodies (flags) of a switch: one warp's ballot
MAX_BODIES = 32


def loop_condition_plain(active: torch.Tensor, loops: torch.Tensor,
                         max_loops: int) -> torch.Tensor:
    """``any(active) and loops < max_loops`` as an int32 scalar tensor."""
    return (active.any() & (loops < max_loops)).to(torch.int32)


def switch_index_plain(flags: torch.Tensor) -> torch.Tensor:
    """The first set flag of the (B,) bool ``flags``, or B when none is
    set, as an int32 scalar tensor: the body a SWITCH node runs (B runs
    none)."""
    first = flags.to(torch.int32).argmax()
    return torch.where(flags.any(), first, flags.numel()).to(torch.int32)


def _library() -> ctypes.CDLL:
    lib = build.load("graph_cond")
    if lib.frame_graph_build.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.loop_cond_launch.argtypes = [p, i, p, i, p, p, p]
        lib.switch_cond_launch.argtypes = [p, i, p, p, p]
        lib.empty_kernel_launch.argtypes = [p]
        ll = ctypes.c_longlong
        lib.stamp_launch.argtypes = [p, p, ll, ll, p]
        lib.globaltimer_probe_launch.argtypes = [p, i, p]
        lib.graph_kernel_nodes.argtypes = [p, p]
        lib.frame_graph_build.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, ll, ll, ll, p, p, p]
        lib.frame_graph_launch.argtypes = [p, p]
        lib.frame_graph_destroy.argtypes = [p, p]
        lib.graph_cond_versions.argtypes = [p]
        for fn in (lib.loop_cond_launch, lib.switch_cond_launch, lib.empty_kernel_launch,
                   lib.stamp_launch, lib.globaltimer_probe_launch, lib.graph_kernel_nodes,
                   lib.frame_graph_build, lib.frame_graph_launch, lib.frame_graph_destroy,
                   lib.graph_cond_versions):
            fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def loop_condition(active: torch.Tensor, loops: torch.Tensor, max_loops: int) -> torch.Tensor:
    """The loop condition of (L,) bool ``active`` and an int32 scalar
    ``loops`` as an int32 scalar tensor: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if active.device.type == "cpu":
        return loop_condition_plain(active, loops, max_loops)
    if (active.dtype != torch.bool or active.dim() != 1 or active.numel() == 0
            or loops.dtype != torch.int32 or loops.numel() != 1
            or not active.is_contiguous() or loops.device != active.device):
        raise ValueError("loop_condition: active (L,) bool and loops an int32 scalar "
                         "on one device")
    out = torch.empty((), dtype=torch.int32, device=active.device)
    global launches
    _check(_library().loop_cond_launch(active.data_ptr(), active.numel(), loops.data_ptr(),
                                       max_loops, out.data_ptr(), runs.address(active.device),
                                       torch.cuda.current_stream(active.device).cuda_stream),
           "loop condition launch")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out


def switch_index(flags: torch.Tensor) -> torch.Tensor:
    """The switch index of (B,) bool ``flags`` (B <= 32) as an int32
    scalar tensor: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    if flags.device.type == "cpu":
        return switch_index_plain(flags)
    if (flags.dtype != torch.bool or flags.dim() != 1 or not 0 < flags.numel() <= MAX_BODIES
            or not flags.is_contiguous()):
        raise ValueError(f"switch_index: flags (B,) bool, 0 < B <= {MAX_BODIES}")
    out = torch.empty((), dtype=torch.int32, device=flags.device)
    global launches
    _check(_library().switch_cond_launch(flags.data_ptr(), flags.numel(), out.data_ptr(),
                                         switch_runs.address(flags.device),
                                         torch.cuda.current_stream(flags.device).cuda_stream),
           "switch condition launch")
    if not torch.cuda.is_current_stream_capturing():
        launches += 1
    return out


def empty_kernel() -> None:
    """Launch an empty one-thread kernel on the current stream: a graph
    captured from it measures the floor of a kernel node (counted
    nowhere)."""
    _check(_library().empty_kernel_launch(torch.cuda.current_stream().cuda_stream),
           "empty kernel launch")


class Ring(NamedTuple):
    """A device ring of span stamps: ``records`` (capacity, 2) int64
    (globaltimer ns, tag), ``cursor`` an int64 scalar counting every
    stamp (`stamp`; past the capacity a stamp is counted and not kept)."""
    records: torch.Tensor
    cursor: torch.Tensor


def stamp(ring: Ring, tag: int) -> None:
    """One stamp of ``tag`` into ``ring`` on the current stream of its
    device (under a capture, a kernel node that stamps at every replay)."""
    dev = ring.records.device
    _check(_library().stamp_launch(ring.records.data_ptr(), ring.cursor.data_ptr(),
                                   ring.records.shape[0], tag,
                                   torch.cuda.current_stream(dev).cuda_stream), "stamp launch")


def globaltimer_steps(device: torch.device, n: int) -> torch.Tensor:
    """``n`` back-to-back readings of the card's globaltimer (ns, int64)
    by one thread, synchronised: their least nonzero step is its
    resolution."""
    out = torch.zeros(n, dtype=torch.int64, device=device)
    _check(_library().globaltimer_probe_launch(out.data_ptr(), n,
                                               torch.cuda.current_stream(device).cuda_stream),
           "globaltimer probe launch")
    torch.cuda.synchronize(device)
    return out


def kernel_nodes(graph: int) -> int:
    """The kernel nodes of a captured ``cudaGraph_t`` (child graphs not
    entered)."""
    out = ctypes.c_int()
    _check(_library().graph_kernel_nodes(graph, ctypes.byref(out)), "cudaGraphGetNodes")
    return out.value


def versions() -> Tuple[int, int]:
    """(driver, runtime) CUDA versions as the library sees them."""
    out = (ctypes.c_int * 2)()
    _check(_library().graph_cond_versions(out), "cudaDriverGetVersion")
    return out[0], out[1]


class FrameGraph:
    """An instantiated frame graph (`build_frame_graph`); `launch` runs it
    on the current stream, `close` frees it."""

    def __init__(self, graph: int, exec_: int, device: torch.device, cond_nodes: int):
        self._graph, self._exec, self.device, self.cond_nodes = graph, exec_, device, cond_nodes

    def launch(self) -> None:
        _check(_library().frame_graph_launch(
            self._exec, torch.cuda.current_stream(self.device).cuda_stream), "cudaGraphLaunch")

    def close(self) -> None:
        if self._exec is not None:
            _check(_library().frame_graph_destroy(self._graph, self._exec), "cudaGraphDestroy")
            self._graph = self._exec = None

    def __del__(self):
        try:
            self.close()
        except Exception:       # never raise under garbage collection
            pass


#: the kinds of a frame graph's items (``csrc/graph_cond.cu``)
SEGMENT, WHILE, SWITCH = 0, 1, 2


class Item(NamedTuple):
    """One item of a frame graph: a segment (``graph`` placed as is), a
    loop (``graph`` the pass, run while any of ``flag``, the carry's
    (L,) bool ``active``, is set and ``loops``, its int32 pass count, is
    below ``max_loops``) or a switch (``graph`` a tuple of B bodies,
    body b run when it is the first set flag of ``flag``, B bools; none
    when none is set).  A graph is a raw ``cudaGraph_t`` handle
    (``torch.cuda.CUDAGraph.raw_cuda_graph()``); the tensors stay at
    their addresses while the frame graph lives."""
    kind: int
    graph: Union[int, Tuple[int, ...]]
    flag: Optional[torch.Tensor] = None
    loops: Optional[torch.Tensor] = None
    max_loops: int = 0


def build_frame_graph(device: torch.device, items: Sequence[Item],
                      unit: Optional[Tuple[Ring, int, int]] = None) -> FrameGraph:
    """The chain of ``items`` (the graph of ``csrc/graph_cond.cu``),
    instantiated; with ``unit`` = (ring, open tag, close tag) its first
    and last nodes stamp the unit's span into the ring.  Raises on any
    error."""
    n = len(items)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if n == 0:
        raise ValueError("build_frame_graph: no items")
    for it in items:
        if it.kind == SEGMENT:
            continue
        flag, count = it.flag, it.loops
        if (it.kind not in (WHILE, SWITCH) or flag is None or flag.device != device
                or flag.dtype != torch.bool or not flag.is_contiguous() or flag.numel() == 0
                or (it.kind == SWITCH and (not isinstance(it.graph, tuple)
                                           or len(it.graph) != flag.numel()
                                           or flag.numel() > MAX_BODIES))
                or (it.kind == WHILE and (count is None or count.device != device
                                          or count.dtype != torch.int32
                                          or count.numel() != 1))):
            raise ValueError("build_frame_graph: a loop's carry is (L,) bool active and an "
                             "int32 count, a switch's flags one bool a body (at most "
                             f"{MAX_BODIES}), on the graph's device")
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    # a switch's bodies as an array of handles, alive until the build returns
    bodies = {k: (ctypes.c_void_p * len(it.graph))(*it.graph)
              for k, it in enumerate(items) if it.kind == SWITCH}
    graphs = ptrs(*(ctypes.cast(bodies[k], ctypes.c_void_p).value if k in bodies else it.graph
                    for k, it in enumerate(items)))
    graph, exec_, placed = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    ring, open_tag, close_tag = unit if unit is not None else (None, 0, 0)
    _check(_library().frame_graph_build(
        device.index, n, ints(*(it.kind for it in items)), graphs,
        ptrs(*(0 if it.flag is None else it.flag.data_ptr() for it in items)),
        ints(*(0 if it.flag is None else it.flag.numel() for it in items)),
        ptrs(*(0 if it.loops is None else it.loops.data_ptr() for it in items)),
        ints(*(it.max_loops for it in items)), runs.address(device),
        switch_runs.address(device), ring.records.data_ptr() if ring is not None else None,
        ring.cursor.data_ptr() if ring is not None else None,
        ring.records.shape[0] if ring is not None else 0,
        open_tag, close_tag, ctypes.byref(graph), ctypes.byref(exec_),
        ctypes.byref(placed)), "frame graph build")
    return FrameGraph(graph.value, exec_.value, device, placed.value)
