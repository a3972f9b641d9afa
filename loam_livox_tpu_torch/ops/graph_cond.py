"""The frame graph's condition kernel and the graph's assembly
(``csrc/graph_cond.cu``): the card's counterpart of the JAX package's
``lax.while_loop`` (``loam_livox_tpu/registration/icp.py:324-331``) and
of the ``lax.cond`` that picks the matching-buffer update
(``loam_livox_tpu/runtime/odometry.py:422-453``).

`loop_condition` runs the condition kernel alone (``any(active) and
loops < max_loops`` into a device int), or its plain version on the
CPU; `build_frame_graph` places the same kernel before each CUDA graph
WHILE node of a raw frame's graph (`runtime.frame_program`) and at the
end of each pass, and before each IF node (with the flag as its one
lane and no pass count), where it sets the node's conditional handle on
the device.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import build

#: condition kernels launched alone from Python since the last reset
launches = 0
#: the kernel's runs on the card, counted by the kernel: launched alone
#: or run by a frame graph's replays
runs = build.RunCounter()


def loop_condition_plain(active: torch.Tensor, loops: torch.Tensor,
                         max_loops: int) -> torch.Tensor:
    """``any(active) and loops < max_loops`` as an int32 scalar tensor."""
    return (active.any() & (loops < max_loops)).to(torch.int32)


def _library() -> ctypes.CDLL:
    lib = build.load("graph_cond")
    if lib.frame_graph_build.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.loop_cond_launch.argtypes = [p, i, p, i, p, p, p]
        lib.frame_graph_build.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p]
        lib.frame_graph_launch.argtypes = [p, p]
        lib.frame_graph_destroy.argtypes = [p, p]
        lib.graph_cond_versions.argtypes = [p]
        for fn in (lib.loop_cond_launch, lib.frame_graph_build, lib.frame_graph_launch,
                   lib.frame_graph_destroy, lib.graph_cond_versions):
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
SEGMENT, WHILE, IF = 0, 1, 2


class Item(NamedTuple):
    """One item of a frame graph: a segment (``graph`` placed as is), a
    loop (``graph`` the pass, run while any of ``flag``, the carry's
    (L,) bool ``active``, is set and ``loops``, its int32 pass count, is
    below ``max_loops``) or a branch (``graph`` run when ``flag``, one
    bool, is set).  ``graph`` is a raw ``cudaGraph_t`` handle
    (``torch.cuda.CUDAGraph.raw_cuda_graph()``); the tensors stay at
    their addresses while the frame graph lives."""
    kind: int
    graph: int
    flag: Optional[torch.Tensor] = None
    loops: Optional[torch.Tensor] = None
    max_loops: int = 0


def build_frame_graph(device: torch.device, items: Sequence[Item]) -> FrameGraph:
    """The chain of ``items`` (the graph of ``csrc/graph_cond.cu``),
    instantiated.  Raises on any error."""
    n = len(items)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if n == 0:
        raise ValueError("build_frame_graph: no items")
    for it in items:
        if it.kind == SEGMENT:
            continue
        flag, count = it.flag, it.loops
        if (it.kind not in (WHILE, IF) or flag is None or flag.device != device
                or flag.dtype != torch.bool or not flag.is_contiguous() or flag.numel() == 0
                or (it.kind == IF and flag.numel() != 1)
                or (it.kind == WHILE and (count is None or count.device != device
                                          or count.dtype != torch.int32
                                          or count.numel() != 1))):
            raise ValueError("build_frame_graph: a loop's carry is (L,) bool active and an "
                             "int32 count, a branch's flag one bool, on the graph's device")
    ptrs, ints = ctypes.c_void_p * n, ctypes.c_int * n
    graph, exec_, placed = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    _check(_library().frame_graph_build(
        device.index, n, ints(*(it.kind for it in items)), ptrs(*(it.graph for it in items)),
        ptrs(*(0 if it.flag is None else it.flag.data_ptr() for it in items)),
        ints(*(0 if it.flag is None else it.flag.numel() for it in items)),
        ptrs(*(0 if it.loops is None else it.loops.data_ptr() for it in items)),
        ints(*(it.max_loops for it in items)), runs.address(device),
        ctypes.byref(graph), ctypes.byref(exec_), ctypes.byref(placed)), "frame graph build")
    return FrameGraph(graph.value, exec_.value, device, placed.value)
