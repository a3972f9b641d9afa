"""The frame program: a dispatch unit as one CUDA graph launch on the
card, the counterpart of the JAX package's one jitted program a unit
(``loam_livox_tpu/runtime/pipeline.py:50-60, 136-238``), whose point is
one dispatch a unit: launches one by one from Python would dominate at
real-time rates.  A unit is one of five kinds:

* a raw frame (``process_raw_frame``), through the Livox or the
  Velodyne front end;
* a chunk of K raw frames run back to back
  (``process_raw_frames_chunked``, a ``lax.scan`` of the frame body);
* a racing group of G raw frames, their L = G·P pieces registered in one
  lane-batched solve (``process_raw_frames_batched``);
* a step on a finished feature frame (``odometry_step``,
  ``loam_livox_tpu/runtime/odometry.py:231``): a multi-head piece;
* a multi-head raw frame's front end (``extract_multi_lidar``,
  ``loam_livox_tpu/frontend/multi.py:37``), whose P merged pieces then
  run as P steps: 1 + P launches a Mid-100 frame, the JAX package's
  1 + P dispatches.

Every correspondence engine runs inside them: ``knn_fused``, and the
``grid`` and ``dense`` engines, whose bucket grids are rebuilt with the
matching buffer under the rebuild body (a grid has no append).

Each runs what the plain program (`pipeline.process_raw_frame`,
`batched.odometry_step_batched`, `odometry.odometry_step`,
`pipeline.extract_heads`) runs, the same functions in the same order on
the same inputs, so its rows and state equal the plain program's bit
for bit.  Per shape key, ``(kind, configuration, padded input length)``,
for a chunk or group its frame count, for a step the frame's three
capacities and for a multi-head front end its head count (jit's static
arguments and shapes; the schedule sets the configuration's
capacities), it captures at the key's first use, each piece a
``torch.cuda.CUDAGraph(keep_graph=True)`` capture into the key's memory
pool, in the order they replay.  A frame:

    segment 0   front end, source filter, the first step's input filter
                and registration set-up, its ICP carry written to a
                static carry
    body k      one ICP pass (`registration.icp.prepare_registration`)
                over step k's static carry, written back in place
    commit k    step k's gates and history commit
                (`runtime.odometry.commit_history`: the history ring and,
                where the configuration keeps them, the cell maps' masked
                insertions), its trajectory row, the new state copied
                into the static state, and the matching-buffer update's
                flags (rebuild, append)
    rebuild k   the matching buffer rebuilt in place from its sources
                (`runtime.odometry.rebuilt_matching`): the history window,
                or in cell matching the pools of the cells near the new
                pose, gathered (C·P rows) and voxel-filtered
    append k    the step's points appended to it, in place, where the
                configuration appends between rebuilds
    segment k+1 step k+1's set-up

`ops.graph_cond.build_frame_graph` joins them into ``segment 0 →
WHILE{body 0} → commit 0 → SWITCH{rebuild 0 | append 0} → segment 1 →
…``.  Each WHILE node's condition kernel (``csrc/graph_cond.cu``) reads
the carry's ``active`` and pass count on the card: the
``lax.while_loop`` of ``loam_livox_tpu/registration/icp.py:324-331``.
Each SWITCH node's condition kernel picks the first set of the step's
two exclusive flags (or neither), so only the update taken runs, after
one condition launch: the ``lax.cond`` of
``loam_livox_tpu/runtime/odometry.py:421-458``, where the plain program
computes both and selects (`runtime.odometry.update_matching`).
Without appends the switch has the rebuild alone.

A chunk reuses the frame key's captured pieces: its graph places them K
times, each placement between two small captures of its own, ``load k``
(the chunk's input slot k copied into the frame's static inputs) and
``store k`` (the frame's rows copied into the chunk's).  With loop
closure the chunk makes one loop-service entry, the OR of its frames'
touched masks (``loam_livox_tpu/runtime/pipeline.py:163-178``): ``load
0`` zeroes an accumulator, each ``store k`` ORs the frame's mask into
it, and ``store K-1`` writes it into the state's ``last_touched``.  The
assembly clones every piece and creates a conditional handle for each
WHILE and SWITCH node it places, so one capture serves K placements; a
chunk costs one frame capture and 2K small ones.  A step key is a frame
key whose segment 0 starts from a static feature frame (`_StepKey`,
copied in before each launch) in place of the front end; a multi-head
front end is one segment (`_HeadsKey`).  A group is captured whole:

    segment 0   the G front ends (`pipeline.extract_pieces`) over the
                group's input slots and `batched.prepare_group`, its
                L-lane ICP carry written to a static carry
    body        one L-lane ICP pass, under one WHILE node whose
                condition votes over the L lanes (every lane re-runs
                until all have converged, as under ``vmap``)
    commit k    lane k's commit (`batched.commit_lane`; lane 0's first
                the gates over the loop's result), its row and flags
                (with loop closure its touched mask ORed into the
                group's, which lane L-1 writes into the state), then its
                SWITCH node, k = 0 .. L-1

Everything a unit reads lives in static buffers that the graph's
addresses point at: the padded points, intensities, mask and the base
time (a float64 device scalar, so no time is fixed at capture), a slot
each for a chunk's or group's frames, and the state, whose tensors the
graph updates in place.  The pipeline reads that state without a copy
and hands others a copy (`pipeline.OdometryPipeline.state`).  A capacity
growth re-pads the state between units; the next unit's key is new and
is captured then, and the keys it supersedes (the same kind,
configuration and shape at other capacities: the schedule only grows)
are freed.

The keys hold what the state holds: in cell matching and with loop
closure the cell maps (each map's frame index a device scalar that the
replays advance) and, with loop closure, the touched mask the loop
service reads after each unit (`pipeline.OdometryPipeline._feed_loop`
hands the service copies of what it keeps: the next unit overwrites the
static state).

Residual subsampling draws from the threefry key the state and the
ICP carry hold (`ops.threefry`): the step's set-up splits the state's
key, and each pass splits the carry's key and writes the first half
back into the static carry in place, so every replay of a WHILE body
draws new numbers, as the plain program's passes do.

Under a product mesh (`parallel.mesh`) the program is given the rank's
slices of the state (`parallel.layout`), and a frame, step, chunk or
group key wraps its pieces in two segments of its own: first the
slices all-gathered into the key's static whole state
(`layout.gather_state_into`, one ``all_gather_into_tensor`` a sharded
field), last this rank's rows copied back into the static slices
(`layout.shard_state_into`); in between the pieces run as above, the
kNN's search sharded over the ranks inside each WHILE body
(`registration.icp._searcher`), its candidates exchanged and merged by
one kernel that reads the peers' symmetric buffers (`ops.peer_gather`:
across ranks the card refused a frame graph with NCCL's captured
all-gather inside a conditional body).  The key holds the mesh's size and rank, and the
program warms the communicator and the exchange up before any capture
(`parallel.mesh.warm_up`, `peer_gather.rendezvous`).

With the span recorder on (`utils.logging.spans`, switched on before
the first capture) the pieces hold the device spans their functions
place, each a stamp kernel node, and each unit's graph opens and closes
its ``unit.<kind>`` span with a stamp as its first and last nodes; the
launch, a key's capture and the loads of its static buffers are host
spans.  Off, the graphs hold no stamp.

Captures, their seconds and the launches count in
`core.accounting.GRAPHS`, in all and by kind.  A capture or build that
fails raises: the card never falls back to the plain program (`on_slice`).
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..core import accounting
from ..core.config import SlamConfig
from ..core.types import FeatureFrame, PointBatch
from ..map.cell_map import append_cloud, empty_cell_map
from ..ops import debounce as debounce_op
from ..ops import graph_cond
from ..ops import knn_fused as knn_op
from ..ops import peer_gather as peer_op
from ..ops import threefry
from ..ops import voxel_centroid
from ..ops.bucket_grid import build_bucket_grid, grid_knn
from ..ops.knn import knn_dense
from ..ops.voxel import voxel_downsample
from ..parallel import mesh as mesh_mod
from ..parallel.layout import gather_state, gather_state_into, shard_state, shard_state_into
from ..registration.icp import ICPCarry
from ..utils.logging import spans
from .batched import commit_lane, prepare_group
from .odometry import (MatchingUpdate, OdometryState, appended_matching, commit_history,
                       prepare_step, rebuilt_matching)


def on_slice(cfg: SlamConfig, device: torch.device, mesh=None) -> bool:
    """Whether the frame program runs a pipeline's dispatch units: on the
    card, every configuration `require_supported` accepts: the Livox or
    Velodyne front end, the ``knn_fused``, ``grid`` or ``dense`` engine,
    history or cell matching, loop closure on or off, residual
    subsampling on or off (its draws come from the carry's threefry key,
    so a replayed pass draws anew), under sequential, chunked or racing
    dispatch, the multi-head frame's front end and feature-frame steps,
    with or without a product ``mesh``.  On the CPU the plain program
    runs; a dispatch mode the plain program refuses raises before this
    is asked (`pipeline.OdometryPipeline`)."""
    return device.type == "cuda"


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple tree, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return []


def map_tensors(fn, tree):
    """``fn`` over the tensors of a NamedTuple tree (host fields shared)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, x) for x in tree))
    return tree


def _assign(static, new) -> None:
    """Copy ``new``'s tensors into ``static``'s, in place.  A value that
    shares memory with a static tensor other than its own is cloned
    first, so no copy reads what an earlier copy wrote."""
    dst, src = _leaves(static), _leaves(new)
    if len(dst) != len(src):
        raise ValueError("frame program: state trees differ")
    owned = {t.untyped_storage().data_ptr() for t in dst}
    vals = [s if (s is d or s.untyped_storage().data_ptr() not in owned) else s.clone()
            for d, s in zip(dst, src)]
    for d, s in zip(dst, vals):
        if s is not d:
            d.copy_(s)


_warm: set = set()


def _warm_up(device: torch.device) -> None:
    """Load every kernel module and library handle the units use before
    the first capture on ``device`` (a kernel's first launch or a
    library's first call must not happen under capture): the solver,
    the sorts, the three engines (the ``dense`` engine's ``q @ ref.T`` on
    cuBLAS, the ``grid`` build's ``cummax`` and scatters and its query's
    ``searchsorted``), the port's kernels (the voxel filter's among them)
    and a cell-map insertion; with the span recorder on, its ring and
    stamp kernel."""
    spans.warm(device)
    if device in _warm:
        return
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.eye(6, **f32)[None] + 1.0
    torch.linalg.solve_ex(a, torch.ones((1, 6, 1), **f32), check_errors=False)
    torch.einsum("nij,nik->jk", a, a)
    torch.sort(torch.arange(8, device=device).flip(0), stable=True)
    ref = torch.zeros((512, 3), **f32)
    mask = torch.ones(512, dtype=torch.bool, device=device)
    with accounting.charged_to({}):
        knn_op.knn_fused(torch.zeros((4, 3), **f32), ref, mask, k=5, max_radius=1.0)
    knn_dense(torch.zeros((4, 3), **f32), ref, mask, k=5, query_tile=2)
    grid_knn(torch.zeros((4, 3), **f32), build_bucket_grid(ref, mask, 1.0, 8, 4), k=5)
    idx = torch.full((8,), 8, dtype=torch.int64, device=device)
    debounce_op.debounce(idx, torch.zeros(8, dtype=torch.bool, device=device), 8,
                         torch.ones((), dtype=torch.int64, device=device), 1)
    graph_cond.loop_condition(torch.zeros(1, dtype=torch.bool, device=device),
                              torch.zeros((), dtype=torch.int32, device=device), 1)
    graph_cond.switch_index(torch.zeros(2, dtype=torch.bool, device=device))
    key = threefry.split(threefry.prng_key(0, device))[1]
    threefry.keep_mask(key[None], torch.ones((1, 8), dtype=torch.bool, device=device), 4)
    pts = PointBatch(torch.zeros((4, 3), **f32), torch.zeros(4, **f32),
                     torch.ones(4, dtype=torch.bool, device=device))
    with accounting.charged_to({}):
        voxel_downsample(pts, 1.0)
    append_cloud(empty_cell_map(1.0, 8, 2, device), pts, 10, 4)
    _warm.add(device)


class _Inputs(NamedTuple):
    pts: torch.Tensor        # (..., N, 3) float32
    inten: torch.Tensor      # (..., N) float32
    mask: torch.Tensor       # (..., N) bool
    base_time: torch.Tensor  # (...) float64


def _inputs(device, n_raw: int, lead: tuple = ()) -> _Inputs:
    """Static input buffers: one raw frame, or with ``lead`` = (K,) a slot
    a frame."""
    return _Inputs(torch.zeros(lead + (n_raw, 3), dtype=torch.float32, device=device),
                   torch.zeros(lead + (n_raw,), dtype=torch.float32, device=device),
                   torch.zeros(lead + (n_raw,), dtype=torch.bool, device=device),
                   torch.zeros(lead, dtype=torch.float64, device=device))


def _load_inputs(inp: _Inputs, pts, inten, mask, base_time: float) -> None:
    """Copy one raw frame into static input buffers."""
    inp.pts.copy_(pts)
    inp.inten.copy_(inten)
    inp.mask.copy_(mask)
    inp.base_time.fill_(float(base_time))


def _load_slots(slots: _Inputs, frames) -> None:
    """Copy raw frames ``(pts, inten, mask, base_time)`` into the slots."""
    for k, frame in enumerate(frames):
        _load_inputs(_Inputs(*(x[k] for x in slots)), *frame)


def _matching(state: OdometryState) -> tuple:
    """The state's matching buffer and grids (`odometry.rebuilt_matching`'s order)."""
    return (state.map_corners, state.map_surface, state.grid_corners, state.grid_surface)


class _Pool:
    """Captures into one graph memory pool, in the order they replay, kept
    alive with the key that owns them."""

    def __init__(self, program: "FrameProgram"):
        self.program = program
        self.handle = torch.cuda.graph_pool_handle()
        self.keep: list = []

    def capture(self, fn) -> int:
        """Capture ``fn`` on the program's side stream; returns the raw
        ``cudaGraph_t`` (`graph_cond.Item`'s graph), whose kernel nodes
        and span stamps among them the program records
        (`FrameProgram.nodes`).  The cyclic garbage collector waits until
        the capture ends: an unreachable graph or pipeline torn down under
        a capture (a graph destroyed, a pool's memory returned) would
        invalidate it."""
        g = torch.cuda.CUDAGraph(keep_graph=True)
        stamps, filters = spans.stamps, voxel_centroid.captured
        side = self.program.stream
        cur = torch.cuda.current_stream(self.program.device)
        side.wait_stream(cur)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side):
                g.capture_begin(pool=self.handle, capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:    # the capture is broken: report its cause
                        _end_allocation_to(self.program.device, self.handle)
                    raise
                g.capture_end()
        finally:
            if collecting:
                gc.enable()
        cur.wait_stream(side)
        self.keep.append(g)
        raw = g.raw_cuda_graph()
        self.program.nodes[raw] = (graph_cond.kernel_nodes(raw), spans.stamps - stamps)
        self.program.filters[raw] = voxel_centroid.captured - filters
        return raw


def _end_allocation_to(device: torch.device, pool) -> None:
    """Drop the caching allocator's record of a capture into ``pool`` that
    failed to end (`CUDAGraph.capture_end` raises before it ends the
    allocation to the pool), so that the process's later allocator calls,
    and its memory pools' teardown at exit, find no capture underway."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(index, pool)
    except RuntimeError:        # already ended
        pass


def _set_flags(flags: torch.Tensor, upd: MatchingUpdate) -> None:
    """A step's (rebuild, append) row, read by its SWITCH node."""
    flags[0].copy_(upd.rebuild)
    if upd.append is not None:
        flags[1].copy_(upd.append)


def _update_switch(pool: _Pool, state: OdometryState, flags: torch.Tensor,
                   upd: MatchingUpdate, cfg: SlamConfig) -> graph_cond.Item:
    """The SWITCH item of one step's matching-buffer update over the
    static ``state``: body 0 the rebuild, body 1 the append of ``upd``'s
    points where appends run."""
    def rebuild() -> None:
        _assign(_matching(state), rebuilt_matching(state, cfg))

    def append() -> None:
        _assign(_matching(state)[:2], appended_matching(state, upd))

    bodies = (pool.capture(rebuild),)
    if upd.append is not None:
        bodies += (pool.capture(append),)
    return graph_cond.Item(graph_cond.SWITCH, bodies, flags[:len(bodies)])


class _Product:
    """A unit's product mode (module doc): the static whole state, the
    rank's static slices (a replicated field is the whole state's own
    tensor) and the unit's first and last segments, the slices gathered
    into the whole state and this rank's rows copied back.  ``slices`` is
    the caller's, gathered once here, outside any capture."""

    def __init__(self, pool: _Pool, mesh, slices: OdometryState, axes):
        self.state = map_tensors(torch.clone, gather_state(slices, axes, mesh))
        self.slices, _ = shard_state(self.state, mesh)
        self.gather = graph_cond.Item(graph_cond.SEGMENT, pool.capture(
            lambda: gather_state_into(self.slices, self.state, axes, mesh)))
        self._scatter = lambda: shard_state_into(self.state, self.slices, axes, mesh)
        self.pool = pool
        self.scatter = None

    def wrap(self, items: list) -> list:
        """``items`` between the gather and the copy back (captured at the
        first call, after the unit's pieces: captures follow replay order)."""
        if self.scatter is None:
            self.scatter = graph_cond.Item(graph_cond.SEGMENT, self.pool.capture(self._scatter))
        return [self.gather, *items, self.scatter]


def _static_state(program: "FrameProgram", pool: _Pool, state: OdometryState, axes):
    """A key's static state and its product mode (None without a mesh):
    under the program's mesh ``state`` is the rank's slices."""
    if program.mesh is None:
        return map_tensors(torch.clone, state), None
    product = _Product(pool, program.mesh, state, axes)
    return product.state, product


def _debounces(cfg: SlamConfig) -> int:
    """The debounce kernel's runs a raw frame of one head: one in the
    Livox front end, none in the Velodyne one."""
    return 1 if cfg.common.lidar_type == "livox" else 0


class _StepsKey:
    """One unit's odometry steps captured at one shape key: the frames
    ``front`` makes from the key's static inputs, each step's pieces
    (module doc), their static buffers, and the unit's graph, built at
    its first launch alone (a frame key captured for a chunk only never
    builds it)."""

    def __init__(self, program: "FrameProgram", state: OdometryState, cfg: SlamConfig,
                 n_steps: int, front, axes=None):
        from .pipeline import trajectory_rows

        t0 = time.perf_counter()
        dev = program.device
        self.device = dev
        self.pool = pool = _Pool(program)
        self.state, self.product = _static_state(program, pool, state, axes)
        self.rows = torch.zeros((n_steps, 10), dtype=torch.float32, device=dev)
        #: each step's matching-buffer update: (rebuild, append) flags
        flags = torch.zeros((n_steps, 2), dtype=torch.bool, device=dev)
        self.last_reg = None
        max_loops = cfg.optimization.icp_maximum_iteration
        ctx: Dict[object, object] = {}
        carries: List[ICPCarry] = []

        def begin(k: int) -> None:
            frame = ctx["frames"][k]
            corner_in, surf_in, icp_pass, carry, finish, rng = prepare_step(self.state, frame,
                                                                             cfg)
            static = map_tensors(torch.empty_like, carry)
            carries.append(static)
            _assign(static, carry)
            ctx[k] = (frame, corner_in, surf_in, icp_pass, finish, rng)

        def seg0() -> None:
            ctx["frames"] = front()
            begin(0)

        def body(k: int):
            def run() -> None:
                _assign(carries[k], ctx[k][3](carries[k]))
            return run

        def commit(k: int):
            def run() -> None:
                frame, corner_in, surf_in, _, finish, rng = ctx[k]
                reg = finish(carries[k])
                new, reg, upd = commit_history(self.state._replace(rng=rng), frame, corner_in,
                                               surf_in, reg, cfg)
                self.rows[k].copy_(trajectory_rows([reg], [frame])[0])
                program.loop_total.add_(carries[k].loops)
                program.rebuild_total.add_(upd.rebuild)
                _assign(self.state, new)
                _set_flags(flags[k], upd)
                ctx["upd", k] = upd
                self.last_reg = reg
            return run

        G = graph_cond
        items = [G.Item(G.SEGMENT, pool.capture(seg0))]
        for k in range(n_steps):
            items.append(G.Item(G.WHILE, pool.capture(body(k)), carries[k].active,
                                carries[k].loops, max_loops))
            items.append(G.Item(G.SEGMENT, pool.capture(commit(k))))
            items.append(_update_switch(pool, self.state, flags[k], ctx["upd", k], cfg))
            if k + 1 < n_steps:
                items.append(G.Item(G.SEGMENT, pool.capture(lambda k=k: begin(k + 1))))
        pool.keep += [ctx, carries, flags]
        #: the pieces in replay order, placed by the unit's graph or a chunk's
        #: (under a mesh between the product's gather and copy back)
        self.items = items
        self.program = program
        self.pass_kernels = program.pass_kernels(items[1])
        self.filters, self.rebuild_filters = program.voxel_filters(items)
        self.steps = self.splits = n_steps
        self.whiles = self.switches = n_steps
        self._graph = None
        self.kernel_nodes = self.stamp_nodes = None
        self.capture_s = time.perf_counter() - t0

    @property
    def slices(self):
        """The rank's static slices under a mesh, else None."""
        return None if self.product is None else self.product.slices

    def wrap(self, items: list) -> list:
        """A unit's items: under a mesh between the gather and the copy back."""
        return items if self.product is None else self.product.wrap(items)

    @property
    def graph(self) -> graph_cond.FrameGraph:
        if self._graph is None:
            t0 = time.perf_counter()
            self._graph = self.program.build(self, self.wrap(self.items))
            self.capture_s += time.perf_counter() - t0
        return self._graph

    def load_state(self, state: OdometryState) -> None:
        """The caller's state (under a mesh its slices) into the static
        state, where it is not already the program's."""
        held = self.state if self.product is None else self.product.slices
        if state is not held:
            _assign(held, state)

    def close(self) -> None:
        if self._graph is not None:
            self._graph.close()


class _FrameKey(_StepsKey):
    """A raw frame: its front end and source filters over the static
    inputs, then its steps."""
    kind = "frame"

    def __init__(self, program: "FrameProgram", state: OdometryState, cfg: SlamConfig,
                 n_raw: int, n_steps: int, axes=None):
        from .pipeline import extract_pieces

        self.inputs = inp = _inputs(program.device, n_raw)
        self.frames, self.debounces = 1, _debounces(cfg)
        super().__init__(program, state, cfg, n_steps, lambda: extract_pieces(
            inp.pts, inp.inten, inp.mask, inp.base_time, cfg, n_steps), axes)

    def load(self, state: OdometryState, pts, inten, mask, base_time: float) -> None:
        """Point the static buffers at this frame: its inputs and state."""
        _load_inputs(self.inputs, pts, inten, mask, base_time)
        self.load_state(state)


class _StepKey(_StepsKey):
    """One odometry step on a finished feature frame (the JAX package's
    jitted ``odometry_step``): the frame key's pieces without the front
    end, over a static feature frame that `load` copies the caller's
    into."""
    kind = "step"

    def __init__(self, program: "FrameProgram", state: OdometryState, cfg: SlamConfig,
                 frame: FeatureFrame, axes=None):
        self.inputs = inp = map_tensors(torch.empty_like, frame)
        self.frames = self.debounces = 0
        super().__init__(program, state, cfg, 1, lambda: [inp], axes)

    def load(self, state: OdometryState, frame: FeatureFrame) -> None:
        _assign(self.inputs, frame)
        self.load_state(state)


class _HeadsKey:
    """A multi-head raw frame's front end (the JAX package's jitted
    ``extract_multi_lidar``): S heads' static inputs through
    `pipeline.extract_heads`, captured whole into one graph; its P merged
    feature frames stay in the key's pool, overwritten by each launch."""
    kind = "heads"

    def __init__(self, program: "FrameProgram", cfg: SlamConfig, n_heads: int, n_raw: int):
        from .pipeline import extract_heads

        t0 = time.perf_counter()
        dev = program.device
        self.pool = _Pool(program)
        # one frame time for every head
        self.inputs = inp = _inputs(dev, n_raw, (n_heads,))._replace(
            base_time=torch.zeros((), dtype=torch.float64, device=dev))
        out: Dict[str, list] = {}

        def front() -> None:
            out["frames"] = extract_heads(inp.pts, inp.inten, inp.mask, inp.base_time, cfg)

        G = graph_cond
        items = [G.Item(G.SEGMENT, self.pool.capture(front))]
        #: the merged feature frames, one a piece (static: see `FrameProgram.run_heads`)
        self.out = out["frames"]
        self.pool.keep.append(out)
        self.frames, self.debounces, self.steps = 1, n_heads * _debounces(cfg), 0
        self.whiles = self.switches = self.splits = 0
        self.pass_kernels = None
        self.filters, self.rebuild_filters = program.voxel_filters(items)
        self.graph = program.build(self, items)
        self.capture_s = time.perf_counter() - t0

    def load(self, xyz, inten, mask, base_time: float) -> None:
        _load_inputs(self.inputs, xyz, inten, mask, base_time)

    def close(self) -> None:
        self.graph.close()


class _ChunkKey:
    """K raw frames as one graph: the frame key's pieces placed K times
    (module doc), with the chunk's input slots and rows."""
    kind = "chunk"

    def __init__(self, frame: _FrameKey, n_frames: int):
        t0 = time.perf_counter()
        self.frame = frame
        n_raw, n_steps = frame.inputs.pts.shape[0], frame.steps
        self.slots = slots = _inputs(frame.device, n_raw, (n_frames,))
        self.rows = torch.zeros((n_frames * n_steps, 10), dtype=torch.float32,
                                device=frame.device)
        touched = frame.state.last_touched
        #: with loop closure, the OR of the chunk's touched masks (held
        #: here: the graph writes it at every replay)
        self.touched_any = acc = None if touched is None else torch.zeros_like(touched)

        def load(k: int):
            def run() -> None:
                for dst, src in zip(frame.inputs, slots):
                    dst.copy_(src[k])
                if acc is not None and k == 0:
                    acc.zero_()
            return run

        def store(k: int):
            def run() -> None:
                self.rows[k * n_steps:(k + 1) * n_steps].copy_(frame.rows)
                if acc is not None:
                    acc.logical_or_(touched)
                    if k == n_frames - 1:
                        touched.copy_(acc)
            return run

        G = graph_cond
        items = []
        for k in range(n_frames):
            items.append(G.Item(G.SEGMENT, frame.pool.capture(load(k))))
            items += frame.items
            items.append(G.Item(G.SEGMENT, frame.pool.capture(store(k))))
        self.frames, self.steps = n_frames, n_frames * n_steps
        self.debounces, self.splits = n_frames * frame.debounces, n_frames * frame.splits
        self.whiles, self.switches = n_frames * frame.whiles, n_frames * frame.switches
        self.pass_kernels = frame.pass_kernels
        self.filters, self.rebuild_filters = frame.program.voxel_filters(items)
        self.graph = frame.program.build(self, frame.wrap(items))
        self.capture_s = time.perf_counter() - t0

    @property
    def state(self) -> OdometryState:
        return self.frame.state

    @property
    def slices(self):
        return self.frame.slices

    def load(self, state: OdometryState, frames) -> None:
        _load_slots(self.slots, frames)
        self.frame.load_state(state)

    def close(self) -> None:
        self.graph.close()


class _GroupKey:
    """G raw frames as one racing group's graph (module doc)."""
    kind = "group"

    def __init__(self, program: "FrameProgram", state: OdometryState, cfg: SlamConfig,
                 n_raw: int, n_frames: int, axes=None):
        from .pipeline import extract_pieces, trajectory_rows

        t0 = time.perf_counter()
        dev = program.device
        self.pool = pool = _Pool(program)
        self.slots = slots = _inputs(dev, n_raw, (n_frames,))
        self.state, product = _static_state(program, pool, state, axes)
        self.last_reg = None
        ctx: Dict[object, object] = {}
        touched = self.state.last_touched
        #: with loop closure, the OR of the lanes' touched masks (held
        #: here: the graph writes it at every replay)
        self.touched_any = acc = None if touched is None else torch.zeros_like(touched)

        def seg0() -> None:
            frames = [piece for g in range(n_frames)
                      for piece in extract_pieces(slots.pts[g], slots.inten[g], slots.mask[g],
                                                  slots.base_time[g], cfg)]
            group = prepare_group(self.state, frames, cfg)
            carry = map_tensors(torch.empty_like, group.carry)
            _assign(carry, group.carry)
            ctx.update(frames=frames, group=group, carry=carry)

        def body() -> None:
            _assign(ctx["carry"], ctx["group"].icp_pass(ctx["carry"]))

        def commit(k: int):
            def run() -> None:
                group, carry, frame = ctx["group"], ctx["carry"], ctx["frames"][k]
                if k == 0:
                    ctx["regs"] = group.finish(carry)
                    program.loop_total.add_(carry.loops)
                    program.group_loop_total.add_(carry.loops)
                new, reg, upd = commit_lane(self.state, k, frame, group, ctx["regs"], cfg)
                program.rebuild_total.add_(upd.rebuild)
                self.rows[k].copy_(trajectory_rows([reg], [frame])[0])
                _assign(self.state, new)
                if acc is not None:
                    # one loop-service entry a group: every lane's touched
                    # cells, as `batched.odometry_step_batched` ORs them
                    if k == 0:
                        acc.copy_(touched)
                    else:
                        acc.logical_or_(touched)
                    if k == n_lanes - 1:
                        touched.copy_(acc)
                _set_flags(flags[k], upd)
                ctx["upd", k] = upd
                self.last_reg = reg
            return run

        G = graph_cond
        items = [G.Item(G.SEGMENT, pool.capture(seg0))]
        n_lanes = len(ctx["frames"])
        self.rows = torch.zeros((n_lanes, 10), dtype=torch.float32, device=dev)
        flags = torch.zeros((n_lanes, 2), dtype=torch.bool, device=dev)
        carry = ctx["carry"]
        items.append(G.Item(G.WHILE, pool.capture(body), carry.active, carry.loops,
                            cfg.optimization.icp_maximum_iteration))
        for k in range(n_lanes):
            items.append(G.Item(G.SEGMENT, pool.capture(commit(k))))
            items.append(_update_switch(pool, self.state, flags[k], ctx["upd", k], cfg))
        pool.keep += [ctx, flags]
        self.frames, self.steps = n_frames, n_lanes
        self.debounces = n_frames * _debounces(cfg)
        # the state's key split once, and its second half into one a lane
        self.whiles, self.switches, self.splits = 1, n_lanes, 2
        self.slices = None if product is None else product.slices
        self.pass_kernels = program.pass_kernels(items[1])
        self.filters, self.rebuild_filters = program.voxel_filters(items)
        self.graph = program.build(self, items if product is None else product.wrap(items))
        self.capture_s = time.perf_counter() - t0

    def load(self, state: OdometryState, frames) -> None:
        _load_slots(self.slots, frames)
        held = self.state if self.slices is None else self.slices
        if state is not held:
            _assign(held, state)

    def close(self) -> None:
        self.graph.close()


class FrameProgram:
    """One pipeline's unit graphs, one a shape key (module doc)."""

    def __init__(self, device: torch.device, mesh=None):
        self.device = device
        _warm_up(device)
        #: the product mesh (`parallel.mesh.Mesh`) the units gather over, or None
        self.mesh = mesh
        if mesh is not None:
            mesh_mod.warm_up(mesh, device)
            # the candidates' exchange inside the passes: the rendezvous of
            # its symmetric buffers and its kernel's first launch
            k = 5
            peer_op.peer_gather(torch.zeros((1, k), device=device),
                                torch.zeros((1, k), dtype=torch.int32, device=device), mesh, k)
        #: the shape keys' last element: the mesh's size and rank
        self._mesh_key = (None if mesh is None else (mesh.size, mesh.rank),)
        #: under a mesh, the rank's static slices the last unit left
        self.slices = None
        self.stream = torch.cuda.Stream(device)
        self._graphs: Dict[tuple, object] = {}
        self._captured: List[Tuple[tuple, dict]] = []
        #: each captured piece's (kernel nodes, span stamps among them), by
        #: its raw graph (`_Pool.capture`)
        self.nodes: Dict[int, Tuple[int, int]] = {}
        #: ICP passes run by the replays, summed on the card
        self.loop_total = torch.zeros((), dtype=torch.int64, device=device)
        #: the racing groups' share of them
        self.group_loop_total = torch.zeros((), dtype=torch.int64, device=device)
        #: matching-buffer rebuilds run by the replays (SWITCH body 0), summed on the card
        self.rebuild_total = torch.zeros((), dtype=torch.int64, device=device)
        #: each captured piece's voxel filters, by its raw graph (`_Pool.capture`)
        self.filters: Dict[int, int] = {}

    def run(self, state: OdometryState, pts, inten, mask, base_time: float, cfg: SlamConfig,
            n_steps: int, axes=None) -> Tuple[OdometryState, torch.Tensor, object]:
        """One raw frame of ``n_steps`` odometry steps at ``cfg``:
        returns the new state (the program's static state), the frame's
        (n_steps, 10) trajectory rows (a copy) and its last registration
        (the program's: the next unit overwrites it).  Under the
        program's mesh ``state`` is the rank's slices, laid out by
        ``axes`` (`parallel.layout.state_axes`); the returned state is
        the whole one, and `slices` the rank's static slices."""
        n_raw = pts.shape[0]
        key = ("frame", cfg, n_raw) + self._mesh_key
        g = self._key(key, lambda: _FrameKey(self, state, cfg, n_raw, n_steps, axes),
                      build=True)
        with spans.host("load"):
            g.load(state, pts, inten, mask, base_time)
        self._launch(key, g)
        return g.state, g.rows.clone(), g.last_reg

    def run_chunk(self, state: OdometryState, frames, cfg: SlamConfig, n_steps: int,
                  axes=None) -> Tuple[OdometryState, torch.Tensor, object]:
        """K raw frames ``(pts, inten, mask, base_time)`` back to back, one
        launch: the state, the (K·n_steps, 10) rows and the last
        registration, as `run` returns them."""
        n_raw = frames[0][0].shape[0]
        key = ("chunk", cfg, n_raw, len(frames)) + self._mesh_key
        g = self._graphs.get(key)
        if g is None:
            self._drop_superseded(key)
            frame = self._key(("frame", cfg, n_raw) + self._mesh_key,
                              lambda: _FrameKey(self, state, cfg, n_raw, n_steps, axes))
            g = self._key(key, lambda: _ChunkKey(frame, len(frames)))
        with spans.host("load"):
            g.load(state, frames)
        self._launch(key, g)
        return g.frame.state, g.rows.clone(), g.frame.last_reg

    def run_group(self, state: OdometryState, frames, cfg: SlamConfig, axes=None
                  ) -> Tuple[OdometryState, torch.Tensor, object]:
        """G raw frames as one racing group, one launch: the state, the
        (G·P, 10) rows and the last lane's registration, as `run` returns
        them."""
        n_raw = frames[0][0].shape[0]
        key = ("group", cfg, n_raw, len(frames)) + self._mesh_key
        g = self._key(key, lambda: _GroupKey(self, state, cfg, n_raw, len(frames), axes))
        with spans.host("load"):
            g.load(state, frames)
        self._launch(key, g)
        return g.state, g.rows.clone(), g.last_reg

    def run_step(self, state: OdometryState, frame: FeatureFrame, cfg: SlamConfig, axes=None
                 ) -> Tuple[OdometryState, torch.Tensor, object]:
        """One odometry step on a finished feature frame, one launch: the
        state, the (1, 10) row and the registration, as `run` returns
        them.  The key's shape is the frame's own three capacities (a
        merged multi-head frame has S times a head's)."""
        caps = (frame.corners.capacity, frame.surface.capacity, frame.full.capacity)
        key = ("step", cfg, caps) + self._mesh_key
        g = self._key(key, lambda: _StepKey(self, state, cfg, frame, axes), build=True)
        with spans.host("load"):
            g.load(state, frame)
        self._launch(key, g)
        return g.state, g.rows.clone(), g.last_reg

    def run_heads(self, xyz, inten, mask, base_time: float, cfg: SlamConfig
                  ) -> List[FeatureFrame]:
        """A multi-head raw frame's front end, one launch: (S, N, 3)
        points, (S, N) intensities and masks of S heads sharing
        ``base_time`` -> its merged feature frames (`pipeline.extract_heads`).
        They are the key's static buffers, overwritten by its next launch:
        a caller that keeps one past it keeps a copy (`run_step` copies
        each into its own static frame)."""
        key = ("heads", cfg, xyz.shape[1], xyz.shape[0])
        g = self._key(key, lambda: _HeadsKey(self, cfg, xyz.shape[0], xyz.shape[1]))
        with spans.host("load"):
            g.load(xyz, inten, mask, base_time)
        self._launch(key, g)
        return g.out

    def _key(self, key: tuple, make, build: bool = False):
        """The key's graphs, captured by ``make`` at its first use and
        recorded: capacities, shape, nodes, capture seconds, and the
        device memory the card gave up while it was made (new pool
        segments, static buffers and the graph itself; memory the caching
        allocator already held is reused unseen)."""
        g = self._graphs.get(key)
        if g is not None:
            return g
        self._drop_superseded(key)
        # the pool's segments, the static buffers and the graph's own
        # memory are allocated before their calls return
        free = torch.cuda.mem_get_info(self.device)[0]
        with spans.host("capture"):
            g = make()
            if build:
                g.graph
        used = free - torch.cuda.mem_get_info(self.device)[0]
        self._graphs[key] = g
        cfg = key[1]
        caps = cfg.capacity
        self._captured.append((key, {
            "kind": g.kind, "matching_mode": int(cfg.mapping.matching_mode),
            "loop_closure": bool(cfg.loop_closure.if_enable_loop_closure),
            "map_surf_capacity": caps.map_surf_capacity,
            "map_corner_capacity": caps.map_corner_capacity,
            "hist_surf_capacity": caps.hist_surf_capacity,
            "max_surface_ds": caps.max_surface_ds, "shape": key[2],
            "frames": g.frames, "debounces": g.debounces, "splits": g.splits,
            "steps": g.steps, "whiles": g.whiles, "switches": g.switches,
            "mesh": None if self.mesh is None else self.mesh.size,
            "pass_kernels": g.pass_kernels, "kernel_nodes": g.kernel_nodes,
            "stamp_nodes": g.stamp_nodes, "filters": g.filters,
            "rebuild_filters": g.rebuild_filters,
            "capture_s": g.capture_s, "device_mb": used / 2 ** 20, "launches": 0}))
        accounting.GRAPHS["graph_capture"] += 1
        accounting.GRAPHS[f"capture_{g.kind}"] += 1
        accounting.GRAPHS["graph_capture_s"] += g.capture_s
        return g

    def _launch(self, key: tuple, g) -> None:
        with spans.host("launch"):
            g.graph.launch()
        if hasattr(g, "slices"):        # a unit that holds the state
            self.slices = g.slices
        for k, entry in reversed(self._captured):
            if k == key:
                entry["launches"] += 1
                break
        accounting.GRAPHS["graph_launch"] += 1
        accounting.GRAPHS[f"launch_{key[0]}"] += 1

    def build(self, key, items: list) -> graph_cond.FrameGraph:
        """``key``'s unit graph of ``items`` (`graph_cond.build_frame_graph`),
        with its ``unit.<kind>`` span's stamps when the recorder is on;
        sets the key's ``kernel_nodes`` and ``stamp_nodes``: its pieces'
        kernel nodes (`nodes`; a switch's every body) and the unit's two
        stamps, of which those that are span stamps (the condition kernels
        aside)."""
        unit = spans.unit(key.kind, self.device)
        graph = graph_cond.build_frame_graph(self.device, items, unit)
        kernels = stamps = 0 if unit is None else 2
        for it in items:
            for piece in it.graph if isinstance(it.graph, tuple) else (it.graph,):
                k, s = self.nodes[piece]
                kernels, stamps = kernels + k, stamps + s
        key.kernel_nodes, key.stamp_nodes = kernels, stamps
        return graph

    def voxel_filters(self, items: list) -> Tuple[int, int]:
        """A unit's voxel filters: a launch's outside the conditional
        bodies, and a switch's first body's (the rebuild: one a
        `rebuilds`)."""
        filters, rebuild = 0, 0
        for it in items:
            if it.kind == graph_cond.SEGMENT:
                filters += self.filters[it.graph]
            elif it.kind == graph_cond.SWITCH:
                rebuild = max(rebuild, self.filters[it.graph[0]])
        return filters, rebuild

    def pass_kernels(self, item: graph_cond.Item) -> int:
        """The kernel nodes of a WHILE item's pass, its span stamps aside:
        the nodes a pass pays."""
        k, s = self.nodes[item.graph]
        return k - s

    def _drop_superseded(self, key: tuple) -> None:
        """Free the keys of ``key``'s kind, configuration and shape (input
        length and frame count, or a step's frame capacities) at other
        capacities: the schedule only grows, so
        they never replay.  (A chunk key keeps the frame key it places
        alive until it is freed itself.)"""
        cfg = key[1]
        for old in [k for k in self._graphs
                    if k != key and k[0] == key[0] and k[2:] == key[2:]
                    and k[1].replace(capacity=cfg.capacity) == cfg]:
            self._graphs.pop(old).close()

    def loop_passes(self) -> int:
        """ICP passes the replays ran (one host read)."""
        return int(self.loop_total)

    def rebuilds(self) -> int:
        """Matching-buffer rebuilds the replays ran (one host read)."""
        return int(self.rebuild_total)

    def group_passes(self) -> int:
        """The racing groups' share of `loop_passes` (one host read)."""
        return int(self.group_loop_total)

    def summary(self) -> List[dict]:
        """Each key captured, in order: its kind, capacities, shape (the
        input length, or a step's three frame capacities), raw frames,
        debounce runs, threefry splits outside the passes (one a step, two
        a racing group), steps, WHILE and SWITCH nodes a launch, voxel
        filters a launch outside the conditional bodies and in a rebuild
        body (`voxel_filters`), the
        mesh's size (None without one), capture seconds,
        device memory (`_key`), launches, whether it is still held (a
        superseded key is freed) and, where held, the bytes its graph
        pool's segments hold now (from the allocator's snapshot; a chunk
        places its frame key's pool and has none of its own)."""
        pools = {}
        for seg in torch.cuda.memory_snapshot():
            pool = tuple(seg.get("segment_pool_id", ()))
            pools[pool] = pools.get(pool, 0) + seg["total_size"]
        out = []
        for key, c in self._captured:
            g = self._graphs.get(key)
            pool = getattr(g, "pool", None)
            out.append({**c, "held": g is not None,
                        "pool_mb": (None if g is None else 0.0 if pool is None
                                    else pools.get(tuple(pool.handle), 0) / 2 ** 20)})
        return out
