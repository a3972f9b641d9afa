"""The frame program: a raw frame as one CUDA graph launch on the card,
the counterpart of the JAX package's ``jax.jit(process_raw_frame)``
(``loam_livox_tpu/runtime/pipeline.py:50-60, 136-138``), whose point is
one dispatch a frame: launches one by one from Python would dominate at
real-time rates.

`FrameProgram.run` runs what the plain program (`pipeline.process_raw_frame`)
runs, the same functions in the same order on the same inputs, so its
rows and state equal the plain program's bit for bit.  Per shape key
(the active configuration, whose capacities the schedule sets, and the
padded input length: jit's static arguments and shapes) it captures,
at the key's first use:

    segment 0   front end, source filter, the first step's input filter
                and registration set-up, its ICP carry written to a
                static carry
    body k      one ICP pass (`registration.icp.prepare_registration`)
                over step k's static carry, written back in place
    commit k    step k's gates and history commit
                (`runtime.odometry.commit_history`), its trajectory row,
                the new state copied into the static state, and the
                matching-buffer update's flags (rebuild, append)
    rebuild k   the matching buffer rebuilt from the history window, in
                place (`runtime.odometry.rebuilt_matching`)
    append k    the step's points appended to it, in place, where the
                configuration appends between rebuilds
    segment k+1 step k+1's set-up

each a ``torch.cuda.CUDAGraph(keep_graph=True)`` capture into one
memory pool, in the order they replay; `ops.graph_cond.build_frame_graph`
joins them into ``segment 0 → WHILE{body 0} → commit 0 →
SWITCH{rebuild 0 | append 0} → segment 1 → …``.  Each WHILE node's
condition kernel (``csrc/graph_cond.cu``) reads the carry's ``active``
and pass count on the card: the ``lax.while_loop`` of
``loam_livox_tpu/registration/icp.py:324-331``.  Each SWITCH node's
condition kernel picks the first set of the step's two exclusive flags
(or neither), so only the update taken runs, after one condition launch:
the ``lax.cond`` of ``loam_livox_tpu/runtime/odometry.py:421-458``,
where the plain program computes both and selects
(`runtime.odometry.update_matching`).  Without appends the switch has
the rebuild alone.

Everything a frame reads lives in static buffers that the graph's
addresses point at: the padded points, intensities, mask and the base
time (a float64 device scalar, so no time is fixed at capture), and the
state, whose tensors the graph updates in place.  So the state a
pipeline holds on this path is the program's: a frame changes it where
it lies (clone it to keep a snapshot).  A capacity growth re-pads the
state between frames; the next frame's key is new and is captured then,
and the keys it supersedes (the same configuration and input length at
other capacities: the schedule only grows) are freed.

Captures, their seconds and the launches count in
`core.accounting.GRAPHS`.  A capture or build that fails raises: the
card never falls back to the plain program for a configuration on the
slice (`on_slice`).
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..core import accounting
from ..core.config import SlamConfig
from ..ops import debounce as debounce_op
from ..ops import graph_cond
from ..ops import knn_fused as knn_op
from ..registration.icp import ICPCarry
from .odometry import (OdometryState, appended_matching, commit_history, prepare_step,
                       rebuilt_matching)


def on_slice(cfg: SlamConfig, device: torch.device, mesh=None) -> bool:
    """Whether the frame program runs a pipeline's raw frames: on the
    card, sequential dispatch, the Livox front end, history matching,
    the ``knn_fused`` engine, loop closure off, no residual subsampling
    (its generator is not replayed), no product mesh.  Everything else
    runs the plain program (`ROADMAP.md` lists those paths)."""
    c, o, p = cfg.common, cfg.optimization, cfg.parallel
    return (device.type == "cuda" and mesh is None and int(p.mesh_devices) <= 1
            and int(p.frame_batch) <= 1 and int(p.dispatch_chunk) <= 1
            and c.lidar_type == "livox" and int(cfg.mapping.matching_mode) == 0
            and not cfg.loop_closure.if_enable_loop_closure
            and o.correspondence in ("auto", "pallas") and int(o.subsample_residuals) == 0)


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of a NamedTuple tree, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return []


def _map(fn, tree):
    """``fn`` over the tensors of a NamedTuple tree (host fields shared)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
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
    """Load every kernel module and library handle the frame uses before
    the first capture on ``device`` (a kernel's first launch or a
    library's first call must not happen under capture)."""
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
    idx = torch.full((8,), 8, dtype=torch.int64, device=device)
    debounce_op.debounce(idx, torch.zeros(8, dtype=torch.bool, device=device), 8,
                         torch.ones((), dtype=torch.int64, device=device), 1)
    graph_cond.loop_condition(torch.zeros(1, dtype=torch.bool, device=device),
                              torch.zeros((), dtype=torch.int32, device=device), 1)
    graph_cond.switch_index(torch.zeros(2, dtype=torch.bool, device=device))
    _warm.add(device)


class _Inputs(NamedTuple):
    pts: torch.Tensor        # (N, 3) float32
    inten: torch.Tensor      # (N,) float32
    mask: torch.Tensor       # (N,) bool
    base_time: torch.Tensor  # () float64


def _matching(state: OdometryState) -> tuple:
    """The state's matching buffer and grids (`odometry.rebuilt_matching`'s order)."""
    return (state.map_corners, state.map_surface, state.grid_corners, state.grid_surface)


class _KeyGraph:
    """The captured graphs of one shape key and their static buffers."""

    def __init__(self, program: "FrameProgram", state: OdometryState, cfg: SlamConfig,
                 n_raw: int, n_steps: int):
        from .pipeline import extract_pieces, trajectory_rows

        dev = program.device
        self.inputs = _Inputs(torch.zeros((n_raw, 3), dtype=torch.float32, device=dev),
                              torch.zeros(n_raw, dtype=torch.float32, device=dev),
                              torch.zeros(n_raw, dtype=torch.bool, device=dev),
                              torch.zeros((), dtype=torch.float64, device=dev))
        self.state = _map(torch.clone, state)
        self.rows = torch.zeros((n_steps, 10), dtype=torch.float32, device=dev)
        #: each step's matching-buffer update: (rebuild, append) flags
        flags = torch.zeros((n_steps, 2), dtype=torch.bool, device=dev)
        self.last_reg = None
        #: the captured graphs and all they read, kept alive with the program
        self._keep: list = []
        pool = torch.cuda.graph_pool_handle()
        side = program.stream
        cur = torch.cuda.current_stream(dev)
        max_loops = cfg.optimization.icp_maximum_iteration
        t0 = time.perf_counter()

        def capture(fn):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                g.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    fn()
                except BaseException:
                    try:
                        g.capture_end()
                    except RuntimeError:    # the capture is broken: report its cause
                        pass
                    raise
                g.capture_end()
            cur.wait_stream(side)
            self._keep.append(g)
            return g.raw_cuda_graph()

        inp = self.inputs
        ctx: Dict[str, object] = {}
        carries: List[ICPCarry] = []

        def begin(k: int) -> None:
            frame = ctx["frames"][k]
            corner_in, surf_in, icp_pass, carry, finish = prepare_step(self.state, frame, cfg)
            static = _map(torch.empty_like, carry)
            carries.append(static)
            _assign(static, carry)
            ctx[k] = (frame, corner_in, surf_in, icp_pass, finish)

        def seg0() -> None:
            ctx["frames"] = extract_pieces(inp.pts, inp.inten, inp.mask, inp.base_time, cfg,
                                           n_steps)
            begin(0)

        def body(k: int):
            def run() -> None:
                _assign(carries[k], ctx[k][3](carries[k]))
            return run

        def commit(k: int):
            def run() -> None:
                frame, corner_in, surf_in, _, finish = ctx[k]
                reg = finish(carries[k])
                new, reg, upd = commit_history(self.state, frame, corner_in, surf_in, reg, cfg)
                self.rows[k].copy_(trajectory_rows([reg], [frame])[0])
                program.loop_total.add_(carries[k].loops)
                _assign(self.state, new)
                flags[k, 0].copy_(upd.rebuild)
                if upd.append is not None:
                    flags[k, 1].copy_(upd.append)
                ctx["upd", k] = upd
                self.last_reg = reg
            return run

        def rebuild() -> None:
            _assign(_matching(self.state), rebuilt_matching(self.state, cfg))

        def append(k: int):
            def run() -> None:
                _assign(_matching(self.state)[:2], appended_matching(self.state, ctx["upd", k]))
            return run

        def segment(k: int):
            return lambda: begin(k)

        G = graph_cond
        items = [G.Item(G.SEGMENT, capture(seg0))]
        for k in range(n_steps):
            items.append(G.Item(G.WHILE, capture(body(k)), carries[k].active, carries[k].loops,
                                max_loops))
            items.append(G.Item(G.SEGMENT, capture(commit(k))))
            # body 0 the rebuild, body 1 the append where appends run
            bodies = (capture(rebuild),)
            if ctx["upd", k].append is not None:
                bodies += (capture(append(k)),)
            items.append(G.Item(G.SWITCH, bodies, flags[k, :len(bodies)]))
            if k + 1 < n_steps:
                items.append(G.Item(G.SEGMENT, capture(segment(k + 1))))
        #: SWITCH nodes a frame (one a step: the matching update)
        self.switches = sum(it.kind == G.SWITCH for it in items)
        self._keep += [ctx, carries, flags]
        self.graph = G.build_frame_graph(dev, items)
        self.capture_s = time.perf_counter() - t0

    def load(self, state: OdometryState, pts, inten, mask, base_time: float) -> None:
        """Point the static buffers at this frame: its inputs, and the
        caller's state where it is not already the program's."""
        inp = self.inputs
        inp.pts.copy_(pts)
        inp.inten.copy_(inten)
        inp.mask.copy_(mask)
        inp.base_time.fill_(float(base_time))
        if state is not self.state:
            _assign(self.state, state)


class FrameProgram:
    """One pipeline's frame graphs, one a shape key (module doc)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._graphs: Dict[Tuple[SlamConfig, int], _KeyGraph] = {}
        self._captured: List[Tuple[Tuple[SlamConfig, int], dict]] = []
        #: ICP passes run by the replays, summed on the card
        self.loop_total = torch.zeros((), dtype=torch.int64, device=device)

    def run(self, state: OdometryState, pts, inten, mask, base_time: float, cfg: SlamConfig,
            n_steps: int) -> Tuple[OdometryState, torch.Tensor, object]:
        """One raw frame of ``n_steps`` odometry steps at ``cfg``:
        returns the new state (the program's static state), the frame's
        (n_steps, 10) trajectory rows (a copy) and its last registration
        (valid until the next frame)."""
        key = (cfg, pts.shape[0])
        g = self._graphs.get(key)
        if g is None:
            self._drop_superseded(key)
            _warm_up(self.device)
            g = _KeyGraph(self, state, cfg, pts.shape[0], n_steps)
            self._graphs[key] = g
            caps = cfg.capacity
            self._captured.append((key, {
                "map_surf_capacity": caps.map_surf_capacity,
                "map_corner_capacity": caps.map_corner_capacity,
                "hist_surf_capacity": caps.hist_surf_capacity,
                "max_surface_ds": caps.max_surface_ds, "n_raw": pts.shape[0],
                "steps": n_steps, "switches": g.switches, "capture_s": g.capture_s,
                "cond_nodes": g.graph.cond_nodes}))
            accounting.GRAPHS["graph_capture"] += 1
            accounting.GRAPHS["graph_capture_s"] += g.capture_s
        g.load(state, pts, inten, mask, base_time)
        g.graph.launch()
        accounting.GRAPHS["graph_launch"] += 1
        return g.state, g.rows.clone(), g.last_reg

    def _drop_superseded(self, key: Tuple[SlamConfig, int]) -> None:
        """Free the keys of ``key``'s configuration and input length at
        other capacities: the schedule only grows, so they never replay."""
        cfg, n_raw = key
        for old in [k for k in self._graphs
                    if k[1] == n_raw and k[0].replace(capacity=cfg.capacity) == cfg]:
            self._graphs.pop(old).graph.close()

    def loop_passes(self) -> int:
        """ICP passes the replays ran (one host read)."""
        return int(self.loop_total)

    def summary(self) -> List[dict]:
        """Each key captured, in order: its capacities, input length,
        steps, SWITCH nodes, capture seconds and condition kernels placed, and whether
        it is still held (a superseded key is freed)."""
        return [{**c, "held": key in self._graphs} for key, c in self._captured]
