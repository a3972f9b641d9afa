"""Per-layer device times of one benchmark cell, read from the program's
span recorder (`loam_livox_tpu_torch.utils.logging.spans`).

    python scripts/torch_layer_spans.py --workload <cell> --seed <n>
        [--seconds 30] [--spans 0|1] [--profile 0|1]

One run of a cell of ``BENCHMARK.json`` as `slambench.harness` runs it:
its configuration and traffic, the stream made on the card from the
seed, the warm-up, then the window (a replay cell's recording of
``replay_frames`` back to back, ``--seconds`` its cap; or live at the
sensor's rate for ``--seconds``).  With ``--spans 1`` the recorder is
switched on before the pipeline is built (so every capture holds its
stamps), reset after the warm-up, and read after the window's closing
synchronise (one host read); a clock pair at the window's open and one
at its close map the card's globaltimer onto ``perf_counter_ns`` and
give the drift.  With
``--profile 1`` the harness's traced slice (`slambench.trace.Tracer`)
runs inside the window too, and the line adds the share of the slice's
unrecorded busy time (``UNTRACED``: the kernels of the conditional
bodies) that the device spans cover, and the slice's idle gaps labelled
by the innermost program host span over each (then the harness's own).
The outputs are not checked here (the benchmark's `slambench.check`
does): with both options off the run is the benchmark's untraced window
without its check, the base of the recorder's cost.

The line (JSON, last on stdout): the card and its power limit, the
window's frames, seconds and end-to-end metric (``frames_per_s`` or
``latency_ms_p95``), graph launches and host syncs of the window, and
with spans the per-layer numbers of `layer_metrics` (front end, voxel
filters by call site, kNN search, targets, LM solve and the pass's self
time), `live_metrics` for a live cell, ``pass_kernels`` (the kernel
nodes of the ICP pass body of the key launched most), the clock pairs,
the globaltimer's resolution and the ring's records and losses.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Sequence, Tuple  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from loam_livox_tpu_torch.utils import logging as L  # noqa: E402

#: a voxel filter's call site, by the span it nests in
VOXEL_SITES = {L.SPAN_SETUP: "input filter", L.SPAN_ADD_FRAME: "commit",
               L.SPAN_BUILD_TREE: "rebuild", L.SPAN_FRONT_END: "front end"}


def voxel_site(parent: Optional[L.Span]) -> str:
    """The call site of a voxel filter span nested in ``parent``: a unit's
    own voxel filters are the front end's source filters."""
    if parent is None:
        return "top"
    if parent.name.startswith(L.SPAN_UNIT + "."):
        return "source filter"
    return VOXEL_SITES.get(parent.name, parent.name)


def _ms(ns: float) -> float:
    return ns * 1e-6


def layer_metrics(spans: Sequence[L.Span], frames: int) -> Dict[str, object]:
    """The per-layer device times of a window's complete spans over its
    ``frames`` raw frames: inclusive span time (a child's time counts in
    its parent's too) per frame or per ICP pass, the voxel filters by call
    site, the pass split into its children and its self time, and each
    span name's count, total and self time."""
    dur = [s.t1 - s.t0 for s in spans]
    child = [0] * len(spans)
    for i, s in enumerate(spans):
        if s.parent >= 0:
            child[s.parent] += dur[i]
    by_name: Dict[str, Dict[str, float]] = {}
    for i, s in enumerate(spans):
        e = by_name.setdefault(s.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        e["count"] += 1
        e["total_ms"] += _ms(dur[i])
        e["self_ms"] += _ms(dur[i] - child[i])

    def total(name: str) -> float:
        return by_name.get(name, {}).get("total_ms", 0.0)

    passes = by_name.get(L.SPAN_PASS, {}).get("count", 0)
    out: Dict[str, object] = {"frames": frames, "passes": passes}
    if frames > 0:
        out["frontend_ms_per_frame"] = total(L.SPAN_FRONT_END) / frames
        out["voxel_ms_per_frame"] = total(L.SPAN_VOXEL) / frames
        sites: Dict[str, float] = {}
        for s, d in zip(spans, dur):
            if s.name == L.SPAN_VOXEL:
                site = voxel_site(spans[s.parent] if s.parent >= 0 else None)
                sites[site] = sites.get(site, 0.0) + _ms(d) / frames
        out["voxel_ms_per_frame_by_site"] = sites
    if passes > 0:
        pass_ms = total(L.SPAN_PASS)
        parts = {"search": total(L.SPAN_QUERY), "targets": total(L.SPAN_TARGETS),
                 "solve": total(L.SPAN_POSE_OPT)}
        parts["self"] = pass_ms - sum(parts.values())
        out["pass_ms"] = pass_ms / passes
        out["knn_ms_per_pass"] = parts["search"] / passes
        out["solver_ms_per_pass"] = parts["solve"] / passes
        out["pass_split_pct"] = {k: 100.0 * v / pass_ms for k, v in parts.items()}
        out["pass_children_pct"] = 100.0 * (pass_ms - parts["self"]) / pass_ms
    out["by_name"] = by_name
    return out


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    import numpy as np

    return float(np.percentile(np.asarray(values, np.float64), q))


def units(spans: Sequence[L.Span]) -> List[L.Span]:
    """The top-level spans, one a frame-program launch (``unit.<kind>``)."""
    return [s for s in spans if s.depth == 0 and s.name.startswith(L.SPAN_UNIT + ".")]


def live_metrics(unit_spans: Sequence[L.Span], due_ns: Sequence[int], to_host) -> dict:
    """Frame k's start lag (its unit's first stamp on the host clock minus
    its due time: dispatch, copy-up and queueing behind earlier frames)
    and its own device time (the unit's last stamp minus its first), p50
    and p95 over the window; one unit a frame."""
    n = min(len(unit_spans), len(due_ns))
    lag = [_ms(to_host(u.t0) - d) for u, d in zip(unit_spans[:n], due_ns[:n])]
    own = [_ms(u.t1 - u.t0) for u in unit_spans[:n]]
    return {"frames": n, "start_lag_ms_p95": percentile(lag, 95),
            "start_lag_ms_p50": percentile(lag, 50),
            "frame_device_ms_p95": percentile(own, 95), "frame_device_ms_p50": percentile(own, 50)}


def clock_map(open_pair: L.ClockPair, close_pair: L.ClockPair):
    """Globaltimer ns -> ``perf_counter_ns``, the offset interpolated
    between the window's two clock pairs (their drift)."""
    d0, o0 = open_pair.device_ns, open_pair.offset_ns
    span = close_pair.device_ns - d0
    slope = (close_pair.offset_ns - o0) / span if span > 0 else 0.0
    return lambda t: t + o0 + slope * (t - d0)


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def subtract(base: Sequence[Tuple[float, float]], cut: Sequence[Tuple[float, float]]):
    """``base`` (disjoint, sorted) minus the union of ``cut``."""
    cut = union(cut)
    out = []
    j = 0
    for a, b in base:
        while j < len(cut) and cut[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(cut) and cut[k][0] < b:
            c, d = cut[k]
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def covered_share(target: Sequence[Tuple[float, float]],
                  cover: Sequence[Tuple[float, float]]) -> Optional[float]:
    """The share of the union of ``target`` that the union of ``cover``
    covers (None for an empty target)."""
    target = union(target)
    whole = sum(b - a for a, b in target)
    if whole <= 0:
        return None
    left = sum(b - a for a, b in subtract(target, cover))
    return 1.0 - left / whole


def innermost_first(host: Sequence[L.Span]) -> List[tuple]:
    """Program host spans as ``slambench.trace.reduce_events`` takes them
    ((label, t0, t1)), deepest first, so that a gap takes the innermost
    span over it."""
    return [(s.name, s.t0, s.t1) for s in sorted(host, key=lambda s: -s.depth) if s.t1 >= 0]


def launch_lead(unit_spans: Sequence[L.Span], launches: Sequence[L.Span], to_host,
                slack_ns: float) -> dict:
    """Each unit's first stamp (host clock) minus the start of its host
    ``launch`` span (the k-th of each): a unit before its launch, beyond
    ``slack_ns``, is a clock fault."""
    n = min(len(unit_spans), len(launches))
    lead = [to_host(u.t0) - h.t0 for u, h in zip(unit_spans[:n], launches[:n])]
    return {"launches": n, "min_us": min(lead) * 1e-3 if lead else None,
            "before_launch": sum(1 for x in lead if x < -slack_ns)}


def pass_kernels_of(summary: Sequence[dict]) -> Optional[int]:
    """The kernel nodes of the ICP pass body of the held key launched most
    (`FrameProgram.summary`): the node floor a pass pays."""
    held = [e for e in summary if e["held"] and e.get("pass_kernels") is not None]
    return max(held, key=lambda e: e["launches"])["pass_kernels"] if held else None


def resolution_ns(device) -> int:
    """The least nonzero step of 10^5 back-to-back globaltimer readings."""
    from loam_livox_tpu_torch.ops import graph_cond

    t = graph_cond.globaltimer_steps(device, 100_000)
    steps = (t[1:] - t[:-1])
    steps = steps[steps > 0]
    return int(steps.min()) if steps.numel() else 0


def card() -> dict:
    import torch

    out = {"name": torch.cuda.get_device_name(0)}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["nvidia_smi"] = None
    return out


def event_map(origin, origin_ns: int, pair_open: L.ClockPair, pair_close: L.ClockPair):
    """Globaltimer ns -> the clock on which ``origin`` (a CUDA event) reads
    ``origin_ns``: each clock pair's stamp sits in the middle of its two
    events, whose times against ``origin`` place it; the scale between the
    two pairs (the clocks' drift) is interpolated.  This is the mapping the
    harness's `LaunchClock` places launches by, so spans and launches
    agree to a few microseconds (half an event bracket)."""
    def at(p: L.ClockPair) -> float:
        before, after = p.events
        return (origin.elapsed_time(before) + before.elapsed_time(after) / 2) * 1e6

    e0, e1 = at(pair_open), at(pair_close)
    g0, g1 = pair_open.device_ns, pair_close.device_ns
    slope = (e1 - e0) / (g1 - g0) if g1 > g0 else 1.0
    return lambda t: origin_ns + e0 + (t - g0) * slope


def _covered(target, cover) -> Optional[float]:
    share = covered_share(target, cover)
    return None if share is None else 100.0 * share


def _slice_extras(tracer, host: Sequence[L.Span], harness_spans, dev_spans, to_host,
                  pairs: Tuple[L.ClockPair, L.ClockPair]) -> dict:
    """The traced slice's UNTRACED time (launch intervals the profiler's
    records leave uncovered) covered by the device spans, units aside and
    units alone; each launch's edges against its unit; and the idle gaps
    labelled by program host spans first.  Spans are placed on the
    profiler's clock through the launches' own CUDA events (`event_map`);
    ``host_untraced_covered_pct`` places them through the host clock
    (`clock_map` and the harness's profiler-to-host offset), for
    comparison."""
    from slambench import trace as T

    prof = tracer.prof
    open_ns = T._marker(prof, "slambench.slice_open")
    close_ns = T._marker(prof, "slambench.slice_close")
    offset = open_ns - tracer.open_host            # profiler clock minus host
    events = T._device_events(prof)
    launches = T._clip(tracer.clock.intervals(tracer.origin, open_ns), open_ns, close_ns)
    recorded = union([(max(a, open_ns), min(b, close_ns)) for _, a, b in events])
    untraced = subtract(union(launches), recorded)
    to_prof = event_map(tracer.origin, open_ns, *pairs)

    def placed(pick, clock) -> List[Tuple[float, float]]:
        return [(clock(s.t0), clock(s.t1)) for s in dev_spans if pick(s)]

    def inner(s):
        return s.depth > 0

    def outer(s):
        return s.depth == 0

    def host_clock(t):
        return to_host(t) + offset

    units_p = placed(outer, to_prof)
    inner_p = placed(inner, to_prof)
    edges = []
    for a, b in launches:
        best = max(units_p, key=lambda u: min(u[1], b) - max(u[0], a), default=None)
        if best is not None and min(best[1], b) > max(best[0], a):
            edges.append(((best[0] - a) * 1e-3, (b - best[1]) * 1e-3))
    recorded_ms = sum(b - a for a, b in recorded) * 1e-6
    _, _, gaps = T.reduce_events(events, open_ns, close_ns,
                                 innermost_first(host) + list(harness_spans), offset, launches)
    return {"untraced_ms": sum(b - a for a, b in untraced) * 1e-6,
            "untraced_covered_pct": _covered(untraced, inner_p),
            "untraced_in_units_pct": _covered(untraced, units_p),
            "host_untraced_covered_pct": _covered(untraced, placed(inner, host_clock)),
            "recorded_ms": recorded_ms,
            "launch_edges_us": [[round(x, 3), round(y, 3)] for x, y in edges],
            "idle_gaps": [[n, s] for n, s in gaps]}


def run(cell_name: str, seed: int, seconds: float, with_spans: bool, profile: bool) -> dict:
    import torch

    from slambench import harness as H
    from slambench.gen.stream import Site, make_frames

    manifest = H.load_manifest(ROOT)
    cell = H.cell_of(manifest, cell_name)
    cfg_doc = H.load_config(cell["config"])
    traffic = H.load_traffic(cell["traffic"])
    mode = traffic["mode"]
    site = Site.from_dict(cfg_doc["site"])
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(1)
    L.spans.on = with_spans
    prog = H.Program(cfg_doc["slam"], len(site.heads_yaw_deg), dev)
    warmup = int(traffic["warmup_frames"])
    if mode == "replay":
        n_window = int(cfg_doc["replay_frames"])
    else:
        n_window = int(round(seconds * float(traffic["rate_hz"])))
    n_stream = warmup + n_window
    stream = make_frames(site, seed, n_stream, prog.cfg.capacity.max_raw_points, dev)
    copy_to = None
    if mode == "live":
        stream = stream._replace(**{k: getattr(stream, k).cpu().pin_memory()
                                    for k in ("xyz", "inten", "mask")})
        copy_to = dev
    hspans = H.HostSpans()
    for i in range(warmup):
        if profile and i == warmup - 1:
            from slambench.trace import warm_profiler

            with warm_profiler():
                H._dispatch(prog, stream, i, hspans, copy_to)
        else:
            H._dispatch(prog, stream, i, hspans, copy_to)
    torch.cuda.synchronize(dev)
    H.reset_counters()
    L.spans.reset()
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_START
    out: dict = {"cell": cell_name, "seed": seed, "spans": int(with_spans),
                 "profile": int(profile), "card": card(), "setup_s": setup_s}
    opened = []

    class Clock(H.DeviceClock):                 # the live window's open, kept
        def __init__(self, device):
            super().__init__(device)
            opened.append(self.t0)

    H.DeviceClock = Clock
    tracer = None
    if profile:
        from slambench.trace import Tracer

        tracer = Tracer(hspans, int(traffic.get("trace_after_frames", 30)),
                        int(traffic.get("trace_frames", 8)))
    pair_open = L.spans.clock_pair(dev) if with_spans else None
    rec = H.Records(mode=mode, setup_s=setup_s)
    if mode == "replay":
        rec.frames, rec.seconds, rec.capped = H.replay_window(
            prog, stream, warmup, n_window, seconds, int(traffic["in_flight"]), dev, hspans,
            None, tracer)
        out["frames_per_s"] = rec.frames / rec.seconds
        out["capped"] = rec.capped
    else:
        rate = float(traffic["rate_hz"])
        rec.frames, rec.seconds, rec.latencies_ms = H.live_window(
            prog, stream, warmup, seconds, rate, dev, hspans, None, tracer)
        out["latency_ms_p95"] = percentile(rec.latencies_ms, 95)
        out["latency_ms_p50"] = percentile(rec.latencies_ms, 50)
    H.read_counters(rec)
    out.update(frames=rec.frames, seconds=rec.seconds, host_syncs=rec.syncs,
               graph_launches_per_frame=rec.graphs.get("graph_launch", 0) / max(rec.frames, 1),
               captures_in_window=rec.graphs.get("graph_capture", 0))
    sl = tracer.result() if tracer is not None else None
    if sl is not None:
        out["slice"] = {"busy_s": sl.busy_s, "window_s": sl.window_s,
                        "untraced_s": sl.op_s.get("frame graph: kernels in conditional bodies "
                                                  "(not recorded one by one)", 0.0),
                        "breakdown": sl.breakdown()}
    summary = prog.pipe.program.summary()
    out["pass_kernels"] = pass_kernels_of(summary)
    out["keys"] = [{k: e[k] for k in ("kind", "launches", "pass_kernels", "kernel_nodes",
                                      "stamp_nodes", "held")} for e in summary]
    if not with_spans:
        return out
    pair_close = L.spans.clock_pair(dev)
    device_rec = L.spans.read(dev)
    host_rec = L.spans.host_spans()
    to_host = clock_map(pair_open, pair_close)
    out["ring"] = {"records": 2 * len(device_rec.spans), "lost": device_rec.lost,
                   "broken": device_rec.broken, "complete": device_rec.complete,
                   "host_spans": len(host_rec.spans), "host_lost": host_rec.lost}
    dt = pair_close.device_ns - pair_open.device_ns
    out["clock"] = {"open_offset_ns": pair_open.offset_ns,
                    "open_uncertainty_ns": pair_open.uncertainty_ns,
                    "close_offset_ns": pair_close.offset_ns,
                    "close_uncertainty_ns": pair_close.uncertainty_ns,
                    "drift_ppm": (pair_close.offset_ns - pair_open.offset_ns) / dt * 1e6
                    if dt > 0 else None,
                    "globaltimer_resolution_ns": resolution_ns(dev)}
    if not device_rec.complete:
        return out
    spans = device_rec.spans
    out["layers"] = layer_metrics(spans, rec.frames)
    unit_spans = units(spans)
    slack = pair_open.uncertainty_ns + pair_close.uncertainty_ns
    out["launch_lead"] = launch_lead(unit_spans, [s for s in host_rec.spans if s.name == "launch"],
                                     to_host, slack)
    if mode == "live":
        t_open_ns = opened[-1] * 1e9
        due = [t_open_ns + k * 1e9 / rate for k in range(rec.frames)]
        out["live"] = live_metrics(unit_spans, due, to_host)
    if sl is not None:
        out["slice"].update(_slice_extras(tracer, host_rec.spans, hspans.spans, spans, to_host,
                                         (pair_open, pair_close)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_layer_spans: no CUDA device", file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.spans), bool(args.profile))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
