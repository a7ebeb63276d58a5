"""Per-layer readings from the program's own spans and counters
(``avsep_tpu_torch/utils/spans.py``) in a ``--trace 1`` training run.

The readers of ``train.host_ms``, ``train.syncs`` and
``train.dispatch_idle_ms`` (and their ``.sop_train`` twins) call
:func:`readings`.  Once per process it builds a second instance of the
cell's program from the run's ``--workload`` and ``--seed`` (the same
nets, seeded weights and pool as the run's; the run's own program is freed
by then), warms it, and runs two stretches of the traffic's
``trace_steps`` steps with the recorder on:

* **stretch S**, no profiler: the mean ``train.step`` span (the host
  issuing forward, backward, gradient mean, update and metrics) and the
  synchronizing CUDA calls counted inside ``train.step``; its wall per
  step against that of the same number of steps run just before it with
  the recorder off is the recorder's cost (the run prints both beside the
  unprofiled window's);
* **stretch A**, the card's activity traced alone: every gap between the
  card's merged busy intervals, from the end of the anchors before the
  steps to the end of those after them, is given to the innermost span
  open at the gap's middle, or to ``outside train.step``; the gaps under
  ``train.step`` give ``train.dispatch_idle_ms``.  The spans' host clock
  is put on the trace's by anchors: ``torch.cuda.synchronize()`` calls,
  each between two host clock reads, whose CUPTI runtime events the trace
  holds; the card's own timestamps, which the trace converts to the
  host's with a drift of up to a few hundred microseconds, are moved onto
  the launches' clock by the floor of the launch-to-kernel latency
  (:func:`on_launch_clock`).  The run prints the per-span idle
  (``idle_by_span``), the anchors' error bound, the drift removed, and how
  long after a ``train.backward`` span opens its first kernel starts.

A program without ``avsep_tpu_torch.utils.spans`` (or a run on several
cards, or a process that is no benchmark run) gives no readings, and its
readers report nothing.  On a CPU there is no card's activity to trace
and no sync to count: only ``train.host_ms`` is read.
"""

from __future__ import annotations

import bisect
import dataclasses
import gc
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

OUTSIDE = "outside train.step"
STEP = "train.step"
WARM = 2            # steps of the second instance before the stretches
ANCHORS = 3         # synchronize calls before and after stretch A
LAUNCH = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
# the shortest launch-to-kernel latency onto an idle H100 (4.2 to 6.5 us in
# traces whose clocks agree)
LAUNCH_FLOOR_S = 5e-6

_done: Dict[Tuple[str, int], Optional[Dict]] = {}


def _flag(argv: Sequence[str], name: str) -> Optional[str]:
    for i, a in enumerate(argv):
        if a == name and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith(name + "="):
            return a.split("=", 1)[1]
    return None


def readings(reading: Dict) -> Optional[Dict]:
    """The span readings of this process's run, measured at the first
    call; None where there are none to read."""
    if reading.get("kind") != "train":
        return None
    workload = _flag(sys.argv, "--workload")
    seed = _flag(sys.argv, "--seed")
    if workload is None or seed is None:
        return None
    key = (workload, int(seed))
    if key not in _done:
        _done[key] = _measure(workload, int(seed), reading.get("step_s"))
    return _done[key]


def _measure(workload: str, seed: int, step_s: Optional[float]
             ) -> Optional[Dict]:
    try:
        from avsep_tpu_torch.utils import spans
    except ImportError:       # a program without the recorder
        return None
    import torch

    from benchmark import harness
    from benchmark.drivers.train import Program, sync
    cell = harness.find_cell(workload)
    if cell.chips != 1:
        return None
    gc.collect()
    prog = Program(cell, seed, None if torch.cuda.is_available() else "cpu")
    dev, k = prog.dev, int(cell.traffic["trace_steps"])
    for _ in range(WARM):
        prog.step(prog.random_indices())

    def steps():
        for _ in range(k):
            spans.correlate(prog.i)
            prog.step(prog.random_indices())

    def wall():
        sync(dev)
        t0 = time.perf_counter()
        steps()
        sync(dev)
        return time.perf_counter() - t0

    # ---- the same steps with the recorder off, for its cost; then
    # stretch S: the recorder on, nothing profiled
    off_s = wall()
    spans.drain()
    with spans.recording():
        counting = spans.counting_syncs()
        on_s = wall()
    rec = spans.drain()
    out = {"steps": k, "span_step_s": on_s / k, "off_step_s": off_s / k,
           "unprofiled_step_s": step_s}
    out.update(step_readings(rec.records, counting))

    # ---- stretch A: the recorder on, the card's activity traced alone
    if dev.type == "cuda":
        out.update(_stretch_a(prog, spans, steps, k))
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _print(cell.name, out)
    return out


def step_readings(records, counting: bool) -> Dict:
    """From stretch S's records: ``host_ms`` (mean ``train.step``), and
    with ``counting`` ``syncs`` (per step, inside ``train.step``), by step
    kind too, and each span's syncs over the stretch."""
    from avsep_tpu_torch.utils import spans
    kids = spans.descendants(records)
    steps = [r for r in records if r.name == STEP]
    if not steps:
        return {}
    out = {"host_ms": 1e3 * sum(r.seconds for r in steps) / len(steps),
           "span_summary": {
               name: {"count": s["count"], "total_ms": 1e3 * s["total_s"],
                      "self_ms": 1e3 * s["self_s"], **s["counts"]}
               for name, s in spans.summary(records).items()}}
    if counting:
        per = [(r.attrs.get("kind"),
                spans.inclusive_counts(r, kids).get(spans.SYNC, 0))
               for r in steps]
        out["syncs"] = sum(n for _, n in per) / len(per)
        for kind in sorted({kd for kd, _ in per}):
            ns = [n for kd, n in per if kd == kind]
            out[f"syncs_{kind}"] = sum(ns) / len(ns)
    return out


def _anchor(dev) -> Tuple[float, float]:
    import torch
    h0 = time.perf_counter()
    torch.cuda.synchronize(dev)
    return h0, time.perf_counter()


def _stretch_a(prog, spans, steps, k: int) -> Dict:
    from torch.profiler import ProfilerActivity, profile

    from benchmark.drivers.train import sync
    dev = prog.dev
    sync(dev)
    spans.drain()
    with spans.recording():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            before = [_anchor(dev) for _ in range(ANCHORS)]
            steps()
            after = [_anchor(dev) for _ in range(ANCHORS)]
    rec = spans.drain()
    device, runtime = kineto_events(prof)
    device, drift = on_launch_clock(device, runtime)
    syncs = sorted((s, e) for s, e, name, _ in runtime
                   if name == "cudaDeviceSynchronize")
    if len(syncs) < 2 * ANCHORS:
        return {"anchor_note": f"{len(syncs)} synchronize events in the "
                f"trace, {2 * ANCHORS} anchors made"}
    host = before + after
    off, err = clock_offset(host, syncs[:2 * ANCHORS])
    recs = [dataclasses.replace(r, t0=r.t0 + off, t1=r.t1 + off)
            for r in rec.records]
    window = (syncs[ANCHORS - 1][1], syncs[2 * ANCHORS - 1][1])
    att = attribute(busy_intervals(device), window, recs)
    out = {"dispatch_idle_ms": 1e3 * att["step_idle_s"] / k,
           "idle_by_span": att["idle_by_span"],
           "idle_by_kind": att["idle_by_kind"],
           "a_window_s": window[1] - window[0], "a_busy_s": att["busy_s"],
           "a_idle_s": att["idle_s"], "anchor_err_us": 1e6 * err,
           "a_host_wall_s": after[-1][1] - before[-1][1], **drift}
    out.update(first_kernels(recs, runtime, device, "train.backward"))
    return out


def kineto_events(prof):
    """The trace's device activities ``(start, end, name, correlation)``
    and CUDA runtime calls alike, in seconds on the trace's clock."""
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    base = min((e.start_ns() for e in evs), default=0)
    device, runtime = [], []
    for e in evs:
        s = (e.start_ns() - base) / 1e9
        row = (s, s + e.duration_ns() / 1e9, e.name(), e.correlation_id())
        if e.device_type() == DeviceType.CUDA:
            device.append(row)
        elif e.name().startswith(("cuda", "cu")):
            runtime.append(row)
    return device, runtime


def on_launch_clock(device, runtime, floor_s: float = LAUNCH_FLOOR_S):
    """The device's activities moved onto the runtime calls' clock.  The
    trace puts the card's timestamps on the host's by a conversion that
    can drift (on an H100, a kernel starting up to 0.35 ms before its own
    launch call at one end of a stretch, 0.06 ms after at the other).  A
    kernel starts at least ``floor_s`` after its launch, later when the
    card is busy: so the drift is taken as the line under every launch's
    latency that lies highest at the stretch's middle (the edge of the
    latencies' lower convex hull there), and the device's times are moved
    so that the line reads ``floor_s``.  Returns the moved activities and
    the correction at the first and the last launch (``drift_us``)."""
    starts = {corr: s for s, _, _, corr in device}
    pts = sorted((s, starts[corr] - s) for s, _, n, corr in runtime
                 if n in LAUNCH and corr in starts)
    if len(pts) < 2:
        return device, {}
    hull: List[Tuple[float, float]] = []
    for p in pts:                       # the lower hull, left to right
        while len(hull) >= 2 and _cross(hull[-2], hull[-1], p) <= 0:
            hull.pop()
        hull.append(p)
    mid = sum(t for t, _ in pts) / len(pts)
    k = next((k for k in range(len(hull) - 1) if hull[k + 1][0] >= mid),
             len(hull) - 2)
    (t0, m0), (t1, m1) = hull[k], hull[k + 1]
    b = (m1 - m0) / (t1 - t0) if t1 > t0 else 0.0
    a = m0 - b * t0

    def moved(t):   # the card's time t read on the launches' clock
        return (t - a + floor_s * (1 + b)) / (1 + b)
    return ([(moved(s), moved(e), n, c) for s, e, n, c in device],
            {"drift_us": [1e6 * (a + b * pts[0][0] - floor_s),
                          1e6 * (a + b * pts[-1][0] - floor_s)]})


def _cross(o, p, q) -> float:
    return (p[0] - o[0]) * (q[1] - o[1]) - (p[1] - o[1]) * (q[0] - o[0])


def clock_offset(host: List[Tuple[float, float]],
                 trace: List[Tuple[float, float]]) -> Tuple[float, float]:
    """The offset ``trace - host`` of two clocks from anchors: a call that
    the host bracketed by reads ``(h0, h1)`` and the trace recorded as
    ``(s, e)`` puts the offset between ``e - h1`` and ``s - h0``.  Returns
    the middle of the anchors' common range and half its width (the error
    bound; negative if the anchors disagree)."""
    lo = max(e - h1 for (h0, h1), (s, e) in zip(host, trace))
    hi = min(s - h0 for (h0, h1), (s, e) in zip(host, trace))
    return (lo + hi) / 2, (hi - lo) / 2


def busy_intervals(device) -> List[Tuple[float, float]]:
    """The union of the device's activity intervals, merged."""
    merged: List[List[float]] = []
    for s, e, *_ in sorted(device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def attribute(busy: List[Tuple[float, float]], window: Tuple[float, float],
              records) -> Dict:
    """Every idle gap of ``window`` (its stretches outside the union of the
    ``busy`` intervals) given to the innermost record open at the gap's
    middle (the latest opened of those open), or to :data:`OUTSIDE`.
    Returns ``idle_by_span`` (name -> seconds, longest first), the idle,
    busy and ``step_idle_s`` (the gaps under a ``train.step``) seconds, and
    ``idle_by_kind``: the gaps under a ``train.step`` by its ``kind``
    attribute, then by span."""
    w0, w1 = window
    gaps, t, busy_s = [], w0, 0.0
    for s, e in busy_intervals(busy):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        busy_s += e - s
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    by_id = {r.id: r for r in records}

    def step_of(r):
        while r is not None and r.name != STEP:
            r = by_id.get(r.parent)
        return r

    # the innermost record of each stretch between two span boundaries
    points = sorted({p for r in records for p in (r.t0, r.t1)})
    label = []
    for a in points:
        open_ = [r for r in records if r.t0 <= a < r.t1]
        label.append(max(open_, key=lambda r: (r.t0, -r.t1))
                     if open_ else None)
    idle: Dict[str, float] = {}
    by_kind: Dict[str, Dict[str, float]] = {}
    for s, e in gaps:
        i = bisect.bisect_right(points, (s + e) / 2) - 1
        r = label[i] if i >= 0 else None
        name = r.name if r is not None else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (e - s)
        step = step_of(r)
        if step is not None:
            kind = by_kind.setdefault(
                str(getattr(step, "attrs", {}).get("kind")), {})
            kind[name] = kind.get(name, 0.0) + (e - s)
    return {"idle_by_span": sorted(idle.items(), key=lambda kv: -kv[1]),
            "idle_by_kind": by_kind,
            "idle_s": sum(e - s for s, e in gaps), "busy_s": busy_s,
            "step_idle_s": sum(sum(d.values()) for d in by_kind.values())}


def first_kernels(records, runtime, device, name: str) -> Dict:
    """For each ``name`` span: how long after it opens the first launch
    made inside it is issued, and its kernel starts (seconds, on the
    trace's clock; the smallest and the largest over the spans)."""
    launches = sorted((s, corr, n) for s, _, n, corr in runtime
                      if n in LAUNCH)
    kernels = {corr: (s, n) for s, _, n, corr in device}
    issue, start, early = [], [], []
    for r in records:
        if r.name != name:
            continue
        i = bisect.bisect_left(launches, (r.t0, -1, ""))
        if i == len(launches) or launches[i][0] >= r.t1:
            continue
        s, corr, call = launches[i]
        issue.append(s - r.t0)
        if corr in kernels:
            k_s, kernel = kernels[corr]
            start.append(k_s - r.t0)
            if k_s < r.t0:
                early.append(f"{call} {corr} at +{1e6 * (s - r.t0):.1f} us, "
                             f"{kernel[:60]} at {1e6 * (k_s - r.t0):.1f} us")
    if not start:
        return {}
    return {"first_launch_us": [1e6 * min(issue), 1e6 * max(issue)],
            "first_kernel_us": [1e6 * min(start), 1e6 * max(start)],
            "first_kernel_spans": len(start), "first_kernel_early": early}


def _print(cell: str, r: Dict) -> None:
    ms = (lambda v: f"{1e3 * v:.3f}" if v else "n/a")
    parts = [f"spans ({cell}): stretch S {ms(r['span_step_s'])} ms per step "
             f"with the recorder on, against {ms(r['off_step_s'])} ms off "
             f"just before and {ms(r['unprofiled_step_s'])} ms in the "
             f"unprofiled window"]
    if "host_ms" in r:
        parts.append(f"train.step {r['host_ms']:.3f} ms")
    if "syncs" in r:
        parts.append("syncs per step " + ", ".join(
            f"{k[6:] or 'all'} {v:g}" for k, v in sorted(r.items())
            if k.startswith("syncs")))
    if "dispatch_idle_ms" in r:
        parts.append(
            f"stretch A: {1e3 * r['a_idle_s'] / r['steps']:.3f} idle ms per "
            f"step ({1e3 * r['a_window_s'] / r['steps']:.3f} ms, host "
            f"{1e3 * r['a_host_wall_s'] / r['steps']:.3f}), "
            f"{r['dispatch_idle_ms']:.3f} under train.step; anchors "
            f"+-{r['anchor_err_us']:.1f} us; idle_by_span " + ", ".join(
                f"{n} {1e3 * v / r['steps']:.3f}"
                for n, v in r["idle_by_span"]) + "; idle ms over the "
            "stretch by step kind " + "; ".join(
                f"{kind}: " + ", ".join(f"{n} {1e3 * v:.3f}" for n, v in
                                       sorted(d.items(), key=lambda x: -x[1]))
                for kind, d in sorted(r["idle_by_kind"].items())))
    if "first_kernel_us" in r:
        parts.append("train.backward's first launch "
                     f"{r['first_launch_us'][0]:.1f} to "
                     f"{r['first_launch_us'][1]:.1f} us after it opens, "
                     f"its kernel {r['first_kernel_us'][0]:.1f} to "
                     f"{r['first_kernel_us'][1]:.1f} us, over "
                     f"{r['first_kernel_spans']} spans; before the span "
                     "opens: " + ("; ".join(r["first_kernel_early"])
                                  or "none"))
    if "drift_us" in r:
        parts.append(f"the card's clock moved onto the launches' by "
                     f"{-r['drift_us'][0]:.1f} to {-r['drift_us'][1]:.1f} "
                     "us across the stretch")
    if "anchor_note" in r:
        parts.append(r["anchor_note"])
    print("; ".join(parts), flush=True)
    if "span_summary" in r:
        print(f"span summary ({cell}, stretch S, {r['steps']} steps): "
              + ", ".join(f"{n} {v}" for n, v in r["span_summary"].items()),
              flush=True)
