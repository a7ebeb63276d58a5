"""The motion net's share of a training step, in a ``--trace 1`` run of a
cell whose visual stream is video (``load_clips``): **stretch M**.

The readers of ``motion.device_ms`` and ``mfu.motion`` call
:func:`readings`.  Once per process, after :func:`benchmark.trace.spans.
readings` is done and has freed its instance, it builds another instance
of the cell's program from the run's ``--workload`` and ``--seed`` (the
same nets, seeded weights and pool as the run's), wraps its nets in
``train.make_eager_train_step``, the step that ``train.GraphedStep``
captures, warms :data:`WARM` AV steps, then profiles :data:`STEPS` AV steps
with the span recorder on, tracing the host's ops and the card.

Stretch M is eager because a kernel replayed from a CUDA graph carries no
launching op, so a graphed stretch cannot say which layer a kernel belongs
to; the eager step issues the same cuDNN calls that the graph holds.

A kernel (any activity on the card) belongs to the motion net if its
launching op (the op the trace links it to) opened inside a
``train.motion`` span on the same thread, or runs under an autograd
backward function (``autograd::engine::evaluate_function``) whose sequence
number is that of a forward op opened inside ``train.motion`` on the
backward function's forward thread.  Kernels are never sorted by name:
a name does not tell a 3-D convolution from a 2-D one.  The union of those
kernels' intervals, per AV step, is ``device_ms``.  The FLOPs are
``counts.flops.resnet3d_fast`` trained per clip (the stem without an input
gradient) times the ``motion.clips`` counted per AV step in the stretch.

A program without the span, a cell without clips, a run on several cards
or a process that is no benchmark run gives no readings; a CPU run counts
the clips and has no card to trace.
"""

from __future__ import annotations

import bisect
import gc
import sys
from collections import namedtuple
from typing import Dict, List, Optional, Tuple

SPAN = "train.motion"
COUNTER = "motion.clips"
BACKWARD = "autograd::engine::evaluate_function:"
WARM = 2            # eager AV steps before the stretch
STEPS = 6           # profiled AV steps

# a host op of the trace: its id (what the card's activities link to), its
# thread, start and end, name, autograd sequence number and, for a backward
# function, the thread of its forward; ``annotation`` for a span's range
Op = namedtuple("Op", "id thread t0 t1 name seq fwd_thread annotation")

_done: Dict[Tuple[str, int], Optional[Dict]] = {}


def readings(reading: Dict) -> Optional[Dict]:
    """Stretch M's readings of this process's run, measured at the first
    call; None where there are none to read."""
    from benchmark.trace import spans as bspans
    if reading.get("kind") != "train":
        return None
    workload = bspans._flag(sys.argv, "--workload")
    seed = bspans._flag(sys.argv, "--seed")
    if workload is None or seed is None:
        return None
    key = (workload, int(seed))
    if key not in _done:
        bspans.readings(reading)        # its instance is gone after it
        _done[key] = _measure(workload, int(seed))
    return _done[key]


def _spanned_program() -> bool:
    try:
        from avsep_tpu_torch import engine
        from avsep_tpu_torch.utils import spans  # noqa: F401
    except ImportError:
        return False
    return hasattr(engine, "motion_clips")


def _measure(workload: str, seed: int) -> Optional[Dict]:
    from benchmark import harness
    cell = harness.find_cell(workload)
    if cell.chips != 1 or not cell.config["flags"].get("load_clips") \
            or not _spanned_program():
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avsep_tpu_torch import train
    from avsep_tpu_torch.utils import spans
    from benchmark import data
    from benchmark.drivers.train import Program, sync
    gc.collect()
    prog = Program(cell, seed, None if torch.cuda.is_available() else "cpu")
    dev = prog.dev
    step = train.make_eager_train_step(prog.cfg, prog.state.nets, True, dev)

    def av():
        batch = data.train_batch(prog.pool, prog.random_indices()[prog.rows],
                                 True, prog.stream)
        step(prog.state, batch)

    for _ in range(WARM):
        av()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(dev)
    spans.drain()
    with spans.recording():
        with profile(activities=activities) as prof:
            for _ in range(STEPS):
                av()
            sync(dev)
    rec = spans.drain()
    ops, device = trace_events(prof)
    out = from_events(ops, device, rec.records, cell.config["flags"])
    del prog, step, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if out is not None:
        _print(cell.name, out)
    return out


def trace_events(prof) -> Tuple[List[Op], List[Tuple[float, float, int,
                                                      str]]]:
    """The trace's host ops (:class:`Op`) and the card's activities
    ``(start, end, launching op's id, name)``, in seconds on the trace's
    clock."""
    from torch.autograd import DeviceType
    evs = list(prof.profiler.kineto_results.events())
    base = min((e.start_ns() for e in evs), default=0)
    ops, device = [], []
    for e in evs:
        s = (e.start_ns() - base) / 1e9
        end = s + e.duration_ns() / 1e9
        if e.device_type() == DeviceType.CUDA:
            device.append((s, end, e.linked_correlation_id(), e.name()))
        elif e.device_type() == DeviceType.CPU \
                and e.linked_correlation_id() == 0:   # not a runtime call
            name = e.name()
            annotation = getattr(e, "is_user_annotation",
                                 lambda: "::" not in name)()
            ops.append(Op(e.correlation_id(), e.start_thread_id(), s, end,
                          name, e.sequence_nr(), e.fwd_thread_id(),
                          bool(annotation)))
    return ops, device


def motion_activities(ops: List[Op], device, span: str = SPAN
                      ) -> Tuple[List[Tuple[float, float]], int, int]:
    """The card's activities that belong to the motion net (module
    docstring), as ``(start, end)``, with how many came from forward and
    from backward ops."""
    by_thread: Dict[int, List[Op]] = {}
    for op in ops:
        by_thread.setdefault(op.thread, []).append(op)
    spans_of = {t: sorted((o.t0, o.t1) for o in v if o.name == span)
                for t, v in by_thread.items()}

    def inside(op: Op) -> bool:
        ranges = spans_of.get(op.thread, [])
        i = bisect.bisect_right(ranges, (op.t0, float("inf"))) - 1
        return i >= 0 and ranges[i][0] <= op.t0 < ranges[i][1]

    forward = {(o.thread, o.seq) for o in ops
               if o.seq >= 0 and not o.annotation
               and not o.name.startswith(BACKWARD) and inside(o)}
    # each op's innermost enclosing backward function (itself included)
    backward_of: Dict[int, Optional[Tuple[int, int]]] = {}
    for v in by_thread.values():
        stack: List[Tuple[Op, Optional[Tuple[int, int]]]] = []
        for o in sorted(v, key=lambda o: (o.t0, -o.t1)):
            while stack and stack[-1][0].t1 <= o.t0:
                stack.pop()
            key = (o.fwd_thread, o.seq) if o.name.startswith(BACKWARD) \
                else (stack[-1][1] if stack else None)
            backward_of[o.id] = key
            stack.append((o, key))
    by_id = {o.id: o for o in ops}
    out, n_fwd, n_bwd = [], 0, 0
    for s, e, link, _ in device:
        op = by_id.get(link)
        if op is None or op.annotation:
            continue
        if inside(op):
            n_fwd += 1
        elif backward_of.get(op.id) in forward:
            n_bwd += 1
        else:
            continue
        out.append((s, e))
    return out, n_fwd, n_bwd


def from_events(ops: List[Op], device, records, flags: Dict
                ) -> Optional[Dict]:
    """Stretch M's readings from its trace and span records: ``clips`` per
    AV step and, where the card's activities were traced, ``device_ms``,
    ``mfu`` and the stretch's whole busy ms per step; None where the trace
    holds no ``train.motion`` span."""
    from benchmark.counts import flops as kflops
    from benchmark.drivers.train import PEAK_FLOPS
    from benchmark.trace.spans import busy_intervals
    if not any(o.name == SPAN for o in ops):
        return None
    steps = [r for r in records if r.name == "train.step"]
    clips = sum(r.counts.get(COUNTER, 0) for r in records) / max(
        1, len(steps))
    out: Dict = {"steps": len(steps), "clips": clips}
    acts, n_fwd, n_bwd = motion_activities(ops, device)
    if not acts:
        return out
    per = len(steps)
    busy = sum(e - s for s, e in busy_intervals(acts))
    # the card's copies of the spans' ranges are no work
    ranges = {o.name for o in ops if o.annotation}
    whole = sum(e - s for s, e in busy_intervals(
        [(s, e) for s, e, _, name in device if name not in ranges]))
    img = flags["imgSize"]
    flops = clips * kflops.trained(kflops.resnet3d_fast(
        1, flags["clip_len"], img, img))
    out.update({"device_ms": 1e3 * busy / per,
                "step_device_ms": 1e3 * whole / per,
                "forward_activities": n_fwd, "backward_activities": n_bwd,
                "flops": flops,
                "mfu": 100.0 * flops / (busy / per)
                / PEAK_FLOPS[flags["dtype"]]})
    return out


def _print(cell: str, r: Dict) -> None:
    text = (f"motion ({cell}): stretch M, {r['steps']} eager AV steps, "
            f"{r['clips']:g} clips per step")
    if "device_ms" in r:
        text += (f"; the motion net {r['device_ms']:.3f} of "
                 f"{r['step_device_ms']:.3f} busy ms per step "
                 f"({r['forward_activities']} forward and "
                 f"{r['backward_activities']} backward activities), "
                 f"{r['flops']:.5g} FLOP, {r['mfu']:.4f} % of the peak")
    print(text, flush=True)
