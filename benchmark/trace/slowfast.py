"""SlowFast R50's slow pathway and laterals in a ``--trace 1`` run of a
cell whose motion net is ``--arch_motion slowfast_r50``: **stretch L**.

The readers of ``motion_slow.device_ms``, ``mfu.motion_slow`` and
``motion_lateral.device_ms`` call :func:`readings`.  Once per process,
after stretch M (``trace/motion.py``, which runs stretches S and A first)
is done and has freed its instance, it builds another instance of the
cell's program from the run's ``--workload`` and ``--seed``, wraps its
nets in ``train.make_eager_train_step``, warms :data:`WARM` AV steps, then
profiles :data:`STEPS` AV steps with the span recorder on, tracing the
host's ops and the card: stretch M's rule, called here with the spans
``motion.slow`` (the slow stem and each slow stage) and ``motion.lateral``
(each lateral convolution with its concatenation) in place of
``train.motion`` (``motion.motion_activities``).  The union of each
span's kernels' intervals, per AV step, is its ``device_ms``.  The slow
pathway's FLOPs are ``counts.slowfast.slow_pathway`` trained per clip (the
stem without an input gradient) at ``clip_len`` frames, times the
``motion.slow_frames`` counted per AV step over ``ceil(clip_len / 8)``.

A program without the spans, a cell whose motion net has no slow pathway,
a run on several cards or a process that is no benchmark run gives no
readings; a CPU run counts the slow frames and has no card to trace.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, Optional, Tuple

SLOW = "motion.slow"
LATERAL = "motion.lateral"
COUNTER = "motion.slow_frames"
WARM = 2            # eager AV steps before the stretch
STEPS = 6           # profiled AV steps

_done: Dict[Tuple[str, int], Optional[Dict]] = {}


def readings(reading: Dict) -> Optional[Dict]:
    """Stretch L's readings of this process's run, measured at the first
    call; None where there are none to read."""
    from benchmark.trace import motion
    from benchmark.trace import spans as bspans
    if reading.get("kind") != "train":
        return None
    workload = bspans._flag(sys.argv, "--workload")
    seed = bspans._flag(sys.argv, "--seed")
    if workload is None or seed is None:
        return None
    key = (workload, int(seed))
    if key not in _done:
        motion.readings(reading)        # its instance is gone after it
        _done[key] = _measure(workload, int(seed))
    return _done[key]


def _slowfast(flags: Dict) -> bool:
    return bool(flags.get("load_clips")) and \
        flags.get("arch_motion") == "slowfast_r50"


def _measure(workload: str, seed: int) -> Optional[Dict]:
    from benchmark import harness
    cell = harness.find_cell(workload)
    if cell.chips != 1 or not _slowfast(cell.config["flags"]):
        return None
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avsep_tpu_torch import train
    from avsep_tpu_torch.utils import spans
    from benchmark import data
    from benchmark.drivers.train import Program, sync
    from benchmark.trace.motion import trace_events
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


def from_events(ops, device, records, flags: Dict) -> Optional[Dict]:
    """Stretch L's readings from its trace and span records:
    ``slow_frames`` per AV step and, where the card's activities were
    traced, ``slow_ms``, ``lateral_ms`` and ``mfu``; None where the trace
    holds no ``motion.slow`` span."""
    from benchmark.counts import flops as kflops
    from benchmark.counts import slowfast as kslowfast
    from benchmark.drivers.train import PEAK_FLOPS
    from benchmark.trace.motion import motion_activities
    from benchmark.trace.spans import busy_intervals
    if not any(o.name == SLOW for o in ops):
        return None
    steps = [r for r in records if r.name == "train.step"]
    per = max(1, len(steps))
    frames = sum(r.counts.get(COUNTER, 0) for r in records) / per
    out: Dict = {"steps": len(steps), "slow_frames": frames}
    slow, n_fwd, n_bwd = motion_activities(ops, device, span=SLOW)
    lateral, l_fwd, l_bwd = motion_activities(ops, device, span=LATERAL)
    if not slow:
        return out
    img, t = flags["imgSize"], flags["clip_len"]
    clips = frames / -(-t // 8)
    flops = clips * kflops.trained(kslowfast.slow_pathway(1, t, img, img))
    slow_s = sum(e - s for s, e in busy_intervals(slow)) / per
    out.update({"slow_ms": 1e3 * slow_s,
                "lateral_ms": 1e3 * sum(e - s for s, e in
                                        busy_intervals(lateral)) / per,
                "activities": [n_fwd, n_bwd, l_fwd, l_bwd],
                "flops": flops,
                "mfu": 100.0 * flops / slow_s / PEAK_FLOPS[flags["dtype"]]})
    return out


def _print(cell: str, r: Dict) -> None:
    text = (f"slowfast ({cell}): stretch L, {r['steps']} eager AV steps, "
            f"{r['slow_frames']:g} slow frames per step")
    if "slow_ms" in r:
        a = r["activities"]
        text += (f"; the slow pathway {r['slow_ms']:.3f} busy ms per step "
                 f"({a[0]} forward and {a[1]} backward activities), "
                 f"{r['flops']:.5g} FLOP, {r['mfu']:.4f} % of the peak; "
                 f"the laterals {r['lateral_ms']:.3f} ms ({a[2]} forward "
                 f"and {a[3]} backward activities)")
    print(text, flush=True)
