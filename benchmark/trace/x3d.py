"""X3D-M's channelwise convolutions and squeeze-excitation gates in a
``--trace 1`` run of a cell whose motion net is ``--arch_motion x3d_m``:
**stretch X**.

The readers of ``motion_channelwise.device_ms``,
``motion_channelwise_roofline`` and ``motion_se.device_ms`` call
:func:`readings`.  Once per process, after stretch M (``trace/motion.py``,
which runs stretches S and A first) is done and has freed its instance,
it builds another instance of the cell's program from the run's
``--workload`` and ``--seed``, wraps its nets in
``train.make_eager_train_step``, warms :data:`WARM` AV steps, then profiles
:data:`STEPS` AV steps with the span recorder on, tracing the host's ops
and the card: stretch M's rule (``motion.motion_activities``), called with
the spans ``motion.channelwise`` (each channelwise convolution with its
BatchNorm, the stem's 5x1x1 included) and ``motion.se`` (each block's gate
with the swish after it) in place of ``train.motion``.  The union of each
span's kernels' intervals, per AV step, is its ``device_ms``.  The
channelwise convolutions' bytes are ``counts.x3d.channelwise`` (three
passes, each activation once) for the ``motion.clips`` counted per AV
step, and their least time at 3.35 TB/s over ``channelwise_ms`` is the
roofline share: the span holds each convolution's BatchNorm too, so the
share reads the BatchNorm's time against the convolutions' bytes alone.

A program without the spans, a cell whose motion net is no X3D, a run on
several cards or a process that is no benchmark run gives no readings; a
CPU run counts the clips and has no card to trace.
"""

from __future__ import annotations

import gc
import sys
from typing import Dict, Optional, Tuple

CHANNELWISE = "motion.channelwise"
SE = "motion.se"
COUNTER = "motion.clips"
WARM = 2            # eager AV steps before the stretch
STEPS = 6           # profiled AV steps

_done: Dict[Tuple[str, int], Optional[Dict]] = {}


def readings(reading: Dict) -> Optional[Dict]:
    """Stretch X's readings of this process's run, measured at the first
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


def _x3d(flags: Dict) -> bool:
    return bool(flags.get("load_clips")) and \
        flags.get("arch_motion") == "x3d_m"


def _measure(workload: str, seed: int) -> Optional[Dict]:
    from benchmark import harness
    cell = harness.find_cell(workload)
    if cell.chips != 1 or not _x3d(cell.config["flags"]):
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
    """Stretch X's readings from its trace and span records: ``clips`` per
    AV step and, where the card's activities were traced,
    ``channelwise_ms``, ``se_ms``, the channelwise convolutions' ``bytes``
    per AV step and ``roofline``; None where the trace holds no
    ``motion.channelwise`` span."""
    from benchmark.counts import bytes as kbytes
    from benchmark.counts import x3d as kx3d
    from benchmark.trace.motion import motion_activities
    from benchmark.trace.spans import busy_intervals
    if not any(o.name == CHANNELWISE for o in ops):
        return None
    steps = [r for r in records if r.name == "train.step"]
    per = max(1, len(steps))
    clips = sum(r.counts.get(COUNTER, 0) for r in records) / per
    out: Dict = {"steps": len(steps), "clips": clips}
    cw, c_fwd, c_bwd = motion_activities(ops, device, span=CHANNELWISE)
    se, s_fwd, s_bwd = motion_activities(ops, device, span=SE)
    if not cw:
        return out
    img, t = flags["imgSize"], flags["clip_len"]
    n_bytes = kx3d.channelwise(1, t, img, img,
                               kx3d.itemsize(flags["dtype"])) * clips
    cw_s = sum(e - s for s, e in busy_intervals(cw)) / per
    out.update({"channelwise_ms": 1e3 * cw_s,
                "se_ms": 1e3 * sum(e - s for s, e in
                                   busy_intervals(se)) / per,
                "activities": [c_fwd, c_bwd, s_fwd, s_bwd],
                "bytes": n_bytes,
                "roofline": 100.0 * kbytes.least_seconds(n_bytes) / cw_s})
    return out


def _print(cell: str, r: Dict) -> None:
    text = (f"x3d ({cell}): stretch X, {r['steps']} eager AV steps, "
            f"{r['clips']:g} clips per step")
    if "channelwise_ms" in r:
        a = r["activities"]
        text += (f"; the channelwise convolutions with their BatchNorms "
                 f"{r['channelwise_ms']:.3f} busy ms per step ({a[0]} "
                 f"forward and {a[1]} backward activities), the "
                 f"convolutions' {r['bytes']:.5g} bytes at "
                 f"{r['roofline']:.4f} % of their roofline; the gates and "
                 f"swishes {r['se_ms']:.3f} ms ({a[2]} forward and {a[3]} "
                 f"backward activities)")
    print(text, flush=True)
