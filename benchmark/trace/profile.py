"""Reading a ``torch.profiler`` trace of a short steady stretch.

* busy time: the union of the device's activity intervals (kernels,
  copies, sets), so overlapping kernels count once; the idle share is
  what the stretch's wall leaves;
* each kernel bucketed by the category table below (a frozen copy of the
  port's ``tools/trace_report.CATEGORIES`` and its attribution: a kernel
  goes by the aten op that launched it, the port's ctypes kernels and
  layout conversions by name);
* the longest idle gaps, named by the innermost host op running at the
  gap's middle;
* NCCL kernel time;
* each port kernel's launches with their durations, in order.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

CATEGORIES = (
    ("frame_window", "kernel", r"frame_window_kernel"),
    ("overlap_add_normalize", "kernel", r"overlap_add_kernel"),
    ("nccl", "kernel", r"nccl"),
    ("copy/transpose", "kernel", r"nchwToNhwc|nhwcToNchw|^Memcpy"),
    ("convolution", "op", r"conv(?!ert)"),
    ("matmul", "op", r"^aten::(mm|bmm|addmm|baddbmm|_addmm_activation|"
                     r"matmul|linear|mv|dot)$"),
    ("fft", "op", r"fft"),
    ("convolution", "kernel", r"conv(?!ert)|fprop|dgrad|wgrad"),
    ("matmul", "kernel", r"gemm|cutlass|cublas"),
    ("fft", "kernel", r"fft"),
    ("copy/transpose", "kernel", r"[Tt]ranspose"),
    ("copy/transpose", "op",
     r"^aten::(copy_|_to_copy|clone|contiguous|cat|stack)$"),
    ("reduce", "kernel", r"reduce_kernel|scan|index_add|scatter"),
    ("reduce", "op", r"^aten::(sum|mean|amax|amin|max|min|argmax|argmin|prod|"
                     r"norm|linalg_vector_norm|var|std|var_mean|std_mean|"
                     r"logsumexp|cumsum|scatter\w*|index_add\w*|"
                     r"index_put\w*|\w*pool\w*|\w*batch_norm\w*)$"),
    ("fusion/elementwise", "kernel",
     r"elementwise|foreach|multi_tensor|fill|upsample|where|Memset"),
    ("fusion/elementwise", "op", r"^aten::"),
)
_RULES = tuple((cat, fld, re.compile(p)) for cat, fld, p in CATEGORIES)
TOP = 10


def categorize(kernel: str, op: Optional[str]) -> str:
    for cat, fld, pat in _RULES:
        name = kernel if fld == "kernel" else op
        if name is not None and pat.search(name):
            return cat
    return "other"


@dataclass
class Activity:
    name: str
    op: Optional[str]
    start_us: float
    end_us: float


@dataclass
class Trace:
    """The device activity and host ops of one profiled stretch."""
    device: List[Activity]
    host: List[Tuple[float, float, str]]
    wall_s: float

    def busy_intervals(self) -> List[Tuple[float, float]]:
        spans = sorted((a.start_us, a.end_us) for a in self.device)
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def category_seconds(self) -> Dict[str, float]:
        out = defaultdict(float)
        for a in self.device:
            out[categorize(a.name, a.op)] += (a.end_us - a.start_us) / 1e6
        return dict(out)

    def idle_gaps(self, longest: int = 500) -> Dict[str, float]:
        """Seconds of idle gaps by the innermost host op running at each
        gap's middle (``host: no op`` where none ran); past the
        ``longest`` gaps, the rest are summed as ``short gaps``."""
        busy = self.busy_intervals()
        gaps = sorted(((s1 - e0, (e0 + s1) / 2) for (_, e0), (s1, _)
                       in zip(busy, busy[1:])), reverse=True)
        host = sorted(self.host)
        starts = [h[0] for h in host]
        out = defaultdict(float)
        for us, mid in gaps[:longest]:
            name = "host: no op"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[i][1] >= mid:
                    name = host[i][2]
                    break
            out[name] += us / 1e6
        rest = sum(us for us, _ in gaps[longest:])
        if rest:
            out["short gaps"] += rest / 1e6
        return dict(out)

    def kernel(self, pattern: str) -> List[float]:
        """Durations in seconds of the activities whose name matches, in
        the order they started."""
        pat = re.compile(pattern)
        return [(a.end_us - a.start_us) / 1e6 for a in
                sorted(self.device, key=lambda a: a.start_us)
                if pat.search(a.name)]

    def breakdown(self) -> Dict:
        def top(d):
            return [[k, v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.category_seconds()),
                "idle_gaps": top(self.idle_gaps())}


def traced(fn, activities, dev) -> Trace:
    """Run ``fn()`` under ``torch.profiler`` with ``activities``, the card
    synchronized before and after, and read its :class:`Trace`; its wall
    is the stretch's, synchronized."""
    import time

    import torch
    from torch.profiler import profile

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
    return from_profiler(prof, wall)


def from_profiler(prof, wall_s: float) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` (of the
    CUDA activity alone, or with the CPU's ops too).  Each kernel is given
    the aten op that launched it by name and order, as the port's
    ``trace_report`` does (the profiler hands a host op the kernels its
    launch enclosed); without the CPU's ops a kernel has none."""
    from torch.autograd import DeviceType
    launched = defaultdict(list)
    host = []
    device = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if ev.device_type == DeviceType.CPU:
            if "::" in ev.name or ev.name.startswith("bench."):
                host.append((float(ev.time_range.start),
                             float(ev.time_range.end), ev.name))
            if "::" in ev.name:
                for k in ev.kernels:
                    launched[k.name].append(ev.name)
        elif ev.device_type == DeviceType.CUDA:
            device.append(Activity(ev.name, None,
                                   float(ev.time_range.start),
                                   float(ev.time_range.end)))
    seen = defaultdict(int)
    for a in device:
        ops = launched.get(a.name, [])
        if seen[a.name] < len(ops):
            a.op = ops[seen[a.name]]
        seen[a.name] += 1
    return Trace(device, host, wall_s)
