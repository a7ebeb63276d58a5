"""Profiler breakdown of the flagship AV train step on the card, the port of
``tools/trace_report.py``.

The step is the JAX tool's flagship (``:118-124``; ``measure.flagship``)
through the port's production step as the host dispatches it launch by
launch, ``train.make_eager_train_step(cfg, nets, use_vis=True)`` (the
CUDA graph of ``make_train_step`` would hide each launch's host side).
Its batch is drawn on the card inside the step from a
seeded device ``torch.Generator``, as the JAX tool draws its batch inside
the jitted step (``:137-145``), so the draw's device time counts alike:
``audios`` ``0.1 * N(0, 1)`` ``[B, 2, audLen]``, ``frames`` uniform in
[0, 1) ``[B, 2, 1, 224, 224, 3]``.  One warm-up step runs first (the
counterpart of the JAX tool's compile + first: cuDNN's algorithm choice,
the kernel libraries' load), then ``n_steps`` steps under
``torch.profiler`` with the CPU and CUDA activities.

Where XLA hides its heavy ops behind fusion names and the JAX tool resolves
them from the HLO, eager torch names each kernel and the aten op that
launched it: each CUDA kernel event is attributed to its launching op
(:func:`kernel_records`; the report's ``contains`` holds that op where the
JAX report holds a fusion's heavy kinds) and bucketed by :data:`CATEGORIES`
into the JAX tool's categories.  The port's own kernels are launched
through ``ctypes``, so no aten op launches them: they are matched by kernel
name and each gets a bucket of its own, named after the kernel, which the
report's ``port_kernels`` reads.

:func:`aggregate` turns plain event records into the report: the JAX
report's keys (``:198-209``) plus ``port_kernels`` (ms per step and
launches of each kernel; ``launches_counted`` is its wrapper's counter over
the profiled steps) and ``card`` (nvidia-smi's name and power limit).

    python -m avsep_tpu_torch.tools.trace_report [batch] [n_steps] [dtype]
        [dft] [--out PATH]

(the JAX tool's argv: defaults 32, 8, float32, fft).  Writes
``build/measure/trace_report[_<dtype>_<dft>].json`` (the JAX tool's tag
rule) or ``--out``.  Runs on the GPU only; on the CPU it refuses with the
JAX tool's reason, as there is no device event to read.
"""

from __future__ import annotations

import argparse
import re
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import torch

from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.tools import measure

TOP_K = 12
WARMUP = 1
# the port's kernels: report bucket -> the CUDA kernel's name in its source
PORT_KERNELS = {"frame_window": "frame_window_kernel",
                "overlap_add_normalize": "overlap_add_kernel"}
NO_DEVICE_EVENTS = (
    "no device-op events found in the trace (no CUDA kernel event: running "
    "on the CPU? trace_report needs a card; use tools.mfu_report for "
    "platform-independent numbers)")

# Name -> category rules in order, the first match wins: (category, field,
# pattern), the field being the kernel's name or its launching aten op
# (None for a kernel no op launched).  The port's kernels and the layout
# conversions go by kernel name whatever launched them; then the heavy ops
# by the op that launched them (a cuDNN convolution's kernels are
# implicit GEMMs, FFTs and pointwise products); then by kernel name;
# BatchNorm counts as a reduction, as the JAX tool files a fusion by the
# heaviest op it contains; what is left of an aten op is elementwise work,
# as XLA's non-heavy fusions are.
CATEGORIES = (
    ("frame_window", "kernel", r"frame_window_kernel"),
    ("overlap_add_normalize", "kernel", r"overlap_add_kernel"),
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
     r"elementwise|foreach|multi_tensor|fill|upsample|where"),
    ("fusion/elementwise", "op", r"^aten::"),
)
_RULES = tuple((cat, field, re.compile(p)) for cat, field, p in CATEGORIES)


class KernelRecord(NamedTuple):
    """One device activity of a trace: the kernel's (or copy's) name, the
    aten op that launched it (None: no op did), its duration in µs."""
    kernel: str
    op: Optional[str]
    us: float


def categorize(kernel: str, op: Optional[str]) -> str:
    """The category of a kernel launched by ``op`` under :data:`CATEGORIES`;
    ``other`` when no rule matches."""
    for cat, field, pat in _RULES:
        name = kernel if field == "kernel" else op
        if name is not None and pat.search(name):
            return cat
    return "other"


def kernel_records(prof) -> List[KernelRecord]:
    """The CUDA activities of a finished ``torch.profiler.profile``, each
    with the op that launched it: the profiler hands every CPU op the
    kernels whose launch it enclosed innermost (``FunctionEvent.kernels``).
    Only ops (``aten::mm``, ``c10d::...``: a name with ``::``) count as
    launchers; a marker such as CUPTI's ``Command Buffer Full`` that
    shares its op's correlation is skipped.  The CUDA events of a name
    beyond those (a ``ctypes`` launch) get no op, with the rest of that
    name's time shared evenly."""
    from torch.autograd import DeviceType
    linked = defaultdict(list)
    device = defaultdict(list)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and "::" in ev.name:
            for k in ev.kernels:
                linked[k.name].append((ev.name, float(k.duration)))
        elif ev.device_type == DeviceType.CUDA:
            device[ev.name].append(float(ev.time_range.elapsed_us()))
    out = []
    for name, durs in device.items():
        ops = linked.get(name, [])[:len(durs)]
        out += [KernelRecord(name, op, us) for op, us in ops]
        rest = len(durs) - len(ops)
        if rest:
            us = max(0.0, sum(durs) - sum(us for _, us in ops)) / rest
            out += [KernelRecord(name, None, us)] * rest
    return out


def aggregate(records: Iterable[KernelRecord], n_steps: int, wall_s: float,
              top_k: int = TOP_K) -> Dict:
    """The JAX report's keys from ``records`` of ``n_steps`` steps that took
    ``wall_s`` seconds: wall and device-busy ms per step, the busy share of
    the wall, each category's share of the busy time (descending), the
    ``top_k`` kernels by time (``op``: the kernel, ``contains``: the aten
    ops that launched it, None if none), and ``port_kernels``.  Raises with
    the JAX tool's reason when no record has any time."""
    records = list(records)
    total_us = sum(r.us for r in records)
    if total_us <= 0:
        raise RuntimeError(NO_DEVICE_EVENTS)
    per_cat = defaultdict(float)
    per_kernel = defaultdict(float)
    ops_of = defaultdict(set)
    launches = defaultdict(int)
    for r in records:
        cat = categorize(r.kernel, r.op)
        per_cat[cat] += r.us
        per_kernel[r.kernel] += r.us
        if r.op is not None:
            ops_of[r.kernel].add(r.op)
        launches[cat] += 1
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:top_k]
    return {
        "n_steps": n_steps,
        "wall_ms_per_step": wall_s / n_steps * 1e3,
        "device_busy_ms_per_step": total_us / n_steps / 1e3,
        "device_busy_frac_of_wall": (total_us / 1e6) / wall_s,
        "category_pct": {k: 100.0 * v / total_us
                         for k, v in sorted(per_cat.items(),
                                            key=lambda kv: -kv[1])},
        "top_ops_pct": [
            {"op": name, "pct": 100.0 * us / total_us,
             "ms_per_step": us / n_steps / 1e3,
             "contains": sorted(ops_of[name]) or None}
            for name, us in top],
        "port_kernels": {
            k: {"ms_per_step": per_cat.get(k, 0.0) / n_steps / 1e3,
                "launches": launches.get(k, 0)}
            for k in PORT_KERNELS},
    }


def draw_batch(cfg: Config, batch: int, generator: torch.Generator,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """The JAX tool's in-step draws on ``device``: ``audios`` then
    ``frames``, from ``generator`` (a generator of that device)."""
    return {"audios": 0.1 * torch.randn(batch, cfg.num_mix, cfg.audLen,
                                        generator=generator, device=device),
            "frames": torch.rand(batch, cfg.num_mix, 1, cfg.imgSize,
                                 cfg.imgSize, 3, generator=generator,
                                 device=device)}


def drawing_step(cfg: Config, state: train.TrainState, batch: int,
                 seed: int = 1, device=None) -> Callable[[], Dict]:
    """A call that draws a batch (:func:`draw_batch`, a device generator
    seeded with ``seed``) and runs one AV step of
    ``train.make_train_step`` on ``state`` (in place); returns the step's
    metrics."""
    dev = engine.nets_device(state.nets, device)
    step = train.make_eager_train_step(cfg, state.nets, use_vis=True,
                                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def one() -> Dict:
        return step(state, draw_batch(cfg, batch, gen, dev))[1]

    return one


def profile_steps(one: Callable[[], Dict], n_steps: int,
                  device: torch.device):
    """``n_steps`` calls of ``one`` under ``torch.profiler`` with the CPU and
    CUDA activities, a synchronized host clock around them; returns their
    :func:`kernel_records`, the wall seconds and each port kernel's
    launches as its wrapper counted them over the same calls."""
    from torch.profiler import ProfilerActivity, profile
    measure.synchronize(device)
    counted0 = {k: getattr(kernels, k).launches for k in PORT_KERNELS}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            one()
        measure.synchronize(device)
        wall = time.perf_counter() - t0
    counted = {k: getattr(kernels, k).launches - counted0[k]
               for k in PORT_KERNELS}
    return kernel_records(prof), wall, counted


def make_report(cfg: Config, batch: int, n_steps: int,
                records: Iterable[KernelRecord], wall_s: float,
                counted: Dict[str, int], card: str, top_k: int = TOP_K
                ) -> Dict:
    """The report of ``n_steps`` profiled steps: :func:`aggregate` with the
    JAX report's ``batch``, ``dtype`` and ``dft``, each port kernel's
    ``launches_counted``, the ``card`` and the ``calls`` made (the warm-up
    and the profiled steps)."""
    r = {"batch": batch, "n_steps": n_steps, "dtype": cfg.dtype,
         "dft": cfg.dft, **aggregate(records, n_steps, wall_s, top_k)}
    for k, v in r["port_kernels"].items():
        v["launches_counted"] = counted[k]
    r.update(card=card, calls={"train_step": WARMUP + n_steps})
    return r


def run(cfg: Config, state: train.TrainState, batch: int, n_steps: int,
        device=None, card: str = "cpu", top_k: int = TOP_K) -> Dict:
    """:data:`WARMUP` steps, then ``n_steps`` profiled steps of
    :func:`drawing_step` on ``state`` (in place); returns the report.
    Refuses a CPU device: there is no device event to read."""
    dev = engine.nets_device(state.nets, device)
    if dev.type != "cuda":
        raise RuntimeError(NO_DEVICE_EVENTS)
    one = drawing_step(cfg, state, batch, device=dev)
    for _ in range(WARMUP):
        one()
    records, wall, counted = profile_steps(one, n_steps, dev)
    return make_report(cfg, batch, n_steps, records, wall, counted, card,
                       top_k)


def print_report(r: Dict) -> None:
    print(f"\n[{r['card']}] wall {r['wall_ms_per_step']:.1f} ms/step, "
          f"device busy {r['device_busy_ms_per_step']:.1f} ms/step "
          f"({100 * r['device_busy_frac_of_wall']:.0f}% of wall)")
    print("== device time by category ==")
    for k, v in r["category_pct"].items():
        print(f"  {k:22s} {v:5.1f}%")
    print(f"== top {len(r['top_ops_pct'])} kernels ==")
    for row in r["top_ops_pct"]:
        inside = (" [" + ",".join(row["contains"]) + "]"
                  if row["contains"] else "")
        print(f"  {row['pct']:5.1f}%  {row['ms_per_step']:7.3f} ms  "
              f"{row['op'][:100]}{inside}")
    for k, v in r["port_kernels"].items():
        print(f"  {k}: {v['ms_per_step']:.5f} ms/step, {v['launches']} "
              f"launches ({v['launches_counted']} counted)")


def main(argv=None, device=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("n_steps", type=int, nargs="?", default=8)
    ap.add_argument("dtype", nargs="?", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("dft", nargs="?", default="fft",
                    choices=["fft", "matmul"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship(dtype=args.dtype, dft=args.dft)
    state = train.init_state(cfg, engine.build_nets(cfg, device=dev),
                             torch.Generator().manual_seed(0), device=dev)
    r = run(cfg, state, args.batch, args.n_steps, device=dev, card=card)
    print_report(r)
    tag = "" if (args.dtype, args.dft) == ("float32", "fft") else \
        f"_{args.dtype}_{args.dft}"
    out = measure.report_path(args.out, f"trace_report{tag}.json")
    measure.write_json(r, out)
    print(f"report written to {out}")
    return r


if __name__ == "__main__":
    engine.full_float32()
    main()
