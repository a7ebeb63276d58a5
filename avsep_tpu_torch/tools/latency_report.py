"""Single-clip device latency and the service's batching knee on the card,
the port of ``tools/latency_report.py``.

1. **B = 1 device time**: bench.py's flagship separation at one clip runs
   ``--runs`` times under ``torch.profiler``; the CUDA activity (kernels,
   copies, sets) is summed per call, where the JAX tool sums the device's
   "XLA Ops" events.  The wall p50 / p95 of the same calls (synchronized,
   the wavs copied to the host) stand beside it.
2. **Batching knee**: ``serve.SeparationService`` swept over
   ``--waits`` (``max_wait_ms``) at ``--clients`` closed-loop clients; each
   point gives req/s, request p50 / p95 and the mean dynamic batch.  The
   knee is where more waiting stops buying batch and only adds latency.

The report is written after every point, so a run cut short keeps what it
measured: ``build/measure/latency_report.json`` or ``--out``.

    python -m avsep_tpu_torch.tools.latency_report [--runs 32]
        [--sweep_n 128] [--clients 16] [--max_batch 16]
        [--waits 0 2 5 10 25 50] [--skip_sweep] [--out PATH]

Runs on the GPU only; each service is closed on every exit path.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.serve import SeparationService
from avsep_tpu_torch.tools import measure
from avsep_tpu_torch.tools.bench import timed_fn


def device_ms_per_call(fn, calls: int, device: torch.device
                       ) -> Optional[float]:
    """Device ms per call of ``fn(0) .. fn(calls - 1)``: the CUDA events of
    a ``torch.profiler`` trace, summed; None on the CPU or when the trace
    holds no device event (not measured)."""
    if device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize(device)
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def b1_latency(cfg: Config, nets: engine.Nets, runs: int,
               rs: np.random.RandomState, device=None) -> Dict:
    """Part 1: wall p50 / p95 and device ms per call of a one-clip
    ``separate`` over ``runs`` distinct inputs, after one warm-up call."""
    dev = engine.nets_device(nets, device)
    fn = timed_fn(nets, cfg, dev)
    T = 1 if cfg.one_frame else cfg.num_frames
    mixes = [torch.from_numpy(
        (rs.randn(1, cfg.audLen) * 0.1).astype(np.float32)).to(dev)
        for _ in range(runs)]
    frames = [torch.from_numpy(rs.rand(
        1, cfg.num_mix, T, cfg.imgSize, cfg.imgSize, 3).astype(
            np.float32)).to(dev) for _ in range(runs)]
    fn(mixes[0], frames[0]).cpu()
    walls = []
    for i in range(runs):
        measure.synchronize(dev)
        t0 = time.perf_counter()
        fn(mixes[i], frames[i]).cpu()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    dev_ms = device_ms_per_call(lambda i: fn(mixes[i], frames[i]), runs, dev)
    return {"runs": runs, "wall_p50_ms": measure.percentile(walls, 0.50),
            "wall_p95_ms": measure.percentile(walls, 0.95),
            "device_ms_per_call": dev_ms,
            "note": "device_ms is the CUDA activity of a torch.profiler "
                    "trace per call (null: not measured); wall includes "
                    "the copy of the wavs to the host",
            # the profiled calls run on a card only
            "calls": {"separate": 1 + runs
                      + (runs if dev.type == "cuda" else 0)}}


def knee_point(cfg: Config, nets: engine.Nets, bank: np.ndarray, wait: float,
               clients: int, max_batch: int, device=None) -> Dict:
    """One point of part 2: a fresh service at ``max_wait_ms=wait``, one
    warm-up request, then ``len(bank)`` closed-loop audio-only requests."""
    svc = SeparationService(cfg, nets, max_batch=max_batch,
                            max_wait_ms=wait, device=device)
    try:
        svc.submit(bank[0]).result(timeout=measure.WAIT_S)
        wall, lats = measure.closed_loop(lambda i: svc.submit(bank[i]),
                                         len(bank), clients)
        snap = svc.stats.snapshot()
    finally:
        svc.close()
    return {"max_wait_ms": wait, "req_per_s": len(bank) / wall,
            "p50_ms": measure.percentile(lats, 0.50),
            "p95_ms": measure.percentile(lats, 0.95),
            "mean_batch": snap["mean_batch"],
            "dispatches": snap["dispatches"]}


def run(cfg: Config, nets: engine.Nets, out: str, runs: int = 32,
        sweep_n: int = 128, clients: int = 16, max_batch: int = 16,
        waits: Sequence[float] = (0.0, 2.0, 5.0, 10.0, 25.0, 50.0),
        skip_sweep: bool = False, device=None, card: str = "cpu") -> Dict:
    """Both parts, the report written to ``out`` after each milestone;
    returns it (``calls`` counts every ``separate`` call and dispatch)."""
    dev = engine.nets_device(nets, device)
    rs = np.random.RandomState(0)
    b1 = b1_latency(cfg, nets, runs, rs, dev)
    calls = b1.pop("calls")["separate"]
    report = {"card": card, "b1_separate": b1, "batching_sweep": []}
    dev_ms = b1["device_ms_per_call"]
    print(f"[{card}] B=1 separate: wall p50 {b1['wall_p50_ms']:.2f} ms, "
          "device " + (f"{dev_ms:.3f} ms/call" if dev_ms is not None
                       else "not measured"), flush=True)
    measure.write_json(report, out)
    if not skip_sweep:
        bank = rs.randn(sweep_n, cfg.audLen).astype(np.float32) * 0.1
        for wait in waits:
            pt = knee_point(cfg, nets, bank, wait, clients, max_batch, dev)
            calls += pt["dispatches"]
            report["batching_sweep"].append(pt)
            measure.write_json(report, out)
            print(f"[{card}] wait {wait:5.1f} ms: {pt['req_per_s']:6.1f} "
                  f"req/s  p50 {pt['p50_ms']:6.1f}  p95 {pt['p95_ms']:6.1f}"
                  f"  mean batch {pt['mean_batch']:.1f}", flush=True)
    print(f"report written to {out}")
    return {**report, "calls": {"separate": calls}}


def main(argv=None, device=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=32)
    ap.add_argument("--sweep_n", type=int, default=128,
                    help="requests per sweep point")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--waits", type=float, nargs="*",
                    default=[0.0, 2.0, 5.0, 10.0, 25.0, 50.0])
    ap.add_argument("--skip_sweep", action="store_true")
    ap.add_argument("--out", default=None,
                    help="report path (default build/measure/"
                         "latency_report.json)")
    args = ap.parse_args(argv)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship()
    nets = measure.seeded_nets(cfg, dev)
    return run(cfg, nets, measure.report_path(args.out,
                                              "latency_report.json"),
               runs=args.runs, sweep_n=args.sweep_n, clients=args.clients,
               max_batch=args.max_batch, waits=args.waits,
               skip_sweep=args.skip_sweep, device=dev, card=card)


if __name__ == "__main__":
    engine.full_float32()
    main()
