"""Serving benchmark: sustained request throughput and latency on the card,
the port of ``tools/serve_bench.py``.

Drives ``serve.SeparationService`` (bench.py's flagship model, seeded
``engine.init_params`` weights) with ``--clients`` closed-loop client
threads, each submitting a distinct mixture (``RandomState(0)``) and
waiting for its wavs before the next, after one warm-up request.  Reports
requests/s, the mean dynamic batch, dispatches, request p50 / p95 and the
dispatch p50: the deployment path (host audio per request, dynamic
batches formed from concurrent clients, one copy each way per dispatch),
where ``bench`` is the device pipeline alone.

    python -m avsep_tpu_torch.tools.serve_bench [--n 256] [--clients 8]
        [--max_batch 16] [--max_wait_ms 10] [--wire f32|int16] [--av]
        [--frames_wire f32|u8]

Runs on the GPU only; the service is closed on every exit path.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.serve import SeparationService
from avsep_tpu_torch.tools import measure


def run(cfg: Config, nets: engine.Nets, n: int = 256, clients: int = 8,
        max_batch: int = 16, max_wait_ms: float = 10.0, wire: str = "f32",
        av: bool = False, frames_wire: str = "f32", device=None) -> Dict:
    """One closed-loop run against a fresh service; returns the summary
    (``calls`` counts the service's dispatches, the warm-up's included)."""
    svc = SeparationService(cfg, nets, max_batch=max_batch,
                            max_wait_ms=max_wait_ms, wire=wire,
                            frames_wire=frames_wire, device=device)
    try:
        rs = np.random.RandomState(0)
        # distinct mixtures per request; AV: one distinct uint8 frame set
        # per request (the f32 frames wire converts at submit)
        mix_bank = rs.randn(n, cfg.audLen).astype(np.float32) * 0.1
        frame_bank = (rs.randint(0, 256, size=(n,) + svc.frames_shape,
                                 dtype=np.uint8) if av else None)

        def submit(i):
            return svc.submit(mix_bank[i], frames=None if frame_bank is None
                              else frame_bank[i])

        submit(0).result(timeout=measure.WAIT_S)  # warm-up
        wall, lats = measure.closed_loop(submit, n, clients)
        snap = svc.stats.snapshot()
    finally:
        svc.close()
    return {"requests": n, "clients": clients, "max_batch": max_batch,
            "max_wait_ms": max_wait_ms, "wire": wire,
            "mode": "AV" if av else "AO",
            "frames_wire": frames_wire if av else None, "wall_s": wall,
            "req_per_s": n / wall, "mean_batch": snap["mean_batch"],
            "dispatches": snap["dispatches"],
            "request_p50_ms": measure.percentile(lats, 0.50),
            "request_p95_ms": measure.percentile(lats, 0.95),
            "dispatch_p50_ms": snap["p50_ms"],
            "calls": {"separate": snap["dispatches"]}}


def summary(r: Dict, card: str) -> str:
    """The JAX tool's printed summary, with the card."""
    return "\n".join([
        f"card: {card}",
        f"requests: {r['requests']}  clients: {r['clients']}  "
        f"max_batch: {r['max_batch']}  wall: {r['wall_s']:.2f}s  "
        f"mode: {r['mode']}"
        + (f"  frames_wire: {r['frames_wire']}" if r["mode"] == "AV"
           else ""),
        f"throughput: {r['req_per_s']:.1f} req/s "
        f"(= clips/s; {r['req_per_s'] * 60:.0f} clips/min)",
        f"mean dynamic batch: {r['mean_batch']:.2f}  "
        f"dispatches: {r['dispatches']}",
        f"request latency p50/p95: {r['request_p50_ms']:.1f} / "
        f"{r['request_p95_ms']:.1f} ms  (dispatch p50 "
        f"{r['dispatch_p50_ms']:.1f} ms)"])


def main(argv=None, device=None) -> Dict:
    """Parse the JAX tool's flags, run, print the summary; returns it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=256, help="total requests")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--max_wait_ms", type=float, default=10.0)
    ap.add_argument("--wire", default="f32", choices=["f32", "int16"])
    ap.add_argument("--av", action="store_true",
                    help="visually-guided requests (frames attached)")
    ap.add_argument("--frames_wire", default="f32", choices=["f32", "u8"])
    args = ap.parse_args(argv)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship()
    nets = measure.seeded_nets(cfg, dev)
    r = run(cfg, nets, n=args.n, clients=args.clients,
            max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
            wire=args.wire, av=args.av, frames_wire=args.frames_wire,
            device=dev)
    print(summary(r, card), flush=True)
    return {**r, "card": card}


if __name__ == "__main__":
    engine.full_float32()
    main()
