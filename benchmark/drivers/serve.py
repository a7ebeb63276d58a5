"""The serving driver: the port's TCP separation server under open-loop
load from clients in a process of their own.

Traffic parameters (``benchmark/traffic/<mix>.json``): ``rate_per_s``,
the offered load; ``av_share``, the share of requests that carry frames;
the service's knobs ``max_batch``, ``max_wait_ms``, ``wire``,
``frames_wire``; ``clients``, the connections the load generator keeps
open; ``warm_rounds``; ``check_requests``, how many answered requests the
reference checks; ``trace_seconds``, the profiled stretch.

Set-up starts ``serve.SeparationService`` over the configuration's nets in
its serving precision with the benchmark's seeded weights, and
``serve.SeparationServer`` on a loopback port, as ``python -m
avsep_tpu_torch.serve`` does.  The load generator (a spawned process, so
its threads do not share the server's interpreter lock) makes the
requests from the seed: mixtures of two seeded clips of ``audLen``
samples, and for a visual request both sources' frames as float RGB.  It
warms both dispatch groups, then sends ``rate_per_s x seconds`` requests
on an open-loop schedule: the arrival gaps are the same set of
exponential quantiles for every seed, in a seeded order, and so is the
half-and-half split of visual and audio-only requests.  A request's
latency runs from when it was due to when its reply was read, so a stall
shows in every request behind it.  Every request due in the window is
waited for, up to a minute past the close.

The reference then separates a seeded sample of the answered requests
from the same inputs and weights; an audio-only answer is held against
both orders of the service's random slot swap.
"""

from __future__ import annotations

import json
import math
import multiprocessing as mp
import queue
import struct
import threading
import time
from typing import Dict

import numpy as np

from benchmark import checks, data, harness, weights
from benchmark.counts import bytes as kbytes
from benchmark.counts import flops as kflops
from benchmark.harness import Cell, Check, Outcome

HOST = "127.0.0.1"
PEAK_FLOPS = {"float32": 67e12}      # H100 SXM, dense, without TF32
LATE_WAIT_S = 60.0


def serve_flags(config: Dict) -> Dict:
    return {**config["flags"], **config.get("serve_flags", {})}


# ------------------------------------------------------------- requests


class Requests:
    """The seeded inputs of a run, made on the host with numpy: a pool of
    clips (``benchmark/data.py``'s tones, drawn with numpy here) and, per
    request, a mixture of two of them and, for a visual request, their
    frames."""

    def __init__(self, flags: Dict, traffic: Dict, seed: int,
                 n_requests: int):
        import torch
        g = torch.Generator().manual_seed(harness.sub_seed(seed, 5))
        pool = data.make_pool(int(traffic["pool_clips"]), flags["audLen"],
                              flags["audRate"], flags["imgSize"], g, "cpu")
        self.audio = pool["audio"].numpy()
        self.frames = pool["frames"].numpy()
        rng = np.random.default_rng(harness.sub_seed(seed, 6))
        n = n_requests
        q = (np.arange(n) + 0.5) / n
        self.gaps = rng.permutation(-np.log1p(-q)) / traffic["rate_per_s"]
        n_av = int(round(traffic["av_share"] * n))
        self.visual = rng.permutation(np.arange(n) < n_av)
        first = rng.integers(0, len(self.audio), n)
        self.pairs = np.stack([first, (first + rng.integers(
            1, len(self.audio), n)) % len(self.audio)], 1)
        self.checked = np.sort(rng.choice(
            n, min(n, int(traffic["check_requests"])), replace=False))
        self.frame_bytes = [(f.astype(np.float32) / 255.0).tobytes()
                            for f in self.frames]

    def mix(self, k: int) -> np.ndarray:
        a, b = self.pairs[k % len(self.pairs)]
        return ((self.audio[a] + self.audio[b]) / 2).astype(np.float32)

    def frames_of(self, k: int):
        """``[N, 1, H, W, 3]`` float32 RGB in [0, 1], or None."""
        if not self.visual[k % len(self.visual)]:
            return None
        a, b = self.pairs[k % len(self.pairs)]
        f = np.stack([self.frames[a], self.frames[b]])[:, None]
        return f.astype(np.float32) / 255.0


# --------------------------------------------------- the load generator


class Client:
    """One connection speaking the service's wire protocol (``serve.py``:
    a uint32 header length, a JSON header, the raw payload) with its
    pieces sent as they are and the reply read into one buffer, so the
    client's own copies stay out of the round trip it times."""

    def __init__(self, port: int, reqs: Requests):
        import socket
        self.sock = socket.create_connection((HOST, port),
                                             timeout=harness.WAIT_S)
        self.reqs = reqs

    def close(self) -> None:
        self.sock.close()

    def _read(self, n: int) -> memoryview:
        buf = memoryview(bytearray(n))
        got = 0
        while got < n:
            m = self.sock.recv_into(buf[got:], n - got)
            if not m:
                raise ConnectionError("the server closed mid-message")
            got += m
        return buf

    def separate(self, k: int) -> np.ndarray:
        reqs = self.reqs
        mix = reqs.mix(k)
        parts = [mix.tobytes()]
        header = {"op": "separate", "n": int(mix.size)}
        if reqs.visual[k % len(reqs.visual)]:
            a, b = reqs.pairs[k % len(reqs.pairs)]
            parts += [reqs.frame_bytes[a], reqs.frame_bytes[b]]
            header.update({"frames_shape": [2, 1] + list(
                reqs.frames.shape[1:]), "frames_dtype": "f32"})
        header["payload_bytes"] = sum(len(p) for p in parts)
        hj = json.dumps(header).encode()
        self.sock.sendall(struct.pack("<I", len(hj)) + hj)
        for p in parts:
            self.sock.sendall(p)
        (hlen,) = struct.unpack("<I", self._read(4))
        rh = json.loads(bytes(self._read(hlen)))
        if not rh.get("ok"):
            raise RuntimeError(f"server error: {rh.get('error')}")
        body = self._read(int(rh["payload_bytes"]))
        return np.frombuffer(body, np.float32).reshape(rh["shape"])


def _run_schedule(clients, offsets: np.ndarray, keep: set):
    """Send request ``i`` at ``offsets[i]`` seconds from now on a free
    connection; returns per request ``(due, sent, done, ok)`` in seconds
    from the start, and the replies of the requests in ``keep``."""
    n = len(offsets)
    todo: "queue.Queue" = queue.Queue()
    rec = [None] * n
    replies = {}
    lock = threading.Lock()
    t0 = time.perf_counter() + 0.05

    def worker(client):
        while True:
            k = todo.get()
            if k is None:
                return
            sent = time.perf_counter() - t0
            try:
                wav = client.separate(k)
                ok = bool(np.isfinite(wav).all())
            except (OSError, RuntimeError, ValueError):
                wav, ok = None, False
            done = time.perf_counter() - t0
            with lock:
                rec[k] = (float(offsets[k]), sent, done, ok)
                if k in keep and wav is not None:
                    replies[k] = wav.copy()

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in clients]
    for t in threads:
        t.start()
    for i in range(n):
        wait = t0 + offsets[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        todo.put(i)
    for _ in threads:
        todo.put(None)
    close = t0 + offsets[-1] + LATE_WAIT_S if n else t0
    for t in threads:
        t.join(max(0.0, close - time.perf_counter()))
    return rec, replies


def loadgen(conn, flags: Dict, traffic: Dict, seed: int,
            seconds: float, trace: bool) -> None:
    """The client process: its requests (made while the server sets up),
    connections once the server's port comes, warm-up, the window and,
    when asked, the traced stretch; results go back through ``conn``."""
    n = int(round(traffic["rate_per_s"] * seconds))
    reqs = Requests(flags, traffic, seed, n)
    port = conn.recv()
    clients = [Client(port, reqs) for _ in range(int(traffic["clients"]))]
    try:
        for r in range(int(traffic["warm_rounds"])):
            for k in range(len(reqs.visual)):      # one of each group
                if bool(reqs.visual[k]) == bool(r % 2):
                    clients[0].separate(k)
                    break
        conn.send(("ready", None))
        conn.recv()                                # the server's snapshot
        offsets = np.cumsum(reqs.gaps)
        offsets = offsets - offsets[0]
        t_wall = time.time()
        rec, replies = _run_schedule(clients, offsets,
                                     set(reqs.checked.tolist()))
        conn.send(("window", {"t_wall": t_wall, "rec": rec,
                              "replies": replies}))
        if trace:
            conn.recv()
            m = int(round(traffic["rate_per_s"] * traffic["trace_seconds"]))
            rec2, _ = _run_schedule(clients, offsets[:m], set())
            conn.send(("trace", {"rec": rec2}))
    finally:
        for c in clients:
            c.close()


# ---------------------------------------------------------------- the run


def _port_cfg(config: Dict):
    from avsep_tpu_torch.config import Config
    flags = {k: tuple(v) if isinstance(v, list) else v
             for k, v in serve_flags(config).items()}
    return Config(**flags)


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    import gc

    import torch

    from avsep_tpu_torch import engine, serve
    from avsep_tpu_torch.ops import kernels
    from benchmark.drivers.train import device_of, sync
    from benchmark.reference import music_hidsep as ref
    from benchmark.reference.nets import Precision, tf32

    engine.full_float32()            # serve.py's __main__
    traffic, flags = cell.traffic, serve_flags(cell.config)
    ctx = mp.get_context("spawn")
    here, there = ctx.Pipe()
    gen = ctx.Process(target=loadgen, name="loadgen",
                      args=(there, flags, traffic, seed, seconds, trace))
    gen.start()
    server = svc = None
    try:
        cfg = _port_cfg(cell.config)
        dev = engine.resolve_device(device)
        nets = engine.build_nets(cfg, device=dev)
        by_name = {"sound": nets.sound, "frame": nets.frame}
        init = weights.make(
            by_name, torch.Generator(device=dev).manual_seed(
                harness.sub_seed(seed, 0)), dev,
            cell.config.get("serve_weights", "reference"))
        weights.load(by_name, init)
        svc = serve.SeparationService(
            cfg, nets, max_batch=int(traffic["max_batch"]),
            max_wait_ms=float(traffic["max_wait_ms"]),
            rng_seed=harness.sub_seed(seed, 4) % (2 ** 31),
            wire=traffic["wire"], frames_wire=traffic["frames_wire"],
            device=dev)
        server = serve.serve_forever(svc, HOST, 0)
        here.send(server.server_address[1])
        here.recv()                                    # warmed
        sync(dev)
        s0 = svc.stats.snapshot()
        lat0 = len(svc.stats.latencies_ms)
        rows0 = svc.stats.batched_rows
        here.send("go")
        _, win = here.recv()
        s1 = svc.stats.snapshot()
        with svc.stats.lock:
            disp = list(svc.stats.latencies_ms[lat0:])
            rows = svc.stats.batched_rows - rows0
        dispatches = s1["dispatches"] - s0["dispatches"]
        reading = {"kind": "serve"}
        if trace:
            from torch.profiler import ProfilerActivity, profile
            from benchmark.trace import profile as tprof
            sync(dev)
            oa0 = kernels.overlap_add_normalize.launches
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                here.send("trace")
                _, tr_rec = here.recv()
                sync(dev)
                wall = time.perf_counter() - t1
            tr = tprof.from_profiler(prof, wall)
            oa = tr.kernel(r"overlap_add_kernel")
            B, N = int(traffic["max_batch"]), cfg.num_mix
            T = 1 + cfg.audLen // cfg.stft_hop
            reading.update({
                "busy_s": tr.busy_s, "window_s": wall,
                "overlap_add_s": sum(oa), "overlap_add_launches": len(oa),
                "overlap_add_counted":
                    kernels.overlap_add_normalize.launches - oa0,
                "overlap_add_bound_s": len(oa) * kbytes.least_seconds(
                    kbytes.overlap_add(B * N, T, cfg.stft_frame,
                                       cfg.stft_hop))})
            breakdown = tr.breakdown()
            del prof, tr
        gen.join(harness.WAIT_S)
    finally:
        if gen.is_alive():
            gen.terminate()
            gen.join()
        if server is not None:
            server.shutdown()
            server.server_close()
        if svc is not None:
            svc.close()
    peak = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    rec = win["rec"]
    done = [r for r in rec if r is not None]
    failed = len(rec) - sum(1 for r in done if r[3])
    lats = sorted(1e3 * (r[2] - r[0]) for r in done if r[3])
    late = sorted(r[1] - r[0] for r in done)
    ends = max((r[2] for r in done), default=0.0)
    setup_s = win["t_wall"] - t_start
    reqs = Requests(flags, traffic, seed, len(rec))
    n_vis = sum(1 for k, r in enumerate(rec)
                if r is not None and r[3] and reqs.visual[k])
    print(f"window: {len(rec)} requests offered at "
          f"{traffic['rate_per_s']} /s over {seconds} s, {len(done)} "
          f"answered, {failed} failed, the last at {ends:.3f} s; generator "
          f"late p50 {1e3 * harness.percentile(late, 0.5):.3f} ms, max "
          f"{1e3 * late[-1]:.3f} ms; {dispatches} dispatches, "
          f"{rows} rows", flush=True)

    # ---- the reference, once the program is freed
    del svc, server, nets, by_name
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    gaps = []
    P = Precision(flags["dtype"])
    with tf32(False):
        for k in reqs.checked.tolist():
            if k not in win["replies"]:
                gaps.append(math.inf)
                continue
            mix = torch.from_numpy(reqs.mix(k))[None].to(dev)
            fr = reqs.frames_of(k)
            got = torch.from_numpy(win["replies"][k])
            if fr is not None:
                want = ref.separate(init, mix, torch.from_numpy(fr)[None]
                                    .to(dev), None, flags, P)[0].cpu()
                gaps.append(checks.wav_gap(got, want))
            else:
                gaps.append(min(checks.wav_gap(got, ref.separate(
                    init, mix, None, torch.tensor([u]), flags, P)[0].cpu())
                    for u in (0.25, 0.75)))
    flops = (n_vis * kflops.separate(flags, 1, True)
             + (len(done) - n_vis) * kflops.separate(flags, 1, False))
    quarter = max(1, len(done) // 4)
    by_due = sorted(done)
    p95 = [harness.percentile(sorted(r[2] - r[0] for r in part), 0.95)
           for part in (by_due[:quarter], by_due[-quarter:])]
    reading.update({
        "last_done_s": ends, "p95_first_last_quarter_ms":
        [1e3 * p95[0], 1e3 * p95[1]],
        "dispatch_p50_ms": harness.percentile(sorted(disp), 0.5)
        if disp else None,
        "mean_batch": rows / dispatches if dispatches else None,
        "mfu": 100.0 * flops / (sum(disp) / 1e3) / PEAK_FLOPS["float32"]
        if disp else None})
    out = Outcome(
        attempted=len(rec), failed=failed,
        e2e={"serve_req_per_s": sum(1 for r in done if r[3]
                                    and r[2] <= seconds) / seconds,
             "serve_p95_ms": harness.percentile(lats, 0.95),
             "serve_p50_ms": harness.percentile(lats, 0.5),
             "setup_s": setup_s},
        checks=[Check(k, v, float(cell.limits[k]))
                for k, v in checks.serve_numbers(gaps).items()
                if k in cell.limits],
        device=device_of(dev, 1, peak), reading=reading)
    if trace:
        out.device.update({"busy_s": reading["busy_s"],
                           "window_s": reading["window_s"]})
        out.breakdown = breakdown
    return out

