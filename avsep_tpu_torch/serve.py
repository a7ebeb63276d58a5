"""Separation serving: dynamic batching and a TCP front end.

Port of ``avsep_tpu/serve.py``: a resident model with requests batched onto
the GPU, and the same length-prefixed JSON + raw-bytes wire protocol (a
client of either package talks to a server of the other).

* **One batch shape.**  Requests are padded to ``max_batch`` rows, so every
  dispatch runs the same shapes (the kernels' launch plans, cuDNN's chosen
  algorithms); the padding rows are dropped before the reply.  An AV group
  is padded with the first request's frames.
* **Dynamic batching.**  The worker takes the first pending request, then
  drains the queue until ``max_batch`` requests are in hand or
  ``max_wait_ms`` has passed.  AO requests and AV requests (with frames)
  form separate groups.
* **One device owner.**  Only the worker thread touches the GPU; the
  handler threads of the TCP server do host work only.  A dispatch copies
  its batch to the device once (from pinned memory), runs
  ``engine.separate`` (one ``frame_window`` and one
  ``overlap_add_normalize`` launch on a CUDA batch) and brings the wavs
  back with one copy.
* **Wires.**  ``wire="int16"`` ships the audio both ways as int16 (a fixed
  32767 scale; the mixes are clipped to [-1, 1]), dequantized and
  requantized on the device.  The frames contract is RGB in [0, 1]
  (float) or [0, 255] (uint8): ``frames_wire="f32"`` ImageNet-normalizes
  the float batch on the device; ``frames_wire="u8"`` ships uint8 and
  ``engine.normalize_frames`` does ``/255`` and the normalization.
* **The slot swap.**  An AO dispatch draws ``max_batch`` uniforms from the
  service's CPU ``torch.Generator`` (seeded from ``rng_seed``) in
  :meth:`SeparationService.draw_swap`; a JAX PRNG stream cannot be
  reproduced in torch, and a test replaces that method to inject the JAX
  service's draws.

In-process use::

    svc = SeparationService(cfg, nets)   # nets on the GPU
    wavs = svc.submit(mix_f32).result()  # [L] -> [N, L']

Network use::

    python -m avsep_tpu_torch.serve --port 7860 --ckpt ./ckpt --id RUN &
    wavs = separate_remote("127.0.0.1", 7860, mix_f32)

``SeparationService`` runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises without a GPU; the command line has no device
flag.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import socketserver
import struct
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import FLAGSHIP, Config


class ServiceStats:
    """Requests, dispatches and dispatch latency (host clock from the
    batch's copy to the device to its wavs on the host)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.dispatches = 0
        self.batched_rows = 0
        self.latencies_ms = []

    def record(self, n_rows: int, lat_ms: float):
        with self.lock:
            self.dispatches += 1
            self.batched_rows += n_rows
            self.latencies_ms.append(lat_ms)
            if len(self.latencies_ms) > 4096:
                del self.latencies_ms[:2048]

    def snapshot(self) -> Dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            pct = (lambda p: lat[min(len(lat) - 1,
                                     int(p * len(lat)))] if lat else 0.0)
            return {"requests": self.requests,
                    "dispatches": self.dispatches,
                    "mean_batch": (self.batched_rows
                                   / max(self.dispatches, 1)),
                    "p50_ms": pct(0.50), "p95_ms": pct(0.95)}


class SeparationService:
    """Resident separation model with dynamic request batching.  ``nets``
    (``engine.Nets``, weights loaded) must lie on ``device``."""

    def __init__(self, cfg: Config, nets: engine.Nets, max_batch: int = 8,
                 max_wait_ms: float = 5.0, rng_seed: int = 0,
                 wire: str = "f32", frames_wire: str = "f32", device=None):
        if wire not in ("f32", "int16"):
            raise ValueError(f"wire must be f32 or int16, got {wire!r}")
        if frames_wire not in ("f32", "u8"):
            raise ValueError(
                f"frames_wire must be f32 or u8, got {frames_wire!r}")
        self.device = engine.nets_device(nets, device)
        self.cfg = cfg
        self.nets = nets
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.wire = wire
        self.frames_wire = frames_wire
        self.stats = ServiceStats()
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._gen = torch.Generator().manual_seed(rng_seed)
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    # ------------------------------------------------------------- client
    @property
    def frames_shape(self):
        """The one accepted frames shape per request: a malformed request
        must not poison a batched wave."""
        T = 1 if self.cfg.one_frame else self.cfg.num_frames
        return (self.cfg.num_mix, T, self.cfg.imgSize, self.cfg.imgSize,
                3)

    def submit(self, audio_mix: np.ndarray,
               frames: Optional[np.ndarray] = None) -> Future:
        """audio_mix [L] float32 (truncated / zero-padded to cfg.audLen);
        frames ``self.frames_shape`` RGB in [0, 1] float (uint8 [0, 255]
        also accepted) for visually guided separation, or None for audio
        only.  Returns a Future resolving to [num_mix, L'] float32 wavs."""
        if self._stop.is_set():
            raise RuntimeError("service is closed")
        if frames is not None:
            frames = np.asarray(frames)
            if frames.shape != self.frames_shape:
                raise ValueError(
                    f"frames must have shape {self.frames_shape}, got "
                    f"{frames.shape}")
            if frames.dtype != np.uint8 and not np.issubdtype(
                    frames.dtype, np.floating):
                # int16 / int32 "images" are ambiguous in scale: clipping
                # them to [0, 1] would binarize real pictures
                raise ValueError(
                    f"frames must be uint8 [0,255] or float [0,1], got "
                    f"dtype {frames.dtype}")
            if self.frames_wire == "u8":
                if frames.dtype != np.uint8:
                    frames = np.rint(
                        np.clip(frames, 0.0, 1.0) * 255.0).astype(np.uint8)
            else:
                if frames.dtype == np.uint8:
                    frames = frames.astype(np.float32) / 255.0
                frames = np.asarray(frames, np.float32)
        mix = np.zeros(self.cfg.audLen, np.float32)
        n = min(len(audio_mix), self.cfg.audLen)
        mix[:n] = np.clip(audio_mix[:n], -1.0, 1.0)
        fut: Future = Future()
        with self.stats.lock:
            self.stats.requests += 1
        self._q.put((mix, frames, fut, time.perf_counter()))
        # submit/close race: if close() won, the worker is gone, so fail
        # this future instead of leaving it pending forever
        if self._stop.is_set():
            self._fail_pending()
        return fut

    def _fail_pending(self):
        """Resolve every still-queued future with an error: a pending
        ``fut.result()`` must never hang."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None and not item[2].done():
                item[2].set_exception(RuntimeError("service closed"))

    def close(self):
        self._stop.set()
        self._q.put(None)
        self._t.join(timeout=5.0)
        self._fail_pending()

    # ------------------------------------------------------------- worker
    def draw_swap(self) -> torch.Tensor:
        """The audio-only slot swap's draw for one dispatch: ``max_batch``
        uniforms in [0, 1) from the service's CPU generator."""
        return torch.rand(self.max_batch, generator=self._gen)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _run(self, mixes: np.ndarray, frames: Optional[np.ndarray]
             ) -> np.ndarray:
        """One dispatch: ``mixes [max_batch, L]`` (int16 on the int16
        wire) and ``frames [max_batch, N, T, H, W, 3]`` (uint8, or float
        in [0, 1]) or None -> ``[max_batch, N, L']`` float32 wavs on the
        host."""
        a = self._put(mixes)
        if self.wire == "int16":
            a = a.float() / 32767.0
        f = None
        if frames is not None:
            f = self._put(frames)
            if self.frames_wire != "u8":
                f = engine.imagenet_normalize(f)
        wavs = engine.separate(
            self.nets, a, f, self.cfg, device=self.device,
            swap_uniforms=None if frames is not None else self.draw_swap()
        )["wavs"]
        if self.wire == "int16":
            wavs = torch.round(wavs * 32767.0).to(torch.int16)
        wavs = wavs.cpu().numpy()
        if self.wire == "int16":
            wavs = wavs.astype(np.float32) / 32767.0
        return wavs

    def _collect(self):
        """The first request blocks; then drain until max_batch or the wait
        deadline.  Returns a list of (mix, frames, future, t0)."""
        first = self._q.get()
        if first is None:
            return None
        reqs = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(reqs) < self.max_batch:
            left = deadline - time.perf_counter()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the shutdown sentinel
                break
            reqs.append(nxt)
        return reqs

    def _dispatch_group(self, group, with_frames: bool):
        if not group:
            return
        B = self.max_batch
        mixes = np.zeros((B, self.cfg.audLen), np.float32)
        for i, (mix, _, _, _) in enumerate(group):
            mixes[i] = mix
        if self.wire == "int16":
            mixes = np.rint(mixes * 32767.0).astype(np.int16)
        frames = None
        if with_frames:
            frames = np.stack([f for _, f, _, _ in group]
                              + [group[0][1]] * (B - len(group)))
        t0 = time.perf_counter()
        wavs = self._run(mixes, frames)
        self.stats.record(len(group), (time.perf_counter() - t0) * 1e3)
        for i, (_, _, fut, _) in enumerate(group):
            fut.set_result(wavs[i])

    def _worker(self):
        while not self._stop.is_set():
            reqs = self._collect()
            if reqs is None:
                break
            try:
                self._dispatch_group(
                    [r for r in reqs if r[1] is None], with_frames=False)
                self._dispatch_group(
                    [r for r in reqs if r[1] is not None],
                    with_frames=True)
            except Exception as e:  # propagate to every waiting client
                for _, _, fut, _ in reqs:
                    if not fut.done():
                        fut.set_exception(e)
        # requests still queued behind the stop sentinel must not leave
        # their futures pending forever
        self._fail_pending()


# ------------------------------------------------------------------ wire
# Length-prefixed messages: uint32 header_len | json header | raw payload.
# Request header: {"op": "separate" | "stats", "n": L, "frames_shape": [...],
# "frames_dtype": "f32" | "u8", "payload_bytes": ...}, payload = the mix as
# f32 bytes [+ the frames' bytes].  Response header: {"ok": true, "shape":
# [...], "payload_bytes": ...}, payload = the wavs as f32 bytes; or
# {"ok": false, "error": ...}.

def _send_msg(sock, header: dict, payload: bytes = b""):
    hj = json.dumps(header).encode()
    sock.sendall(struct.pack("<I", len(hj)) + hj + payload)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _recv_msg(sock):
    (hlen,) = struct.unpack("<I", _recv_exact(sock, 4))
    header = json.loads(_recv_exact(sock, hlen))
    payload = _recv_exact(sock, int(header.get("payload_bytes", 0)))
    return header, payload


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        svc: SeparationService = self.server.service  # type: ignore
        while True:
            try:  # wire errors end the connection
                header, payload = _recv_msg(self.request)
            except (ConnectionError, OSError):
                return
            try:  # request errors are reported in-band and the (still
                # framing-synchronized) connection keeps serving
                if header["op"] == "stats":
                    _send_msg(self.request,
                              {"ok": True, **svc.stats.snapshot()})
                    continue
                n = int(header["n"])
                fs = (tuple(header["frames_shape"])
                      if header.get("frames_shape") else None)
                fdt = (np.uint8 if header.get("frames_dtype") == "u8"
                       else np.float32)
                need = 4 * n + (int(np.prod(fs)) * np.dtype(fdt).itemsize
                                if fs else 0)
                if len(payload) != need:
                    # a truncated payload must fail loudly, not separate a
                    # zero-filled mixture
                    raise ValueError(
                        f"payload is {len(payload)} bytes, expected {need} "
                        f"(n={n}" + (f", frames_shape={list(fs)}" if fs
                                     else "") + ")")
                mix = np.frombuffer(payload[:4 * n], np.float32)
                frames = None
                if fs:
                    frames = np.frombuffer(payload[4 * n:], fdt).reshape(fs)
                wavs = svc.submit(mix, frames).result()
                _send_msg(self.request,
                          {"ok": True, "shape": list(wavs.shape),
                           "payload_bytes": wavs.nbytes},
                          np.ascontiguousarray(wavs).tobytes())
            except (ConnectionError, OSError):
                return
            except Exception as e:
                try:
                    _send_msg(self.request,
                              {"ok": False, "error": repr(e)})
                except OSError:
                    return


class SeparationServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, service: SeparationService):
        super().__init__(addr, _Handler)
        self.service = service


def serve_forever(service: SeparationService, host: str = "127.0.0.1",
                  port: int = 7860) -> SeparationServer:
    """The server on a daemon thread (``port=0`` picks a free port; read
    ``server.server_address``); stop it with ``server.shutdown()``."""
    server = SeparationServer((host, port), service)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server


def separate_remote(host: str, port: int, mix: np.ndarray,
                    frames: Optional[np.ndarray] = None,
                    sock: Optional[socket.socket] = None,
                    timeout: Optional[float] = None) -> np.ndarray:
    """Client helper: one round trip, returns [num_mix, L'] wavs.  uint8
    frames ride the wire as they are (a quarter of the bytes).
    ``timeout`` (seconds) bounds the connection and each socket read of a
    connection this call opens."""
    own = sock is None
    if own:
        sock = socket.create_connection((host, port), timeout=timeout)
    try:
        mix = np.ascontiguousarray(mix, np.float32)
        header = {"op": "separate", "n": int(mix.size),
                  "payload_bytes": mix.nbytes}
        payload = mix.tobytes()
        if frames is not None:
            if np.asarray(frames).dtype != np.uint8:
                frames = np.ascontiguousarray(frames, np.float32)
            frames = np.ascontiguousarray(frames)
            header["frames_shape"] = list(frames.shape)
            header["frames_dtype"] = ("u8" if frames.dtype == np.uint8
                                      else "f32")
            header["payload_bytes"] += frames.nbytes
            payload += frames.tobytes()
        _send_msg(sock, header, payload)
        rh, rp = _recv_msg(sock)
        if not rh.get("ok"):
            raise RuntimeError(f"server error: {rh.get('error')}")
        return np.frombuffer(rp, np.float32).reshape(rh["shape"])
    finally:
        if own:
            sock.close()


def server_stats(host: str, port: int,
                 timeout: Optional[float] = None) -> Dict:
    with socket.create_connection((host, port), timeout=timeout) as sock:
        _send_msg(sock, {"op": "stats"})
        header, _ = _recv_msg(sock)
        return header


# -------------------------------------------------------------------- CLI

def main(argv=None):
    import argparse

    from avsep_tpu_torch import checkpoint
    from avsep_tpu_torch.config import parse_args
    from avsep_tpu_torch.train import init_state

    ap = argparse.ArgumentParser(
        description="avsep_tpu_torch separation server")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--max_batch", type=int, default=8)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--wire", default="f32", choices=["f32", "int16"],
                    help="host<->device audio encoding (int16 halves the "
                         "bytes, ~90 dB SNR)")
    ap.add_argument("--frames_wire", default="f32",
                    choices=["f32", "u8"],
                    help="host<->device frames encoding (u8 quarters the "
                         "bytes; float submits are quantized to 8 bits)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--id", default="")
    args, rest = ap.parse_known_args(argv)
    cfg = parse_args(rest) if rest else FLAGSHIP

    nets = engine.build_nets(cfg)
    state = init_state(cfg, nets, torch.Generator().manual_seed(0))
    if args.ckpt:
        state = checkpoint.restore_checkpoint(
            os.path.join(args.ckpt, args.id), state, "best")

    svc = SeparationService(cfg, state.nets, max_batch=args.max_batch,
                            max_wait_ms=args.max_wait_ms, wire=args.wire,
                            frames_wire=args.frames_wire)
    server = SeparationServer((args.host, args.port), svc)
    print(f"serving on {args.host}:{args.port} "
          f"(max_batch={args.max_batch}, "
          f"max_wait_ms={args.max_wait_ms})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        svc.close()


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    main()
