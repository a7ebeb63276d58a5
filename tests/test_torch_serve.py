"""The port's serving layer (avsep_tpu_torch/serve.py): every case of
tests/test_serve.py against the port's service, the padded batch against
``avsep_tpu.engine.separate`` with the JAX service's draws injected, and the
wire protocol against the JAX package's client.

Size as tests/test_serve.py (``tiny_cfg``): unet5 at ngf 8, the dilated
ResNet18 at 32 channels on 64x64 frames, 16383 samples; the weights are
random values in the JAX shapes carried over by ``from_jax``
(tests/test_torch_forward.py), on the CPU (``device="cpu"``).

Tolerances: the service against the port's own ``engine.separate`` on the
same padded batch and draws, bit for bit (one batch shape, the same
operations); against JAX, with soft masks, the tolerance of
tests/test_torch_engine.py (masks 2e-4, wavs 1e-4 of their largest
sample); the int16 wire over 30 dB SNR against f32, as the JAX test.  Every
future, socket and thread wait has a timeout; servers bind port 0.
"""

import socket
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.engine import separate as jax_separate
from avsep_tpu.serve import separate_remote as jax_separate_remote
from avsep_tpu.serve import server_stats as jax_server_stats
from avsep_tpu_torch import engine
from avsep_tpu_torch.serve import (
    SeparationService, _recv_msg, _send_msg, separate_remote, serve_forever,
    server_stats)
from tests.test_torch_forward import configs, make_nets

AUDLEN = 64 * 256 - 1
WAIT = 120  # seconds: the bound on every future, socket and join


@pytest.fixture(scope="module")
def model():
    jcfg, cfg = configs(arch_frame="resnet18dilated")
    jnets, params, stats, pnets = make_nets(cfg)
    return cfg, pnets, (jcfg, jnets, params, stats)


def service(model, **kw):
    cfg, nets, _ = model
    return SeparationService(kw.pop("cfg", cfg), nets, device="cpu", **kw)


def mixes(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(0.3 * np.sin(2 * np.pi * (200 + 50 * i)
                          * np.arange(AUDLEN) / 11025)
             + 0.05 * rs.randn(AUDLEN)).astype(np.float32)
            for i in range(n)]


def padded(reqs, B):
    out = np.zeros((B, AUDLEN), np.float32)
    for i, m in enumerate(reqs):
        out[i] = np.clip(m, -1, 1)
    return out


def test_service_matches_direct_padded_call(model):
    """The service's rows == a direct ``engine.separate`` on the same
    padded batch with the same draws (the service's generator, seeded from
    ``rng_seed``): bit for bit."""
    cfg, nets, _ = model
    svc = service(model, max_batch=4, max_wait_ms=50.0, rng_seed=7)
    try:
        reqs = mixes(3)
        futs = [svc.submit(m) for m in reqs]
        outs = [f.result(timeout=WAIT) for f in futs]
    finally:
        svc.close()
    swap = torch.rand(4, generator=torch.Generator().manual_seed(7))
    direct = engine.separate(nets, padded(reqs, 4), None, cfg, device="cpu",
                             swap_uniforms=swap)["wavs"].numpy()
    for i, out in enumerate(outs):
        assert out.shape == direct[i].shape == (2, 256 * 63)
        np.testing.assert_array_equal(out, direct[i])


def test_service_padded_batch_matches_jax_on_injected_draws(model):
    """The JAX service's first dispatch draws ``uniform(split(PRNGKey(7))
    [1], (max_batch,))``; injected through ``draw_swap``, the port's rows
    equal ``avsep_tpu.engine.separate`` on the padded batch (soft masks, so
    that no bin sits on the threshold)."""
    cfg, nets, (jcfg, jnets, params, stats) = model
    cfg, jcfg = cfg.replace(binary_mask=0), jcfg.replace(binary_mask=0)
    _, sub = jax.random.split(jax.random.PRNGKey(7))
    svc = service(model, cfg=cfg, max_batch=4, max_wait_ms=50.0)
    svc.draw_swap = lambda: torch.from_numpy(
        np.array(jax.random.uniform(sub, (4,))))
    try:
        reqs = mixes(3, seed=2)
        outs = [f.result(timeout=WAIT) for f in [svc.submit(m)
                                                  for m in reqs]]
    finally:
        svc.close()
    want = np.asarray(jax.device_get(jax_separate(
        jnets, params, stats, jnp.asarray(padded(reqs, 4)), None, jcfg,
        rng=sub)["wavs"]))
    for i, out in enumerate(outs):
        assert np.abs(out - want[i]).max() < 1e-4 * np.abs(want[i]).max()
    assert np.abs(np.stack(outs)).max() > 1e-3       # not silence


def test_dynamic_batching_coalesces(model):
    svc = service(model, max_batch=4, max_wait_ms=500.0)
    try:
        futs = [svc.submit(m) for m in mixes(4, seed=1)]
        for f in futs:
            assert np.isfinite(f.result(timeout=WAIT)).all()
        snap = svc.stats.snapshot()
    finally:
        svc.close()
    assert snap["requests"] == 4
    assert snap["dispatches"] == 1, "4 requests should coalesce"
    assert snap["mean_batch"] == 4.0


def test_av_and_ao_groups(model):
    """Frames and no-frames requests in one wave go out as two groups."""
    svc = service(model, max_batch=4, max_wait_ms=500.0)
    try:
        rs = np.random.RandomState(3)
        frames = rs.rand(2, 1, 64, 64, 3).astype(np.float32)
        f_av = svc.submit(mixes(1, seed=2)[0], frames=frames)
        f_ao = svc.submit(mixes(1, seed=4)[0])
        out_av = f_av.result(timeout=WAIT)
        out_ao = f_ao.result(timeout=WAIT)
        snap = svc.stats.snapshot()
    finally:
        svc.close()
    assert out_av.shape == out_ao.shape
    assert np.isfinite(out_av).all() and np.isfinite(out_ao).all()
    assert not np.array_equal(out_av, out_ao)
    assert snap["dispatches"] == 2


def test_error_propagates_to_future(model):
    svc = service(model, max_batch=2, max_wait_ms=1.0)
    try:
        # a dispatch-time failure (device error, OOM...) is delivered on
        # the future
        def boom(*a, **k):
            raise RuntimeError("injected dispatch failure")
        svc._run = boom
        fut = svc.submit(mixes(1)[0])
        with pytest.raises(RuntimeError, match="injected"):
            fut.result(timeout=WAIT)
    finally:
        svc.close()


def test_submit_after_close_raises(model):
    svc = service(model)
    svc.close()
    assert not svc._t.is_alive()
    with pytest.raises(RuntimeError):
        svc.submit(mixes(1)[0])


def test_tcp_round_trip(model):
    cfg = model[0]
    svc = service(model, max_batch=2, max_wait_ms=2.0)
    server = serve_forever(svc, port=0)
    host, port = server.server_address
    try:
        results = {}

        def call(i):
            results[i] = separate_remote(host, port, mixes(1, seed=i)[0],
                                         timeout=WAIT)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        assert set(results) == {0, 1, 2}
        for out in results.values():
            assert out.shape[0] == cfg.num_mix
            assert np.isfinite(out).all()
        snap = server_stats(host, port, timeout=WAIT)
        assert snap["ok"] and snap["requests"] >= 3
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_int16_wire_close_to_f32(model):
    """wire=int16 halves the audio bytes; a borderline binary-mask bin may
    flip under the input quantization, so the bound is an SNR (> 30 dB
    against the f32 wire), as in the JAX test."""
    req = mixes(2, seed=9)
    outs = {}
    for wire in ("f32", "int16"):
        svc = service(model, max_batch=2, max_wait_ms=200.0, rng_seed=11,
                      wire=wire)
        try:
            futs = [svc.submit(m) for m in req]
            outs[wire] = [f.result(timeout=WAIT) for f in futs]
        finally:
            svc.close()
    for a, b in zip(outs["f32"], outs["int16"]):
        assert b.dtype == np.float32 and np.abs(b).max() <= 1.0
        diff = np.linalg.norm(a - b)
        snr = 20 * np.log10(np.linalg.norm(a) / max(diff, 1e-12))
        assert snr > 30.0, f"int16 wire SNR {snr:.1f} dB"


def test_close_fails_pending_futures(model):
    """Queued but undispatched requests resolve with an error on close(),
    never hang."""
    svc = service(model, max_batch=2, max_wait_ms=5000.0)
    # the worker collects the first wave and waits out its deadline;
    # close() comes before the dispatch
    futs = [svc.submit(m) for m in mixes(3, seed=12)]
    svc.close()
    resolved = 0
    for f in futs:
        try:
            f.result(timeout=WAIT)
            resolved += 1
        except RuntimeError:
            resolved += 1
    assert resolved == 3, "every future must resolve (result or error)"


def test_bad_frames_shape_rejected_at_submit(model):
    svc = service(model)
    try:
        with pytest.raises(ValueError):
            svc.submit(mixes(1)[0],
                       frames=np.zeros((2, 1, 32, 32, 3), np.float32))
        assert svc.frames_shape == (2, 1, 64, 64, 3)
    finally:
        svc.close()


def test_tcp_connection_survives_request_error(model):
    """A request-level failure is reported in-band and the (framing-
    synchronized) connection keeps serving."""
    cfg = model[0]
    svc = service(model, max_batch=2, max_wait_ms=2.0)
    server = serve_forever(svc, port=0)
    host, port = server.server_address
    sock = socket.create_connection((host, port), timeout=WAIT)
    try:
        with pytest.raises(RuntimeError, match="server error"):
            separate_remote(host, port, mixes(1)[0],
                            frames=np.zeros((3, 3), np.float32), sock=sock)
        out = separate_remote(host, port, mixes(1)[0], sock=sock)
        assert out.shape[0] == cfg.num_mix
    finally:
        sock.close()
        server.shutdown()
        server.server_close()
        svc.close()


def test_av_frames_are_imagenet_normalized(model):
    """The serving contract is frames in [0, 1]: the service normalizes
    them on the device, so its output equals a direct ``separate`` on
    explicitly normalized frames, and a uint8 submit equals its float/255
    equivalent."""
    from avsep_tpu.engine import _IMAGENET_MEAN, _IMAGENET_STD
    cfg, nets, _ = model
    svc = service(model, max_batch=1, max_wait_ms=1.0, rng_seed=3)
    try:
        mix = mixes(1, seed=5)[0]
        rs = np.random.RandomState(11)
        frames_u8 = rs.randint(0, 256, size=svc.frames_shape,
                               dtype=np.uint8)
        frames = frames_u8.astype(np.float32) / 255.0
        got = svc.submit(mix, frames=frames).result(timeout=WAIT)
        got_u8 = svc.submit(mix, frames=frames_u8).result(timeout=WAIT)
    finally:
        svc.close()
    m = padded([mix[:cfg.audLen]], 1)
    f_norm = ((frames - np.float32(_IMAGENET_MEAN))
              / np.float32(_IMAGENET_STD)).astype(np.float32)
    want = engine.separate(nets, m, f_norm[None], cfg,
                           device="cpu")["wavs"][0].numpy()
    assert np.allclose(got, want, atol=1e-5), np.abs(got - want).max()
    # raw pixels would be another input entirely
    raw = engine.separate(nets, m, frames[None], cfg,
                          device="cpu")["wavs"][0].numpy()
    assert not np.allclose(raw, want, atol=1e-5)
    assert np.allclose(got_u8, got, atol=1e-5)


def test_u8_frames_wire_matches_f32(model):
    """uint8 frames over TCP (a quarter of the AV request bytes) give the
    wavs of the f32 wire carrying the same /255 values."""
    cfg = model[0]
    svc = service(model, max_batch=1, max_wait_ms=1.0)
    server = serve_forever(svc, port=0)
    host, port = server.server_address
    try:
        mix = mixes(1, seed=9)[0]
        rs = np.random.RandomState(3)
        f_u8 = rs.randint(0, 256, size=svc.frames_shape, dtype=np.uint8)
        out_u8 = separate_remote(host, port, mix, frames=f_u8, timeout=WAIT)
        out_f32 = separate_remote(host, port, mix,
                                  frames=f_u8.astype(np.float32) / 255.0,
                                  timeout=WAIT)
        assert out_u8.shape[0] == cfg.num_mix
        assert np.allclose(out_u8, out_f32, atol=1e-6)
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_frames_wire_u8_service_matches_f32(model):
    """frames_wire="u8" (uint8 to the device, /255 there) matches the f32
    wire on 8-bit-exact inputs."""
    mix = mixes(1, seed=21)[0]
    rs = np.random.RandomState(13)

    def serve_once(frames_wire, frames):
        svc = service(model, max_batch=1, max_wait_ms=1.0, rng_seed=5,
                      frames_wire=frames_wire)
        try:
            return svc.submit(mix, frames=frames).result(timeout=WAIT)
        finally:
            svc.close()

    shape = (2, 1, 64, 64, 3)
    f_u8 = rs.randint(0, 256, size=shape, dtype=np.uint8)
    out_u8 = serve_once("u8", f_u8)
    out_f32 = serve_once("f32", f_u8.astype(np.float32) / 255.0)
    assert np.allclose(out_u8, out_f32, atol=1e-5)


def test_integer_nonuint8_frames_rejected(model):
    """int16 / int32 frames are of ambiguous scale: submit rejects them."""
    svc = service(model, frames_wire="u8")
    try:
        bad = np.random.RandomState(0).randint(
            0, 256, size=svc.frames_shape).astype(np.int32)
        with pytest.raises(ValueError, match="uint8 .* or float"):
            svc.submit(mixes(1)[0], frames=bad)
    finally:
        svc.close()
    with pytest.raises(ValueError, match="wire"):
        service(model, wire="f16")


def test_tcp_truncated_payload_rejected(model):
    """A header whose ``n`` promises more samples than the payload ships
    gets an in-band ok=False reply; the connection stays usable."""
    cfg = model[0]
    svc = service(model, max_batch=1, max_wait_ms=2.0)
    server = serve_forever(svc, port=0)
    host, port = server.server_address
    sock = socket.create_connection((host, port), timeout=WAIT)
    try:
        mix = mixes(1)[0]
        short = mix[:100].astype(np.float32).tobytes()  # n says more
        _send_msg(sock, {"op": "separate", "n": int(mix.shape[0]),
                         "payload_bytes": len(short)}, short)
        header, _ = _recv_msg(sock)
        assert header["ok"] is False
        assert "expected" in header["error"]
        out = separate_remote(host, port, mix, sock=sock)
        assert out.shape[0] == cfg.num_mix
    finally:
        sock.close()
        server.shutdown()
        server.server_close()
        svc.close()


def test_jax_client_talks_to_the_port_server(model):
    """Wire compatibility: the JAX package's ``separate_remote`` and
    ``server_stats`` against the port's server, AO and AV (uint8 and float
    frames), equal to the port's own client's replies."""
    svc = service(model, max_batch=1, max_wait_ms=1.0, rng_seed=2)
    server = serve_forever(svc, port=0)
    host, port = server.server_address
    rs = np.random.RandomState(4)
    f_u8 = rs.randint(0, 256, size=svc.frames_shape, dtype=np.uint8)
    mix = mixes(1, seed=6)[0]
    try:
        for frames in (f_u8, f_u8.astype(np.float32) / 255.0):
            with socket.create_connection((host, port), timeout=WAIT) as s:
                theirs = jax_separate_remote(host, port, mix, frames=frames,
                                             sock=s)
            ours = separate_remote(host, port, mix, frames=frames,
                                   timeout=WAIT)
            np.testing.assert_array_equal(theirs, ours)
        with socket.create_connection((host, port), timeout=WAIT) as s:
            ao = jax_separate_remote(host, port, mix, sock=s)
        assert ao.shape == (2, 256 * 63) and np.isfinite(ao).all()
        old = socket.getdefaulttimeout()
        socket.setdefaulttimeout(WAIT)     # its connection's bound
        try:
            snap = jax_server_stats(host, port)
        finally:
            socket.setdefaulttimeout(old)
        assert snap["ok"] and snap["requests"] == 5
        assert snap["dispatches"] == 5
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_service_raises_without_a_gpu(model, monkeypatch):
    cfg, nets, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeparationService(cfg, nets)
