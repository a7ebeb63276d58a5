"""The port's measurement tools (``avsep_tpu_torch/tools/``: bench,
serve_bench, latency_report, train_throughput, mfu_report, memory_report,
sep_dtype_ab) on the CPU, against the JAX package where the two compute the
same thing.  The tools time only on a card; here their functions run with
``device="cpu"`` and no time is read as a device's.

Size: unet5 at ngf 8 and the tiny conv encoder at 32 channels on 64x64
frames, 16383 samples (64 STFT frames), B = 2, with random weights in the
JAX shapes carried over by ``from_jax`` (tests/test_torch_forward.py).

Tolerances, each stated where it is used:

* The separation that ``bench`` times against ``avsep_tpu.engine.separate``
  on the same numpy inputs: tests/test_torch_engine.py's envelope.  With
  soft masks the waveforms at 1e-4 of their largest sample; with bench's
  binary masks the masks' bins must agree on all but 1e-3 of them (a bin
  within float noise of the threshold may flip) and the waveforms at
  1e-4 of their largest sample wherever no bin of theirs flipped.
* The FLOP counts are integers and held exactly: FlopCounterMode against
  the hand count on every forward piece.  Against XLA's
  ``cost_analysis()["flops"]`` of JAX's compiled function at the same
  size, which also counts elementwise work, the port's count is at most
  XLA's, within a band set from the reading (``XLA_RATIO``).
* ``train_throughput``'s steps, ``sep_dtype_ab``'s float32 leg and the
  memory sweep's search: exact (the same arithmetic in one process).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.engine import separate as jax_separate
from avsep_tpu.train import TrainState as JTrainState
from avsep_tpu.train import make_optimizer, make_train_step as jmake_step
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.tools import (
    bench, latency_report, measure, memory_report, mfu_report, sep_dtype_ab,
    serve_bench, train_throughput)
from tests.test_torch_forward import configs, make_nets
import tools.memory_report as jax_memory_report

B = 2
CPU = torch.device("cpu")
# port FLOPs / XLA FLOPs at this size, dft "matmul": read 0.9315 (separate,
# 1,177,419,776 / 1,263,972,352) and 0.8247 (train step, 2,103,705,600 /
# 2,550,931,968); the rest of XLA's count is elementwise work and
# reductions (the fusion's products and sums, BatchNorm, the losses, the
# SGD update), which FlopCounterMode does not count.  The bands hold the
# readings within about 3 % and never above 1.
XLA_RATIO = {"separate": (0.90, 0.96), "train_step": (0.80, 0.85)}


@pytest.fixture(scope="module")
def nets():
    """JAX and port nets of bench's configuration at the test size, soft
    and binary masks, dft "matmul"."""
    jcfg, cfg = configs(dft="matmul", binary_mask=1)
    jnets, params, stats, pnets = make_nets(cfg)
    return jcfg, cfg, jnets, params, stats, pnets


def _inputs(seed, cfg):
    """bench's draws in numpy: mixtures 0.1 * N(0, 1), frames uniform in
    [0, 1) as normalized float input."""
    rs = np.random.RandomState(seed)
    wav = (0.1 * rs.randn(B, cfg.audLen)).astype(np.float32)
    frames = rs.rand(B, 2, 1, cfg.imgSize, cfg.imgSize, 3).astype(np.float32)
    return wav, frames


def _state(cfg, pnets):
    return train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))


# ------------------------------------------------------------------ bench


@pytest.mark.parametrize("binary_mask", [0, 1])
def test_bench_separation_matches_jax(nets, binary_mask):
    jcfg, cfg, jnets, params, stats, pnets = nets
    jcfg = jcfg.replace(binary_mask=binary_mask)
    cfg = cfg.replace(binary_mask=binary_mask)
    wav, frames = _inputs(1, cfg)
    ref = jax.device_get(jax_separate(jnets, params, stats, jnp.asarray(wav),
                                      jnp.asarray(frames), jcfg))
    got = bench.timed_fn(pnets, cfg, "cpu")(torch.from_numpy(wav),
                                            torch.from_numpy(frames))
    w, rw = got.numpy(), np.asarray(ref["wavs"])
    assert w.shape == rw.shape == (B, 2, 16128)
    assert np.isfinite(w).all() and np.abs(w).max() <= 1.0
    assert np.abs(w).max() > 1e-3                    # not silence
    ok = np.ones(w.shape, bool)
    if binary_mask:
        lin = engine.separate(pnets, wav, frames, cfg,
                              device="cpu")["masks_linear"].numpy()
        flipped = lin != np.asarray(ref["masks_linear"])
        assert flipped.mean() < 1e-3
        # a flipped bin moves the n_fft samples of its frame
        T = lin.shape[-1]
        for b, n, _, t in zip(*np.nonzero(flipped)):
            lo = max(0, (t - 4) * cfg.stft_hop)
            ok[b, n, lo:(t + 4) * cfg.stft_hop] = False
        assert ok.mean() > 0.9
        assert T == 64
    assert np.abs(w - rw)[ok].max() < 1e-4 * np.abs(rw).max()


def test_bench_line_and_throughput_on_cpu(nets):
    _, cfg, _, _, _, pnets = nets
    res = bench.throughput(cfg, pnets, batch=B, iters=2, runs=2,
                           device="cpu")
    assert res["clips_per_s"] > 0
    assert res["calls"] == bench.WARMUP + 2 * 2
    line = bench.bench_line(res["clips_per_s"], "matmul", "cpu")
    # bench.py:208-214's keys, plus the dft and the card
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["vs_baseline"] is None
    assert line["unit"] == "clips/s" and line["dft"] == "matmul"
    assert line["metric"].startswith("duet clips/sec/chip")


# -------------------------------------------------------------------- FLOPs


@pytest.mark.parametrize("dft", ["matmul", "fft"])
def test_flop_counter_equals_hand_count_on_the_forward(nets, dft):
    _, cfg, _, _, _, pnets = nets
    cfg = cfg.replace(dft=dft)
    batches = train_throughput.synthetic_batches(cfg, B, 1, CPU)
    fns = mfu_report.piece_fns(cfg, _state(cfg, pnets), batches, CPU)
    for piece in mfu_report.PIECES:
        c = mfu_report.count(lambda: fns[piece](0), pnets, piece, cfg, B)
        if piece == "train_step":
            # forward + backward; the DFT and warp GEMMs have no backward
            assert c["counter"] > c["hand_forward"] > 0
        else:
            assert c["agree"], (piece, c)
            assert c["counter"] == c["hand_forward"]
    assert mfu_report.gemm_flops("frame_features", cfg, B) == 0


def _xla_flops(compiled):
    ca = compiled.cost_analysis()
    return float((ca[0] if isinstance(ca, (list, tuple)) else ca)["flops"])


def test_flop_count_against_xla(nets):
    jcfg, cfg, jnets, params, stats, pnets = nets
    wav, frames = _inputs(2, cfg)
    sep = jax.jit(lambda p, s, a, f: jax_separate(jnets, p, s, a, f, jcfg)[
        "wavs"]).lower(params, stats, jnp.asarray(wav),
                       jnp.asarray(frames)).compile()
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, stats,
                         make_optimizer(jcfg, params).init(params))
    batch = {"audios": jax.ShapeDtypeStruct((B, 2, cfg.audLen), jnp.float32),
             "frames": jax.ShapeDtypeStruct(frames.shape, jnp.float32)}
    step = jmake_step(jcfg, jnets, True).lower(
        jstate, batch, jax.random.PRNGKey(0)).compile()
    xla = {"separate": _xla_flops(sep), "train_step": _xla_flops(step)}

    batches = train_throughput.synthetic_batches(cfg, B, 1, CPU)
    fns = mfu_report.piece_fns(cfg, _state(cfg, pnets), batches, CPU)
    for piece, (lo, hi) in XLA_RATIO.items():
        c = mfu_report.count(lambda: fns[piece](0), pnets, piece, cfg, B)
        ratio = c["counter"] / xla[piece]
        assert lo <= ratio <= hi, (piece, c["counter"], xla[piece], ratio)


def test_mfu_report_run_on_cpu_has_no_device_share(nets):
    _, cfg, _, _, _, pnets = nets
    r = mfu_report.run(cfg, _state(cfg, pnets), batch=B, n_steps=1,
                       device="cpu")
    assert r["card_name"] == "cpu" and r["dtype_peak_flops"] is None
    assert r["mfu_vs_dtype_peak"] == dict.fromkeys(mfu_report.PIECES)
    assert r["calls"] == dict.fromkeys(
        mfu_report.PIECES, 1 + mfu_report.WARMUP + mfu_report.TIMING_REPS)
    assert r["flops"] == r["flops_hand_forward"] | {
        "train_step": r["flops"]["train_step"]}
    assert len(r["train_step_breakdown_pct"]) == 4


def test_mfu_share_above_one_raises():
    name = "NVIDIA H100 80GB HBM3"
    ok = mfu_report.mfu_shares({"x": 67e9}, {"x": 2.0}, name, "float32")
    assert ok["mfu_vs_dtype_peak"]["x"] == pytest.approx(0.5)
    assert ok["mfu_vs_bf16_peak"]["x"] == pytest.approx(33.5e12 / 989e12)
    with pytest.raises(ValueError, match="above 100"):
        mfu_report.mfu_shares({"x": 67e9}, {"x": 0.5}, name, "float32")
    unknown = mfu_report.mfu_shares({"x": 1e12}, {"x": 1e-3}, "Some GPU",
                                    "float32")
    assert unknown["mfu_vs_dtype_peak"]["x"] is None
    assert unknown["card_name"] == "Some GPU"


# ------------------------------------------------------------------ memory


def _fake_peaks(oom_at=None, refused_at=None):
    """A peak function of the batch: 1 GiB per clip, out of memory from
    ``oom_at`` on, refused for its size from ``refused_at`` on (the
    message of PyTorch's upsample); the batches it was asked for."""
    probed = []

    def peak(batch):
        probed.append(batch)
        if oom_at is not None and batch >= oom_at:
            raise torch.cuda.OutOfMemoryError("fake: out of memory")
        if refused_at is not None and batch >= refused_at:
            raise RuntimeError("upsample_bilinear2d_nhwc only supports "
                               "output tensors with less than INT_MAX "
                               "elements")
        return {"peak_bytes": batch * 2 ** 30}
    return peak, probed


@pytest.mark.parametrize("start,budget,oom_at,refused_at", [
    (32, 100, None, None), (4, 20, None, None), (32, 10 ** 6, None, None),
    (8, 1000, 64, None), (3, 7, None, None), (32, 16, None, None),
    (32, 1000, None, 256)])
def test_memory_sweep_search_matches_jax(monkeypatch, start, budget, oom_at,
                                         refused_at):
    budget_bytes = budget * 2 ** 30
    jax_peak, jax_probed = _fake_peaks(oom_at, refused_at)
    monkeypatch.setattr(jax_memory_report, "analyze_train_step",
                        lambda cfg, batch: jax_peak(batch))
    want = jax_memory_report.sweep_max_batch(lambda: None, budget_bytes,
                                             start)
    peak, probed = _fake_peaks(oom_at, refused_at)
    got = memory_report.sweep_max_batch(peak, budget_bytes, start)
    assert probed == jax_probed
    assert got["max_batch_fitting"] == want["max_batch_fitting"]
    assert set(got["points"]) == set(want["points"])
    for b, m in want["points"].items():
        assert ("error" in m) == ("error" in got["points"][b])
        if "error" not in m:
            assert got["points"][b] == m


def test_memory_report_measures_a_card_only():
    with pytest.raises(ValueError, match="a card's memory"):
        memory_report.run(2 ** 30, device="cpu")


def test_memory_sweep_raises_other_errors():
    def peak(batch):
        raise RuntimeError("a fault of the step, not of its size")
    with pytest.raises(RuntimeError, match="fault of the step"):
        memory_report.sweep_max_batch(peak, 2 ** 40, 8)


# -------------------------------------------------------- train throughput


def test_train_throughput_steps_equal_make_train_step(nets):
    _, cfg, _, _, _, pnets = nets
    a = _state(cfg, make_nets(cfg)[3])
    b = _state(cfg, make_nets(cfg)[3])
    r = train_throughput.run(cfg, a, batch=B, n_steps=1, warmup=1,
                             device="cpu")
    assert r["calls"] == {"train_step": 2} and len(r["losses"]) == 2
    step = train.make_train_step(cfg, b.nets, use_vis=True, device="cpu")
    losses = [float(step(b, bt)[1]["err"]) for bt in
              train_throughput.synthetic_batches(cfg, B, 2, CPU)]
    assert r["losses"] == losses
    assert a.step == b.step == 2
    for (name, p), (_, q) in zip(train.named_parameters(a.nets),
                                 train.named_parameters(b.nets)):
        assert torch.equal(p, q), name
    for g in a.opt_state:
        assert a.opt_state[g].count == b.opt_state[g].count
        for k, buf in a.opt_state[g].momentum.items():
            assert torch.equal(buf, b.opt_state[g].momentum[k]), k
    for (name, x), (_, y) in zip(a.nets.sound.named_buffers(),
                                 b.nets.sound.named_buffers()):
        assert torch.equal(x, y), name


# ------------------------------------------------------------------ serving


@pytest.mark.parametrize("av", [False, True])
def test_serve_bench_on_cpu(nets, av):
    _, cfg, _, _, _, pnets = nets
    r = serve_bench.run(cfg, pnets, n=10, clients=3, max_batch=4,
                        max_wait_ms=20.0, av=av, frames_wire="u8",
                        device="cpu")
    assert r["requests"] == 10 and r["req_per_s"] > 0
    assert 1 <= r["mean_batch"] <= 4
    assert r["request_p50_ms"] <= r["request_p95_ms"]
    assert r["calls"] == {"separate": r["dispatches"]}
    assert r["dispatches"] >= 1 + 10 // 4          # the warm-up's included
    assert "req/s" in serve_bench.summary(r, "cpu")


def test_latency_report_on_cpu(nets, tmp_path):
    _, cfg, _, _, _, pnets = nets
    out = str(tmp_path / "latency.json")
    r = latency_report.run(cfg, pnets, out, runs=2, sweep_n=6, clients=3,
                           max_batch=4, waits=(0.0, 5.0, 20.0),
                           device="cpu")
    b1 = r["b1_separate"]
    assert b1["device_ms_per_call"] is None           # no card: not measured
    assert b1["wall_p50_ms"] <= b1["wall_p95_ms"]
    pts = r["batching_sweep"]
    assert [p["max_wait_ms"] for p in pts] == [0.0, 5.0, 20.0]
    for p in pts:
        assert p["p50_ms"] <= p["p95_ms"] and 1 <= p["mean_batch"] <= 4
    assert r["calls"]["separate"] == 1 + 2 + sum(p["dispatches"]
                                                     for p in pts)
    import json
    with open(out) as f:
        assert len(json.load(f)["batching_sweep"]) == 3


def test_closed_loop_reports_a_client_error():
    def submit(i):
        raise RuntimeError(f"request {i} refused")
    with pytest.raises(RuntimeError, match="refused"):
        measure.closed_loop(submit, 4, 2)


# ------------------------------------------------------------ dtype A/B


def test_sep_dtype_ab_float32_leg_is_separate(nets):
    _, cfg, _, _, _, pnets = nets
    nets16 = engine.Nets(
        AudioUnet(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type, dtype=torch.bfloat16),
        TinyConvEncoder(32, "maxpool", dtype=torch.bfloat16))
    for n16, n32 in zip(nets16[:2], pnets[:2]):
        n16.load_state_dict(n32.state_dict(), strict=True)
    r = sep_dtype_ab.run(cfg, pnets, nets16, batch=B, iters=1, runs=1,
                         device="cpu")
    audio, frames = bench.draw_inputs(cfg, B, 1, CPU,
                                      seed=sep_dtype_ab.FIDELITY_SEED)
    want = engine.separate(pnets, audio[0], frames[0], cfg,
                           device="cpu")["wavs"]
    assert torch.equal(r["wavs"]["float32"], want)
    assert r["wavs"]["bfloat16"].shape == want.shape
    assert np.isfinite(r["bf16_snr_db"]) and 0.0 <= r["flip_rate"] <= 1.0
    assert r["calls"] == {"separate": 2 * (bench.WARMUP + 1 + 1)}
