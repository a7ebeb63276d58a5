"""The span recorder (``avsep_tpu_torch/utils/spans.py``) in the port's
train steps, service and collectives, on the CPU at a small size: off it
keeps nothing and enters no ``record_function``; on it records the names
the benchmark's readers key on, with their parents, request ids and
counts."""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, sop_main, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models.motion import ResNet3dFastOnly
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.serve import (
    SeparationService, separate_remote, serve_forever)
from avsep_tpu_torch.utils import spans
from tests.torch_dist_worker import launch, wait_all

SMALL = dict(arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
             vis_channels=32, fusion_type="hidsep", att_type="sig",
             loss="bce", not_pool_vis=False, binary_mask=1, weighted_loss=1,
             num_mix=2, audLen=16383, imgSize=64, one_frame=True,
             match_weight=0.1, lr_sound=1e-2, lr_frame=1e-3, lr_steps=(2,))
SOP = dict(SMALL, arch_synthesizer="linear", num_channels=8, vis_channels=8,
           fusion_type="Base", att_type="cos", sound_activation="no",
           lr_synthesizer=1e-2, audLen=8191)
# the motion net on 4-frame 32x32 clips at base 1, one block per stage
CLIPS = dict(SMALL, fusion_type="CoLoc_ClipAtt", load_clips=True,
             clip_len=4, imgSize=32, lr_motion=1e-2)
STEP_KIDS = ("train.forward", "train.backward", "train.grad_mean",
             "train.update", "train.metrics")
WAIT = 120  # seconds: the bound on every future, socket and join


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def small_nets(cfg):
    torch.manual_seed(0)
    return engine.Nets(AudioUnet(fc_dim=2, num_downs=5, ngf=8,
                                 fusion_type=cfg.fusion_type,
                                 att_type=cfg.att_type),
                       TinyConvEncoder(32, "maxpool"))


def batch(cfg, B=2, seed=0):
    rs = np.random.RandomState(seed)
    return {"audios": torch.from_numpy(
                (rs.randn(B, 2, cfg.audLen) * 0.05).astype(np.float32)),
            "frames": torch.from_numpy(rs.randint(
                0, 256, (B, 2, 1, 64, 64, 3)).astype(np.uint8))}


def avsep_step(use_vis):
    cfg = Config(**SMALL)
    nets = small_nets(cfg)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    step = train.make_train_step(cfg, nets, use_vis, device="cpu")
    gen = torch.Generator().manual_seed(1)
    return lambda: step(state, batch(cfg), generator=gen)


def sop_step(use_vis):
    cfg = Config(**SOP)
    nets = sop_main.build_sop_nets(cfg, device="cpu")
    state = sop_main.init_sop_state(cfg, nets, torch.Generator()
                                    .manual_seed(0), device="cpu")
    step = sop_main.make_sop_train_step(cfg, state.nets, use_vis, 3,
                                        device="cpu")
    return lambda: step(state, batch(cfg))


def clips_step(use_vis):
    cfg = Config(**CLIPS)
    torch.manual_seed(0)
    nets = engine.Nets(
        AudioUnet(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type), TinyConvEncoder(32, "maxpool"),
        ResNet3dFastOnly(base_channels=1, stage_blocks=(1, 1, 1, 1)))
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    step = train.make_train_step(cfg, nets, use_vis, device="cpu")
    gen = torch.Generator().manual_seed(1)
    b = {"audios": batch(cfg)["audios"],
         "clips": torch.from_numpy(np.random.RandomState(2).randint(
             0, 256, (2, 2, 4, 32, 32, 3)).astype(np.uint8))}
    return lambda: step(state, b, generator=gen)


STEPS = {"av": lambda: avsep_step(True), "ao": lambda: avsep_step(False),
         "sop_av": lambda: sop_step(True), "sop_ao": lambda: sop_step(False),
         "clips_av": lambda: clips_step(True),
         "clips_ao": lambda: clips_step(False)}


def profiled_names(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("which", ["av", "ao"])
def test_off_the_step_keeps_nothing_and_enters_no_record_function(which):
    step = STEPS[which]()
    assert spans.span("train.step") is spans.span("train.forward")
    names = profiled_names(step)
    assert not any(n.startswith(("train.", "dp.")) for n in names), names
    rec = spans.drain()
    assert rec.records == [] and rec.loose == {}


@pytest.mark.parametrize("which", ["av", "ao", "sop_av", "sop_ao",
                                   "clips_av", "clips_ao"])
def test_on_a_step_records_the_names_the_readers_key_on(which):
    step = STEPS[which]()
    step()                             # the first call builds caches
    spans.drain()
    with spans.recording():
        spans.correlate(41)
        names = profiled_names(step)
    every = spans.drain().records
    # the motion net's spans (an AV step on clips: one per source, inside
    # the forward); the step's own phases are the same in every kind
    motion = [r for r in every if r.name == "train.motion"]
    recs = [r for r in every if r.name != "train.motion"]
    assert sorted(r.name for r in recs) == sorted(("train.step",)
                                                  + STEP_KIDS)
    top = [r for r in recs if r.name == "train.step"]
    assert len(top) == 1 and top[0].parent is None
    assert top[0].attrs == {"kind": "ao" if which.endswith("ao") else "av"}
    assert all(r.parent == top[0].id for r in recs if r is not top[0])
    assert {r.cid for r in every} == {41}
    assert {r.thread for r in every} == {threading.get_ident()}
    # the profiler shows the phases: each span entered record_function
    assert {"train.step", *STEP_KIDS} <= names
    kids = [r for r in recs if r is not top[0]]
    assert all(top[0].t0 <= r.t0 <= r.t1 <= top[0].t1 for r in kids)
    order = sorted(kids, key=lambda r: r.t0)
    assert [r.name for r in order] == list(STEP_KIDS)
    counts = spans.summary(every)["train.step"]["counts"]
    if which != "clips_av":
        assert motion == [] and "train.motion" not in names
        assert "motion.clips" not in counts
        return
    forward = next(r for r in recs if r.name == "train.forward")
    assert len(motion) == 2 and "train.motion" in names
    assert all(r.parent == forward.id and r.attrs == {"clips": 2,
                                                      "frames": 4}
               and forward.t0 <= r.t0 <= r.t1 <= forward.t1
               for r in motion)
    # rows x num_mix clips ran through the net
    assert counts["motion.clips"] == 2 * 2


def test_self_time_is_the_duration_less_the_children():
    step = STEPS["av"]()
    with spans.recording():
        step()
    recs = spans.drain().records
    s = spans.summary(recs)
    top = next(r for r in recs if r.name == "train.step")
    kids = sum(r.seconds for r in recs if r.parent == top.id)
    assert s["train.step"]["count"] == 1
    assert s["train.step"]["total_s"] == pytest.approx(top.seconds)
    assert s["train.step"]["self_s"] == pytest.approx(top.seconds - kids,
                                                      abs=1e-9)
    for name in STEP_KIDS:               # leaves: all of it is their own
        assert s[name]["self_s"] == pytest.approx(s[name]["total_s"])


def test_self_time_counts_overlapping_children_once():
    rec = spans.Record("a", 0.0, 10.0, 1, None, 0, None, {}, {})
    kids = [spans.Record("b", 1.0, 4.0, 2, 1, 0, None, {}, {}),
            spans.Record("c", 3.0, 6.0, 3, 1, 0, None, {}, {}),
            spans.Record("d", 9.0, 12.0, 4, 1, 0, None, {}, {})]
    assert spans.self_seconds(rec, kids) == pytest.approx(10 - 5 - 1)


class FakeCuda:
    def __init__(self, mode):
        self.mode = mode

    def get_sync_debug_mode(self):
        return self.mode

    def set_sync_debug_mode(self, mode):
        self.mode = {"warn": 1, "default": 0}.get(mode, mode)


def test_turning_the_recorder_off_restores_the_sync_debug_mode(monkeypatch):
    cuda = FakeCuda(2)
    monkeypatch.setattr(spans, "_sync_debug", lambda: cuda)
    shown = []
    before = warnings.showwarning
    filters = list(warnings.filters)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **kw: shown.append(str(a[0]))
        previous = warnings.showwarning
        spans.enable()
        assert cuda.mode == 1 and spans.counting_syncs()
        with spans.span("train.step"):
            with spans.span("train.forward"):
                for _ in range(3):
                    warnings.warn("called a synchronizing CUDA operation")
            warnings.warn("something else")
        warnings.warn("called a synchronizing CUDA operation")
        spans.disable()
        assert cuda.mode == 2 and not spans.counting_syncs()
        assert warnings.showwarning is previous
        assert not any(f[1] is not None and "synchroniz" in f[1].pattern
                       for f in warnings.filters)
    assert warnings.showwarning is before
    assert list(warnings.filters) == filters
    assert shown == ["something else"]
    rec = spans.drain()
    forward = next(r for r in rec.records if r.name == "train.forward")
    assert forward.counts == {spans.SYNC: 3}
    assert rec.loose == {spans.SYNC: 1}
    kids = spans.descendants(rec.records)
    step = next(r for r in rec.records if r.name == "train.step")
    assert spans.inclusive_counts(step, kids) == {spans.SYNC: 3}
    assert rec.totals() == {spans.SYNC: 4}


def test_timed_reads_the_clock_on_or_off_and_records_only_on():
    with spans.timed("train.data_wait") as off:
        time.sleep(0.002)
    assert off.seconds >= 0.002 and spans.drain().records == []
    with spans.recording():
        with spans.timed("train.data_wait") as on:
            time.sleep(0.002)
    (r,) = spans.drain().records
    assert (r.name, r.t0, r.t1) == ("train.data_wait", on.t0, on.t1)


def test_the_recorder_nests_and_restores_its_state():
    with spans.recording():
        with spans.recording():
            pass
        assert spans.enabled()     # the outer block still records
    assert not spans.enabled()


@pytest.fixture(scope="module")
def service():
    cfg = Config(**SMALL)
    nets = small_nets(cfg)
    for _, net in train.modules(nets):
        net.eval()
    svc = SeparationService(cfg, nets, device="cpu", max_batch=2,
                            max_wait_ms=300.0)
    server = serve_forever(svc, port=0)
    yield svc, server.server_address
    server.shutdown()
    svc.close()


def test_two_concurrent_requests_carry_their_ids(service):
    svc, (host, port) = service
    rs = np.random.RandomState(0)
    mixes = [(0.05 * rs.randn(svc.cfg.audLen)).astype(np.float32)
             for _ in range(2)]
    got = [None, None]

    def client(i):
        got[i] = separate_remote(host, port, mixes[i], timeout=WAIT)
    with spans.recording():
        ts = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT)
        assert not any(t.is_alive() for t in ts)
    # a handler closes its serve.reply span after the client has read the
    # reply: wait for both, within the bound
    recs, deadline = [], time.monotonic() + WAIT
    while sum(r.name == "serve.reply" for r in recs) < 2 and \
            time.monotonic() < deadline:
        recs += spans.drain().records
        time.sleep(0.01)
    assert all(g is not None for g in got)
    by_name = {}
    for r in recs:
        by_name.setdefault(r.name, []).append(r)
    ids = [r.cid for r in by_name["serve.recv"]]
    assert len(ids) == 2 and len(set(ids)) == 2
    assert sorted(r.cid for r in by_name["serve.queue"]) == sorted(ids)
    assert sorted(r.cid for r in by_name["serve.reply"]) == sorted(ids)
    dispatched = [i for r in by_name["serve.dispatch"]
                  for i in r.attrs["requests"]]
    assert sorted(dispatched) == sorted(ids)
    for r in by_name["serve.dispatch"]:
        assert r.attrs["kind"] == "ao"
        assert r.attrs["rows"] == len(r.attrs["requests"])
        assert r.cid == r.attrs["requests"][0]
        kids = sorted((k for k in recs if k.parent == r.id),
                      key=lambda k: k.t0)
        assert [k.name for k in kids] == ["serve.h2d", "serve.separate",
                                          "serve.d2h"]
        assert all(k.cid == r.cid for k in kids)
    for rid in ids:
        recv = next(r for r in by_name["serve.recv"] if r.cid == rid)
        queue = next(r for r in by_name["serve.queue"] if r.cid == rid)
        reply = next(r for r in by_name["serve.reply"] if r.cid == rid)
        assert recv.t1 <= queue.t0 <= queue.t1 <= reply.t0
    assert sum(r.attrs["rows"] for r in by_name["serve.collect"]) == 2
    snap = svc.stats.snapshot()
    assert {"requests", "dispatches", "mean_batch", "p50_ms", "p95_ms",
            "queue_p50_ms", "queue_p95_ms"} <= set(snap)
    assert snap["queue_p95_ms"] >= snap["queue_p50_ms"] >= 0
    # the dispatch latency is the serve.dispatch span's clock reads
    assert svc.stats.latencies_ms[-len(by_name["serve.dispatch"]):] == \
        pytest.approx([1e3 * r.seconds for r in by_name["serve.dispatch"]])


def test_the_service_off_keeps_nothing(service):
    svc, (host, port) = service
    mix = np.zeros(svc.cfg.audLen, np.float32)
    n = len(svc.stats.queue_ms)
    separate_remote(host, port, mix, timeout=WAIT)
    assert spans.drain().records == []
    assert len(svc.stats.queue_ms) == n + 1


def test_two_gloo_ranks_count_their_collectives(tmp_path):
    cfg = Config(**SMALL)
    nets = small_nets(cfg)
    weights = {name: net.state_dict() for name, net in nets._asdict().items()
               if net is not None}
    batches = []
    for i in range(2):
        b = batch(cfg, B=4, seed=10 + i)
        batches.append({k: v.numpy() for k, v in b.items()})
    spec = {"port": {"kind": "train", "cfg": cfg, "weights": weights,
                     "seq": (True, False), "batches": batches,
                     "uniforms": [None, None], "seed": 3, "spans": True}}
    torch.save(spec, tmp_path / "spec.pt")
    procs = launch(lambda r: ["jobs", tmp_path / "spec.pt", r, 2,
                              tmp_path / "init", tmp_path / f"rank{r}.pt"], 2)
    wait_all(procs, timeout=WAIT * 3)
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)["port"]
           for r in (0, 1)]
    for steps in got:
        for step in steps:
            issued = step["issued"]
            # the gradient mean, the metrics and the global BatchNorm's
            # sums, forward and backward
            assert issued["calls"] > 2
            assert step["totals"]["dp.collectives"] == issued["calls"]
            assert step["totals"]["dp.bytes"] == issued["bytes"]
            names = {r[1]: r[0] for r in step["spans"]}
            reduces = [r for r in step["spans"] if r[0] == "dp.all_reduce"]
            assert len(reduces) == issued["calls"]
            parents = {names.get(r[2]) for r in reduces}
            assert {"train.grad_mean", "train.metrics",
                    "train.forward"} <= parents
    assert [[s["issued"] for s in steps] for steps in got[:1]] == \
        [[s["issued"] for s in steps] for steps in got[1:]]
