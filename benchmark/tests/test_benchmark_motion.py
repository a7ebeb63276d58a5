"""The motion net's readings (``benchmark/trace/motion.py``) and the
program's span and counter they read: the attribution on a hand-built
trace and on a real CPU trace of the clips cell's step, the clips counted
per step kind (eagerly, and by a replayed graph), stretch M on the CPU,
and nothing read where no ``train.motion`` span ran."""

import contextlib
import dataclasses
import sys

import pytest
import torch

from benchmark import data, harness
from benchmark.counts import flops as kflops
from benchmark.drivers.train import PEAK_FLOPS, Program
from benchmark.tests import tiny
from benchmark.trace import motion

CELL = "clipatt.train"
SEED = 2 ** 33 + 7
Op = motion.Op


@pytest.fixture(autouse=True)
def recorder_off():
    from avsep_tpu_torch.utils import spans
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


@dataclasses.dataclass
class _Rec:
    name: str
    counts: dict


def _hand_built():
    """A motion forward op inside ``train.motion`` (seq 7 on thread 1), a
    U-Net forward op outside it (seq 9), an op of another thread that
    shares the motion op's sequence number, and the backward functions of
    all three on the autograd thread 2, each over one kernel."""
    ops = [Op(1, 1, 1.0, 5.0, motion.SPAN, -1, 0, True),
           Op(2, 1, 1.5, 2.0, "aten::conv3d", 7, 0, False),
           Op(3, 1, 6.0, 7.0, "aten::conv2d", 9, 0, False),
           Op(4, 3, 1.6, 1.9, "aten::add", 7, 0, False),
           Op(5, 2, 10.0, 12.0, motion.BACKWARD + " ConvolutionBackward0",
              9, 1, False),
           Op(6, 2, 10.5, 11.5, "aten::convolution_backward", -1, 0, False),
           Op(7, 2, 13.0, 15.0, motion.BACKWARD + " ConvolutionBackward0",
              7, 1, False),
           Op(8, 2, 13.5, 14.5, "aten::convolution_backward", -1, 0, False),
           Op(9, 2, 16.0, 17.0, motion.BACKWARD + " AddBackward0", 7, 3,
              False),
           Op(10, 2, 16.2, 16.8, "aten::mul", -1, 0, False)]
    device = [(2.0, 3.0, 2, "k_motion_fwd"), (6.5, 8.0, 3, "k_unet_fwd"),
              (11.0, 12.5, 6, "k_unet_bwd"), (14.0, 16.0, 8, "k_motion_bwd"),
              (16.5, 16.9, 10, "k_other_thread_bwd"),
              (1.0, 16.0, 1, motion.SPAN)]   # the card's copy of the span
    return ops, device


def test_the_motion_net_is_its_forward_and_its_backward_by_sequence():
    ops, device = _hand_built()
    acts, n_fwd, n_bwd = motion.motion_activities(ops, device)
    assert sorted(acts) == [(2.0, 3.0), (14.0, 16.0)]
    assert (n_fwd, n_bwd) == (1, 1)
    rec = [_Rec("train.step", {}),
           _Rec("train.motion", {"motion.clips": 32})]
    flags = {"imgSize": 224, "clip_len": 32, "dtype": "bfloat16"}
    got = motion.from_events(ops, device, rec, flags)
    per_clip = kflops.trained(kflops.resnet3d_fast(1, 32, 224, 224))
    assert got["clips"] == 32 and got["steps"] == 1
    assert got["device_ms"] == pytest.approx(1e3 * (1.0 + 2.0))
    assert got["mfu"] == pytest.approx(100 * 32 * per_clip / 3.0
                                       / PEAK_FLOPS["bfloat16"])
    # the whole step's busy time leaves the span's range out
    assert got["step_device_ms"] == pytest.approx(
        1e3 * (1 + 1.5 + 1.5 + 2 + 0.4))


def test_a_recording_without_the_span_reads_nothing(monkeypatch):
    ops, device = _hand_built()
    ops = [o for o in ops if o.name != motion.SPAN]
    flags = {"imgSize": 224, "clip_len": 32, "dtype": "bfloat16"}
    got = motion.from_events(ops, device, [_Rec("train.step", {})], flags)
    assert got is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", "3"])
    monkeypatch.setattr(motion, "_done", {(CELL, 3): got})
    for name in ("motion.device_ms", "mfu.motion"):
        assert harness.layer_reader(name)({"kind": "train"}) is None


def test_a_cell_without_clips_reads_nothing(monkeypatch):
    cell = tiny.cell("music.train")
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    assert motion._measure("music.train", 3) is None


def _clips_program():
    return Program(tiny.cell(CELL), SEED, "cpu")


def test_every_av_step_counts_rows_times_sources_and_an_ao_step_none():
    from avsep_tpu_torch.utils import spans
    prog = _clips_program()
    spans.drain()
    with spans.recording():
        for _ in range(4):
            prog.step(prog.random_indices())
    rec = spans.drain().records
    kids = spans.descendants(rec)
    got = [(r.attrs["kind"], spans.inclusive_counts(r, kids).get(
        motion.COUNTER, 0)) for r in rec if r.name == "train.step"]
    assert got == [("av", prog.B * prog.N), ("ao", 0)] * 2


class _FakeGraph:
    """A CUDA graph stand-in on the CPU: the capture runs the step once
    (what the real capture's first replay does), a replay runs nothing."""

    def replay(self):
        pass


@contextlib.contextmanager
def _fake_capture(graph, capture_error_mode="global"):
    yield


@pytest.mark.parametrize("use_vis", [True, False])
def test_a_replayed_step_counts_the_clips_its_capture_ran(use_vis,
                                                          monkeypatch):
    from avsep_tpu_torch import train
    from avsep_tpu_torch.utils import spans
    monkeypatch.setattr(train, "graphable", lambda d: True)
    monkeypatch.setattr(train.GraphedStep, "_put_uniforms",
                        lambda self, static, u: static.copy_(u))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", _fake_capture)
    prog = _clips_program()
    cpu = torch.device("cpu")
    step = train.GraphedStep(prog.cfg, use_vis, train.make_eager_train_step(
        prog.cfg, prog.state.nets, use_vis, cpu), cpu)
    batch = data.train_batch(prog.pool, prog.random_indices(), use_vis,
                             prog.stream)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):                  # eager, then the capture: off
        step(prog.state, batch, generator=gen)
    assert step.graph is not None
    with spans.recording():
        step(prog.state, batch, generator=gen)
    rec = spans.drain().records
    assert [r.name for r in rec] == ["train.step"]
    assert rec[0].counts.get("train.graph_replay") == 1
    assert rec[0].counts.get(motion.COUNTER, 0) == \
        (prog.B * prog.N if use_vis else 0)


def test_stretch_m_on_the_cpu_counts_the_clips_and_traces_no_card(
        monkeypatch):
    cell = tiny.cell(CELL)
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    got = motion._measure(CELL, SEED)
    B = cell.traffic["batch_per_card"]
    assert got == {"steps": motion.STEPS,
                   "clips": B * cell.config["flags"]["num_mix"]}


def test_the_attribution_on_a_real_trace_of_the_step():
    """One eager AV step of the clips cell profiled on the CPU, each
    forward 3-D convolution and each convolution's backward function
    standing in for a kernel: the motion net's are exactly the fast
    pathway's convolutions of every source, and none of the U-Net's."""
    from torch.profiler import ProfilerActivity, profile

    from avsep_tpu_torch import train
    from avsep_tpu_torch.utils import spans
    prog = _clips_program()
    step = train.make_eager_train_step(prog.cfg, prog.state.nets, True,
                                       "cpu")
    batch = data.train_batch(prog.pool, prog.random_indices(), True,
                             prog.stream)
    with spans.recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(prog.state, batch)
    ops, device = motion.trace_events(prof)
    assert device == []
    conv_bwd = motion.BACKWARD + " ConvolutionBackward0"
    fwd = [o for o in ops if o.name == "aten::conv3d"]
    bwd = [o for o in ops if o.name == conv_bwd]
    unet = [o for o in ops if o.name in ("aten::conv2d",
                                         "aten::conv_transpose2d")]
    assert unet
    flags = prog.cfg
    convs = len(kflops.resnet3d_fast(1, flags.clip_len, flags.imgSize,
                                     flags.imgSize))
    fake = [(o.t0, o.t1, o.id, "k") for o in fwd + bwd + unet]
    acts, n_fwd, n_bwd = motion.motion_activities(ops, fake)
    assert n_fwd == len(fwd) == prog.N * convs
    # the stem takes no input gradient but its weight's: every conv has a
    # backward function
    assert n_bwd == prog.N * convs < len(bwd)
    assert len(acts) == n_fwd + n_bwd


def test_the_configuration_is_music_hidsep_on_clips():
    """``clipatt_slowfast`` is ``music_hidsep``'s flags with the visual
    stream turned to 32-frame clips through the motion net, uncut."""
    clips, music = tiny.full(CELL).config, tiny.full("music.train").config
    changed = {k: v for k, v in clips["flags"].items()
               if music["flags"].get(k) != v}
    assert changed == {"fusion_type": "CoLoc_ClipAtt", "load_clips": True,
                       "clip_len": 32, "lr_motion": 1e-4}
    assert set(music["flags"]) <= set(clips["flags"])
    assert clips["reduced"] == [] and clips["reference"] == "music_hidsep"
    assert tiny.full(CELL).traffic == tiny.full("music.train").traffic
