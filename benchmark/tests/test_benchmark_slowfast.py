"""The cell ``slowfast.train`` (configuration ``clipatt_slowfast_r50``):
its files found by name, its FLOP counts (``counts/slowfast.py``) against
``torch.utils.flop_counter`` on the plain reference, and its readers
(``trace/slowfast.py``): the attribution on a hand-built trace, stretch L
on the CPU, and nothing read without a card, without the spans, or in a
cell whose motion net has no slow pathway."""

import argparse
import copy
import dataclasses
import json
import math
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import flops as kflops
from benchmark.counts import slowfast as kslowfast
from benchmark.drivers.train import PEAK_FLOPS
from benchmark.reference import slowfast as rslowfast
from benchmark.reference import train as rtrain
from benchmark.reference.nets import Precision
from benchmark.tests import tiny
from benchmark.trace import motion, slowfast

CELL = "slowfast.train"
SEED = 2 ** 33 + 9
METRICS = ("motion_slow.device_ms", "mfu.motion_slow",
           "motion_lateral.device_ms")
Op = motion.Op


@pytest.fixture(autouse=True)
def recorder_off():
    from avsep_tpu_torch.utils import spans
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def small_cell():
    """The cell at a CPU test's size: ``tiny``'s cut (unet5, 8191 samples,
    float32, two rows) at 64x64 and 16 frames, so the slow pathway reads
    two frames and its last norms see 16 values a channel."""
    c = tiny.cell(CELL)
    config = copy.deepcopy(c.config)
    config["flags"].update(clip_len=16)
    return dataclasses.replace(c, config=config)


def test_the_cell_is_found_by_name():
    cell = harness.find_cell(CELL)
    clips = harness.find_cell("clipatt.train")
    assert cell.chips == 1 and cell.traffic == clips.traffic
    changed = {k: v for k, v in cell.config["flags"].items()
               if clips.config["flags"].get(k) != v}
    assert changed == {"arch_motion": "slowfast_r50"}
    assert cell.config["reduced"] == []
    assert cell.config["reference"] == "clipatt_slowfast_r50"
    # the first loss is left out: the precision hardly moves it
    assert set(cell.limits) - {"readings"} == {"grad_gap.median",
                                               "change_gap.median"}
    names = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(names)
    assert "mfu.train" not in names and "mfu.motion" not in names
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s",
                                                    "setup_s"]


def test_slowfast_flops_equal_the_counter_at_published_widths():
    """The net's forward and backward on two 32 x 224 x 224 clips, on the
    meta device: every convolution at the published widths and shapes."""
    from avsep_tpu_torch.models.motion import ResNet3dSlowFast
    with torch.device("meta"):
        net = ResNet3dSlowFast()
    w = {"motion." + k: v.requires_grad_(rtrain.is_param(k))
         if v.is_floating_point() else v
         for k, v in net.state_dict(keep_vars=False).items()}
    clips = torch.empty(2, 32, 224, 224, 3, dtype=torch.uint8,
                        device="meta")
    with FlopCounterMode(display=False) as fc:
        y = rslowfast.slowfast_map(clips, w, Precision("float32"), True)
        torch.autograd.grad(y.sum(), [v for k, v in w.items()
                                      if rtrain.is_param(k)])
    # the fast pathway, the slow pathway, the laterals, and the 3x3 fc from
    # the 2048 + 256 channels of the time means at 7x7
    want = kflops.trained(
        kflops.resnet3d_fast(2, 32, 224, 224)
        + kslowfast.slow_pathway(2, 32, 224, 224)
        + kslowfast.laterals(2, 32, 224, 224)
        + [(kflops.conv_flops(2, 2048 + 256, 256, 3, 7, 7), True)])
    assert fc.get_total_flops() == want


def test_the_published_counts_by_hand():
    # forward per 224x224 clip of 32 frames: fast 10.57, slow 43.92,
    # laterals 0.79 GFLOP; trained per AV step of 16 rows x 2 sources
    one = [kflops.forward(f(1, 32, 224, 224)) for f in (
        kflops.resnet3d_fast, kslowfast.slow_pathway, kslowfast.laterals)]
    assert one == pytest.approx([10.565e9, 43.924e9, 0.78676e9], rel=1e-4)
    assert kflops.trained(kslowfast.slow_pathway(32, 32, 224, 224)) == \
        pytest.approx(4.18646e12, rel=1e-5)


def _hand_built():
    """A slow forward op inside ``motion.slow`` (seq 3), a lateral op
    inside ``motion.lateral`` (seq 4), a fast op outside both (seq 5), and
    the backward functions of all three, each over one kernel."""
    ops = [Op(1, 1, 1.0, 2.0, slowfast.SLOW, -1, 0, True),
           Op(2, 1, 1.2, 1.5, "aten::conv2d", 3, 0, False),
           Op(3, 1, 3.0, 4.0, slowfast.LATERAL, -1, 0, True),
           Op(4, 1, 3.2, 3.5, "aten::conv3d", 4, 0, False),
           Op(5, 1, 5.0, 6.0, "aten::conv3d", 5, 0, False),
           Op(6, 2, 10.0, 11.0, motion.BACKWARD + " ConvolutionBackward0",
              5, 1, False),
           Op(7, 2, 10.2, 10.8, "aten::convolution_backward", -1, 0, False),
           Op(8, 2, 12.0, 13.0, motion.BACKWARD + " ConvolutionBackward0",
              4, 1, False),
           Op(9, 2, 12.2, 12.8, "aten::convolution_backward", -1, 0, False),
           Op(10, 2, 14.0, 15.0, motion.BACKWARD + " ConvolutionBackward0",
              3, 1, False),
           Op(11, 2, 14.2, 14.8, "aten::convolution_backward", -1, 0, False)]
    device = [(1.5, 2.5, 2, "k_slow_fwd"), (3.5, 3.7, 4, "k_lateral_fwd"),
              (6.0, 7.0, 5, "k_fast_fwd"), (10.5, 11.5, 7, "k_fast_bwd"),
              (12.5, 12.9, 9, "k_lateral_bwd"),
              (14.5, 16.5, 11, "k_slow_bwd")]
    return ops, device


@dataclasses.dataclass
class _Rec:
    name: str
    counts: dict


def test_the_slow_pathway_and_the_laterals_by_their_spans():
    ops, device = _hand_built()
    rec = [_Rec("train.step", {}),
           _Rec("train.motion", {slowfast.COUNTER: 128})]
    flags = {"imgSize": 224, "clip_len": 32, "dtype": "bfloat16"}
    got = slowfast.from_events(ops, device, rec, flags)
    per_clip = kflops.trained(kslowfast.slow_pathway(1, 32, 224, 224))
    assert got["slow_frames"] == 128 and got["steps"] == 1
    assert got["slow_ms"] == pytest.approx(1e3 * (1.0 + 2.0))
    assert got["lateral_ms"] == pytest.approx(1e3 * (0.2 + 0.4))
    assert got["activities"] == [1, 1, 1, 1]
    assert got["flops"] == 32 * per_clip
    assert got["mfu"] == pytest.approx(100 * 32 * per_clip / 3.0
                                       / PEAK_FLOPS["bfloat16"])


def test_a_recording_without_the_spans_reads_nothing(monkeypatch):
    ops, device = _hand_built()
    ops = [o for o in ops if o.name != slowfast.SLOW]
    flags = {"imgSize": 224, "clip_len": 32, "dtype": "bfloat16"}
    assert slowfast.from_events(ops, device, [], flags) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", "3"])
    monkeypatch.setattr(motion, "_done", {(CELL, 3): None})
    monkeypatch.setattr(slowfast, "_done", {(CELL, 3): None})
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None
    # no run, no reading
    monkeypatch.setattr(sys, "argv", ["pytest"])
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None


def test_a_cell_without_the_slow_pathway_reads_nothing(monkeypatch):
    cell = tiny.cell("clipatt.train")
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    assert slowfast._measure("clipatt.train", 3) is None


def test_stretch_l_on_the_cpu_counts_the_slow_frames_and_traces_no_card(
        monkeypatch):
    cell = small_cell()
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    got = slowfast._measure(CELL, SEED)
    flags = cell.config["flags"]
    frames = cell.traffic["batch_per_card"] * flags["num_mix"] * \
        math.ceil(flags["clip_len"] / 8)
    assert got == {"steps": slowfast.STEPS, "slow_frames": frames}
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", str(SEED)])
    monkeypatch.setattr(motion, "_done", {(CELL, SEED): None})
    monkeypatch.setattr(slowfast, "_done", {(CELL, SEED): got})
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None



def test_a_sound_run_is_correct(capsys):
    """A run at the small size: sound, and held to the cell's limits."""
    from benchmark import run
    args = argparse.Namespace(workload=CELL, seed=2 ** 32 + 9, seconds=1.0,
                              trace=0)
    assert run.run(args, device="cpu", cell=small_cell(),
                   t_start=time.time()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["checks"]) == {"grad_gap.median", "change_gap.median"}
