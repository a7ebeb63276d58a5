"""The cell ``x3d.train`` (configuration ``clipatt_x3d_m``): its files
found by name and its configuration parsed into the program's ``Config``,
its counts (``counts/x3d.py``) against ``torch.utils.flop_counter`` on the
plain reference and against a hand count, and its readers
(``trace/x3d.py``): the attribution on a hand-built trace, stretch X on the
CPU, and nothing read without a card, without the spans, or in a cell
whose motion net is no X3D."""

import argparse
import copy
import dataclasses
import json
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.counts import bytes as kbytes
from benchmark.counts import flops as kflops
from benchmark.counts import x3d as kx3d
from benchmark.reference import train as rtrain
from benchmark.reference import x3d as rx3d
from benchmark.reference.nets import Precision
from benchmark.tests import tiny
from benchmark.trace import motion, x3d

CELL = "x3d.train"
SEED = 2 ** 33 + 27
METRICS = ("motion_channelwise.device_ms", "motion_channelwise_roofline",
           "motion_se.device_ms")
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
    float32, two rows) at 64x64 and the cell's 16 frames."""
    c = tiny.cell(CELL)
    config = copy.deepcopy(c.config)
    assert config["flags"]["clip_len"] == 16
    return dataclasses.replace(c, config=config)


def test_the_cell_is_found_by_name_and_its_flags_parse():
    from benchmark.drivers.train import port_config
    cell = harness.find_cell(CELL)
    slowfast = harness.find_cell("slowfast.train")
    assert cell.chips == 1 and cell.traffic == slowfast.traffic
    changed = {k: v for k, v in cell.config["flags"].items()
               if slowfast.config["flags"].get(k) != v}
    assert changed == {"arch_motion": "x3d_m", "clip_len": 16}
    assert cell.config["reduced"] == []
    assert cell.config["reference"] == "clipatt_x3d_m"
    cfg = port_config(cell.config)
    assert (cfg.arch_motion, cfg.clip_len, cfg.dtype) == \
        ("x3d_m", 16, "bfloat16")
    motion_cfg = cell.config["motion"]
    assert motion_cfg["stage_blocks"] == list(kx3d.BLOCKS)
    assert motion_cfg["se"]["bottleneck_channels"] == \
        [kx3d.se_width(c) for c in motion_cfg["stage_inner_channels"]]
    assert set(cell.limits) - {"readings"} == {
        "loss_gap.first", "grad_gap.median", "change_gap.median"}
    names = [m["name"] for m in cell.per_layer]
    assert set(METRICS) <= set(names) and "motion.device_ms" in names
    assert "mfu.train" not in names and "mfu.motion" not in names
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_per_s",
                                                    "setup_s"]


def test_x3d_flops_equal_the_counter_at_published_widths():
    """The net's forward, then its forward and backward, on two 16 x 224 x
    224 clips, on the meta device: every convolution at the published
    widths and shapes.  The counter takes a grouped convolution's weight
    gradient for a dense one over the batch (``conv_backward_flop``
    ignores the groups), so it counts each channelwise convolution's
    ``groups - 1`` forwards more, which the trained count adds back."""
    from avsep_tpu_torch.models.x3d import X3D
    with torch.device("meta"):
        net = X3D()
    w = {"motion." + k: v.requires_grad_(rtrain.is_param(k))
         if v.is_floating_point() else v
         for k, v in net.state_dict(keep_vars=False).items()}
    clips = torch.empty(2, 16, 224, 224, 3, dtype=torch.uint8,
                        device="meta")
    convs = kx3d.backbone(2, 16, 224, 224) + kx3d.fc(2, 224, 224)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        rx3d.x3d_map(clips, w, Precision("float32"), True)
    assert fc.get_total_flops() == kflops.forward(convs)
    with FlopCounterMode(display=False) as fc:
        y = rx3d.x3d_map(clips, w, Precision("float32"), True)
        torch.autograd.grad(y.sum(), [v for k, v in w.items()
                                      if rtrain.is_param(k)])
    # each channelwise convolution: its groups (one a channel), the
    # elements of its output on one clip, its taps
    shapes = kx3d.channelwise_shapes(16, 224, 224)
    groups = [24] + [inner for _, inner, *_ in kx3d._shapes(
        16, 224, 224, kx3d.BASE, kx3d.GAMMA_B, kx3d.BLOCKS)]
    taps = [5] + [27] * (len(shapes) - 1)
    assert len(groups) == len(shapes) == 1 + sum(kx3d.BLOCKS)
    assert fc.get_total_flops() == kflops.trained(convs) + sum(
        (g - 1) * 2 * 2 * out * k
        for g, (_, out), k in zip(groups, shapes, taps))


def test_the_published_counts_by_hand():
    # X3D-M's 4.73 GMAC per 16 x 224 x 224 clip (the paper's table)
    assert kx3d.macs(kx3d.backbone(1, 16, 224, 224)) == \
        pytest.approx(4.73e9, rel=1e-3)
    # channelwise: per clip, input + output elements of the stem's 5x1x1
    # (24 x 16 x 112^2 twice) and of each block's 3x3x3 (block 0 of a
    # stage from the stage's input map to half its side)
    m = [16 * s * s for s in (112, 56, 28, 14, 7)]
    per_clip = (2 * 24 * m[0]
                + 54 * (m[0] + m[1]) + 2 * 2 * 54 * m[1]
                + 108 * (m[1] + m[2]) + 4 * 2 * 108 * m[2]
                + 216 * (m[2] + m[3]) + 10 * 2 * 216 * m[3]
                + 432 * (m[3] + m[4]) + 6 * 2 * 432 * m[4])
    got = kx3d.channelwise(32, 16, 224, 224)
    assert got == 3 * 2 * 32 * per_clip
    assert got == pytest.approx(14.27e9, rel=1e-3)     # per AV step
    assert 1e3 * kbytes.least_seconds(got) == pytest.approx(4.26, rel=1e-3)
    assert [kx3d.se_width(c) for c in (54, 108, 216, 432)] == [8, 8, 16, 32]


def _hand_built():
    """A channelwise op inside ``motion.channelwise`` (seq 3), a gate op
    inside ``motion.se`` (seq 4), a 1x1x1 op outside both (seq 5), and the
    backward functions of all three, each over one kernel."""
    ops = [Op(1, 1, 1.0, 2.0, x3d.CHANNELWISE, -1, 0, True),
           Op(2, 1, 1.2, 1.5, "aten::conv3d", 3, 0, False),
           Op(3, 1, 3.0, 4.0, x3d.SE, -1, 0, True),
           Op(4, 1, 3.2, 3.5, "aten::sigmoid", 4, 0, False),
           Op(5, 1, 5.0, 6.0, "aten::conv3d", 5, 0, False),
           Op(6, 2, 10.0, 11.0, motion.BACKWARD + " ConvolutionBackward0",
              5, 1, False),
           Op(7, 2, 10.2, 10.8, "aten::convolution_backward", -1, 0, False),
           Op(8, 2, 12.0, 13.0, motion.BACKWARD + " SigmoidBackward0",
              4, 1, False),
           Op(9, 2, 12.2, 12.8, "aten::sigmoid_backward", -1, 0, False),
           Op(10, 2, 14.0, 15.0, motion.BACKWARD + " ConvolutionBackward0",
              3, 1, False),
           Op(11, 2, 14.2, 14.8, "aten::convolution_backward", -1, 0, False)]
    device = [(1.5, 2.5, 2, "k_cw_fwd"), (3.5, 3.7, 4, "k_se_fwd"),
              (6.0, 7.0, 5, "k_pw_fwd"), (10.5, 11.5, 7, "k_pw_bwd"),
              (12.5, 12.9, 9, "k_se_bwd"), (14.5, 16.5, 11, "k_cw_bwd")]
    return ops, device


@dataclasses.dataclass
class _Rec:
    name: str
    counts: dict


def test_the_channelwise_convolutions_and_the_gates_by_their_spans():
    ops, device = _hand_built()
    rec = [_Rec("train.step", {}), _Rec("train.motion", {x3d.COUNTER: 32})]
    flags = {"imgSize": 224, "clip_len": 16, "dtype": "bfloat16"}
    got = x3d.from_events(ops, device, rec, flags)
    n_bytes = kx3d.channelwise(32, 16, 224, 224)
    assert got["clips"] == 32 and got["steps"] == 1
    assert got["channelwise_ms"] == pytest.approx(1e3 * (1.0 + 2.0))
    assert got["se_ms"] == pytest.approx(1e3 * (0.2 + 0.4))
    assert got["activities"] == [1, 1, 1, 1]
    assert got["bytes"] == n_bytes
    assert got["roofline"] == pytest.approx(
        100 * n_bytes / kbytes.HBM_BYTES_PER_S / 3.0)


def test_a_recording_without_the_spans_reads_nothing(monkeypatch):
    ops, device = _hand_built()
    ops = [o for o in ops if o.name != x3d.CHANNELWISE]
    flags = {"imgSize": 224, "clip_len": 16, "dtype": "bfloat16"}
    assert x3d.from_events(ops, device, [], flags) is None
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", "3"])
    monkeypatch.setattr(motion, "_done", {(CELL, 3): None})
    monkeypatch.setattr(x3d, "_done", {(CELL, 3): None})
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None
    # no run, no reading
    monkeypatch.setattr(sys, "argv", ["pytest"])
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None


@pytest.mark.parametrize("other", ["clipatt.train", "slowfast.train"])
def test_a_cell_without_x3d_reads_nothing(monkeypatch, other):
    cell = tiny.cell(other)
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    assert x3d._measure(other, 3) is None


def test_stretch_x_on_the_cpu_counts_the_clips_and_traces_no_card(
        monkeypatch):
    cell = small_cell()
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    got = x3d._measure(CELL, SEED)
    flags = cell.config["flags"]
    clips = cell.traffic["batch_per_card"] * flags["num_mix"]
    assert got == {"steps": x3d.STEPS, "clips": clips}
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", CELL,
                                      "--seed", str(SEED)])
    monkeypatch.setattr(motion, "_done", {(CELL, SEED): None})
    monkeypatch.setattr(x3d, "_done", {(CELL, SEED): got})
    for name in METRICS:
        assert harness.layer_reader(name)({"kind": "train"}) is None


def test_a_sound_run_is_correct(capsys):
    """A run at the small size: sound, and held to the cell's limits."""
    from benchmark import run
    args = argparse.Namespace(workload=CELL, seed=2 ** 32 + 27, seconds=1.0,
                              trace=0)
    assert run.run(args, device="cpu", cell=small_cell(),
                   t_start=time.time()) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["checks"]) == {"loss_gap.first", "grad_gap.median",
                                   "change_gap.median"}


@pytest.mark.cuda
def test_the_training_control_is_not_correct():
    """At the cell's own size on a card: the program passes the cell's
    limits, the fp8 control and the half batch each fail one.  Skips
    without a card."""
    from benchmark import calibrate
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's precisions run there")
    cell = tiny.full(CELL)
    row = calibrate.train_seed(cell, 2 ** 32 + 17, control=True)

    def fails(numbers):
        return any(numbers[k] > float(v) for k, v in cell.limits.items()
                   if k in numbers)

    assert not fails(row["program"])
    assert fails(row["control"])
    assert fails(row["half_batch"])
