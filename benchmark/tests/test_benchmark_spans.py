"""The readings from the program's spans (``benchmark/trace/spans.py``):
the idle attribution on a synthetic trace, the anchors' clock offset, and
a traced CPU run at a small size that reads them after the run."""

import argparse
import copy
import sys
import time
from collections import namedtuple

import pytest

from benchmark import harness, run
from benchmark.drivers import train as dtrain
from benchmark.tests import tiny
from benchmark.trace import spans as bspans

Rec = namedtuple("Rec", "name t0 t1 id parent")
Kind = namedtuple("Kind", "name t0 t1 id parent attrs")
NEW = ("train.host_ms", "train.syncs", "train.dispatch_idle_ms")


def _steps():
    """Two steps of 10 s, each a ``train.step`` over a forward and a
    backward, with a ``train.loss_read`` outside them."""
    recs = []
    for k, t in enumerate((0.0, 20.0)):
        base = 10 * k
        recs += [Rec("train.step", t + 1, t + 11, base + 1, None),
                 Rec("train.forward", t + 1, t + 5, base + 2, base + 1),
                 Rec("train.backward", t + 5, t + 10, base + 3, base + 1),
                 Rec("train.loss_read", t + 12, t + 13, base + 4, None)]
    return recs


def test_every_gap_goes_to_the_innermost_span():
    recs = _steps()
    # overlapping activities merge; each gap goes by its middle: [0, 2)
    # and [3, 4) forward, [6, 6.5) backward, [10.5, 12.5) outside,
    # [16, 21.5) outside, [24, 26) backward (the forward ends at 25),
    # [30, 30.5) the step itself, [31, 40) outside
    busy = [(2, 3), (4, 6), (6.5, 10.5), (12.5, 16), (15, 15.5),
            (21.5, 24), (26, 30), (30.5, 31)]
    att = bspans.attribute(busy, (0.0, 40.0), recs)
    idle = dict(att["idle_by_span"])
    assert idle == pytest.approx({
        bspans.OUTSIDE: 2 + 5.5 + 9, "train.forward": 2 + 1,
        "train.backward": 0.5 + 2, "train.step": 0.5})
    assert att["busy_s"] == pytest.approx(17.5)
    assert att["idle_s"] == pytest.approx(40 - 17.5)
    assert sum(idle.values()) == pytest.approx(att["idle_s"])
    # under train.step: forward, backward and the step's own gap
    assert att["step_idle_s"] == pytest.approx(3 + 2.5 + 0.5)
    assert att["idle_by_kind"] == {"None": pytest.approx(
        {"train.forward": 3, "train.backward": 2.5, "train.step": 0.5})}
    assert [n for n, _ in att["idle_by_span"]][0] == bspans.OUTSIDE


def test_the_idle_under_each_step_goes_by_its_kind():
    recs = [Kind("train.step", 0, 10, 1, None, {"kind": "av"}),
            Kind("train.forward", 0, 5, 2, 1, {}),
            Kind("train.step", 10, 20, 3, None, {"kind": "ao"}),
            Kind("train.forward", 10, 15, 4, 3, {})]
    att = bspans.attribute([(1, 2), (3, 12), (13, 19)], (0, 20), recs)
    assert att["idle_by_kind"] == {
        "av": pytest.approx({"train.forward": 1 + 1}),
        "ao": pytest.approx({"train.forward": 1, "train.step": 1})}
    assert att["step_idle_s"] == pytest.approx(4)


def test_a_gap_in_a_loss_read_is_outside_the_step():
    att = bspans.attribute([(0, 12.2), (12.8, 40)], (0, 40), _steps())
    assert dict(att["idle_by_span"]) == pytest.approx(
        {"train.loss_read": 0.6})
    assert att["step_idle_s"] == 0


def test_the_busy_intervals_merge_and_clip_to_the_window():
    busy = bspans.busy_intervals([(5, 7, "k", 1), (1, 3, "k", 2),
                                  (2, 4, "k", 3), (6, 6.5, "k", 4)])
    assert busy == [(1, 4), (5, 7)]
    att = bspans.attribute(busy, (2, 6), [])
    assert att["busy_s"] == pytest.approx(3)
    assert dict(att["idle_by_span"]) == pytest.approx({bspans.OUTSIDE: 1})


def test_the_anchors_bound_the_clock_offset():
    off = 1000.0
    host = [(1.0, 1.5), (5.0, 5.2), (9.0, 9.9)]
    # each call took 0.1 s on the trace, somewhere inside the host's reads
    trace = [(1.3 + off, 1.4 + off), (5.05 + off, 5.15 + off),
             (9.0 + off, 9.1 + off)]
    est, err = bspans.clock_offset(host, trace)
    assert abs(est - off) <= err + 1e-9
    # the second anchor bounds it below, the third above
    assert err == pytest.approx(0.025)


@pytest.mark.parametrize("busy", [3, 1])
def test_a_drifting_card_clock_is_moved_onto_the_launches(busy):
    floor = bspans.LAUNCH_FLOOR_S
    runtime, device, waits = [], [], []
    for i in range(600):
        t = i * 1e-3
        # launches wait behind a busy card, all but every 3rd or, with
        # busy 1, all but the first and the last 20; the card's clock runs
        # 0.4 ms early at the start and 0.1 ms late at the end
        if busy == 3:
            wait = 2e-3 if i % 3 else 0.0
        else:
            wait = 0.0 if i < 20 or i >= 580 else 1e-3 + 1e-5 * (i % 7)
        waits.append(wait)
        true = t + floor + wait
        k = true - 4e-4 + 5e-4 * true / 0.6
        runtime.append((t, t + 2e-6, "cudaLaunchKernel", i + 1))
        device.append((k, k + 1e-5, "kernel", i + 1))
    moved, info = bspans.on_launch_clock(device, runtime)
    assert info["drift_us"] == pytest.approx([-400, 100], abs=1)
    # each kernel is back at its launch plus the floor and its wait
    assert [k for k, *_ in moved] == pytest.approx(
        [t + floor + w for (t, *_), w in zip(runtime, waits)], abs=1e-8)
    # a card whose clock agrees is left where it is
    still, info = bspans.on_launch_clock(
        [(t + floor, e + floor, n, c) for t, e, n, c in runtime], runtime)
    assert info["drift_us"] == pytest.approx([0, 0], abs=1e-6)
    assert [r[0] for r in still] == pytest.approx(
        [t + floor for t, *_ in runtime], abs=1e-12)


def test_the_first_kernel_of_a_span():
    recs = [Rec("train.backward", 1.0, 2.0, 1, None),
            Rec("train.backward", 3.0, 4.0, 2, None)]
    runtime = [(0.5, 0.6, "cudaLaunchKernel", 7),
               (1.1, 1.2, "cudaLaunchKernel", 8),
               (1.3, 1.4, "cudaLaunchKernel", 9),
               (3.2, 3.3, "cudaLaunchKernelExC", 10)]
    device = [(1.0, 1.05, "k", 7), (1.5, 1.6, "k", 8), (1.7, 1.8, "k", 9),
              (3.25, 3.3, "k", 10)]
    got = bspans.first_kernels(recs, runtime, device, "train.backward")
    assert got["first_launch_us"] == pytest.approx([1e5, 2e5])
    assert got["first_kernel_us"] == pytest.approx([2.5e5, 5e5])


@pytest.mark.parametrize("name", ["music.train", "sop.train"])
def test_a_traced_run_reads_the_spans_after_it(name, monkeypatch, capsys):
    cell = tiny.cell(name)
    seed = 2 ** 32 + 29
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", name,
                                      "--seed", str(seed), "--trace", "1"])
    monkeypatch.setattr(harness, "find_cell", lambda n, spec=None: cell)
    monkeypatch.setattr(bspans, "_done", {})
    kept = {}
    real = dtrain.run

    def keep(*a, **kw):
        out = real(*a, **kw)
        kept["reading"] = copy.deepcopy(out.reading)
        return out
    monkeypatch.setattr(dtrain, "run", keep)
    args = argparse.Namespace(workload=name, seed=seed, seconds=0.5,
                              trace=1)
    assert run.run(args, device="cpu", cell=cell, t_start=time.time()) == 0
    text = capsys.readouterr().out
    line = run.json.loads(text.strip().splitlines()[-1])
    assert line["correct"] is True
    suffix = "" if name == "music.train" else ".sop_train"
    got = {m for m in line["metrics"] if m.startswith(NEW)}
    # on a CPU: the host's time in the step; no card to trace, no sync
    assert got == {"train.host_ms" + suffix}
    assert 0 < line["metrics"]["train.host_ms" + suffix]["value"] < 1e5
    assert "spans (" in text and "train.step" in text
    # the old metrics read what the run left, untouched by the new ones
    for m in cell.per_layer:
        if m["name"] in line["metrics"] and not m["name"].startswith(NEW):
            want = harness.layer_reader(m["name"])(kept["reading"])
            assert line["metrics"][m["name"]]["value"] == float(want)


def test_no_run_on_the_command_line_reads_nothing(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pytest"])
    assert bspans.readings({"kind": "train"}) is None
    assert bspans.readings({"kind": "serve"}) is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", "music.train",
                                      "--seed", "3"])
    monkeypatch.setattr(bspans, "_done", {})
    import avsep_tpu_torch.utils
    monkeypatch.delattr(avsep_tpu_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "avsep_tpu_torch.utils.spans", None)
    assert bspans.readings({"kind": "train", "step_s": 0.04}) is None
