"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at a small
size on the CPU, once for each fault a cell can have."""

import argparse
import time

import pytest
import torch

from benchmark import data, run
from benchmark.tests import tiny


def _run(cell, capsys, seconds=1.0, trace=0):
    args = argparse.Namespace(workload=cell.name, seed=2 ** 32 + 9,
                              seconds=seconds, trace=trace)
    assert run.run(args, device="cpu", cell=cell, t_start=time.time()) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return run.json.loads(line)


TRAIN = ["music.train", "sop.train", "clipatt.train"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_sound_run_is_correct(name, capsys):
    assert _run(tiny.cell(name), capsys)["correct"] is True


@pytest.mark.parametrize("name", ["music.train", "sop.train"])
def test_a_traced_run_reports_its_per_layer_metrics(name, capsys):
    cell = tiny.cell(name)
    line = _run(cell, capsys, trace=1)
    assert line["correct"] is True
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    # a CPU run has no card: its share of the peak is still read
    assert any(k.startswith("mfu.") for k in line["metrics"])
    assert "breakdown" in line and line["device"]["window_s"] > 0


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch, capsys):
    from avsep_tpu_torch import train

    def no_update(cfg, state, err, use_vis):
        state.step += 1
    monkeypatch.setattr(train, "apply_gradients", no_update)
    assert _run(tiny.cell(name), capsys)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_of_the_batch_left_out(name, monkeypatch, capsys):
    from avsep_tpu_torch import engine, sop_engine

    def halved(fn):
        def wrapped(nets, batch, *a, **kw):
            return fn(nets, {k: v[:v.shape[0] // 2]
                             for k, v in batch.items()}, *a, **kw)
        return wrapped
    monkeypatch.setattr(engine, "forward", halved(engine.forward))
    monkeypatch.setattr(sop_engine, "sop_forward",
                        halved(sop_engine.sop_forward))
    assert _run(tiny.cell(name), capsys)["correct"] is False


def test_clips_leave_the_pool_as_it_was_and_move(monkeypatch):
    def pool(clip_len):
        return data.make_pool(6, 8191, 11025, 64,
                              torch.Generator().manual_seed(2 ** 33 + 3),
                              "cpu", clip_len=clip_len)
    plain, with_clips = pool(0), pool(4)
    assert set(plain) == {"audio", "frames"}
    for k in plain:
        assert torch.equal(plain[k], with_clips[k])
    clips = with_clips["clips"]
    assert clips.shape == (6, 4, 64, 64, 3) and clips.dtype == torch.uint8
    # consecutive frames of every clip differ
    assert (clips[:, 1:] != clips[:, :-1]).flatten(2).any(2).all()
    # rendered a clip at a time, the clips are the same
    monkeypatch.setattr(data, "CLIP_CHUNK_ELEMS", 1)
    assert torch.equal(pool(4)["clips"], clips)


def rank_without_exchange(payload, cfg, device):
    """A rank whose gradient mean is left out (the ranks are spawned, so
    the fault is planted in each)."""
    from avsep_tpu_torch.parallel import distributed
    from benchmark.drivers import train
    distributed.mean_ = lambda tensors: None
    train._rank_entry(payload, cfg, device)


def test_the_exchange_between_chips_left_out(monkeypatch, capsys):
    from benchmark.drivers import train
    monkeypatch.setattr(train, "_rank_entry", rank_without_exchange)
    assert _run(tiny.cell("music.train_dp4"), capsys)["correct"] is False


def test_an_answer_altered_where_it_is_produced(monkeypatch, capsys):
    from avsep_tpu_torch import engine
    separate = engine.separate

    def altered(*a, **kw):
        out = separate(*a, **kw)
        out["wavs"] = out["wavs"] * 0.99
        return out
    monkeypatch.setattr(engine, "separate", altered)
    assert _run(tiny.cell("music.serve"), capsys, 2.0)["correct"] is False


def test_a_sound_service_is_correct(capsys):
    assert _run(tiny.cell("music.serve"), capsys, 2.0)["correct"] is True
