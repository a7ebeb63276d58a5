"""The FLOP and byte counts against a count of what runs, at a small size:
``torch.utils.flop_counter`` over the plain reference (which counts the
convolutions and the synthesizer's products the count takes, and none of
the STFT, warp or elementwise work it leaves out), and the kernels' bytes
by hand."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import data, weights
from benchmark.counts import bytes as kbytes
from benchmark.counts import flops as kflops
from benchmark.drivers.train import _program, port_config
from benchmark.reference import music_hidsep, train as rtrain
from benchmark.reference.nets import Precision
from benchmark.tests import tiny

B = 2


def _setup(cell_name):
    cell = tiny.cell(cell_name)
    cfg = port_config(cell.config)
    nets, _, _ = _program(cell.config, cfg, torch.device("cpu"))
    from avsep_tpu_torch import train
    init = weights.make(dict(train.modules(nets)),
                        torch.Generator().manual_seed(1), "cpu")
    pool = data.make_pool(8, cfg.audLen, cfg.audRate, cfg.imgSize,
                          torch.Generator().manual_seed(2), "cpu",
                          clip_len=cfg.clip_len if cfg.load_clips else 0)
    idx = data.source_indices(8, B, 2, torch.Generator().manual_seed(3),
                              "cpu")
    return cell, init, pool, idx


@pytest.mark.parametrize("cell_name,use_vis", [
    ("music.train", True), ("music.train", False),
    ("sop.train", True), ("sop.train", False),
    ("clipatt.train", True), ("clipatt.train", False)])
def test_train_step_flops_equal_the_counter(cell_name, use_vis):
    cell, init, pool, idx = _setup(cell_name)
    t = rtrain.Trainer(cell.config, init, Precision("float32"))
    batch = data.train_batch(pool, idx, use_vis,
                             data.visual_stream(cell.config["flags"]))
    with FlopCounterMode(display=False) as fc:
        t.step(batch, use_vis, torch.tensor([0.2, 0.7]), 3)
    want = kflops.train_step(cell.config["flags"], B, use_vis,
                             cell.config["model"])
    assert fc.get_total_flops() == want


@pytest.mark.parametrize("use_vis", [True, False])
def test_separate_flops_equal_the_counter(use_vis):
    cell, init, pool, idx = _setup("music.serve")
    flags = {**cell.config["flags"], **cell.config["serve_flags"]}
    mix = pool["audio"][idx].sum(1) / 2
    frames = pool["frames"][idx][:, :, None].float() / 255 if use_vis \
        else None
    with FlopCounterMode(display=False) as fc:
        music_hidsep.separate(init, mix, frames, torch.tensor([0.2, 0.7]),
                              flags, Precision("float32"))
    assert fc.get_total_flops() == kflops.separate(flags, B, use_vis)


def test_train_flops_at_published_widths_by_hand():
    # the fast pathway on one 32 x 224 x 224 clip: 5.2825 GMAC forward
    fast = kflops.resnet3d_fast(1, 32, 224, 224)
    assert kflops.forward(fast) / 2 == pytest.approx(5.2825e9, rel=1e-4)
    # an AV step of 16 rows x 2 sources trains it on 32 clips
    assert kflops.trained(kflops.resnet3d_fast(32, 32, 224, 224)) \
        == pytest.approx(0.86319e12, rel=1e-4)
    flags = tiny.full("music.train").config["flags"]
    assert kflops.per_kind(flags, 16, "avsep") == {
        True: 2726874316800, False: 1052535422976}
    clips = {**flags, "fusion_type": "CoLoc_ClipAtt", "load_clips": True,
             "clip_len": 32}
    assert kflops.per_kind(clips, 16, "avsep") == {
        True: 2 * 1052535422976 + 863187763200, False: 1052535422976}
    assert kflops.per_kind(tiny.full("sop.train").config["flags"], 16,
                           "sop") == {True: 2046745903104,
                                      False: 1266948243456}


def test_kernel_bytes_by_hand():
    # frame_window: 3 rows of 20 samples, n_fft 8, hop 4: padded rows of
    # 28, 6 frames of 8, the window of 8
    assert kbytes.frame_window(3, 20, 8, 4) == 4 * (3 * 28 + 8 + 3 * 6 * 8)
    # overlap_add: 3 rows of 6 frames of 8, hop 4: 28 samples out
    assert kbytes.overlap_add(3, 6, 8, 4) == 4 * (3 * 6 * 8 + 28 + 3 * 28)
    # the flagship's, as PERF.md's bounds give them
    assert kbytes.least_seconds(kbytes.frame_window(16, 65535, 1022, 256)) \
        == pytest.approx(6.27e-6, rel=1e-3)
    assert kbytes.least_seconds(kbytes.overlap_add(32, 256, 1022, 256)) \
        == pytest.approx(12.61e-6, rel=1e-3)
