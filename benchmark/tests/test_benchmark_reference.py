"""The plain reference agrees with the port at a small size on the CPU:
the first training steps of both configurations (losses, first gradient,
the parameters' change), and the service's separation."""

import pytest
import torch

from benchmark import checks, data, weights
from benchmark.drivers.train import Program
from benchmark.drivers.serve import _port_cfg, serve_flags
from benchmark.reference import music_hidsep
from benchmark.reference.nets import Precision
from benchmark.tests import tiny


@pytest.mark.parametrize("cell_name", ["music.train", "sop.train"])
def test_train_steps_agree(cell_name):
    prog = Program(tiny.cell(cell_name), 2 ** 33 + 5, "cpu")
    prog.checked_steps()
    assert prog.kinds == [True, False, True]
    ref = prog.reference("float32")
    got = prog.numbers(ref)
    assert got["loss_gap"] < 1e-4
    assert got["grad_gap"] < 1e-3
    assert got["grad_gap.median"] < 1e-4
    # leaves that moved by a few roundings of their values are left out
    assert got["change_gap"] < 0.02
    assert got["change_gap.median"] < 1e-3


def test_a_change_within_rounding_is_left_out():
    p0 = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    change = {k: torch.full((64,), 2e-7) for k in ("scale", "bias")}
    assert checks.resolved_leaves(change, p0) == ["bias"]
    change["scale"] = torch.full((64,), 1e-4)
    assert checks.resolved_leaves(change, p0) == ["scale", "bias"]


@pytest.mark.parametrize("use_vis", [True, False])
def test_separation_agrees(use_vis):
    from avsep_tpu_torch import engine
    cell = tiny.cell("music.serve")
    flags = serve_flags(cell.config)
    cfg = _port_cfg(cell.config)
    nets = engine.build_nets(cfg, device="cpu")
    init = weights.make({"sound": nets.sound, "frame": nets.frame},
                        torch.Generator().manual_seed(4), "cpu")
    weights.load({"sound": nets.sound, "frame": nets.frame}, init)
    pool = data.make_pool(8, cfg.audLen, cfg.audRate, cfg.imgSize,
                          torch.Generator().manual_seed(5), "cpu")
    idx = data.source_indices(8, 3, 2, torch.Generator().manual_seed(6),
                              "cpu")
    mix = pool["audio"][idx].sum(1) / 2
    frames = pool["frames"][idx][:, :, None].float() / 255 if use_vis \
        else None
    u = torch.tensor([0.1, 0.6, 0.9])
    want = music_hidsep.separate(init, mix, frames, u, flags,
                                 Precision("float32"))
    got = engine.separate(nets, mix, None if frames is None else
                          engine.imagenet_normalize(frames), cfg,
                          device="cpu", swap_uniforms=u)["wavs"]
    for r in range(3):
        assert checks.wav_gap(got[r], want[r]) < 1e-4
