"""The plain reference agrees with the port at a small size on the CPU:
the first training steps of both configurations (losses, first gradient,
the parameters' change), and the service's separation."""

import pytest
import torch

from benchmark import checks, data, weights
from benchmark.drivers.train import Program
from benchmark.drivers.serve import _port_cfg, serve_flags
from benchmark.reference import music_hidsep, nets
from benchmark.reference.nets import Precision
from benchmark.tests import tiny


# leaves that moved by a few roundings of their values are left out of
# the change's gaps
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "grad_gap.median": 1e-4,
          "change_gap": 0.02, "change_gap.median": 1e-3}
# cells whose first gradients float32 rounding alone moves by more than
# LIMITS: the fast pathway's BatchNorm leaves at this size move by up to 3 %
# when the starting weights move by one rounding
ROUNDING_BOUND = {"clipatt.train"}


def rounding_spread(prog, ref, draws: int = 3):
    """Each number of the reference against itself with every starting
    weight moved by one float32 rounding, the largest of ``draws``
    draws: how far rounding alone moves it."""
    from benchmark.reference import train as rtrain
    init, out = prog.init, {}
    try:
        for d in range(draws):
            g = torch.Generator().manual_seed(d)
            prog.init = {k: v * (1 + 2.0 ** -24 * torch.randn(
                v.shape, generator=g)) if rtrain.is_param(k) else v
                for k, v in init.items()}
            side = prog.reference("float32")
            prog.init = init
            for k, v in prog.numbers(ref, side=side).items():
                out[k] = max(out.get(k, 0.0), v)
    finally:
        prog.init = init
    return out


@pytest.mark.parametrize("cell_name",
                         ["music.train", "sop.train", "clipatt.train"])
def test_train_steps_agree(cell_name):
    prog = Program(tiny.cell(cell_name), 2 ** 33 + 5, "cpu")
    prog.checked_steps()
    assert prog.kinds == [True, False, True]
    ref = prog.reference("float32")
    got = prog.numbers(ref)
    limits = dict(LIMITS)
    if cell_name in ROUNDING_BOUND:
        own = rounding_spread(prog, ref)
        limits = {k: max(v, 3 * own[k]) for k, v in LIMITS.items()}
    for k, v in limits.items():
        assert got[k] < v, (k, got[k], v)


@pytest.mark.parametrize("train", [True, False])
def test_the_fast_pathway_agrees_with_the_port(train):
    from avsep_tpu_torch.models.motion import ResNet3dFastOnly
    net = ResNet3dFastOnly().train(train)
    init = weights.make({"motion": net}, torch.Generator().manual_seed(7),
                        "cpu")
    if not train:                  # running statistics away from 0 and 1
        g = torch.Generator().manual_seed(8)
        for k in init:
            if k.endswith("running_mean"):
                init[k] = 0.1 * torch.randn(init[k].shape, generator=g)
            elif k.endswith("running_var"):
                init[k] = 0.5 + torch.rand(init[k].shape, generator=g)
    weights.load({"motion": net}, init)
    x = torch.randn(2, 4, 64, 64, 3, generator=torch.Generator()
                    .manual_seed(9))
    with torch.no_grad():
        got = net(x)
    want = nets.resnet3d_fast(x, dict(init), Precision("float32"), train)
    assert got.shape == want.shape == (2, 4, 2, 2, 256)
    limit = 1e-5
    if train:
        # with batch statistics the net moves its output by about 3e-5
        # when its input moves by one float32 rounding
        moved = x * (1 + 2.0 ** -24 * torch.randn(
            x.shape, generator=torch.Generator().manual_seed(10)))
        w = {k: v.clone() for k, v in init.items()}
        own = nets.resnet3d_fast(moved, w, Precision("float32"), True)
        limit = max(limit, 3 * float((own - want).norm() / want.norm()))
    assert float((got - want).norm() / want.norm()) < limit
    if train:                      # the running statistics moved alike
        sd = net.state_dict()
        for k in ("layer4_2.bn3.running_mean", "bn1.running_var"):
            assert torch.allclose(sd[k], init["motion." + k], rtol=1e-5,
                                  atol=1e-6)


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
