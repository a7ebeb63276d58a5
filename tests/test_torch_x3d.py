"""X3D-M as the clip stream (``--arch_motion x3d_m``, ``models/x3d.X3D``)
on the CPU at a small size: base 8, stages (1, 2, 2, 1), clips of 8 x 64 x
64 (a 2 x 2 map after the five stride-2 steps), weights drawn from a seed.
About 15 s in one process.

The net is held to the plain reference, ``benchmark/reference/x3d.py``
(written from mmaction2's ``X3D`` and ``BlockX3D``, its stem a 3-D
convolution where the port runs a 2-D one, its swish ``y * sigmoid(y)``
where the port calls ``F.silu``), in float32: the pooled map in train and
eval mode and every parameter's gradient, within 1e-4 of the largest
value (the map's; the largest gradient of any parameter).  The two sides
sum in other orders, and float32 summation order is all that 1e-4 leaves
room for: the same net in bfloat16 misses it by an order of magnitude or
more, which the test shows too.  Then X3D-M's published shapes (the
backbone's 2,089,986 parameters, depths, inner widths), the gates' places
and widths, one AV and one AO train step against the reference module
``clipatt_x3d_m``, the spans ``motion.channelwise`` and ``motion.se``
inside ``train.motion``, and the default ``--arch_motion``, which still
builds the fast pathway alone.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import layers, motion
from avsep_tpu_torch.models.builder import ModelBuilder
from avsep_tpu_torch.models.motion import ResNet3dFastOnly
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.models.x3d import X3D, round_width
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.ops.imagenet import normalize_frames
from avsep_tpu_torch.utils import spans
from benchmark import weights
from benchmark.reference import train as rtrain
from benchmark.reference import x3d as rx3d
from benchmark.reference.nets import Precision

NET = dict(base_channels=8, stage_blocks=(1, 2, 2, 1))
B, T, S = 2, 8, 64
# float32 summation order (module docstring)
TOL = 1e-4
F32 = Precision("float32")
# unet5 at ngf 8: its 64-channel bottleneck splits into 2 chunks of 32
CLIPS = dict(arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
             vis_channels=32, fusion_type="CoLoc_ClipAtt", att_type="sig",
             loss="bce", not_pool_vis=False, binary_mask=1, weighted_loss=1,
             num_mix=2, audLen=8191, imgSize=S, one_frame=True,
             match_weight=0.1, img_activation="relu", load_clips=True,
             clip_len=T, lr_sound=1e-2, lr_frame=1e-3, lr_motion=1e-2,
             lr_steps=(100,), arch_motion="x3d_m")


@pytest.fixture(autouse=True)
def small_reference(monkeypatch):
    """The reference's stages at the small net's depths; the recorder off
    around every test."""
    monkeypatch.setattr(rx3d, "BLOCKS", NET["stage_blocks"])
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def clips_of(seed, shape=(B, T, S, S, 3)):
    return torch.randint(0, 256, shape, dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def small_net(dtype=torch.float32, train_mode=True, fc_dim=16, seed=7):
    """The small net and the seeded weights it holds (keys ``motion.*``);
    in eval mode the running statistics are drawn away from 0 and 1."""
    net = X3D(fc_dim=fc_dim, dtype=dtype, **NET)
    init = weights.make({"motion": net}, torch.Generator().manual_seed(seed),
                        "cpu")
    if not train_mode:
        g = torch.Generator().manual_seed(seed + 1)
        for k in init:
            if k.endswith("running_mean"):
                init[k] = 0.1 * torch.randn(init[k].shape, generator=g)
            elif k.endswith("running_var"):
                init[k] = 0.5 + torch.rand(init[k].shape, generator=g)
    weights.load({"motion": net}, init)
    return net.train(train_mode), init


def rel(got, want, scale=None):
    """The largest error of ``got`` over ``scale``, by default the largest
    value of ``want``."""
    if scale is None:
        scale = float(want.detach().abs().max())
    return float((got.detach().double() - want.detach().double()).abs().max()
                 / scale)


def port_map(net, clips):
    """The activated map as ``engine._motion_features`` makes it: X3D takes
    the clips normalized."""
    assert not net.stem_kernel
    return torch.relu(net.pooled_map(normalize_frames(clips)))


@pytest.mark.parametrize("train_mode", [True, False], ids=["train", "eval"])
def test_forward_and_gradients_against_the_reference(train_mode):
    net, init = small_net(train_mode=train_mode)
    clips = clips_of(3)
    got = port_map(net, clips)
    w = {k: v.clone().requires_grad_(rtrain.is_param(k))
         for k, v in init.items()}
    want = rx3d.x3d_map(clips, w, F32, train_mode)
    assert got.shape == want.shape == (B, 2, 2, 16)
    assert rel(got, want) < TOL
    r = torch.randn(want.shape, generator=torch.Generator().manual_seed(4))
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad((got * r).sum(), list(net.parameters()))
    refs = torch.autograd.grad((want * r).sum(),
                               [w["motion." + k] for k in names])
    assert len(names) == len([k for k in init if rtrain.is_param(k)])
    largest = max(float(gr.abs().max()) for gr in refs)
    for k, g, gr in zip(names, grads, refs):
        assert float(gr.abs().max()) > 0, k
        assert rel(g, gr, largest) < TOL, k
    if train_mode:                 # the running statistics moved alike
        sd = net.state_dict()
        for k in ("bn1.running_mean", "layer3_1.bn2.running_var",
                  "layer4_0.downsample_bn.running_mean", "bn5.running_var"):
            assert rel(sd[k], w["motion." + k]) < TOL, k
    # bfloat16 misses the tolerance: it is float32's alone
    half, _ = small_net(torch.bfloat16, train_mode)
    assert rel(port_map(half, clips), want) > 10 * TOL


def test_x3d_m_at_its_published_widths():
    with torch.device("meta"):
        net = ModelBuilder.build_motion("x3d_m", fc_dim=256)
    sd = net.state_dict()
    params = dict(net.named_parameters())
    assert sum(p.numel() for k, p in params.items()
               if not k.startswith("fc.")) == 2_089_986
    assert tuple(sd["conv1_s.weight"].shape) == (24, 3, 1, 3, 3)
    assert tuple(sd["conv1_t.weight"].shape) == (24, 1, 5, 1, 1)
    assert tuple(sd["conv5.weight"].shape) == (432, 192, 1, 1, 1)
    assert tuple(sd["fc.weight"].shape) == (256, 432, 3, 3)
    assert tuple(sd["fc.bias"].shape) == (256,)
    blocks = {re.match(r"layer(\d)_(\d+)\.", k).groups()
              for k in sd if re.match(r"layer\d_\d+\.", k)}
    depth = [sum(1 for s, _ in blocks if s == str(i)) for i in (1, 2, 3, 4)]
    assert depth == [3, 5, 11, 7] == [net.stages[i].__len__()
                                      for i in range(4)]
    for i, (out, inner) in enumerate(zip((24, 48, 96, 192),
                                         (54, 108, 216, 432))):
        for j in range(depth[i]):
            name = f"layer{i + 1}_{j}"
            assert tuple(sd[f"{name}.conv1.weight"].shape)[:2] == \
                (inner, 24 if i == j == 0 else (out if j else out // 2))
            # channelwise: one input channel a group, 3x3x3
            assert tuple(sd[f"{name}.conv2.weight"].shape) == \
                (inner, 1, 3, 3, 3)
            assert getattr(net, name).conv2.groups == inner
            assert tuple(getattr(net, name).conv2.stride) == \
                (1, 2 if j == 0 else 1, 2 if j == 0 else 1)
            assert tuple(sd[f"{name}.conv3.weight"].shape)[:2] == (out, inner)
            assert (f"{name}.downsample_conv.weight" in sd) == (j == 0)
    norms = [m for m in net.modules() if isinstance(m, layers.BatchNorm)]
    assert len(norms) == 84
    # the kernels take every width but the first two stages' inner ones
    assert sum(kernels.motion_bn_fits(m.num_features) for m in norms) == 68
    assert sorted({m.num_features for m in norms
                   if not kernels.motion_bn_fits(m.num_features)}) == \
        [54, 108]


def test_squeeze_excitation_in_every_other_block_at_the_published_widths():
    assert [round_width(c, 1 / 16) for c in (54, 108, 216, 432)] == \
        [8, 8, 16, 32]
    # mmaction2's rule: nearest multiple of 8, at least 8, one more 8 under
    # 0.9 of the exact value
    assert [round_width(c, 1 / 16) for c in (16, 136, 400, 440)] == \
        [8, 8, 24, 32]
    with torch.device("meta"):
        net = ModelBuilder.build_motion("x3d_m")
    for i, stage in enumerate(net.stages):
        for j, name in enumerate(stage):
            se = getattr(net, name).se_module
            assert (se is not None) == (j % 2 == 0), name
            if se is not None:
                assert se.bottleneck == (8, 8, 16, 32)[i]
                assert tuple(se.fc1.weight.shape) == \
                    (se.bottleneck, (54, 108, 216, 432)[i], 1, 1, 1)
                assert se.fc1.bias is not None and se.fc2.bias is not None
    small, _ = small_net()
    assert [name for stage in small.stages for name in stage
            if small.get_submodule(name).se_module is not None] == \
        ["layer1_0", "layer2_0", "layer3_0", "layer4_0"]


def test_the_gate_and_the_swish_follow_the_channelwise_norm(monkeypatch):
    """Each block's channelwise BatchNorm takes no ReLU, and what leaves
    it goes through the gate, then the swish, into ``conv3``."""
    net, _ = small_net()
    block = net.layer1_0
    calls = []
    real = motion.bn_act

    def spy(bn, x, relu=True, residual=None):
        calls.append((bn, relu, residual is not None))
        return real(bn, x, relu, residual)
    monkeypatch.setattr("avsep_tpu_torch.models.x3d.bn_act", spy)
    seen = {}
    block.conv3.register_forward_pre_hook(
        lambda m, args: seen.__setitem__("conv3_in", args[0]))
    x = torch.randn(B, 8, 4, 16, 16)
    block(x)
    by_bn = {id(bn): (relu, res) for bn, relu, res in calls}
    assert by_bn[id(block.bn1)] == (True, False)
    assert by_bn[id(block.bn2)] == (False, False)
    assert by_bn[id(block.downsample_bn)] == (False, False)
    assert by_bn[id(block.bn3)] == (True, True)
    with torch.no_grad():
        y = real(block.bn2, block.conv2(real(block.bn1, block.conv1(x))),
                 relu=False)
        g = torch.sigmoid(block.se_module.fc2(torch.relu(
            block.se_module.fc1(y.mean(dim=(2, 3, 4), keepdim=True)))))
        y = y * g
        assert torch.allclose(seen["conv3_in"], y * torch.sigmoid(y),
                              atol=1e-6)


def small_state(cfg, seed=0):
    """The clips branch at a small size with the small X3D, its seeded
    weights (as the benchmark makes them) and a fresh state."""
    torch.manual_seed(seed)
    nets = engine.Nets(
        AudioUnet(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type), TinyConvEncoder(32, "maxpool"),
        X3D(fc_dim=32, **NET))
    by_name = dict(train.modules(nets))
    init = weights.make(by_name, torch.Generator().manual_seed(seed + 1),
                        "cpu")
    weights.load(by_name, init)
    return train.TrainState(0, nets, train.init_opt_state(cfg, nets)), init


def clip_batch(cfg, seed=2):
    rs = np.random.RandomState(seed)
    return {"audios": torch.from_numpy(
                (rs.randn(B, 2, cfg.audLen) * 0.05).astype(np.float32)),
            "clips": clips_of(seed, (B, 2, T, S, S, 3))}


@pytest.mark.parametrize("use_vis", [True, False], ids=["av", "ao"])
def test_a_train_step_against_the_reference(use_vis):
    """One step through ``train.make_train_step`` from seeded weights: its
    loss and its gradient as the optimizer got it (the momentum after one
    step, less the weight decay) against the reference module's.  Each
    leaf within 2 % of the larger of its largest value and the median
    leaf's: at this size the U-Net's convolutions and the BatchNorms'
    gradients move by up to about 0.5 % between two float32 summation
    orders (the AO step, which runs no motion net, reads as far)."""
    cfg = Config(**CLIPS)
    state, init = small_state(cfg)
    batch = clip_batch(cfg)
    u = torch.tensor([0.3, 0.8])
    step = train.make_train_step(cfg, state.nets, use_vis, device="cpu")
    _, metrics = step(state, batch, swap_uniforms=u)
    config = {"flags": dataclasses.asdict(cfg), "reference": "clipatt_x3d_m"}
    loss, grads = rtrain.Trainer(config, init, F32).step(
        batch, use_vis, None if use_vis else u)
    assert abs(float(metrics["err"]) - loss) < TOL * abs(loss)
    frozen = rtrain.frozen_nets(config["flags"], use_vis)
    got = {k: b - cfg.weight_decay * init[k]
           for g in state.opt_state.values() if g is not None
           for k, b in g.momentum.items() if rtrain.group_of(k) not in frozen}
    assert set(got) == set(grads)
    assert any(".se_module." in k for k in got) == use_vis
    largest = {k: float(v.abs().max()) for k, v in grads.items()}
    floor = float(np.median(list(largest.values())))
    for k in grads:
        assert rel(got[k], grads[k], max(largest[k], floor)) < 2e-2, k


def test_the_spans_lie_inside_train_motion():
    cfg = Config(**CLIPS)
    state, _ = small_state(cfg)
    step = train.make_eager_train_step(cfg, state.nets, True,
                                       torch.device("cpu"))
    with spans.recording():
        step(state, clip_batch(cfg),
             generator=torch.Generator().manual_seed(5))
    rec = spans.drain().records
    by_id = {r.id: r for r in rec}

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name
    channelwise = [r for r in rec if r.name == "motion.channelwise"]
    se = [r for r in rec if r.name == "motion.se"]
    blocks = sum(NET["stage_blocks"])
    # per source: the stem's and each block's channelwise conv; each
    # block's gate or swish
    assert (len(channelwise), len(se)) == (2 * (1 + blocks), 2 * blocks)
    for r in channelwise + se:
        assert "train.motion" in list(ancestors(r))
        assert not [n for n in ancestors(r) if n.startswith("motion.")]
    (step_rec,) = [r for r in rec if r.name == "train.step"]
    counts = spans.inclusive_counts(step_rec, spans.descendants(rec))
    assert counts["motion.clips"] == B * cfg.num_mix
    assert "motion.slow_frames" not in counts


def test_x3d_trains_through_the_engine_and_the_default_is_unchanged():
    cfg = Config(**{**CLIPS, "vis_channels": 256, "clip_len": 4})
    nets = engine.build_nets(cfg, device="cpu")
    assert type(nets.motion) is X3D and nets.motion.fc.out_channels == 256
    assert not nets.motion.stem_kernel
    default = Config(**{**CLIPS, "vis_channels": 256, "clip_len": 4,
                        "arch_motion": Config.arch_motion})
    assert default.arch_motion == "slowfast_fast"
    nets = engine.build_nets(default, device="cpu")
    assert type(nets.motion) is ResNet3dFastOnly
    assert set(nets.motion.state_dict()) == set(ResNet3dFastOnly()
                                                .state_dict())
    with pytest.raises(ValueError, match="arch_motion"):
        engine.build_nets(cfg.replace(arch_motion="x3d_l"), device="cpu")
