"""SlowFast R50 as the clip stream (``--arch_motion slowfast_r50``,
``models/motion.ResNet3dSlowFast``) on the CPU at a small size: slow base
8, fast base 1, one block per stage, clips of 16 x 32 x 32 at alpha 8,
weights drawn from a seed.

The net is held to the plain reference, ``benchmark/reference/
slowfast.py`` (written from mmaction2's ``ResNet3dSlowFast.forward``,
the slow frames by its nearest resample, the slow stem a 3-D convolution
where the port runs a 2-D one), in float32: the pooled map in train and
eval mode and every parameter's gradient, within 1e-4 of the largest
value (the map's; the largest gradient of any parameter: at base 1 some
leaves' gradients are sums that cancel to a millionth of it, and there
the two sides keep only its float32 rounding in common).  The two sides
sum in other orders (a 2-D against a 3-D stem, the
time means, cuDNN-free CPU convolutions of other blockings), and float32
summation order is all that 1e-4 leaves room for: the same net in
bfloat16 misses it by two orders of magnitude or more, which the test
shows too.  Then the slow frames, the ``state_dict`` keys, an mmaction2
checkpoint's import, one AV and one AO train step against the reference
module ``clipatt_slowfast_r50``, the spans ``motion.slow`` and
``motion.lateral`` with the counter ``motion.slow_frames``, and the
default ``--arch_motion``, which builds the fast pathway alone as before.
"""

import contextlib
import dataclasses
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models.builder import ModelBuilder
from avsep_tpu_torch.models.motion import ResNet3dFastOnly, ResNet3dSlowFast
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.torch_import import motion_state_dict_from_torch
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.ops.imagenet import normalize_frames
from avsep_tpu_torch.utils import spans
from benchmark import weights
from benchmark.reference import slowfast as rslowfast
from benchmark.reference import train as rtrain
from benchmark.reference.nets import Precision

NET = dict(fast_channels=1, slow_channels=8, stage_blocks=(1, 1, 1, 1))
B, T, S = 2, 16, 32
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
             lr_steps=(100,), arch_motion="slowfast_r50")


@pytest.fixture(autouse=True)
def small_reference(monkeypatch):
    """The reference's stages at the small net's one block each; the
    recorder off around every test."""
    monkeypatch.setattr(rslowfast, "BLOCKS", NET["stage_blocks"])
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
    net = ResNet3dSlowFast(fc_dim=fc_dim, dtype=dtype, **NET)
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
    """The activated map as ``engine._motion_features`` makes it: the
    float32 net takes the clips normalized, the bfloat16 one as they are
    (its fast stem reads them)."""
    x = clips if net.stem_kernel else normalize_frames(clips)
    return torch.relu(net.pooled_map(x))


@pytest.mark.parametrize("train_mode", [True, False], ids=["train", "eval"])
def test_forward_and_gradients_against_the_reference(train_mode):
    net, init = small_net(train_mode=train_mode)
    clips = clips_of(3)
    got = port_map(net, clips)
    w = {k: v.clone().requires_grad_(rtrain.is_param(k))
         for k, v in init.items()}
    want = rslowfast.slowfast_map(clips, w, F32, train_mode)
    assert got.shape == want.shape == (B, 1, 1, 16)
    assert rel(got, want) < TOL
    r = torch.randn(want.shape, generator=torch.Generator().manual_seed(4))
    names = [k for k, _ in net.named_parameters()]
    grads = torch.autograd.grad((got * r).sum(), list(net.parameters()))
    refs = torch.autograd.grad((want * r).sum(),
                               [w["motion." + k] for k in names])
    assert len(names) == len([k for k in init if rtrain.is_param(k)])
    largest = max(float(gr.abs().max()) for gr in refs)
    for k, g, gr in zip(names, grads, refs):
        assert rel(g, gr, largest) < TOL, k
    if train_mode:                 # the running statistics moved alike
        sd = net.state_dict()
        for k in ("slow_path.layer4_0.bn3.running_var",
                  "slow_path.bn1.running_mean", "fast_path.bn1.running_var"):
            assert rel(sd[k], w["motion." + k]) < TOL, k
    # bfloat16 misses the tolerance: it is float32's alone
    half, _ = small_net(torch.bfloat16, train_mode)
    assert rel(port_map(half, clips), want) > 10 * TOL


def test_the_slow_pathway_reads_every_eighth_frame(monkeypatch):
    net, _ = small_net()
    seen = []
    stem = net.slow_path.stem
    monkeypatch.setattr(net.slow_path, "stem",
                        lambda frames: seen.append(frames) or stem(frames))
    clips = clips_of(5)
    net.pooled_map(normalize_frames(clips))
    assert torch.equal(seen[0], normalize_frames(clips[:, [0, 8]]))
    # mmaction2's nearest resample at 1/8 takes the same frames
    for t in (16, 32):
        x = torch.randn(1, 3, t, 2, 2)
        assert torch.equal(F.interpolate(x, mode="nearest", scale_factor=(
            1 / 8, 1, 1)), x[:, :, ::8])


def test_state_dict_keys_and_shapes():
    with torch.device("meta"):
        net = ModelBuilder.build_motion("slowfast_r50", fc_dim=256)
        fast = ResNet3dFastOnly()
    sd = net.state_dict()
    assert {k.split(".", 1)[0] for k in sd} == {"slow_path", "fast_path",
                                                "fc"}
    assert {k for k in sd if k.startswith("fast_path.")} == \
        {"fast_path." + k for k in fast.state_dict()}
    assert tuple(sd["fc.weight"].shape) == (256, 2304, 3, 3)
    assert tuple(sd["fc.bias"].shape) == (256,)
    laterals = {k: tuple(v.shape) for k, v in sd.items() if "lateral" in k}
    assert laterals == {
        "slow_path.conv1_lateral.weight": (16, 8, 5, 1, 1),
        "slow_path.layer1_lateral.weight": (64, 32, 5, 1, 1),
        "slow_path.layer2_lateral.weight": (128, 64, 5, 1, 1),
        "slow_path.layer3_lateral.weight": (256, 128, 5, 1, 1)}
    assert tuple(sd["slow_path.conv1.weight"].shape) == (64, 3, 1, 7, 7)
    first = [sd[f"slow_path.layer{i}_0.conv1.weight"].shape for i in
             (1, 2, 3, 4)]
    assert [s[1] for s in first] == [80, 320, 640, 1280]
    assert [s[2] for s in first] == [1, 1, 3, 3]       # inflate (0, 0, 1, 1)
    assert [sd[f"slow_path.layer{i}_0.downsample_conv.weight"].shape[:2]
            for i in (1, 2, 3, 4)] == [(256, 80), (512, 320), (1024, 640),
                                       (2048, 1280)]
    blocks = {re.match(r"slow_path\.layer(\d)_(\d)\.", k).groups()
              for k in sd if re.match(r"slow_path\.layer\d_\d\.", k)}
    assert sorted(blocks) == [(str(i), str(j)) for i, n in
                              zip((1, 2, 3, 4), (3, 4, 6, 3))
                              for j in range(n)]
    bns = [k for k in sd if k.startswith("slow_path.")
           and k.endswith("running_mean")]
    assert len(bns) == 53


def mmaction_keys(sd):
    """The port's SlowFast keys under mmaction2's names (``backbone.``,
    ``conv1.conv`` / ``conv1.bn``, ``layer1.0.conv1.conv``,
    ``downsample.conv`` / ``.bn``, ``conv1_lateral.conv``), and a
    classification head."""
    out = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            continue
        m = k
        m = re.sub(r"^(\w+_path)\.conv1\.weight$", r"\1.conv1.conv.weight", m)
        m = re.sub(r"^(\w+_path)\.bn1\.", r"\1.conv1.bn.", m)
        m = re.sub(r"_lateral\.weight$", "_lateral.conv.weight", m)
        m = re.sub(r"\.layer(\d)_(\d+)\.", r".layer\1.\2.", m)
        m = re.sub(r"\.conv(\d)\.weight$", r".conv\1.conv.weight", m)
        m = re.sub(r"\.bn(\d)\.", r".conv\1.bn.", m)
        m = m.replace(".downsample_conv.weight", ".downsample.conv.weight")
        m = m.replace(".downsample_bn.", ".downsample.bn.")
        out["backbone." + m] = v
    out["cls_head.fc_cls.weight"] = torch.ones(400, 2304)
    out["cls_head.fc_cls.bias"] = torch.zeros(400)
    return out


def test_an_mmaction2_checkpoint_imports_both_pathways():
    net = ResNet3dSlowFast(fast_channels=1, slow_channels=8, fc_dim=16)
    g = torch.Generator().manual_seed(11)
    want = {k: torch.randn(v.shape, generator=g) if v.is_floating_point()
            else v for k, v in net.state_dict().items()}
    sd = mmaction_keys(want)
    assert any(".layer3.5.conv2.conv.weight" in k for k in sd)
    got = motion_state_dict_from_torch(sd, "slowfast_r50")
    assert set(got) == set(want) - {"fc.weight", "fc.bias"}
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    # strict, once the fc, which no mmaction2 checkpoint has, is added
    net.load_state_dict({**got, "fc.weight": want["fc.weight"],
                         "fc.bias": want["fc.bias"]}, strict=True)
    # a dict that holds the fc (this system's own) brings it along
    with_fc = motion_state_dict_from_torch(
        {**sd, "fc.weight": want["fc.weight"], "fc.bias": want["fc.bias"]},
        "slowfast_r50")
    net.load_state_dict(with_fc, strict=True)
    # the fast pathway alone, from the same dict, as before
    fast = motion_state_dict_from_torch(sd)
    ResNet3dFastOnly(base_channels=1).load_state_dict(fast, strict=True)
    assert torch.equal(fast["layer2_1.bn3.running_var"],
                       want["fast_path.layer2_1.bn3.running_var"])
    with pytest.raises(ValueError):
        motion_state_dict_from_torch(sd, "slowfast_r101")


def small_state(cfg, seed=0):
    """The clips branch at a small size with the small SlowFast net, its
    seeded weights (as the benchmark makes them) and a fresh state."""
    torch.manual_seed(seed)
    nets = engine.Nets(
        AudioUnet(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type), TinyConvEncoder(32, "maxpool"),
        ResNet3dSlowFast(fc_dim=32, **NET))
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
    config = {"flags": dataclasses.asdict(cfg),
              "reference": "clipatt_slowfast_r50"}
    loss, grads = rtrain.Trainer(config, init, F32).step(
        batch, use_vis, None if use_vis else u)
    assert abs(float(metrics["err"]) - loss) < TOL * abs(loss)
    frozen = rtrain.frozen_nets(config["flags"], use_vis)
    got = {k: b - cfg.weight_decay * init[k]
           for g in state.opt_state.values() if g is not None
           for k, b in g.momentum.items() if rtrain.group_of(k) not in frozen}
    assert set(got) == set(grads)
    assert any(k.startswith("motion.slow_path.") for k in got) == use_vis
    largest = {k: float(v.abs().max()) for k, v in grads.items()}
    floor = float(np.median(list(largest.values())))
    for k in grads:
        assert rel(got[k], grads[k], max(largest[k], floor)) < 2e-2, k


def recorded_step(cfg, use_vis, graphed=False, monkeypatch=None):
    """The span records of one recorded step; ``graphed``: a replay of the
    step, CUDA graphs stood in for on the CPU (the capture runs the step
    once, a replay runs nothing)."""
    state, _ = small_state(cfg)
    batch = clip_batch(cfg)
    cpu = torch.device("cpu")
    step = train.make_eager_train_step(cfg, state.nets, use_vis, cpu)
    if graphed:
        class FakeGraph:
            def replay(self):
                pass

        @contextlib.contextmanager
        def capture(graph, capture_error_mode="global"):
            yield
        monkeypatch.setattr(train, "graphable", lambda d: True)
        monkeypatch.setattr(train.GraphedStep, "_put_uniforms",
                            lambda self, static, u: static.copy_(u))
        monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
        monkeypatch.setattr(torch.cuda, "graph", capture)
        step = train.GraphedStep(cfg, use_vis, step, cpu)
        for _ in range(2):          # eager, then the capture: not recorded
            step(state, batch, generator=torch.Generator().manual_seed(5))
    with spans.recording():
        step(state, batch, generator=torch.Generator().manual_seed(5))
    return spans.drain().records


def test_the_slow_spans_lie_inside_train_motion_and_count_slow_frames():
    cfg = Config(**CLIPS)
    rec = recorded_step(cfg, True)
    by_id = {r.id: r for r in rec}

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name
    slow = [r for r in rec if r.name == "motion.slow"]
    lateral = [r for r in rec if r.name == "motion.lateral"]
    # per source: the stem and 4 stages; 4 laterals
    assert (len(slow), len(lateral)) == (2 * 5, 2 * 4)
    for r in slow + lateral:
        assert "train.motion" in list(ancestors(r))
    kids = spans.descendants(rec)
    (step,) = [r for r in rec if r.name == "train.step"]
    counts = spans.inclusive_counts(step, kids)
    assert counts["motion.slow_frames"] == B * cfg.num_mix * T // 8
    assert counts["motion.clips"] == B * cfg.num_mix
    ao = recorded_step(cfg, False)
    assert not [r for r in ao if r.name.startswith("motion.")]


@pytest.mark.parametrize("use_vis", [True, False], ids=["av", "ao"])
def test_a_replayed_step_counts_the_slow_frames_again(use_vis, monkeypatch):
    cfg = Config(**CLIPS)
    rec = recorded_step(cfg, use_vis, graphed=True, monkeypatch=monkeypatch)
    assert [r.name for r in rec] == ["train.step"]
    assert rec[0].counts.get("train.graph_replay") == 1
    assert rec[0].counts.get("motion.slow_frames", 0) == \
        (B * cfg.num_mix * T // 8 if use_vis else 0)


def test_the_default_is_the_fast_pathway_as_before():
    cfg = Config(**{**CLIPS, "vis_channels": 256, "clip_len": 4,
                    "arch_motion": Config.arch_motion})
    assert cfg.arch_motion == "slowfast_fast"
    nets = engine.build_nets(cfg, device="cpu")
    assert type(nets.motion) is ResNet3dFastOnly
    assert set(nets.motion.state_dict()) == set(ResNet3dFastOnly()
                                                .state_dict())
    nets.motion.reset_parameters_(torch.Generator().manual_seed(0))
    clips = clips_of(6, (B, 4, S, S, 3))
    with torch.no_grad():
        want = torch.relu(torch.mean(nets.motion(normalize_frames(clips)),
                                     dim=1))
        with spans.recording():
            got = engine._motion_features(nets, clips, cfg)
    assert torch.equal(got, want)
    rec = spans.drain()
    assert rec.totals() == {"motion.clips": B}
    with pytest.raises(ValueError, match="arch_motion"):
        engine.build_nets(cfg.replace(arch_motion="slowfast_r101"),
                          device="cpu")
