"""The motion net's stem as the ops ``avsep::motion_stem`` and
``avsep::motion_stem_wgrad`` (``ops/kernels.py``, ``csrc/motion_stem.cu``).

On the CPU the ops take their plain versions, which must be the bfloat16
path the net ran before the kernel, bit for bit: ``engine.
normalize_frames``, the permute, and ``layers.Conv3d`` at compute dtype
bfloat16, forward and weight gradient, for uint8 and float32 clips and for
a strided ``stream[:, n]`` view.  The bfloat16 net calls the op once per
forward and the float32 net never; clips that require grad raise; and a
profiler links the op's forward and its backward to the ``train.motion``
span the way ``benchmark/trace/motion.py`` (stretch M) attributes kernels.

On a card (the ``cuda`` marker; each test skips without one) the kernels
against the plain version on the card, at the clips cell's shape and at
ragged ones; two weight-gradient calls bit for bit; and a bfloat16 clips
step captured in a CUDA graph.  The file imports torch, the port and the
graph tests' helpers only, so the card's machine, which has no JAX, runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_motion_stem.py -q -s

Tolerances on the card, kernel against cuDNN: both round float32 sums to
bfloat16, so an output may differ by the rounding of each (2^-8 of its
value, twice) plus what the two summation orders change in float32.  The
forward sums K = 735 products: at most 2 x 735 x 2^-24 of the sum of their
magnitudes.  The weight gradient sums every output position (6.4 M at the
cell's shape) in blocks: the kernel's longest sequential chain is 512
mma accumulations of a block plus 25 columns and 5 butterfly levels, and
2 x 1024 x 2^-24 of the magnitudes bounds both orders here.  That bound
is only tight where the sums do not cancel: with a zero-mean output
gradient a typical weight gradient is about sqrt(6.4 M) products while
the magnitudes sum 6.4 M, and the bound would be a fifth of the value.
So the output gradients here have mean 1, and the test at the cell's
shape holds the median tolerance to a small share of the value.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import layers
from avsep_tpu_torch.models.motion import ResNet3dFastOnly
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.utils import spans
from tests.test_torch_train_graph import cuda_device  # noqa: F401 (fixture)

SHAPE = (2, 6, 20, 24, 3)
K = 735


def stem_conv(seed=0):
    torch.manual_seed(seed)
    return layers.Conv3d(3, 8, (5, 7, 7), stride=(1, 2, 2),
                         padding=(2, 3, 3), bias=False,
                         compute_dtype=torch.bfloat16)


def clip_cases(shape=SHAPE, seed=0, device="cpu"):
    """uint8 clips, a strided view of one source of a [B, 2, ...] batch,
    and float32 normalized clips."""
    g = torch.Generator().manual_seed(seed)
    B, T, H, W, C = shape
    both = torch.randint(0, 256, (B, 2, T, H, W, C), dtype=torch.uint8,
                         generator=g).to(device)
    return {"uint8": both[:, 0].contiguous(), "uint8_view": both[:, 1],
            "float32": engine.normalize_frames(both[:, 0])}


def conv3d_path(conv, clips, grad):
    """The stem as the net ran it before the kernel, and its weight
    gradient."""
    y = conv(engine.normalize_frames(clips).permute(0, 4, 1, 2, 3))
    gw, = torch.autograd.grad(y, conv.weight, grad)
    return y, gw


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("case", ["uint8", "uint8_view", "float32"])
def test_plain_op_is_the_conv3d_path_bit_for_bit(case):
    conv = stem_conv()
    clips = clip_cases()[case]
    assert case != "uint8_view" or not clips.is_contiguous()
    grad = torch.randn((2, 8, 6, 10, 12),
                       generator=torch.Generator().manual_seed(1)).bfloat16()
    want, want_gw = conv3d_path(conv, clips, grad)
    got = kernels.motion_stem(clips, conv.weight)
    gw, = torch.autograd.grad(got, conv.weight, grad)
    assert got.dtype == torch.bfloat16 and gw.dtype == torch.float32
    assert got.shape == want.shape == (2, 8, 6, 10, 12)
    assert torch.equal(got, want)
    assert torch.equal(gw, want_gw)
    assert torch.equal(kernels.motion_stem_wgrad(clips, grad, conv.weight),
                       want_gw)


def test_op_gives_no_gradient_to_clips():
    conv = stem_conv()
    clips = clip_cases()["float32"].requires_grad_()
    with pytest.raises(RuntimeError, match="must not require grad"):
        kernels.motion_stem(clips, conv.weight)
    with torch.no_grad():
        kernels.motion_stem(clips, conv.weight)


@pytest.mark.parametrize("bad", ["dtype", "channels", "weight", "device"])
def test_op_rejects_what_the_kernel_does_not_take(bad):
    conv = stem_conv()
    clips, w = clip_cases()["uint8"], conv.weight
    if bad == "dtype":
        clips = clips.to(torch.int16)
    elif bad == "channels":
        clips = clips[..., :2]
    elif bad == "weight":
        w = w[:4]
    else:
        clips = clips.to("meta")
    with pytest.raises((TypeError, ValueError)):
        kernels.motion_stem(clips, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_motion_features_call_the_op_in_bfloat16_only(dtype, monkeypatch):
    """``engine._motion_features`` hands a bfloat16 net the uint8 clip and
    the net calls the op once and ``conv1`` (cuDNN's convolution on a card)
    never; the float32 net normalizes, runs ``conv1`` and never calls the
    op."""
    cfg = Config(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=6)
    torch.manual_seed(0)
    net = ResNet3dFastOnly(dtype=dtype).train()
    assert net.stem_kernel == (dtype == torch.bfloat16)
    nets = engine.Nets(None, None, net)
    clips = clip_cases()["uint8"]
    calls, conv1 = [], []
    op = kernels.motion_stem
    monkeypatch.setattr(kernels, "motion_stem",
                        lambda c, w: calls.append(c.dtype) or op(c, w))
    net.conv1.register_forward_hook(lambda m, i, o: conv1.append(i[0].dtype))
    got = engine._motion_features(nets, clips, cfg)
    bf16 = dtype == torch.bfloat16
    assert calls == ([torch.uint8] if bf16 else [])
    assert conv1 == ([] if bf16 else [torch.float32])
    assert got.dtype == dtype and got.shape == (2, 1, 1, 256)


def test_bfloat16_net_equals_its_conv3d_stem_bit_for_bit(monkeypatch):
    """The whole bfloat16 net in train mode, through
    ``engine._motion_features``, forward and every parameter's gradient:
    the op route against the route the net took before it."""
    cfg = Config(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=6)
    clips = clip_cases()["uint8_view"]

    def run(route):
        torch.manual_seed(0)
        net = ResNet3dFastOnly(dtype=torch.bfloat16).train()
        monkeypatch.setattr(ResNet3dFastOnly, "stem_kernel", route)
        out = engine._motion_features(engine.Nets(None, None, net), clips,
                                      cfg)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    list(net.parameters()))
        monkeypatch.undo()
        return out, grads, net.state_dict()

    got, got_g, got_sd = run(True)
    want, want_g, want_sd = run(False)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)


def test_stretch_m_attributes_the_stem_forward_and_backward():
    """Under ``torch.profiler`` with the span recorder on, a bfloat16
    ``_motion_features`` and its backward: the stem's op opens inside
    ``train.motion`` as an op (not an annotation) with a sequence number,
    and an autograd backward function carries that number, on the forward's
    thread.  So stretch M's rule, with no change, counts a kernel launched
    under either: here two stand-in activities linked to the two ops."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import motion as stretch_m
    cfg = Config(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=6)
    torch.manual_seed(0)
    net = ResNet3dFastOnly(dtype=torch.bfloat16).train()
    clips = clip_cases()["uint8_view"]
    spans.drain()
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        out = engine._motion_features(engine.Nets(None, None, net), clips,
                                      cfg)
        out.float().sum().backward()
    spans.drain()
    ops, _ = stretch_m.trace_events(p)
    motion = [o for o in ops if o.name == stretch_m.SPAN]
    stem = [o for o in ops if o.name == "avsep::motion_stem"]
    wgrad = [o for o in ops if o.name == "avsep::motion_stem_wgrad"]
    assert len(motion) == len(stem) == len(wgrad) == 1
    (m,), (s,), (w,) = motion, stem, wgrad
    assert not s.annotation and s.seq >= 0 and s.thread == m.thread
    assert m.t0 <= s.t0 < m.t1
    backward = [o for o in ops if o.name.startswith(stretch_m.BACKWARD)
                and o.seq == s.seq and o.fwd_thread == s.thread]
    assert len(backward) == 1 and backward[0].t0 <= w.t0 < backward[0].t1
    device = [(1.0, 2.0, s.id, "stem_forward_kernel"),
              (3.0, 5.0, w.id, "stem_wgrad_kernel"),
              (6.0, 7.0, -1, "unlinked")]
    acts, n_fwd, n_bwd = stretch_m.motion_activities(ops, device)
    assert (n_fwd, n_bwd) == (1, 1)
    assert acts == [(1.0, 2.0), (3.0, 5.0)]


def test_tile_size_matches_the_cuda_source():
    # the weight gradient's scratch has one column per output tile of a
    # block, sized in Python from _STEM_TILE: it must be the kernel's tile
    with open(os.path.join(kernels.CSRC_DIR, "motion_stem.cu")) as f:
        src = f.read()
    tile = {k: int(v) for k, v in re.findall(
        r"constexpr int (kTileH|kTileW) = (\d+);", src)}
    assert tile == {"kTileH": kernels._STEM_TILE, "kTileW": kernels._STEM_TILE}


def test_graph_replays_count_the_stem_launches():
    # GraphedStep advances each counter of kernels.launch_counts() by what
    # its capture counted, so a replayed AV step counts its stem launches
    counts = kernels.launch_counts()
    assert {"motion_stem", "motion_stem_wgrad"} <= set(counts)
    for name, n in counts.items():
        assert isinstance(n, int) and getattr(kernels, name).launches == n


# ------------------------------------------------------------- on a card


def _magnitudes(x, w, grad=None):
    """float32 sums of the magnitudes of each output's (or each weight
    gradient's) products, TF32 off."""
    xa, wa = x.float().abs(), w.detach().float().abs()
    if grad is None:
        return F.conv3d(xa, wa, None, kernels.STEM_STRIDE,
                        kernels.STEM_PADDING)
    _, gw, _ = torch.ops.aten.convolution_backward(
        grad.float().abs(), xa, wa, None, kernels.STEM_STRIDE,
        kernels.STEM_PADDING, (1, 1, 1), False, (0, 0, 0), 1,
        (False, True, False))
    return gw


def error_over_tolerance(got, want, magnitudes, chain):
    """The largest error of ``got`` against ``want`` over its tolerance
    (module docstring): each side's bfloat16 rounding, 2^-8 of its value,
    plus ``chain`` float32 roundings of the summed magnitudes per summation
    order.  An exact zero against an exact zero reads 0.  Also the median
    of the tolerance as a share of ``want``'s nonzero magnitudes."""
    got, want = got.detach().float(), want.detach().float()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) \
        + 2 * chain * 2.0 ** -24 * magnitudes
    err = (got - want).abs()
    share = (tol / want.abs())[want != 0]
    return (float(torch.where(err == 0, 0.0, err / tol).max()),
            float(share.median()) if share.numel() else 0.0)


def output_grad(shape, device, generator=None):
    """A bfloat16 output gradient of mean 1 (module docstring)."""
    return (torch.randn(shape, device=device, generator=generator)
            + 1.0).bfloat16()


def _check_against_plain(clips, weight, grad):
    """The kernels against the plain version on the card: the largest error
    over its tolerance and the tolerance's median share of the value,
    forward and weight gradient."""
    got = kernels.motion_stem(clips, weight)
    x = kernels._stem_input(clips)
    fwd = error_over_tolerance(got, kernels.motion_stem_plain(clips, weight),
                               _magnitudes(x, weight), K)
    gw = kernels.motion_stem_wgrad(clips, grad, weight)
    bwd = error_over_tolerance(
        gw, kernels.motion_stem_wgrad_plain(clips, grad, weight),
        _magnitudes(x, weight, grad), 1024)
    torch.cuda.synchronize()
    return fwd, bwd, got


@pytest.mark.cuda
def test_kernels_match_plain_at_the_cells_shape_on_cuda(cuda_device):
    """16 clips of 32 x 224 x 224 (one source of a clips AV step, as the
    ``[:, n]`` view of the batch), forward and weight gradient, each
    tolerance a small share of a typical value (a weight gradient off by a
    dropped frame, 1/32 of its sum, would fail); the counters count one
    launch each."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    batch = torch.randint(0, 256, (16, 2, 32, 224, 224, 3),
                          dtype=torch.uint8, device=cuda_device, generator=g)
    conv = stem_conv().to(cuda_device)
    grad = output_grad((16, 8, 32, 112, 112), cuda_device, g)
    n0 = kernels.motion_stem.launches, kernels.motion_stem_wgrad.launches
    (fwd, fwd_share), (bwd, bwd_share), got = _check_against_plain(
        batch[:, 1], conv.weight, grad)
    print(f"cell shape: forward {fwd:.3g}, weight gradient {bwd:.3g} of "
          f"their tolerances, which are {fwd_share:.3g} and {bwd_share:.3g} "
          "of a typical value")
    assert got.shape == (16, 8, 32, 112, 112)
    assert got.permute(0, 2, 3, 4, 1).is_contiguous()
    assert (kernels.motion_stem.launches - n0[0],
            kernels.motion_stem_wgrad.launches - n0[1]) == (1, 1)
    assert fwd <= 1.0 and bwd <= 1.0
    assert fwd_share <= 0.05 and bwd_share <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 1, 1, 3), (3, 9, 37, 51, 3),
                                   (2, 17, 64, 31, 3), (1, 5, 224, 224, 3)])
@pytest.mark.parametrize("case", ["uint8", "uint8_view", "float32"])
def test_kernels_match_plain_ragged_and_strided_on_cuda(cuda_device, shape,
                                                        case):
    clips = clip_cases(shape, seed=sum(shape), device=cuda_device)[case]
    conv = stem_conv(1).to(cuda_device)
    B, T, H, W, _ = shape
    grad = output_grad((B, 8, T, (H + 1) // 2, (W + 1) // 2), cuda_device)
    (fwd, _), (bwd, _), _ = _check_against_plain(clips, conv.weight, grad)
    print(f"{shape} {case}: forward {fwd:.3g}, weight gradient {bwd:.3g}")
    assert fwd <= 1.0 and bwd <= 1.0


@pytest.mark.cuda
def test_weight_gradient_repeats_bit_for_bit_on_cuda(cuda_device):
    clips = clip_cases((4, 16, 112, 112, 3), device=cuda_device)["uint8"]
    conv = stem_conv().to(cuda_device)
    grad = torch.randn((4, 8, 16, 56, 56), device=cuda_device).bfloat16()
    a = kernels.motion_stem_wgrad(clips, grad, conv.weight)
    b = kernels.motion_stem_wgrad(clips, grad, conv.weight)
    assert torch.equal(a, b)
    assert torch.equal(kernels.motion_stem(clips, conv.weight),
                       kernels.motion_stem(clips, conv.weight))


CLIP_CFG = dict(arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
                vis_channels=32, fusion_type="CoLoc_ClipAtt",
                load_clips=True, clip_len=4, att_type="sig", loss="bce",
                not_pool_vis=False, binary_mask=1, weighted_loss=1,
                num_mix=2, audLen=16383, imgSize=64, one_frame=True,
                match_weight=0.1, lr_sound=1e-2, lr_frame=1e-3,
                lr_motion=1e-3, lr_steps=(100,), dtype="bfloat16",
                dft="matmul")


def graphed_clip_steps(device, names):
    """bfloat16 clips steps, AV and AO in turn, from one state graphed and
    eager: the largest difference of the graphed run from eager, twice
    eager's own spread (the graph tests' limit), the replays, and per step
    ``(use_vis, launches of each kernel of names)``."""
    from tests.test_torch_train_graph import largest_difference, run
    cfg = Config(**CLIP_CFG)
    kinds = [True, False] * 4
    rs = np.random.RandomState(0)
    data = [{"audios": torch.from_numpy((rs.randn(2, 2, cfg.audLen) * 0.05
                                         ).astype(np.float32)).to(device),
             "clips": torch.from_numpy(rs.randint(
                 0, 256, (2, 2, 4, 64, 64, 3)).astype(np.uint8)).to(
                 device)} for _ in kinds]

    def make_nets(c, device):
        torch.manual_seed(0)
        # the clip attention meets the motion net's 256 channels at ngf 64
        fusion = dict(fc_dim=2, num_downs=5, ngf=64,
                      fusion_type=c.fusion_type, att_type=c.att_type,
                      dtype=torch.bfloat16)
        return engine.Nets(AudioUnet(**fusion).to(device),
                           TinyConvEncoder(32, "maxpool").to(device),
                           ResNet3dFastOnly(dtype=torch.bfloat16).to(device))

    import tests.test_torch_train_graph as graph_tests
    small_nets = graph_tests.small_nets
    graph_tests.small_nets = make_nets
    try:
        ref = run(cfg, train.make_eager_train_step, kinds, data, device)
        again = run(cfg, train.make_eager_train_step, kinds, data, device)
        counts = []

        def counted(c, nets, use_vis, device):
            step = train.make_train_step(c, nets, use_vis, device)

            def call(state, batch, **kw):
                n0 = kernels.launch_counts()
                out = step(state, batch, **kw)
                n1 = kernels.launch_counts()
                counts.append((use_vis, tuple(n1[k] - n0[k] for k in names)))
                return out
            return call

        got = run(cfg, counted, kinds, data, device)
    finally:
        graph_tests.small_nets = small_nets
    return (largest_difference(got, ref),
            2 * largest_difference(ref, again),
            got["counts"].get("train.graph_replay", 0), counts)


@pytest.mark.cuda
def test_graphed_clip_steps_count_the_stem_on_cuda(cuda_device):
    """bfloat16 clips steps, AV and AO in turn, from one state graphed and
    eager: the losses and every tensor after every step within twice
    eager's own spread, as the graph tests hold them; every AV step, eager,
    captured or replayed, adds 2 to each stem counter (one forward and one
    weight gradient per source), an AO step 0."""
    diff, limit, replays, counts = graphed_clip_steps(
        cuda_device, ("motion_stem", "motion_stem_wgrad"))
    print(f"graphed clip steps against eager: {diff} (limit {limit}); "
          f"replays {replays}")
    assert diff <= limit
    assert replays >= 4
    assert counts == [(v, (2 * v, 2 * v)) for v in [True, False] * 4]
