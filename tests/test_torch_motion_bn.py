"""The motion net's train-mode BatchNorm, with its ReLU and residual add, as
the ops ``avsep::motion_bn`` and ``avsep::motion_bn_backward``
(``ops/kernels.py``, ``csrc/motion_bn.cu``).

On the CPU the ops take their plain versions, which must be what the
bfloat16 motion net ran before the kernels, bit for bit: ``layers.
BatchNorm`` in train mode, the residual add and ``torch.relu``, forward,
the gradients of x, weight, bias and residual, the running buffers and
``num_batches_tracked``, under ``running_stats_frozen`` too; the whole
bfloat16 net forward and backward alike.  4-D inputs, the float32 net, eval
mode and more than one rank never call the op.  A profiler links both ops
to the ``train.motion`` span as stretch M attributes kernels.

On a card (the ``cuda`` marker; each test skips without one) the kernels
against the plain version on the card at every BatchNorm shape of the net
at 16 clips of 32 x 224 x 224, at every slow norm of SlowFast R50 there
(64 to 2048 channels), at every norm of X3D-M the kernels take at 16
clips of 16 x 224 x 224 (24 to 432 channels), at ragged row counts and
at C = 8, 24 and 256; two calls bit for bit; and bfloat16 clips steps captured in a CUDA
graph advance the counters.  The file imports torch, the port and the
graph tests' helpers only, so the card's machine, which has no JAX, runs
it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_motion_bn.py -q -s

Tolerances on the card, kernels against the plain version
(:func:`errors_over_tolerance`): each side takes its float32 statistics
and sums in another order, over up to 6.4 M rows; each side's error is
held to EPS = 2^-16 of the summed magnitudes (the sum of |x| for the mean,
of (x - mean)^2 + mean^2 for the variance, of |g| and |g xhat| for the
gradient's sums).  What those errors move in an output follows from the
formulas, plus 2^-22 of each value for float32 rounding and rsqrt.  Each
side rounds the BatchNorm output to bfloat16 (2^-7 of its value between
them), and again after the residual add; but the two sides' unrounded
values lie so near each other that they round to different bfloat16 values
only where they lie that near a rounding boundary (:func:`rounds_apart`),
and everywhere else the output must match bit for bit.  The ReLU mask is
the one discrete difference: where the rounding may differ and the plain
pre-activation lies within its tolerance of 0, the two sides may mask
differently, and there the gradient may differ by the whole of dy.  The output gradients have mean 1 and grow
with x, so that the per-channel sums do not cancel and their tolerances
stay a small share of each value.
"""

import os
import re
from collections import Counter

import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import layers, motion
from avsep_tpu_torch.models.motion import ResNet3dFastOnly, ResNet3dSlowFast
from avsep_tpu_torch.models.x3d import X3D
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.utils import spans
from tests.test_torch_motion_stem import clip_cases, graphed_clip_steps
from tests.test_torch_train_graph import cuda_device  # noqa: F401 (fixture)

EPS = 2.0 ** -16
CL = torch.channels_last_3d


def bn_module(C, seed=0):
    """A bfloat16 BatchNorm with drawn parameters and running buffers."""
    g = torch.Generator().manual_seed(seed)
    bn = layers.BatchNorm(C, momentum=0.9, eps=1e-5,
                          compute_dtype=torch.bfloat16).train()
    with torch.no_grad():
        bn.weight.copy_(1.0 + 0.2 * torch.randn(C, generator=g))
        bn.bias.copy_(0.2 * torch.randn(C, generator=g))
        bn.running_mean.copy_(torch.randn(C, generator=g))
        bn.running_var.copy_(torch.rand(C, generator=g) + 0.5)
    return bn


def activation(shape, seed=0, device="cpu", shift=0.5):
    """A bfloat16 channels-last [B, C, T, H, W] activation with a mean and
    a scale of its own per channel, as a conv's output has."""
    g = torch.Generator().manual_seed(seed)
    B, C = shape[:2]
    mu = shift * torch.randn(C, generator=g)
    sigma = 0.5 + torch.rand(C, generator=g)
    x = torch.randn(shape, generator=g) * sigma.view(1, C, 1, 1, 1) + \
        mu.view(1, C, 1, 1, 1)
    return x.bfloat16().to(device).contiguous(memory_format=CL)


def module_path(bn, x, relu, residual):
    """The net's ops before the kernels: BatchNorm, the add, the ReLU."""
    y = bn(x)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def op_path(bn, x, relu, residual):
    y, mean, var = kernels.motion_bn(x, bn.weight, bn.bias, bn.eps, relu,
                                     residual)
    bn.update_running(mean, var)
    return y


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("frozen", [False, True], ids=["update", "frozen"])
@pytest.mark.parametrize("relu,res", [(True, False), (False, False),
                                      (True, True), (False, True)],
                         ids=["relu", "plain", "relu_residual", "residual"])
def test_plain_op_is_the_module_path_bit_for_bit(relu, res, frozen):
    x = activation((2, 16, 3, 5, 6))
    residual = activation(x.shape, seed=1) if res else None
    grad = torch.randn(x.shape, generator=torch.Generator().manual_seed(2)
                       ).bfloat16()
    out = {}
    for name, path in (("module", module_path), ("op", op_path)):
        bn = bn_module(16)
        xs = x.clone().requires_grad_()
        rs = None if residual is None else residual.clone().requires_grad_()
        with (layers.running_stats_frozen() if frozen
              else torch.enable_grad()):
            y = path(bn, xs, relu, rs)
        leaves = [xs, bn.weight, bn.bias] + ([rs] if res else [])
        grads = torch.autograd.grad(y, leaves, grad)
        out[name] = (y, grads, bn.state_dict())
    (y, g, sd), (y2, g2, sd2) = out["module"], out["op"]
    assert y2.dtype == torch.bfloat16 and torch.equal(y, y2)
    assert len(g) == len(g2) == 3 + res
    assert all(torch.equal(a, b) for a, b in zip(g, g2))
    assert sd.keys() == sd2.keys()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert int(sd2["num_batches_tracked"]) == (0 if frozen else 1)
    if frozen:
        assert torch.equal(sd2["running_mean"], bn_module(16).running_mean)


def test_statistics_are_the_batch_mean_and_biased_variance():
    x = activation((2, 8, 3, 4, 5))
    bn = bn_module(8)
    _, mean, var = kernels.motion_bn(x, bn.weight, bn.bias, bn.eps, True)
    xf = x.float().transpose(0, 1).reshape(8, -1)
    torch.testing.assert_close(mean, xf.mean(1))
    torch.testing.assert_close(var, xf.var(1, unbiased=False))
    assert not mean.requires_grad and not var.requires_grad


def bn_calls(monkeypatch):
    """Record every call of ``kernels.motion_bn`` (the op, on any device)
    as ``(C, relu, residual given)``."""
    calls, op = [], kernels.motion_bn

    def counted(x, w, b, eps, relu, residual=None):
        calls.append((x.shape[1], relu, residual is not None))
        return op(x, w, b, eps, relu, residual)
    monkeypatch.setattr(kernels, "motion_bn", counted)
    return calls


def test_bfloat16_net_is_the_module_path_bit_for_bit(monkeypatch):
    """The whole bfloat16 net in train mode, through ``engine.
    _motion_features``, forward, every parameter's gradient and every
    buffer: the op route against the modules' route (what the net ran
    before the kernels); the op route calls the op once per BatchNorm,
    53 times, with the ReLU on all but the 4 downsample norms and the
    residual on the 16 blocks' third."""
    cfg = Config(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=4)
    clips = clip_cases((2, 4, 32, 40, 3))["uint8_view"]

    def run(route):
        torch.manual_seed(0)
        net = ResNet3dFastOnly(dtype=torch.bfloat16).train()
        if not route:
            monkeypatch.setattr(motion, "bn_kernel_applies", lambda bn: False)
        calls = bn_calls(monkeypatch)
        out = engine._motion_features(engine.Nets(None, None, net), clips,
                                      cfg)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    list(net.parameters()))
        monkeypatch.undo()
        return out, grads, net.state_dict(), calls

    got, got_g, got_sd, calls = run(True)
    want, want_g, want_sd, none = run(False)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert all(torch.equal(got_sd[k], want_sd[k]) for k in want_sd)
    assert none == []
    assert len(calls) == 53
    assert Counter((relu, res) for _, relu, res in calls) == {
        (True, False): 33, (False, False): 4, (True, True): 16}


@pytest.mark.parametrize("case", ["4d", "float32", "eval", "two_ranks"])
def test_op_is_never_called_off_its_path(case, monkeypatch):
    """4-D inputs (the U-Net's and ResNets' BatchNorm), the float32 net,
    eval mode and more than one rank never reach the op, nor its
    kernels' counters."""
    n0 = kernels.launch_counts()
    calls = bn_calls(monkeypatch)
    if case == "4d":
        bn = bn_module(8)
        bn(torch.randn(2, 8, 5, 6).bfloat16())
    else:
        torch.manual_seed(0)
        dtype = torch.float32 if case == "float32" else torch.bfloat16
        net = ResNet3dFastOnly(base_channels=8, stage_blocks=(1, 1, 1, 1),
                               dtype=dtype).train(case != "eval")
        if case == "two_ranks":
            # a group of two ranks whose all-reduce returns its own sums
            for mod in (motion, layers):
                monkeypatch.setattr(mod, "world_size", lambda: 2)
            monkeypatch.setattr(layers, "all_reduce_sum", lambda t: t)
        clips = clip_cases((2, 4, 32, 32, 3))
        net(clips["uint8" if dtype == torch.bfloat16 else "float32"])
    monkeypatch.undo()
    assert calls == []
    assert kernels.launch_counts() == n0


@pytest.mark.parametrize("bad", ["dtype", "dims", "weight", "residual",
                                 "one_row"])
def test_op_rejects_what_it_does_not_take(bad):
    x, bn = activation((2, 8, 2, 3, 3)), bn_module(8)
    w, res = bn.weight, None
    if bad == "dtype":
        x = x.float()
    elif bad == "dims":
        x = x[:, :, 0]
    elif bad == "weight":
        w = w[:4]
    elif bad == "residual":
        res = x[:1]
    else:
        x = x[:1, :, :1, :1, :1]
    with pytest.raises((TypeError, ValueError)):
        kernels.motion_bn(x, w, bn.bias, bn.eps, True, res)


@pytest.mark.parametrize("bad", ["layout", "channels"])
def test_cuda_path_rejects_what_the_kernels_do_not_take(bad):
    """The card's route raises, before any launch, on an NCDHW input and on
    a C that is not a multiple of 8 (checked here on CPU tensors)."""
    C = 8 if bad == "layout" else 12
    x, bn = activation((2, C, 2, 3, 3)), bn_module(C)
    if bad == "layout":
        x = x.contiguous()
    with pytest.raises(ValueError, match="channels-last|multiple of 8"):
        kernels._motion_bn_cuda(x, bn.weight, bn.bias, bn.eps, True)


def bn_shapes(B, T, H, W, net_class=ResNet3dFastOnly):
    """Every BatchNorm call of the net (the fast pathway, or another motion
    net class) on ``[B, T, H, W, 3]`` clips, in order: ``(name, [B, C, T,
    h, w], relu, residual)``, from the float32 net on the meta device."""
    with torch.device("meta"):
        net = net_class().train()
    shapes = []
    for name, m in net.named_modules():
        if isinstance(m, layers.BatchNorm):
            last = name.rsplit(".", 1)[-1]
            m.register_forward_hook(
                lambda m, i, o, name=name, last=last: shapes.append(
                    (name, tuple(i[0].shape), last != "downsample_bn",
                     last == "bn3")))
    net(torch.empty((B, T, H, W, 3), device="meta"))
    return shapes


def test_plan_launches_two_waves_at_every_shape_of_the_cell():
    """At the clips cell (16 clips of 32 x 224 x 224) every BatchNorm shape
    launches at least two waves of 132 SMs, and its chunks cover its rows;
    the plan's threads are the kernel's."""
    shapes = bn_shapes(16, 32, 224, 224)
    assert len(shapes) == 53
    for _, shape, _, _ in shapes:
        C = shape[1]
        rows = shape[0] * shape[2] * shape[3] * shape[4]
        per_block, blocks = kernels.motion_bn_plan(rows, C)
        per_iter = kernels._BN_THREADS // (C // 8)
        assert per_block % per_iter == 0
        assert (blocks - 1) * per_block < rows <= blocks * per_block
        assert 2 * 132 <= blocks <= kernels._BN_BLOCKS
    with open(os.path.join(kernels.CSRC_DIR, "motion_bn.cu")) as f:
        src = f.read()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (\w+) = (\d+);", src)}
    assert const["kThreads"] == kernels._BN_THREADS
    # the combine loads every block's partial in one round
    assert const["kPartialsPerThread"] * const["kCombineThreads"] >= \
        kernels._BN_BLOCKS


def x3d_cases():
    """X3D-M's BatchNorm calls at 16 clips of 16 x 224 x 224 as
    :func:`bn_shapes` gives them, each block's ``bn2`` without its ReLU
    (the gate follows it): ``[(name, shape, relu, residual)]``."""
    return [(name, shape, relu and not name.endswith(".bn2"), res)
            for name, shape, relu, res in bn_shapes(16, 16, 224, 224, X3D)]


def test_x3d_takes_the_kernels_at_every_whole_group_width():
    """X3D-M's 84 norms: the 68 of whole 8-channel groups (24 to 432) take
    the kernels in bfloat16 train mode on one rank and launch at least two
    waves of 132 SMs, each plan's chunks covering its rows; the 16 inner
    norms of the first two stages (54 and 108 channels) keep the module,
    whose plain path on a card takes any width."""
    cases = x3d_cases()
    assert len(cases) == 84
    with torch.device("meta"):
        net = X3D(dtype=torch.bfloat16).train()
    takes = {name: motion.bn_kernel_applies(net.get_submodule(name))
             for name, *_ in cases}
    assert sum(takes.values()) == 68
    assert {shape[1] for name, shape, *_ in cases if not takes[name]} == \
        {54, 108}
    for name, shape, _, _ in cases:
        if not takes[name]:
            continue
        rows = shape[0] * shape[2] * shape[3] * shape[4]
        per_block, blocks = kernels.motion_bn_plan(rows, shape[1])
        assert (blocks - 1) * per_block < rows <= blocks * per_block
        assert 2 * 132 <= blocks <= kernels._BN_BLOCKS
    with pytest.raises(ValueError, match="multiple of 8"):
        kernels._motion_bn_cuda(
            torch.empty(2, 54, 1, 1, 1, dtype=torch.bfloat16).to(
                memory_format=CL), torch.ones(54), torch.zeros(54), 1e-5,
            True)


def test_stretch_m_attributes_the_batchnorm_forward_and_backward():
    """Under ``torch.profiler`` with the span recorder on, a bfloat16
    ``_motion_features`` and its backward: each of the 53 ``motion_bn`` ops
    opens inside ``train.motion`` as an op with a sequence number, and an
    autograd backward function carries that number and holds one
    ``motion_bn_backward``: stretch M's rule counts kernels launched under
    either."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import motion as stretch_m
    cfg = Config(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=4)
    torch.manual_seed(0)
    net = ResNet3dFastOnly(dtype=torch.bfloat16).train()
    clips = clip_cases((2, 4, 32, 32, 3))["uint8"]
    spans.drain()
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        out = engine._motion_features(engine.Nets(None, None, net), clips,
                                      cfg)
        out.float().sum().backward()
    spans.drain()
    ops, _ = stretch_m.trace_events(p)
    (m,) = [o for o in ops if o.name == stretch_m.SPAN]
    fwd = [o for o in ops if o.name == "avsep::motion_bn"]
    bwd = [o for o in ops if o.name == "avsep::motion_bn_backward"]
    assert len(fwd) == len(bwd) == 53
    backward = [o for o in ops if o.name.startswith(stretch_m.BACKWARD)]
    for s in fwd:
        assert not s.annotation and s.seq >= 0 and s.thread == m.thread
        assert m.t0 <= s.t0 < m.t1
        (b,) = [o for o in backward if o.seq == s.seq
                and o.fwd_thread == s.thread]
        assert sum(b.t0 <= w.t0 < b.t1 for w in bwd) == 1
    device = [(1.0, 2.0, fwd[0].id, "bn_stats_kernel"),
              (3.0, 5.0, bwd[0].id, "bn_backward_reduce_kernel"),
              (6.0, 7.0, -1, "unlinked")]
    acts, _, _ = stretch_m.motion_activities(ops, device)
    assert acts == [(1.0, 2.0), (3.0, 5.0)]


def test_launch_counts_hold_the_batchnorm_counters():
    counts = kernels.launch_counts()
    assert {"motion_bn", "motion_bn_backward"} <= set(counts)
    assert kernels.SOURCES["motion_bn"][0] == \
        kernels.SOURCES["motion_bn_backward"][0] == "motion_bn.cu"


# ------------------------------------------------------------- on a card


def _chan(v, ndim=5):
    return v.view(1, -1, *([1] * (ndim - 2)))


def rounds_apart(v, margin):
    """Where a value within ``margin`` of ``v`` may round to another
    bfloat16 than ``v`` does: ``v`` lies within ``margin`` of the rounding
    boundary half an ulp from the bfloat16 it rounds to."""
    r = v.to(torch.bfloat16).to(v.dtype)
    a, ar = v.abs(), r.abs()
    frac, e = torch.frexp(ar)    # ar = frac * 2**e, frac in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(ar), e - 8)
    below = torch.where(frac == 0.5, ulp / 2, ulp)
    edge = torch.where(a >= ar, ar + ulp / 2, ar - below / 2)
    return ((edge - a).abs() <= margin) | (ar == 0)


@torch.no_grad()
def errors_over_tolerance(x, weight, bias, eps, relu, residual, grad):
    """The kernels against the plain version on ``x``'s card: for each
    output (y, mean, var, dx, dweight, dbias, dresidual) the largest error
    over its tolerance (module docstring; an exact match reads 0) and the
    tolerance's median share of the value; and the elements whose ReLU
    mask may flip."""
    got = kernels.motion_bn(x, weight, bias, eps, relu, residual)
    y, mean, var = got
    gb = kernels.motion_bn_backward(grad, x, weight, bias, mean, var, eps,
                                    relu, residual)
    want = kernels.motion_bn_plain(x, weight, bias, eps, relu, residual)
    wb = kernels.motion_bn_backward_plain(grad, x, weight, bias, want[1],
                                          want[2], eps, relu, residual)
    d = torch.float64
    xf, w, b = x.to(d), weight.to(d), bias.to(d)
    n = x.numel() // x.shape[1]
    m, v = want[1].to(d), want[2].to(d)
    dims = [0, 2, 3, 4]
    dmean = EPS * xf.abs().mean(dims)
    dvar = EPS * (v + m * m)
    istd = (v + eps).rsqrt()
    xhat = (xf - _chan(m)) * _chan(istd)
    rel_istd = dvar / (2 * (v + eps)) + 2.0 ** -22
    # what the statistics' errors move in the normalized value
    s = (_chan(w.abs() * istd) * (_chan(dmean) + (xf - _chan(m)).abs()
                                  * _chan(dvar / (2 * (v + eps))))
         + 2.0 ** -22 * (xhat * _chan(w)).abs())
    # the plain BatchNorm output, rounded; the two sides' unrounded values
    # lie within 2 s plus float32 rounding of the float64 one, and round
    # to the same bfloat16 unless that lies so near a rounding boundary;
    # the add and the ReLU then give the same bits too
    bn = kernels.motion_bn_plain(x, weight, bias, eps, False)[0].to(d)
    scaled = xhat * _chan(w)
    apart = rounds_apart(scaled + _chan(b), 2 * s + 2.0 ** -20 * (
        scaled.abs() + _chan(b.abs()) + (xf * _chan(w * istd)).abs()))
    pre = bn if residual is None else \
        (bn.bfloat16() + residual).to(d)
    tol_bn = torch.where(apart, 2.0 ** -6 * bn.abs() + 2 * s, 0.0)
    tol_pre = tol_bn if residual is None else torch.where(
        apart, tol_bn + 2.0 ** -7 * torch.maximum(y.to(d).abs(),
                                                  want[0].to(d).abs()), 0.0)
    flip = apart & (pre.abs() <= tol_pre) if relu else \
        torch.zeros_like(apart)
    gd = grad.to(d)
    g = torch.where(pre > 0, gd, 0.0) if relu else gd
    tol_db = 2 * EPS * g.abs().sum(dims) + torch.where(flip, gd.abs(),
                                                      0.0).sum(dims)
    tol_dw = (2 * EPS * (g * xhat).abs().sum(dims)
              + torch.where(flip, (gd * xhat).abs(), 0.0).sum(dims)
              + (g * xhat).sum(dims).abs() * rel_istd)
    a = _chan(w * istd)
    k1, k2 = _chan(wb[2].to(d) / n), _chan(wb[1].to(d) / n)
    inner = gd.abs() + k1.abs() + xhat.abs() * k2.abs()
    dx_want = wb[0].to(d)
    tol_dx = (2.0 ** -7 * torch.maximum(gb[0].to(d).abs(), dx_want.abs())
              + a.abs() * (_chan(tol_db / n) + xhat.abs() * _chan(tol_dw / n)
                           + k2.abs() * _chan(istd)
                           * (_chan(dmean) + (xf - _chan(m)).abs()
                              * _chan(dvar / (2 * (v + eps))))
                           + inner * (_chan(rel_istd) + 2.0 ** -22))
              + torch.where(flip, (a * gd).abs(), 0.0))

    def ratio(got, want, tol):
        got, want = got.detach().to(d), want.detach().to(d)
        err = (got - want).abs()
        share = (tol / want.abs())[want != 0]
        return (float(torch.where(err == 0, 0.0, err / tol).max()),
                float(share.median()) if share.numel() else 0.0)

    out = {"y": ratio(y, want[0], tol_pre), "mean": ratio(mean, want[1],
                                                          dmean * 2),
           "var": ratio(var, want[2], dvar * 2),
           "dx": ratio(gb[0], wb[0], tol_dx),
           "dweight": ratio(gb[1], wb[1], tol_dw),
           "dbias": ratio(gb[2], wb[2], tol_db)}
    if residual is not None:
        out["dresidual"] = ratio(gb[3], wb[3], torch.where(flip, gd.abs(),
                                                           0.0))
    torch.cuda.synchronize()
    return out, int(flip.sum()), got, gb


def output_grad(x, generator=None):
    """A bfloat16 channels-last output gradient of mean 1 that grows with
    ``x``, so that neither per-channel sum cancels (module docstring)."""
    return (torch.randn(x.shape, device=x.device, generator=generator)
            + 1.0 + 0.5 * x.float()).bfloat16().contiguous(memory_format=CL)


def _check(device, shape, relu, res, seed=0):
    x = activation(shape, seed, device)
    bn = bn_module(shape[1], seed).to(device)
    residual = activation(shape, seed + 1, device, 1.0) if res else None
    g = torch.Generator(device=device).manual_seed(seed + 2)
    grad = output_grad(x, g)
    return errors_over_tolerance(x, bn.weight, bn.bias, bn.eps, relu,
                                 residual, grad)


def _assert_within(shape, out, flips, max_share=None):
    print(f"{shape}: " + ", ".join(f"{k} {r:.3g} (share {s:.2g})"
                                   for k, (r, s) in out.items())
          + f"; {flips} maskable")
    assert all(r <= 1.0 for r, _ in out.values()), out
    if max_share is not None:
        for k in ("dweight", "dbias", "var"):
            assert out[k][1] <= max_share, (k, out[k])


CELL = bn_shapes(16, 32, 224, 224)
CELL_CASES = sorted({(s, relu, res) for _, s, relu, res in CELL})
# SlowFast R50's slow pathway at the same clips: every distinct norm, 64 to
# 2048 channels on 4 frames (at 1024 and 2048 the plan reads two rows or
# one per block iteration)
SLOW_CASES = sorted({(s, relu, res) for name, s, relu, res in bn_shapes(
    16, 32, 224, 224, ResNet3dSlowFast) if name.startswith("slow_path.")})
# X3D-M at its 16-frame clips: every distinct norm the kernels take
X3D_CASES = sorted({(s, relu, res) for _, s, relu, res in x3d_cases()
                    if kernels.motion_bn_fits(s[1])})


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu,res", CELL_CASES,
                         ids=[f"{s[1]}x{s[3]}{'_relu' * r}{'_res' * q}"
                              for s, r, q in CELL_CASES])
def test_kernels_match_plain_at_the_cells_shapes_on_cuda(cuda_device, shape,
                                                         relu, res):
    """Every distinct BatchNorm call of the net at the clips cell: the
    forward's output and statistics, and the backward's four gradients,
    within their tolerances, each sum's tolerance under 1e-3 of a typical
    value; one launch of each kernel family per call."""
    n0 = kernels.launch_counts()
    out, flips, got, _ = _check(cuda_device, shape, relu, res)
    n1 = kernels.launch_counts()
    assert got[0].is_contiguous(memory_format=CL)
    assert (n1["motion_bn"] - n0["motion_bn"],
            n1["motion_bn_backward"] - n0["motion_bn_backward"]) == (1, 1)
    _assert_within(shape, out, flips, max_share=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu,res", SLOW_CASES,
                         ids=[f"{s[1]}x{s[3]}{'_relu' * r}{'_res' * q}"
                              for s, r, q in SLOW_CASES])
def test_kernels_match_plain_at_the_slow_pathways_shapes_on_cuda(
        cuda_device, shape, relu, res):
    """SlowFast R50's slow pathway at the cell's clips: every distinct
    BatchNorm call, 64 to 2048 channels, within the tolerances, each sum's
    tolerance under 1e-3 of a typical value."""
    out, flips, got, _ = _check(cuda_device, shape, relu, res)
    assert got[0].is_contiguous(memory_format=CL)
    _assert_within(shape, out, flips, max_share=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,relu,res", X3D_CASES,
                         ids=[f"{s[1]}x{s[3]}{'_relu' * r}{'_res' * q}"
                              for s, r, q in X3D_CASES])
def test_kernels_match_plain_at_x3ds_shapes_on_cuda(cuda_device, shape,
                                                    relu, res):
    """X3D-M at 16 clips of 16 x 224 x 224: every distinct BatchNorm call
    the kernels take, 24 to 432 channels (rows of 3 to 54 threads), within
    the tolerances, each sum's tolerance under 1e-3 of a typical value."""
    out, flips, got, _ = _check(cuda_device, shape, relu, res)
    assert got[0].is_contiguous(memory_format=CL)
    _assert_within(shape, out, flips, max_share=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 1, 1, 2), (3, 8, 5, 7, 11),
                                   (2, 256, 3, 5, 7), (2, 24, 3, 9, 13),
                                   (4, 8, 16, 56, 57)])
@pytest.mark.parametrize("relu,res", [(True, False), (False, False),
                                      (True, True)])
def test_kernels_match_plain_ragged_on_cuda(cuda_device, shape, relu, res):
    """Row counts that fill no block, C = 8, 24 (3 threads a row) and
    256."""
    out, flips, _, _ = _check(cuda_device, shape, relu, res, seed=sum(shape))
    _assert_within(shape, out, flips)


@pytest.mark.cuda
@pytest.mark.parametrize("res", [False, True])
def test_two_calls_give_the_same_bits_on_cuda(cuda_device, res):
    shape = (16, 32, 32, 28, 28)
    x = activation(shape, 0, cuda_device)
    bn = bn_module(32).to(cuda_device)
    residual = activation(shape, 1, cuda_device) if res else None
    grad = output_grad(x)
    runs = []
    for _ in range(2):
        y, mean, var = kernels.motion_bn(x, bn.weight, bn.bias, bn.eps, True,
                                         residual)
        runs.append((y, mean, var) + kernels.motion_bn_backward(
            grad, x, bn.weight, bn.bias, mean, var, bn.eps, True, residual))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_graphed_clip_steps_count_the_batchnorm_on_cuda(cuda_device):
    """bfloat16 clips steps, AV and AO in turn, graphed against eager within
    twice eager's own spread; every AV step, eager, captured or replayed,
    adds 2 x 53 to each BatchNorm counter (53 norms per source), an AO
    step 0."""
    diff, limit, replays, counts = graphed_clip_steps(
        cuda_device, ("motion_bn", "motion_bn_backward"))
    print(f"graphed clip steps against eager: {diff} (limit {limit}); "
          f"replays {replays}")
    assert diff <= limit
    assert replays >= 4
    assert counts == [(v, (106 * v, 106 * v)) for v in [True, False] * 4]
