"""The motion net's 3x1x1 temporal convolutions as the ops
``avsep::motion_conv_t3`` and ``avsep::motion_conv_t3_wgrad``
(``ops/kernels.py``, ``csrc/motion_conv_t3.cu``).

On the CPU, at reduced T, H and W, for each of the fast pathway's 16
``conv1``s (``Bottleneck3d.conv1``, 3x1x1, stride 1, temporal padding 1, no
bias): the plain version equals ``F.conv3d``, the input gradient through
the transposed and reversed taps equals autograd's, and the plain weight
gradient equals autograd's, in float32; the bfloat16 op on the CPU is its
plain version, and its autograd gives the two gradients.  The gate
(``models/motion.conv_t3_takes``) takes the fast pathway's ``conv1``s in
bfloat16, and not the float32 net, an NCDHW input, the slow pathway's 256
outputs or a 1x1x1 ``conv1``; the CUDA path raises on what the kernels do
not take before it touches a card.  A profiler links the op's forward and
its backward as stretch M attributes kernels.

On a card (the ``cuda`` marker; each test skips without one) the kernels
against the plain version on the card at each conv1 shape of the net at 16
clips of 32 x 224 x 224 and at ragged shapes, two calls bit for bit, and
bfloat16 clips steps captured in a CUDA graph counting 64 convolution
(32 forward, 32 input gradient) and 32 weight-gradient launches per AV
step.  The file imports torch, the port and the graph tests' helpers
only, so the card's machine, which has no JAX, runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_motion_conv.py -q -s

Tolerances on the card, kernel against the plain version: both take float32
sums and round once to bfloat16, so an output may differ by the rounding
of each (2^-8 of its value, twice: :data:`ROUNDING`) plus what the two
summation orders change in float32, ``chain`` float32 roundings of the
summed magnitudes of the products for each side.  The convolution's chain
is its K = 3 C (at most 768 products, summed in k-steps of 16); the weight
gradient sums every position (1.6 M at res2) in blocks, and its chain
:data:`WGRAD_CHAIN` covers both orders (the plain version's float32 matmul
over the positions included).  The output gradients have mean 1, so that
the weight gradient's sums do not cancel and the tolerance stays a small
share of each value.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch.models import layers, motion
from avsep_tpu_torch.models.motion import ResNet3dFastOnly, SlowPathway
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.utils import spans
from tests.test_torch_train_graph import cuda_device  # noqa: F401 (fixture)

CL = torch.channels_last_3d
ROUNDING = 2.0 ** -7
WGRAD_CHAIN = 4096


def conv1_shapes(net=None):
    """``(block, C_in, C_out, plane_scale)`` of the fast pathway's 16
    ``conv1``s, in order; ``plane_scale`` divides the stem's output plane
    (1 in res2, 2, 4, 8 in res3 to res5, where a stage's first conv1 still
    runs on the stage before's plane: the stride is conv2's)."""
    net = net or ResNet3dFastOnly(dtype=torch.bfloat16)
    out = []
    for si, names in enumerate(net.stages):
        for bi, name in enumerate(names):
            c = getattr(net, name).conv1
            out.append((name, c.in_channels, c.out_channels,
                        2 ** max(0, si - (bi == 0))))
    return out


CONV1 = conv1_shapes()


def t3_conv(c_in, c_out, dtype=torch.float32, seed=0):
    """A 3x1x1 ``conv1`` as ``Bottleneck3d`` builds it, He-scaled."""
    torch.manual_seed(seed)
    return layers.Conv3d(c_in, c_out, (3, 1, 1), padding=(1, 0, 0),
                         bias=False, compute_dtype=dtype)


def activation(shape, seed=0, device="cpu", dtype=torch.bfloat16):
    """A channels-last-3d ``[B, C, T, H, W]`` activation, as ``motion_bn``
    leaves it: a ReLU's output, nonnegative with a mean near 0.5."""
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(shape, generator=g) + 0.3)
    return x.to(device=device, dtype=dtype).contiguous(memory_format=CL)


def output_grad(shape, seed=0, device="cpu", dtype=torch.bfloat16):
    """An output gradient of mean 1 (module docstring), channels-last-3d."""
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) + 1.0).to(
        device=device, dtype=dtype).contiguous(memory_format=CL)


def misaligned(x):
    """``x`` copied into a dense channels-last-3d tensor 2 bytes past a
    16-byte boundary."""
    B, C, T, H, W = x.shape
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)[1:]
    out = buf.view(B, T, H, W, C).permute(0, 4, 1, 2, 3)
    out.copy_(x)
    return out


def reversed_taps(weight):
    """The input gradient's weight: each tap transposed, the taps in
    reverse order."""
    return weight.flip(2).transpose(0, 1)


def small_case(c_in, c_out, seed=0):
    """float32 x [2, C_in, 5, 3, 4], the conv's weight and an output
    gradient."""
    x = activation((2, c_in, 5, 3, 4), seed, dtype=torch.float32)
    w = t3_conv(c_in, c_out, seed=seed).weight.detach()
    g = output_grad((2, c_out, 5, 3, 4), seed + 1, dtype=torch.float32)
    return x, w, g


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("block,c_in,c_out,_", CONV1,
                         ids=[c[0] for c in CONV1])
def test_plain_version_equals_conv3d(block, c_in, c_out, _):
    x, w, _g = small_case(c_in, c_out)
    got = kernels.motion_conv_t3_plain(x, w)
    want = F.conv3d(x, w, None, 1, (1, 0, 0))
    assert got.shape == want.shape and got.is_contiguous(memory_format=CL)
    mags = F.conv3d(x.abs(), w.abs(), None, 1, (1, 0, 0))
    assert ((got - want).abs() <= 2 * 3 * c_in * 2.0 ** -24 * mags
            + 1e-30).all()


@pytest.mark.parametrize("block,c_in,c_out,_", CONV1,
                         ids=[c[0] for c in CONV1])
def test_input_gradient_is_the_conv_of_the_reversed_taps(block, c_in, c_out,
                                                         _):
    x, w, g = small_case(c_in, c_out, seed=1)
    xr = x.clone().requires_grad_()
    dx, = torch.autograd.grad(F.conv3d(xr, w, None, 1, (1, 0, 0)), xr, g)
    got = kernels.motion_conv_t3_plain(g, w, grad_input=True)
    assert torch.equal(got, kernels.motion_conv_t3_plain(g, reversed_taps(w)))
    assert got.shape == dx.shape
    mags = kernels.motion_conv_t3_plain(g.abs(), reversed_taps(w).abs())
    assert ((got - dx).abs() <= 2 * 3 * c_out * 2.0 ** -24 * mags
            + 1e-30).all()


@pytest.mark.parametrize("block,c_in,c_out,_", CONV1,
                         ids=[c[0] for c in CONV1])
def test_plain_weight_gradient_equals_autograds(block, c_in, c_out, _):
    x, w, g = small_case(c_in, c_out, seed=2)
    wr = w.clone().requires_grad_()
    dw, = torch.autograd.grad(F.conv3d(x, wr, None, 1, (1, 0, 0)), wr, g)
    got = kernels.motion_conv_t3_wgrad_plain(x, g)
    assert got.shape == dw.shape == (c_out, c_in, 3, 1, 1)
    mags = kernels.motion_conv_t3_wgrad_plain(x.abs(), g.abs())
    assert ((got - dw).abs() <= 2 * 120 * 2.0 ** -24 * mags + 1e-30).all()


def test_bfloat16_op_on_the_cpu_is_its_plain_version_with_autograd():
    """The op's CPU implementation is the plain version bit for bit, and
    its backward calls the op on the reversed taps and the weight gradient:
    float32 sums rounded once to bfloat16, as the kernels give them."""
    x = activation((2, 32, 5, 3, 4), 3).requires_grad_()
    w = t3_conv(32, 16, seed=3).weight.detach().bfloat16().requires_grad_()
    g = output_grad((2, 16, 5, 3, 4), 4)
    n0 = kernels.motion_conv_t3.launches, kernels.motion_conv_t3_wgrad.launches
    y = kernels.motion_conv_t3(x, w)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    assert torch.equal(y, kernels.motion_conv_t3_plain(x.detach(), w.detach()))
    assert torch.equal(dx, kernels.motion_conv_t3_plain(g, w.detach(), True))
    assert torch.equal(dx, kernels.motion_conv_t3(g, w.detach(), True))
    assert torch.equal(dw, kernels.motion_conv_t3_wgrad_plain(x.detach(), g))
    assert torch.equal(dw, kernels.motion_conv_t3_wgrad(x.detach(), g))
    # the CPU path counts no launch
    assert (kernels.motion_conv_t3.launches,
            kernels.motion_conv_t3_wgrad.launches) == n0
    # within a bfloat16 rounding of cuDNN's (here mkldnn's) bfloat16 conv
    want = F.conv3d(x.detach().float(), w.detach().float(), None, 1,
                    (1, 0, 0))
    assert ((y.float() - want).abs() <= ROUNDING * want.abs() + 1e-6).all()


def _conv1_inputs(net, clips):
    """Each ``conv1``'s input in a forward of ``net`` on ``clips``."""
    seen = {}
    hooks = [getattr(net, n).conv1.register_forward_pre_hook(
        lambda m, a, n=n: seen.__setitem__(n, a[0]))
        for names in net.stages for n in names]
    try:
        with torch.no_grad():
            net(clips)
    finally:
        for h in hooks:
            h.remove()
    return seen


def test_gate_takes_the_fast_pathways_conv1s_in_bfloat16():
    """Every one of the 16 ``conv1``s of the bfloat16 fast pathway, on the
    channels-last-3d bfloat16 input the net hands it (the max-pool after the
    stem keeps the stem's layout), is a shape the kernels take; on a CPU
    tensor :func:`motion.conv_t3` runs the module and launches nothing."""
    torch.manual_seed(0)
    net = ResNet3dFastOnly(dtype=torch.bfloat16).train()
    clips = torch.randint(0, 256, (1, 4, 32, 32, 3), dtype=torch.uint8)
    seen = _conv1_inputs(net, clips)
    assert len(seen) == 16
    for name, x in seen.items():
        conv = getattr(net, name).conv1
        assert x.is_contiguous(memory_format=CL), name
        assert motion.conv_t3_takes(conv, x), name
        n0 = kernels.motion_conv_t3.launches
        with torch.no_grad():
            assert torch.equal(motion.conv_t3(conv, x), conv(x))
        assert kernels.motion_conv_t3.launches == n0


@pytest.mark.parametrize("case", ["float32_net", "ncdhw", "slow_c_out_256",
                                  "slow_1x1x1", "misaligned"])
def test_gate_leaves_what_the_design_does_not_serve(case):
    """The float32 net, an NCDHW input, the slow pathway's 3x1x1 ``conv1``
    of 256 outputs (compute-bound, left to cuDNN), its 1x1x1 ``conv1`` and
    a misaligned view keep the module."""
    if case in ("slow_c_out_256", "slow_1x1x1"):
        slow = SlowPathway(dtype=torch.bfloat16)
        conv = slow.layer3_0.conv1 if case == "slow_c_out_256" else \
            slow.layer1_0.conv1
        assert tuple(conv.kernel_size) == \
            ((3, 1, 1) if case == "slow_c_out_256" else (1, 1, 1))
        x = activation((1, conv.in_channels, 2, 2, 2))
    else:
        dtype = torch.float32 if case == "float32_net" else torch.bfloat16
        conv = t3_conv(32, 8, dtype)
        x = activation((1, 32, 4, 3, 3), dtype=dtype)
        if case == "ncdhw":
            x = x.contiguous()
        elif case == "misaligned":
            x = misaligned(x)
            assert x.is_contiguous(memory_format=CL) and x.data_ptr() % 16
    if case == "slow_c_out_256":
        assert conv.out_channels == 256
    assert not motion.conv_t3_takes(conv, x)
    fast = t3_conv(32, 8, torch.bfloat16)
    assert motion.conv_t3_takes(fast, activation((1, 32, 4, 3, 3)))


@pytest.mark.parametrize("bad", ["ncdhw", "misaligned", "n_out", "channels",
                                 "wgrad_n_out", "wgrad_channels"])
def test_cuda_path_raises_on_what_the_kernels_do_not_take(bad):
    """The CUDA implementations check layout and shape before they touch a
    card, so each refusal shows on CPU tensors handed to them: an NCDHW or
    misaligned input, outputs the convolution is not built for (24), input
    channels not a multiple of 8, and the weight gradient's range (128
    outputs; 136 channels, not a multiple of 128)."""
    c_in, c_out = {"n_out": (32, 24), "channels": (12, 8),
                   "wgrad_n_out": (32, 128),
                   "wgrad_channels": (136, 8)}.get(bad, (32, 8))
    x = activation((1, c_in, 4, 3, 3))
    if bad == "ncdhw":
        x = x.contiguous()
    elif bad == "misaligned":
        x = misaligned(x)
    w = torch.zeros((c_out, c_in, 3, 1, 1), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        if bad.startswith("wgrad"):
            kernels._motion_conv_t3_wgrad_cuda(
                x, output_grad((1, c_out, 4, 3, 3)))
        else:
            kernels._motion_conv_t3_cuda(x, w)


@pytest.mark.parametrize("bad", ["dtype", "weight", "grad", "device"])
def test_op_rejects_what_it_does_not_take(bad):
    x = activation((1, 32, 4, 3, 3))
    w = torch.zeros((8, 32, 3, 1, 1), dtype=torch.bfloat16)
    g = output_grad((1, 8, 4, 3, 3))
    if bad == "dtype":
        x = x.float()
    elif bad == "weight":
        w = w[:, :16]
    elif bad == "grad":
        g = g[:, :, :2]
    else:
        w = w.to("meta")
    with pytest.raises((TypeError, ValueError)):
        if bad == "grad":
            kernels.motion_conv_t3_wgrad(x, g)
        else:
            kernels.motion_conv_t3(x, w)


def _instantiated_layouts():
    with open(os.path.join(kernels.CSRC_DIR, "motion_conv_t3.cu")) as f:
        src = f.read()
    conv = {tuple(map(int, m)) for m in
            re.findall(r"^\s*AVSEP_CONV\((\d+), (\d+), (\d+)\)$", src,
                       re.M)}
    wgrad = {tuple(map(int, m)) for m in
             re.findall(r"^\s*AVSEP_WGRAD\((\d+), (\d+)\)$", src, re.M)}
    return conv, wgrad


@pytest.mark.parametrize("block,c_in,c_out,scale", CONV1,
                         ids=[c[0] for c in CONV1])
def test_plans_fit_the_card_and_the_instantiated_kernels(block, c_in, c_out,
                                                          scale):
    """At the clips cell's shape (16 clips of 32 frames, the stem's 56 x 56
    plane over ``scale``) each pass's plan picks a layout the source
    instantiates, cuts the plane into equal tiles a block holds, fits a
    block's shared memory with 4 to 8 stages, and walks runs of at most the
    clip's frames."""
    conv, wgrad = _instantiated_layouts()
    hw = (56 // scale) ** 2
    for cin, n in ((c_in, c_out), (c_out, c_in)):
        wn, rows, run, stages, smem = kernels.motion_conv_t3_plan(hw, 32, 16,
                                                                  cin, n)
        assert (cin, n, wn) in conv
        assert rows <= 32 * 8 // wn and -(-hw // rows) * rows - hw < rows
        assert 4 <= stages <= 5 and 1 <= run <= 32
        assert smem <= kernels._SMEM_OPTIN_MAX
    bm, run, stages, groups, smem, blocks = kernels.motion_conv_t3_wgrad_plan(
        hw, 32, 16, c_in, c_out)
    assert (c_in, c_out) in wgrad and bm % 16 == 0 and 4 <= stages <= 5
    assert groups * min(4, c_in // 8) == c_in // 8
    assert smem <= kernels._SMEM_OPTIN_MAX
    assert blocks == -(-hw // bm) * 16 * -(-32 // run)
    assert kernels.motion_conv_t3_fits(c_in, c_out)


def test_instantiated_layouts_are_the_plans_domain():
    """The source instantiates what ``ops/kernels.py`` lists, each with 1 to
    4 tiles of 8 outputs a warp, and the plan picks each listed layout for
    its channels; the gate's range is the fast pathway's conv1s."""
    conv, wgrad = _instantiated_layouts()
    assert conv == set(kernels._T3_CONV_LAYOUTS)
    assert wgrad == set(kernels._T3_WGRAD_PAIRS)
    assert all(1 <= n // (8 * wn) <= 4 for _, n, wn in conv)
    for c, n, wn in conv:
        assert kernels.motion_conv_t3_plan(49, 4, 1, c, n)[0] == wn
    pairs = {(c_in, c_out) for _, c_in, c_out, _ in CONV1}
    assert wgrad == pairs
    assert all(kernels.motion_conv_t3_fits(*pair) for pair in pairs)
    for c_in, c_out in ((24, 8), (64, 256), (1024, 64), (32, 24)):
        assert not kernels.motion_conv_t3_fits(c_in, c_out)
    with pytest.raises(ValueError, match="built for"):
        kernels.motion_conv_t3_plan(49, 4, 1, 24, 8)


def test_launch_counts_hold_the_conv_counters():
    counts = kernels.launch_counts()
    assert {"motion_conv_t3", "motion_conv_t3_wgrad"} <= set(counts)
    assert kernels.SOURCES["motion_conv_t3"][0] == \
        kernels.SOURCES["motion_conv_t3_wgrad"][0] == "motion_conv_t3.cu"


def test_stretch_m_attributes_the_conv_forward_and_backward():
    """Under ``torch.profiler`` with the span recorder on, the op called
    inside ``train.motion`` and its backward: it opens as an op with a
    sequence number and an autograd backward function carries that number,
    with the input gradient's op and the weight gradient's op inside it.  So
    stretch M's rule counts their kernels, as it counts the stem's."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.trace import motion as stretch_m
    x = activation((1, 32, 4, 3, 3)).requires_grad_()
    w = t3_conv(32, 8).weight.detach().bfloat16().requires_grad_()
    spans.drain()
    with spans.recording(), profile(activities=[ProfilerActivity.CPU]) as p:
        with spans.span(stretch_m.SPAN):
            y = kernels.motion_conv_t3(x, w)
        y.float().sum().backward()
    spans.drain()
    ops, _ = stretch_m.trace_events(p)
    (m,) = [o for o in ops if o.name == stretch_m.SPAN]
    convs = sorted((o for o in ops if o.name == "avsep::motion_conv_t3"),
                   key=lambda o: o.t0)
    (wg,) = [o for o in ops if o.name == "avsep::motion_conv_t3_wgrad"]
    assert len(convs) == 2
    fwd, dgrad = convs
    assert not fwd.annotation and fwd.seq >= 0 and m.t0 <= fwd.t0 < m.t1
    (b,) = [o for o in ops if o.name.startswith(stretch_m.BACKWARD)
            and o.seq == fwd.seq and o.fwd_thread == fwd.thread]
    assert b.t0 <= dgrad.t0 < b.t1 and b.t0 <= wg.t0 < b.t1
    device = [(1.0, 2.0, fwd.id, "conv_t3_kernel"),
              (3.0, 4.0, dgrad.id, "conv_t3_kernel"),
              (5.0, 6.0, wg.id, "wgrad_t3_kernel"),
              (7.0, 8.0, -1, "unlinked")]
    acts, n_fwd, n_bwd = stretch_m.motion_activities(ops, device)
    assert (n_fwd, n_bwd) == (1, 2)
    assert acts == [(1.0, 2.0), (3.0, 4.0), (5.0, 6.0)]


# ------------------------------------------------------------- on a card


def error_over_tolerance(got, want, magnitudes, chain):
    """The largest error of ``got`` against ``want`` over its tolerance
    (module docstring): each side's bfloat16 rounding plus ``chain`` float32
    roundings of the summed magnitudes per side; an exact zero against an
    exact zero reads 0.  Also the share of elements that are not equal,
    and the median tolerance as a share of ``want``'s nonzero values."""
    got, want = got.detach().float(), want.detach().float()
    tol = ROUNDING * torch.maximum(got.abs(), want.abs()) \
        + 2 * chain * 2.0 ** -24 * magnitudes
    err = (got - want).abs()
    share = (tol / want.abs())[want != 0]
    return (float(torch.where(err == 0, 0.0, err / tol).max()),
            float((err != 0).float().mean()),
            float(share.median()) if share.numel() else 0.0)


def check_against_plain(x, w, grad):
    """The three passes on the card against the plain version: for the
    forward, the input gradient and the weight gradient, (largest error
    over the tolerance, share of unequal elements, median tolerance over
    the value)."""
    c_in, c_out = x.shape[1], w.shape[0]
    y = kernels.motion_conv_t3(x, w)
    fwd = error_over_tolerance(
        y, kernels.motion_conv_t3_plain(x, w),
        kernels.motion_conv_t3_plain(x.abs(), w.abs()), 3 * c_in)
    del y
    dx = kernels.motion_conv_t3(grad, w, True)
    dgrad = error_over_tolerance(
        dx, kernels.motion_conv_t3_plain(grad, w, True),
        kernels.motion_conv_t3_plain(grad.abs(), w.abs(), True), 3 * c_out)
    del dx
    dw = kernels.motion_conv_t3_wgrad(x, grad)
    wgrad = error_over_tolerance(
        dw, kernels.motion_conv_t3_wgrad_plain(x, grad),
        kernels.motion_conv_t3_wgrad_plain(x.abs(), grad.abs()),
        WGRAD_CHAIN)
    torch.cuda.synchronize()
    return {"forward": fwd, "input_gradient": dgrad, "weight_gradient": wgrad}


def cell_case(c_in, c_out, scale, device, seed=0, clips=16):
    """x, the bfloat16 weight and an output gradient at the clips cell's
    shape: ``clips`` clips of 32 frames on the stem's 56 x 56 plane over
    ``scale``."""
    h = 56 // scale
    x = activation((clips, c_in, 32, h, h), seed, device)
    w = t3_conv(c_in, c_out, seed=seed).weight.detach().to(
        device=device, dtype=torch.bfloat16)
    grad = output_grad((clips, c_out, 32, h, h), seed + 1, device)
    return x, w, grad


CELL_SHAPES = sorted({(c_in, c_out, s) for _, c_in, c_out, s in CONV1})


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,scale", CELL_SHAPES,
                         ids=[f"{a}-{b}-{56 // s}" for a, b, s in CELL_SHAPES])
def test_kernels_match_plain_at_the_cells_shapes_on_cuda(cuda_device, c_in,
                                                         c_out, scale):
    """16 clips of 32 frames (one source of an AV step) at each distinct
    conv1 shape: the three passes within their tolerances, each a small
    share of a typical value; one launch of each counter a call."""
    x, w, grad = cell_case(c_in, c_out, scale, cuda_device)
    n0 = kernels.motion_conv_t3.launches, kernels.motion_conv_t3_wgrad.launches
    got = check_against_plain(x, w, grad)
    print(f"{c_in} -> {c_out} at {56 // scale}^2: " + ", ".join(
        f"{k} {e:.3g} of tol, {u:.3g} unequal, tol {s:.3g} of value"
        for k, (e, u, s) in got.items()))
    assert (kernels.motion_conv_t3.launches - n0[0],
            kernels.motion_conv_t3_wgrad.launches - n0[1]) == (2, 1)
    assert all(e <= 1.0 for e, _, _ in got.values())
    assert got["forward"][2] <= 0.02 and got["weight_gradient"][2] <= 0.02


RAGGED = [(1, 8, 8, 1, 1, 1), (3, 32, 8, 2, 5, 7), (2, 32, 16, 3, 9, 9),
          (1, 256, 64, 33, 7, 7), (2, 64, 16, 5, 17, 3), (1, 128, 32, 4, 1, 1),
          (2, 128, 64, 3, 15, 13), (1, 64, 32, 2, 3, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,c_in,c_out,T,H,W", RAGGED)
def test_kernels_match_plain_at_ragged_shapes_on_cuda(cuda_device, B, c_in,
                                                      c_out, T, H, W):
    """Each pair of channels at planes that fill no tile, one or two frames,
    odd runs of frames: with 8 channels a k-step across two taps, and one
    of a tap and zeros; with 256 input channels the input gradient's 256
    outputs."""
    assert kernels.motion_conv_t3_fits(c_in, c_out)
    g = torch.Generator().manual_seed(B * T + c_in)
    x = activation((B, c_in, T, H, W), B + T, cuda_device)
    w = (torch.randn((c_out, c_in, 3, 1, 1), generator=g) * 0.1).to(
        cuda_device, torch.bfloat16)
    grad = output_grad((B, c_out, T, H, W), T, cuda_device)
    got = check_against_plain(x, w, grad)
    print(f"{(B, c_in, c_out, T, H, W)}: {got}")
    assert all(e <= 1.0 for e, _, _ in got.values())


@pytest.mark.cuda
def test_kernels_repeat_bit_for_bit_on_cuda(cuda_device):
    x, w, grad = cell_case(32, 8, 1, cuda_device, seed=5, clips=4)
    assert torch.equal(kernels.motion_conv_t3(x, w),
                       kernels.motion_conv_t3(x, w))
    assert torch.equal(kernels.motion_conv_t3_wgrad(x, grad),
                       kernels.motion_conv_t3_wgrad(x, grad))


@pytest.mark.cuda
def test_cuda_path_raises_on_an_ncdhw_tensor_on_cuda(cuda_device):
    x, w, grad = cell_case(32, 8, 4, cuda_device, clips=1)
    with pytest.raises(ValueError, match="channels-last-3d"):
        kernels.motion_conv_t3(x.contiguous(), w)
    with pytest.raises(ValueError, match="channels-last-3d"):
        kernels.motion_conv_t3_wgrad(x, grad.contiguous())


@pytest.mark.cuda
def test_graphed_clip_steps_count_the_conv_on_cuda(cuda_device):
    """bfloat16 clips steps, AV and AO in turn, graphed against eager within
    the graph tests' limit: every AV step, eager, captured or replayed, adds
    2 x 16 forwards and 2 x 16 input gradients to ``motion_conv_t3`` and
    2 x 16 to ``motion_conv_t3_wgrad``; an AO step 0."""
    from tests.test_torch_motion_stem import graphed_clip_steps
    diff, limit, replays, counts = graphed_clip_steps(
        cuda_device, ("motion_conv_t3", "motion_conv_t3_wgrad"))
    print(f"graphed clip steps against eager: {diff} (limit {limit}); "
          f"replays {replays}")
    assert diff <= limit
    assert replays >= 4
    assert counts == [(v, (64 * v, 32 * v)) for v in [True, False] * 4]
