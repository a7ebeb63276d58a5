"""The port's ``--dtype bfloat16`` against the JAX package's.

The semantics are Flax's ``dtype=bfloat16`` (``avsep_tpu/engine.py:47-57``,
``avsep_tpu/models/builder.py:23-54``): every conv computes in bfloat16 on
float32 parameters, a BatchNorm takes its statistics in float32 and returns
bfloat16, the fusion runs in float32, and ``activate(upcast=True)`` casts
the logits up before every mask and loss.  Size: unet5 at ngf 8, the tiny
encoder or the dilated ResNet18 at 32 channels on 64x64 frames, 16383
samples, B = 3 (``tests/test_torch_forward.py``), random weights through
``from_jax``.

Tolerances.  bfloat16 keeps 8 bits of mantissa, and two implementations
that round a few elements differently drift apart through the layers: the
port's bfloat16 forward is held against JAX's bfloat16 forward at the
distance JAX's bfloat16 forward has from its own float32 one (mean |Δmask|,
on the same weights and batch), and within ``tests/test_bf16.py``'s limits
(0.05 on the masks, 0.1 on the loss).  JAX's bfloat16 forward runs op by
op, each operation rounding to its dtype as the modules say; under jit,
XLA on the CPU is free to keep float32 across operations (its
``xla_allow_excess_precision``, on by default), which a bfloat16 conv on a
GPU does not.  Readings, mean |Δmask| (port vs JAX-bf16 / JAX-bf16 vs
JAX-f32): AV train, tiny encoder 1.21e-3 / 1.48e-3; AV train, dilated
ResNet 2.61e-3 / 4.87e-3; AO train 1.16e-3 / 1.29e-3; the losses within
1.3e-4 of both.  A biased conv adds its bias to the rounded bf16 output,
as Flax does (fused into the conv, the tiny encoder's case read 1.47e-3).  The float32 islands given the same bfloat16
logits are exact up to float32 rounding (1e-6).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.engine import Nets as JNets
from avsep_tpu.engine import forward as jax_forward
from avsep_tpu.models import criterion as jcrit
from avsep_tpu.models.builder import activate as jactivate
from avsep_tpu.models.layers import (
    upsample2x_align_corners as jupsample)
from avsep_tpu.models.resnet import FrameEncoder as JFrameEncoder
from avsep_tpu.models.resnet import TinyConvEncoder as JTinyConvEncoder
from avsep_tpu.models.unet import AudioUnet as JAudioUnet
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.models import criterion as crit
from avsep_tpu_torch.models.builder import activate
from avsep_tpu_torch.models.from_jax import load_from_jax
from avsep_tpu_torch.models.layers import BatchNorm, upsample2x_align_corners
from avsep_tpu_torch.models.resnet import FrameEncoder, TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from tests.test_torch_forward import B, configs, make_batch
from tests.test_torch_models import random_variables

FUSION = dict(fc_dim=2, num_downs=5, ngf=8, fusion_type="hidsep",
              att_type="sig")


def nets_of(frame_arch, jdtype, pdtype):
    """JAX nets in ``jdtype`` and port nets in ``pdtype``."""
    tiny = frame_arch == "tinyconv"
    jframe = (JTinyConvEncoder(fc_dim=32, pool_type="maxpool", dtype=jdtype)
              if tiny else JFrameEncoder(fc_dim=32, pool_type="maxpool",
                                         dilate_scale=16, dtype=jdtype))
    pframe = (TinyConvEncoder(32, "maxpool", dtype=pdtype) if tiny else
              FrameEncoder(32, "maxpool", dilate_scale=16, dtype=pdtype))
    return (JNets(JAudioUnet(**FUSION, dtype=jdtype), jframe),
            engine.Nets(AudioUnet(**FUSION, dtype=pdtype), pframe))


def variables(jnets, frame_arch, seed=0):
    rs = np.random.RandomState(seed)
    hv = 8 if frame_arch == "tinyconv" else 4
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          jnp.zeros((2, 1, hv, hv, 32)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 64, 64, 3)),
                          pool=False, train=False)
    return ({"sound": sv["params"], "frame": fv["params"]},
            {"sound": sv["batch_stats"], "frame": fv["batch_stats"]})


@pytest.mark.parametrize("frame_arch,use_vis", [("tinyconv", True),
                                                ("resnet18dilated", True),
                                                ("tinyconv", False)])
def test_bf16_forward_matches_jax_bf16(frame_arch, use_vis):
    """(a) The port's bfloat16 train forward against JAX's, on the same
    weights: as close to JAX-bf16 as JAX-bf16 is to JAX-f32, inside
    tests/test_bf16.py's limits; parameters float32, masks float32."""
    jcfg, cfg = configs(arch_frame=frame_arch)
    j32, _ = nets_of(frame_arch, jnp.float32, torch.float32)
    j16, pnets = nets_of(frame_arch, jnp.bfloat16, torch.bfloat16)
    params, stats = variables(j32, frame_arch)
    load_from_jax(pnets, params, stats)
    batch = make_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)

    e32, (_, o32) = jax.jit(lambda p, s, b, r: jax_forward(
        j32, p, s, b, jcfg, r, use_vis, True))(params, stats, jb, rng)
    # op by op: under jit, XLA on the CPU keeps float32 between operations
    # where the modules round to bfloat16 (xla_allow_excess_precision)
    e16, (_, o16) = jax_forward(j16, params, stats, jb,
                                jcfg.replace(dtype="bfloat16"), rng, use_vis,
                                True)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (B,))))
    err, out = engine.forward(pnets, batch, cfg.replace(dtype="bfloat16"),
                              use_vis, train=True,
                              swap_uniforms=None if use_vis else u)
    assert all(p.dtype == torch.float32 for _, net in train.modules(pnets)
               for p in net.parameters())
    assert out["pred_masks"].dtype == torch.float32
    assert out["mag_mix"].dtype == torch.float32
    m32 = np.asarray(o32["pred_masks"], np.float32)
    m16 = np.asarray(o16["pred_masks"], np.float32)
    mine = out["pred_masks"].detach().numpy()
    jax_gap = np.abs(m16 - m32).mean()
    port_gap = np.abs(mine - m16).mean()
    assert port_gap <= jax_gap, (port_gap, jax_gap)
    assert port_gap < 0.05 and np.abs(mine - m32).mean() < 0.05
    assert abs(err.item() - float(e16)) < 0.1
    assert abs(err.item() - float(e32)) < 0.1
    # the float32 forward differs from the bfloat16 one
    assert jax_gap > 0


@pytest.mark.parametrize("act", ["sigmoid", "relu", "tanh", "softmax", "no"])
def test_bf16_logits_activate_and_losses_match_jax(act):
    """(b) The float32 islands: the same bfloat16 logits through
    ``activate(upcast=True)``, then each loss, equal JAX's to 1e-6."""
    rs = np.random.RandomState(4)
    logits = rs.randn(2, 16, 8, 2).astype(np.float32) * 4.0
    lj = jnp.asarray(logits, jnp.bfloat16)
    lp = torch.from_numpy(logits).bfloat16()
    np.testing.assert_array_equal(np.asarray(lj, np.float32),
                                  lp.float().numpy())
    want = np.asarray(jactivate(lj, act))
    got = activate(lp, act)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if act != "sigmoid":
        return
    gt = (rs.rand(2, 16, 8, 2) > 0.5).astype(np.float32)
    w = rs.rand(2, 16, 8).astype(np.float32)
    w2 = np.stack([w, w], -1)
    for kind in ("bce", "l1", "l2"):
        pj = jcrit.multi_source_loss(jnp.moveaxis(jnp.asarray(want), -1, 0),
                                     jnp.moveaxis(jnp.asarray(gt), -1, 0),
                                     jnp.asarray(w), kind=kind)
        pp = crit.multi_source_loss(got.movedim(-1, 0),
                                    torch.from_numpy(gt).movedim(-1, 0),
                                    torch.from_numpy(w), kind=kind)
        np.testing.assert_allclose(pp.item(), float(pj), rtol=1e-6)
    lj_, _ = jcrit.pit_loss(jnp.asarray(want), jnp.asarray(gt),
                            jnp.asarray(w2), kind="bce")
    lp_, _ = crit.pit_loss(got, torch.from_numpy(gt), torch.from_numpy(w2),
                           kind="bce")
    np.testing.assert_allclose(lp_.numpy(), np.asarray(lj_), rtol=1e-6)


def test_bf16_saturated_logits_keep_finite_grads():
    """(c) tests/test_bf16.py:106 on the port: a bfloat16 sigmoid rounds to
    exactly 1.0 at logits of about 6, so without the upcast the BCE
    gradient is NaN; through ``activate`` the loss and the gradient stay
    finite."""
    values = [[-40.0, -8.0, 0.0, 8.0, 40.0]]
    logits = torch.tensor(values).bfloat16().requires_grad_()
    gt = torch.tensor([[1.0, 0.0, 1.0, 0.0, 1.0]])
    w = torch.ones_like(gt)
    pred = activate(logits, "sigmoid")
    assert pred.dtype == torch.float32
    val = crit.weighted_loss(pred, gt, w, kind="bce")
    grad, = torch.autograd.grad(val, logits)
    assert np.isfinite(val.item())
    assert torch.isfinite(grad.float()).all()
    raw = torch.sigmoid(logits)                # no upcast: saturates
    bad, = torch.autograd.grad(crit.weighted_loss(
        raw, gt.bfloat16(), w.bfloat16(), kind="bce"), logits)
    assert not torch.isfinite(bad.float()).all()


def test_bf16_train_steps_learn():
    """(c) tests/test_bf16.py:57 on the port: eight bfloat16 train steps on
    a fixed batch; the loss stays finite and falls, the parameters,
    momentum buffers and running statistics stay float32 and move."""
    _, cfg = configs(arch_frame="resnet18dilated", dtype="bfloat16",
                     lr_sound=1e-3, lr_frame=1e-4, lr_steps=(5,))
    j32, _ = nets_of("resnet18dilated", jnp.float32, torch.float32)
    _, pnets = nets_of("resnet18dilated", jnp.bfloat16, torch.bfloat16)
    load_from_jax(pnets, *variables(j32, "resnet18dilated"))
    state = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    p0 = {n: p.detach().clone() for n, p in train.named_parameters(pnets)}
    s0 = {k: v.clone() for k, v in pnets.sound.state_dict().items()}
    step = train.make_train_step(cfg, pnets, True, device="cpu")
    batch = make_batch(0)
    errs = [step(state, batch)[1]["err"].item() for _ in range(8)]
    assert all(np.isfinite(errs)), errs
    assert errs[-1] < errs[0], errs
    named = dict(train.named_parameters(pnets))
    assert all(p.dtype == torch.float32 for p in named.values())
    assert max((named[n] - p).abs().max().item() for n, p in p0.items()) > 0
    for gs in state.opt_state.values():
        assert all(b.dtype == torch.float32 for b in gs.momentum.values())
    sd = pnets.sound.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            assert v.dtype == torch.float32, k
    assert not torch.equal(sd["down_bn1.bn.running_var"],
                           s0["down_bn1.bn.running_var"])


def test_batchnorm_takes_float32_statistics_of_a_bf16_input():
    """The train-mode BatchNorm on a bfloat16 input: its batch statistics,
    running buffers and normalization in float32 (the same numbers as on
    the input's values in float32), its output bfloat16."""
    x = torch.from_numpy(np.random.RandomState(5).randn(4, 6, 9, 7)
                         .astype(np.float32) * 3 + 2).bfloat16()
    bns = [BatchNorm(6, compute_dtype=d).train()
           for d in (torch.bfloat16, torch.float32)]
    for bn in bns:
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, 6))
            bn.bias.copy_(torch.linspace(-1, 1, 6))
    with torch.no_grad():
        y16 = bns[0](x)
        y32 = bns[1](x.float())
    assert y16.dtype == torch.bfloat16 and y32.dtype == torch.float32
    for k in ("running_mean", "running_var"):
        a, b = getattr(bns[0], k), getattr(bns[1], k)
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    # one rounding of the float32 normalization
    np.testing.assert_allclose(y16.float().numpy(),
                               y32.bfloat16().float().numpy(),
                               rtol=2 ** -8, atol=1e-6)
    bns[0].eval()
    assert bns[0](x).dtype == torch.bfloat16


def test_bf16_conv_gradient_reaches_float32_weights():
    net = AudioUnet(**FUSION, dtype=torch.bfloat16).train()
    x = torch.randn(2, 256, 64, 1)
    v = torch.randn(2, 2, 4, 4, 32)
    out, _ = net(x, v)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    for name, p in net.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, \
            name


def test_bf16_upsample_rounds_once():
    """The decoder's 2x upsample on a bfloat16 input: the port rounds the
    float32 interpolation to bfloat16 once, within one bfloat16 step
    (2^-8 relative) of it; the JAX package rounds its H-pass intermediate
    too, so it lies further from the float32 result."""
    x = np.random.RandomState(6).randn(2, 5, 12, 7).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    exact = F.interpolate(xb.float(), scale_factor=2, mode="bilinear",
                          align_corners=True).numpy()
    mine = upsample2x_align_corners(xb)
    assert mine.dtype == torch.bfloat16
    theirs = np.asarray(jupsample(jnp.asarray(
        xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16)),
        np.float32).transpose(0, 3, 1, 2)
    mine_err = np.abs(mine.float().numpy() - exact)
    theirs_err = np.abs(theirs - exact)
    assert np.all(mine_err <= 2 ** -8 * np.abs(exact) + 1e-30)
    assert mine_err.max() < theirs_err.max()
    assert mine_err.mean() < theirs_err.mean()


def test_dtype_flag_builds_bf16_nets_with_float32_state():
    """``--dtype bfloat16`` parses, and ``build_nets`` then computes in
    bfloat16 with float32 parameters and buffers; a state saved under one
    dtype loads under the other."""
    cfg = parse_args(["--dtype", "bfloat16", "--arch_sound", "unet5",
                      "--arch_frame", "tinyconv", "--num_channels", "2",
                      "--vis_channels", "256", "--fusion_type", "hidsep"])
    assert cfg.dtype == "bfloat16"
    nets = engine.build_nets(cfg, device="cpu")
    assert nets.sound.down1.conv.compute_dtype == torch.bfloat16
    assert nets.frame.fc.compute_dtype == torch.bfloat16
    assert nets.sound.up_bn1.bn.compute_dtype == torch.bfloat16
    nets32 = engine.build_nets(cfg.replace(dtype="float32"), device="cpu")
    for (_, n16), (_, n32) in zip(train.modules(nets),
                                  train.modules(nets32)):
        sd = n16.state_dict()
        assert all(v.dtype in (torch.float32, torch.int64)
                   for v in sd.values())
        n32.load_state_dict(sd, strict=True)
    with pytest.raises(ValueError, match="dtype"):
        parse_args(["--dtype", "float16"])
    assert Config().dtype == "float32"


def test_sop_nets_stay_float32_under_the_bf16_flag():
    """The JAX package's ``sop_main`` passes no dtype, so SoP++ computes in
    float32 whatever ``--dtype`` says; the port's does the same."""
    from avsep_tpu_torch.models.layers import Conv2d
    from avsep_tpu_torch.sop_main import build_sop_nets
    cfg = parse_args(["--dtype", "bfloat16", "--arch_sound", "unet5",
                      "--num_channels", "32", "--vis_channels", "32"])
    nets = build_sop_nets(cfg, device="cpu")
    convs = [m for net in nets for m in net.modules()
             if isinstance(m, (Conv2d, BatchNorm))]
    assert convs and all(m.compute_dtype == torch.float32 for m in convs)
