"""The port's training forwards (avsep_tpu_torch/engine.py: forward_ao,
forward_av, forward_avmiximg) against the JAX package's in train mode, on
the same numpy batch and weights: the loss, ``err_ps``, ``match_ps``, the
BatchNorm running statistics the forward leaves behind, and the gradient of
every parameter.

Size: unet5 at ngf 8 (bottleneck 64 = 2 x 32-channel chunks) and the tiny
conv encoder (or the dilated ResNet18) at 32 channels on 64x64 frames,
16383 samples (64 STFT frames), B = 3.  The weights are random values in
the JAX shapes (tests/test_torch_models.py), carried over by
``from_jax.load_from_jax``.  The audio-only slot swap gets the JAX draw
``jax.random.uniform(rng, (B,))``.  One AV case runs the JAX STFT through
its Pallas ``frame_window`` kernel in interpret mode.

Tolerances: float32 networks in another summation order.  The loss and the
per-sample losses at 1e-5 relative, the per-sample match losses (a
difference of two sums of sigmoid maxima) at 1e-5 absolute; the running statistics at 1e-4
relative to each buffer's largest value (the biased batch variance in
another order, and Flax's E[x^2] - E[x]^2 against torch's two-pass
variance); every parameter's gradient at 2e-3 relative to its largest
entry (a backward through two U-Net passes, BCE on sigmoid masks and the
fusion's max-pooling, each float32).  A conv bias that a BatchNorm
follows has a gradient of zero up to rounding (about 1e-8 of the largest
gradient), so each tensor's scale is floored at 1e-4 of the largest
gradient of the step.  The dilated ResNet's gradients are held at 2e-2:
its backward through 20 BatchNorms at B = 3 and a ReLU whose input lies
within rounding of 0 moves the port's own float32 gradient of layer4 by
1e-2 against the port in float64 (the same inputs).

Flax's BatchNorm takes the batch variance as E[x^2] - E[x]^2 in float32,
which loses digits where a channel's mean is large against its spread; the
port's is two-pass.  Through the dilated ResNet's 20 BatchNorms at B = 3
this moves JAX's own float32 gradient of layer4 by up to 18 % (against
the same JAX code with the two-pass variance, or in float64, both of
which the port meets at 1e-5).  So the ResNet case holds the port against
the JAX forward with Flax's ``use_fast_variance=False`` (patched in that
test only); the tiny encoder's cases use Flax unpatched.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.engine import Nets as JNets
from avsep_tpu.engine import forward as jax_forward
from avsep_tpu.models.resnet import FrameEncoder as JFrameEncoder
from avsep_tpu.models.resnet import TinyConvEncoder as JTinyConvEncoder
from avsep_tpu.models.unet import AudioUnet as JAudioUnet
from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models.from_jax import load_from_jax, state_dict_from_jax
from avsep_tpu_torch.models.resnet import FrameEncoder, TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from tests.test_torch_models import random_variables

B = 3
SMALL = dict(arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
             vis_channels=32, fusion_type="hidsep", att_type="sig",
             loss="bce", not_pool_vis=False, binary_mask=1, weighted_loss=1,
             log_freq=1, num_mix=2, audLen=16383, imgSize=64, one_frame=True,
             output_activation="sigmoid", img_activation="relu",
             match_weight=0.1, lr_sound=1e-2, lr_frame=1e-3, lr_steps=(2,))


# fields of the JAX package's Config that the port's leaves out
JAX_ONLY = ("use_pallas",)


def configs(**kw):
    kw = {**SMALL, **kw}
    return JConfig(**kw), Config(**{k: v for k, v in kw.items()
                                    if k not in JAX_ONLY})


def make_nets(cfg, seed=0):
    """JAX and port nets of ``cfg`` with the same random weights: returns
    (jax nets, params, batch_stats, port nets on the CPU)."""
    fusion = dict(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type)
    tiny = cfg.arch_frame == "tinyconv"
    jframe = (JTinyConvEncoder(fc_dim=32, pool_type="maxpool") if tiny else
              JFrameEncoder(fc_dim=32, pool_type="maxpool", dilate_scale=16))
    jnets = JNets(JAudioUnet(**fusion), jframe)
    pnets = engine.Nets(
        AudioUnet(**fusion),
        TinyConvEncoder(32, "maxpool") if tiny else
        FrameEncoder(32, "maxpool", dilate_scale=16))
    rs = np.random.RandomState(seed)
    hv, wv = (8, 8) if tiny else (4, 4)
    nv, wv = (1, 2 * wv) if cfg.fusion_type == "MixVis" else (2, wv)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          jnp.zeros((nv, 1, hv, wv, 32)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 64, 64, 3)),
                          pool=False, train=False)
    params = {"sound": sv["params"], "frame": fv["params"]}
    stats = {"sound": sv["batch_stats"], "frame": fv["batch_stats"]}
    load_from_jax(pnets, params, stats)
    return jnets, params, stats, pnets


def make_batch(seed, B=B):
    rs = np.random.RandomState(seed)
    audios = (rs.randn(B, 2, 16383) * 0.05).astype(np.float32)
    frames = rs.randint(0, 256, (B, 2, 1, 64, 64, 3)).astype(np.uint8)
    return {"audios": audios, "frames": frames}


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def flat_params(params):
    """A JAX {"sound": ..., "frame": ...} parameter-like tree -> the port's
    parameter names (``sound.down0.conv.weight``) and torch layouts."""
    return {f"{net}.{k}": v.numpy() for net in ("sound", "frame")
            for k, v in state_dict_from_jax(params[net], {}).items()}


def check_stats(pnets, params, new_stats, tol=1e-4):
    for net in ("sound", "frame"):
        want = state_dict_from_jax(params[net], new_stats[net])
        got = getattr(pnets, net).state_dict()
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var")):
                assert rel(got[k].numpy(), v.numpy()) < tol, (net, k)


def run_both(cfg_kw, use_vis, seed=1, frame_arch="tinyconv"):
    jcfg, cfg = configs(arch_frame=frame_arch, **cfg_kw)
    jnets, params, stats, pnets = make_nets(cfg)
    batch = make_batch(seed)
    rng = jax.random.PRNGKey(seed)

    def loss(p):
        err, (new_stats, out) = jax_forward(
            jnets, p, stats, {k: jnp.asarray(v) for k, v in batch.items()},
            jcfg, rng, use_vis, train=True)
        return err, (new_stats, out)

    (jerr, (jstats, jout)), jgrads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (B,))))
    err, out = engine.forward(pnets, batch, cfg, use_vis, train=True,
                              swap_uniforms=None if use_vis else u)
    names = [f"{net}.{k}" for net in ("sound", "frame")
             for k, _ in getattr(pnets, net).named_parameters()]
    plist = [p for net in ("sound", "frame")
             for _, p in getattr(pnets, net).named_parameters()]
    grads = torch.autograd.grad(err, plist, allow_unused=True)
    return (jerr, jstats, jout, jgrads, params), (err, out,
                                                 dict(zip(names, grads)),
                                                 pnets)


def check(jax_side, port_side, use_vis, grad_tol=2e-3):
    jerr, jstats, jout, jgrads, params = jax_side
    err, out, grads, pnets = port_side
    want = flat_params(jgrads)
    top = max(np.abs(v).max() for v in want.values())
    assert rel(err.item(), float(jerr)) < 1e-5
    assert rel(out["err_ps"].detach().numpy(), jout["err_ps"]) < 1e-5
    # a difference of two sums of sigmoid maxima: absolute, at the scores'
    # scale
    assert np.abs(out["match_ps"].detach().numpy()
                  - np.asarray(jout["match_ps"])).max() < 1e-5
    assert out["pred_masks"].shape == jout["pred_masks"].shape
    check_stats(pnets, params, jstats)
    assert set(want) == set(grads)
    for name, g in grads.items():
        if name.startswith("frame.") and not use_vis:
            assert g is None and not np.any(want[name]), name
            continue
        ref = want[name]
        scale = max(np.abs(ref).max(), 1e-4 * top)
        assert np.abs(g.numpy() - ref).max() <= grad_tol * scale, name


def test_forward_ao_matches_jax():
    jax_side, port_side = run_both({}, use_vis=False)
    check(jax_side, port_side, False)
    # the frame net is not run: its statistics stay where they were
    assert port_side[1]["match_loss"].item() == 0.0


@pytest.mark.parametrize("frame_arch,pallas", [("tinyconv", False),
                                               ("tinyconv", True),
                                               ("resnet18dilated", False)])
def test_forward_av_matches_jax(frame_arch, pallas, monkeypatch):
    if frame_arch == "resnet18dilated":
        # the oracle with Flax's two-pass batch variance (see the module
        # docstring): the fast one moves JAX's own float32 gradient of
        # layer4 by up to 18 %
        import flax.linen.normalization as fnorm
        stats_fn = fnorm._compute_stats
        monkeypatch.setattr(fnorm, "_compute_stats", lambda *a, **k: stats_fn(
            *a, **{**k, "use_fast_variance": False}))
    jax_side, port_side = run_both({"use_pallas": pallas} if pallas else {},
                                   use_vis=True, frame_arch=frame_arch)
    check(jax_side, port_side, True,
          grad_tol=2e-2 if frame_arch == "resnet18dilated" else 2e-3)
    jout, out = jax_side[2], port_side[1]
    assert rel(out["match_loss"].item(), float(jout["match_loss"])) < 1e-5
    assert rel(out["att_maps"].detach().numpy(), jout["att_maps"]) < 1e-5
    assert out["match_ps"].abs().max().item() > 0


def test_forward_avmiximg_matches_jax():
    jax_side, port_side = run_both({"fusion_type": "MixVis"}, use_vis=True)
    check(jax_side, port_side, True)
    assert rel(port_side[1]["maps"].detach().numpy(),
               jax_side[2]["maps"]) < 1e-5


def test_forward_avmiximg_requires_two_sources():
    _, cfg = configs(fusion_type="MixVis", num_mix=3)
    with pytest.raises(ValueError, match="num_mix=2 only"):
        engine.forward_avmiximg(None, {}, cfg, train=True)


def test_eval_mode_forward_leaves_the_statistics_alone():
    _, cfg = configs()
    _, _, _, pnets = make_nets(cfg)
    before = {k: v.clone() for k, v in pnets.sound.state_dict().items()}
    with torch.no_grad():
        err, _ = engine.forward(pnets, make_batch(2), cfg, True, train=False)
    assert np.isfinite(err.item())
    for k, v in pnets.sound.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert not pnets.sound.training and not pnets.frame.training


def test_batch_helpers_match_jax():
    """The int16 wire's dequantization, the mixture rebuilt from the
    sources, and the visual streams a loader drops."""
    from avsep_tpu.data.wire import audios_of as jaudios_of
    from avsep_tpu.data.wire import encode_audio_wire
    from avsep_tpu.engine import audio_mix_of as jaudio_mix_of
    from avsep_tpu.engine import unused_visual_streams as junused
    jcfg, cfg = configs(audio_wire="int16")
    batch = make_batch(3)
    wire = encode_audio_wire({"audios": batch["audios"]}, jcfg)
    pw = {k: torch.from_numpy(v) for k, v in wire.items()}
    np.testing.assert_array_equal(engine.audios_of(pw).numpy(),
                                  np.asarray(jaudios_of(wire)))
    np.testing.assert_array_equal(engine.audio_mix_of(pw).numpy(),
                                  np.asarray(jaudio_mix_of(wire)))
    mix = batch["audios"].sum(1)
    pb = {"audios": torch.from_numpy(batch["audios"])}
    np.testing.assert_array_equal(engine.audio_mix_of(pb).numpy(), mix)
    for fusion in ("hidsep", "CoLoc_ClipAtt"):
        assert engine.unused_visual_streams(cfg.replace(
            fusion_type=fusion)) == junused(jcfg.replace(fusion_type=fusion))


def test_precomputed_magnitudes_pass_through():
    _, cfg = configs()
    mag_mix = torch.rand(2, 512, 64)
    mags = torch.rand(2, 2, 512, 64)
    got = engine.batch_spectrograms({"mag_mix": mag_mix, "mags": mags}, cfg)
    assert got[0] is mag_mix and got[1] is mags


@pytest.mark.parametrize("use_vis", [True, False])
def test_remat_forward_matches_jax(use_vis):
    """``remat=True`` on both sides (``torch.utils.checkpoint`` against
    ``jax.checkpoint``): the loss, the running statistics and every
    gradient within the plain forward's tolerances."""
    jax_side, port_side = run_both({"remat": True}, use_vis=use_vis)
    check(jax_side, port_side, use_vis)
