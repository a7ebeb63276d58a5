"""The port's SoP++ modules and forward (avsep_tpu_torch/models/sop.py,
synthesizer.py, sop_engine.py) against the JAX package's, on the CPU, with
the same weights carried over by ``from_jax.load_sop_from_jax``; the
training side is tests/test_torch_sop_train.py.

Size: the basis U-Net at unet5, ngf 8, 8 basis channels (extra_size 8, so
16 bottleneck feature-weight channels), the tiny conv encoder at 8
channels on 64x64 frames, InnerProd; 8191 samples (32 STFT frames);
B = 3.  Weights are random He-scaled values in the JAX shapes
(tests/test_torch_models.py).

Tolerances, as tests/test_torch_forward.py and test_torch_train.py state
and read them (float32 networks in another summation order): modules and
the forwards at 1e-5 relative (the attention modules at 1e-5 absolute,
their outputs being cosines and sigmoids of O(1)); after each train step
the loss at 1e-5 relative, each momentum buffer at 1e-2 of its largest
entry (floored at 1e-4 of the step's largest buffer), each parameter at
2e-3 of its change since the start plus 1e-6 of its value, the running
statistics at 1e-4 of each buffer's largest value.  Exact: the counts,
and across an AO step the frame net and the ``frame`` group.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import Config as JConfig
from avsep_tpu.models.resnet import TinyConvEncoder as JTiny
from avsep_tpu.models.sop import BasisUnet as JBasisUnet
from avsep_tpu.models.sop import att_model as jatt_model
from avsep_tpu.models.sop import match_att as jmatch_att
from avsep_tpu.models.synthesizer import Bias as JBias
from avsep_tpu.models.synthesizer import InnerProd as JInnerProd
from avsep_tpu.sop_engine import SopNets as JSopNets
from avsep_tpu.sop_engine import sop_forward as jsop_forward
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import sop as psop
from avsep_tpu_torch.models.from_jax import (
    load_sop_from_jax, state_dict_from_jax, synthesizer_state_dict_from_jax)
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.synthesizer import Bias, InnerProd
from avsep_tpu_torch.sop_engine import SopNets, sop_forward, stage_for_iter
from tests.test_torch_models import random_variables

B, C, L = 3, 8, 8191
WD = 0.05
SMALL = dict(arch_sound="unet5", arch_frame="tinyconv",
             arch_synthesizer="linear", num_channels=C, vis_channels=C,
             fusion_type="Base", att_type="cos", loss="bce", binary_mask=1,
             weighted_loss=1, log_freq=1, num_mix=2, audLen=L, imgSize=64,
             one_frame=True, not_pool_vis=False, img_activation="relu",
             sound_activation="no", output_activation="sigmoid",
             match_weight=0.1, lr_sound=1e-2, lr_synthesizer=1e-2,
             lr_frame=1e-3, lr_steps=(3,), weight_decay=WD)


def configs(**kw):
    kw = {**SMALL, **kw}
    return JConfig(**kw), Config(**kw)


def make_nets(seed=0):
    """JAX and port SoP++ nets with the same random weights: (JAX nets,
    params, batch_stats, port nets on the CPU)."""
    jnets = JSopNets(JBasisUnet(fc_dim=C, num_downs=5, ngf=8, extra_size=C),
                     JTiny(fc_dim=C, pool_type="maxpool"), JInnerProd(C),
                     None)
    rs = np.random.RandomState(seed)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 32, 1)),
                          train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 1, 64, 64, 3)),
                          pool=False, train=False)
    syn = {"scale": (1.0 + 0.1 * rs.randn(C)).astype(np.float32),
           "bias": (0.1 * rs.randn(1)).astype(np.float32)}
    params = {"sound": sv["params"], "frame": fv["params"],
              "synthesizer": syn}
    stats = {"sound": sv["batch_stats"], "frame": fv["batch_stats"]}
    pnets = SopNets(psop.BasisUnet(fc_dim=C, num_downs=5, ngf=8,
                                   extra_size=C),
                    TinyConvEncoder(C, "maxpool"), InnerProd(C))
    load_sop_from_jax(pnets, params, stats)
    return jnets, params, stats, pnets


def make_batch(seed, B=B):
    rs = np.random.RandomState(seed)
    return {"audios": (rs.randn(B, 2, L) * 0.05).astype(np.float32),
            "frames": rs.randint(0, 256, (B, 2, 1, 64, 64, 3)
                                 ).astype(np.uint8)}


def rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def flat(tree):
    """A JAX {"sound", "frame", "synthesizer"} tree -> port names."""
    out = {}
    for net, sub in tree.items():
        sd = synthesizer_state_dict_from_jax(sub) if net == "synthesizer" \
            else state_dict_from_jax(sub, {})
        out.update({f"{net}.{k}": v.numpy() for k, v in sd.items()})
    return out


# ------------------------------------------------------------------ modules


def test_basis_unet_matches_jax():
    jnets, params, stats, pnets = make_nets()
    x = np.random.RandomState(1).randn(2, 256, 32, 1).astype(np.float32)
    jb, jfw = jax.jit(lambda v, x: jnets.sound.apply(v, x, train=False))(
        {"params": params["sound"], "batch_stats": stats["sound"]},
        jnp.asarray(x))
    with torch.no_grad():
        b, fw = pnets.sound.eval()(torch.from_numpy(x))
    assert b.shape == (2, 256, 32, C) and fw.shape == (2, 8, 1, 2 * C)
    assert rel(b.numpy(), jb) < 1e-5
    assert rel(fw.numpy(), jfw) < 1e-5


@pytest.mark.parametrize("kind", ["InnerProd", "Bias"])
def test_synthesizers_match_jax(kind):
    rs = np.random.RandomState(2)
    img = rs.randn(2, C).astype(np.float32)
    snd = rs.randn(2, 5, 4, C).astype(np.float32)
    imgs = rs.randn(2, 3, 3, C).astype(np.float32)
    p = {"bias": np.float32([0.3])}
    if kind == "InnerProd":
        jm, pm = JInnerProd(C), InnerProd(C)
        p["scale"] = (1 + 0.2 * rs.randn(C)).astype(np.float32)
    else:
        jm, pm = JBias(), Bias()
    pm.load_state_dict(synthesizer_state_dict_from_jax(p), strict=True)
    for method, a in (("__call__", img), ("forward_pixelwise", imgs),
                      ("forward_nosum", img)):
        want = jm.apply({"params": p}, jnp.asarray(a), jnp.asarray(snd),
                        method=None if method == "__call__" else method)
        fn = pm if method == "__call__" else getattr(pm, method)
        got = fn(torch.from_numpy(a), torch.from_numpy(snd)).detach()
        assert rel(got.numpy(), want) < 1e-6, method


@pytest.mark.parametrize("att_type", ["cos", "sig"])
@pytest.mark.parametrize("which", ["Base", "MatchAtt"])
def test_attention_modules_match_jax(which, att_type):
    rs = np.random.RandomState(3)
    aud = rs.randn(2, B, 2, 2, 16).astype(np.float32)
    mix = rs.rand(B, 7, 7, 16).astype(np.float32)
    sep = rs.rand(2, B, 7, 7, 16).astype(np.float32)
    jfn = jatt_model if which == "Base" else jmatch_att
    pfn = psop.get_attmodule(which)
    for m, s in ((mix, sep), (mix, None), (None, None)):
        want = jfn(jnp.asarray(aud), None if m is None else jnp.asarray(m),
                   None if s is None else jnp.asarray(s), att_type=att_type)
        got = pfn(torch.from_numpy(aud),
                  None if m is None else torch.from_numpy(m),
                  None if s is None else torch.from_numpy(s),
                  att_type=att_type)
        for field in got._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), field
            if g is not None:
                assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-5, field


def test_pit_reorder_picks_the_swap_and_breaks_ties_to_identity():
    q = torch.tensor([[[1.0, 0.0], [0.0, 1.0]], [[1.0, 0.0], [1.0, 0.0]]])
    keys = torch.tensor([[[0.0, 1.0], [1.0, 0.0]], [[1.0, 0.0], [1.0, 0.0]]])
    re, _, best = psop._pit_reorder(q, keys)
    assert best.tolist() == [1, 0]
    assert torch.equal(re[0], q[0].flip(0)) and torch.equal(re[1], q[1])
    with pytest.raises(ValueError):
        psop.get_attmodule("hidsep")


# ----------------------------------------------------------------- forward


@pytest.mark.parametrize("fusion_type", ["Base", "MatchAtt"])
def test_sop_forward_matches_jax_at_every_stage(fusion_type):
    jcfg, cfg = configs(fusion_type=fusion_type)
    jnets, params, stats, pnets = make_nets()
    batch = make_batch(4)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    assert [stage_for_iter(i, (10, 20, 30)) for i in (5, 15, 25)] == [1, 2, 3]
    for use_vis, stage in ((False, 1), (True, 1), (True, 2), (True, 3)):
        jerr, (_, jout) = jax.jit(lambda p, s, b: jsop_forward(
            jnets, p, s, b, jcfg, jax.random.PRNGKey(0), use_vis, False,
            stage))(params, stats, jb)
        with torch.no_grad():
            err, out = sop_forward(pnets, batch, cfg, use_vis, train=False,
                                   stage=stage)
        assert rel(err.item(), float(jerr)) < 1e-5, stage
        for k in ("pred_masks", "err_ps", "match_loss"):
            assert np.abs(out[k].numpy() - np.asarray(jout[k])).max() \
                <= 1e-5 * max(1.0, np.abs(np.asarray(jout[k])).max()), k
        assert out["pred_masks"].shape == (B, 2, 256, 32)
