"""The port's motion net (avsep_tpu_torch/models/motion.py) against
``avsep_tpu.models.motion.ResNet3dFastOnly``, on the CPU, with the same
weights (``from_jax``): the full-width fast pathway (base 8, stages
``[3, 4, 6, 3]``) on clips ``[2, 4, 64, 64, 3]``, in eval mode and in train
mode (the output and the updated BatchNorm statistics); the strict
``from_jax`` load; the mmaction import in its three key layouts against
the JAX package's ``motion_from_torch`` followed by ``from_jax``; the
compute-dtype ``Conv3d``; the 5-D BatchNorm against Flax's.

Tolerances: the eval output at 1e-4 of its largest value (float32 through
53 convolutions, XLA's and oneDNN's summation orders); in train mode the
output at 1e-3 of its largest value (each BatchNorm divides by a batch
standard deviation taken from few values per channel, up to 2 x 4 x 2 x 2
= 32 in the last stage, which amplifies the rounding differences) and the
running statistics at 1e-4 of each buffer's largest value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models.motion import ResNet3dFastOnly as JFast
from avsep_tpu.models.motion import motion_from_torch
from avsep_tpu_torch.models import layers
from avsep_tpu_torch.models.builder import ModelBuilder
from avsep_tpu_torch.models.from_jax import state_dict_from_jax
from avsep_tpu_torch.models.motion import ResNet3dFastOnly
from avsep_tpu_torch.models.torch_import import motion_state_dict_from_torch
from tests.test_motion import _rand_mmaction_sd
from tests.test_torch_models import random_variables

SHAPE = (2, 4, 64, 64, 3)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def full_width():
    """The JAX fast pathway at full width, random weights in its shapes
    (He-scaled kernels, BatchNorm terms off 1 / 0), and the port's with
    the same weights loaded strictly."""
    jnet = JFast(base_channels=8, stage_blocks=(3, 4, 6, 3))
    rs = np.random.RandomState(0)
    x = rs.standard_normal(SHAPE).astype(np.float32)
    v = random_variables(jnet, rs, jnp.asarray(x), train=False)
    params, stats = v["params"], v["batch_stats"]
    pnet = ModelBuilder.build_motion()
    pnet.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return jnet, params, stats, pnet, x


def test_eval_forward_matches_jax(full_width):
    jnet, params, stats, pnet, x = full_width
    want = np.asarray(jnet.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False))
    with torch.no_grad():
        got = pnet.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4, 2, 2, 256)
    assert _rel(got, want) < 1e-4
    pooled = pnet.forward_pooled(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(pooled, want.max(axis=(1, 2, 3)), rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_train_forward_and_statistics_match_jax(full_width):
    jnet, params, stats, pnet, x = full_width
    want, upd = jnet.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    pnet.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    got = pnet.train()(torch.from_numpy(x)).detach().numpy()
    assert _rel(got, np.asarray(want)) < 1e-3
    sd = pnet.state_dict()
    ref = state_dict_from_jax(params, upd["batch_stats"])
    n = 0
    for k, v in ref.items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(sd[k].numpy(), v.numpy()) < 1e-4, k
            n += 1
        elif k.endswith("num_batches_tracked"):
            assert int(sd[k]) == 1, k
    assert n == 2 * (1 + 3 * 16 + 4)     # stem + 3 per block + downsamples


def test_from_jax_loads_strictly_with_jax_names(full_width):
    _, params, stats, pnet, _ = full_width
    sd = state_dict_from_jax(params, stats)
    assert set(sd) == set(pnet.state_dict())
    assert "layer2_0.downsample_conv.weight" in sd
    assert "layer1_1.bn3.running_var" in sd
    k = np.asarray(params["layer3_0"]["conv1"]["kernel"])   # DHWIO
    assert k.shape == (3, 1, 1, 64, 32)
    np.testing.assert_array_equal(sd["layer3_0.conv1.weight"].numpy(),
                                  k.transpose(4, 3, 0, 1, 2))
    with pytest.raises(RuntimeError):
        ResNet3dFastOnly(base_channels=8, stage_blocks=(3, 4, 6, 2)
                         ).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("layout", ["bare", "fast_path", "raw_ckpt"])
def test_mmaction_import_matches_jax(layout):
    """``motion_state_dict_from_torch`` equals the JAX package's
    ``motion_from_torch`` followed by ``from_jax``, key for key and bit for
    bit, in each layout, and loads strictly."""
    sd = {k: torch.from_numpy(v) for k, v in
          _rand_mmaction_sd(np.random.default_rng(0)).items()}
    if layout == "fast_path":
        fed = {"fast_path." + k: v for k, v in sd.items()}
    elif layout == "raw_ckpt":
        fed = {"backbone.fast_path." + k: v for k, v in sd.items()}
        fed["backbone.slow_path.conv1.conv.weight"] = torch.zeros(1)
        fed["cls_head.fc_cls.weight"] = torch.zeros(1)
    else:
        fed = sd
    got = motion_state_dict_from_torch(fed)
    want = state_dict_from_jax(*motion_from_torch(fed))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k].reshape(v.shape), v), k
    ResNet3dFastOnly().load_state_dict(got, strict=True)


def test_conv3d_compute_dtype():
    """Flax's ``dtype``: input, weight and bias cast to bfloat16, the bias
    added to the rounded conv output; the parameters stay float32."""
    g = torch.Generator().manual_seed(0)
    conv = layers.Conv3d(3, 4, (3, 1, 1), padding=(1, 0, 0),
                         compute_dtype=torch.bfloat16)
    x = torch.randn(2, 3, 4, 5, 5, generator=g)
    y = conv(x)
    assert y.dtype == torch.bfloat16 and conv.weight.dtype == torch.float32
    want = torch.nn.functional.conv3d(
        x.bfloat16(), conv.weight.bfloat16(), padding=(1, 0, 0)) + \
        conv.bias.bfloat16()[:, None, None, None]
    assert torch.equal(y, want)
    conv.compute_dtype = torch.float32
    assert torch.equal(conv(x), torch.nn.functional.conv3d(
        x, conv.weight, conv.bias, padding=(1, 0, 0)))


def test_batchnorm_5d_matches_flax():
    """Train mode on NCDHW input: output and Flax's running statistics
    (momentum 0.9, biased variance) against ``flax.linen.BatchNorm``."""
    rs = np.random.RandomState(1)
    x = (2.0 + rs.standard_normal((2, 4, 3, 5, 5))).astype(np.float32)
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    xl = jnp.asarray(np.moveaxis(x, 1, -1))
    v = fbn.init(jax.random.PRNGKey(0), xl)
    want, upd = fbn.apply(v, xl, mutable=["batch_stats"])
    bn = layers.BatchNorm(4, momentum=0.9, eps=1e-5).train()
    got = bn(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 1),
                               rtol=0, atol=2e-5)
    s = upd["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(), s["mean"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), s["var"], rtol=1e-5)
    with layers.running_stats_frozen():
        before = bn.running_mean.clone()
        bn(torch.from_numpy(x))
        assert torch.equal(bn.running_mean, before)
