"""The port's U-Net layers and initializers (avsep_tpu_torch/models/
layers.py) against the JAX package's, with JAX weights carried over by
avsep_tpu_torch/models/from_jax.py.

Tolerance: float32 convolutions in another summation order, 1e-5 relative
to the output's largest value.  The upsample is torch's own
(``F.interpolate``, as the reference's ``nn.Upsample``), which computes the
source coordinate and the tap weight in float32, while the JAX package rounds
weights computed in float64: the weight carries an error up to one ulp of the
coordinate (< size * 2**-23), times a tap difference of up to twice the
largest value, so the bound there is 1e-6 + size * 2**-22 relative.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models import layers as jl
from avsep_tpu_torch.models import layers as pl
from avsep_tpu_torch.models.resnet import ResNet18Features
from avsep_tpu_torch.models.from_jax import state_dict_from_jax
from tests.test_torch_models import random_variables as _random_variables


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("cin,cout", [(1, 8), (8, 16)])
def test_conv_down_matches_jax(cin, cout):
    rs = np.random.RandomState(cin)
    x = rs.randn(2, 16, 12, cin).astype(np.float32)
    jm = jl.ConvDown(cout)
    var = _random_variables(jm, rs, jnp.asarray(x))
    ref = jm.apply(var, jnp.asarray(x))
    pm = pl.ConvDown(cin, cout)
    pm.load_state_dict(state_dict_from_jax(var["params"], {}), strict=True)
    _close(_nhwc(pm(_nchw(x))), ref)


@pytest.mark.parametrize("use_bias", [False, True])
def test_conv_up_matches_jax(use_bias):
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 6, 10).astype(np.float32)
    jm = jl.ConvUp(4, use_bias=use_bias)
    var = _random_variables(jm, rs, jnp.asarray(x))
    ref = jm.apply(var, jnp.asarray(x))
    pm = pl.ConvUp(10, 4, use_bias=use_bias)
    pm.load_state_dict(state_dict_from_jax(var["params"], {}), strict=True)
    _close(_nhwc(pm(_nchw(x))), ref)


def test_batchnorm_eval_matches_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 5, 5, 6).astype(np.float32)
    jm = jl.TorchBatchNorm()
    var = _random_variables(jm, rs, jnp.asarray(x), train=False)
    ref = jm.apply(var, jnp.asarray(x), train=False)
    pm = pl.TorchBatchNorm(6).eval()
    pm.load_state_dict(state_dict_from_jax(var["params"],
                                           var["batch_stats"]), strict=True)
    assert pm.bn.eps == 1e-5 and pm.bn.momentum == 0.1
    _close(_nhwc(pm(_nchw(x))), ref)


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_train_matches_flax(momentum):
    """Train mode: output, the gradient through the batch statistics, and
    the running buffers, updated with the biased batch variance.  0.9 is
    the U-Net's and ResNet's BN (``TorchBatchNorm``), 0.99 Flax's default
    (``TinyConvEncoder``'s trunk).  The running variance must also differ
    from torch's unbiased update by more than the tolerance, so that the
    test tells the two apart."""
    rs = np.random.RandomState(8)
    x = (rs.randn(3, 5, 4, 6) * 2.0 + 1.0).astype(np.float32)
    r = rs.randn(3, 5, 4, 6).astype(np.float32)
    if momentum == 0.9:
        jm, pm, pre = jl.TorchBatchNorm(), pl.TorchBatchNorm(6), "bn."
        kw = dict(train=True)
    else:
        jm, pm, pre = nn.BatchNorm(use_running_average=False), \
            pl.BatchNorm(6, momentum=0.99), ""
        kw = {}
    var = _random_variables(jm, rs, jnp.asarray(x), **kw)
    pm.load_state_dict(state_dict_from_jax(var["params"],
                                           var["batch_stats"]), strict=True)
    pm.train()

    def loss(params, xx):
        y, upd = jm.apply({"params": params,
                           "batch_stats": var["batch_stats"]}, xx,
                          mutable=["batch_stats"], **kw)
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (ref, stats)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(var["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = pm(xt)
    params = dict(pm.named_parameters())
    g = torch.autograd.grad(torch.sum(y.permute(0, 2, 3, 1)
                                      * torch.from_numpy(r)),
                            [xt, params[pre + "weight"], params[pre + "bias"]])
    _close(_nhwc(y), ref)
    _close(_nhwc(g[0]), gx, rel=1e-4)
    gsd = state_dict_from_jax(gp, {})
    _close(g[1].numpy(), gsd[pre + "weight"], rel=1e-4)
    _close(g[2].numpy(), gsd[pre + "bias"], rel=1e-4)
    want = state_dict_from_jax(var["params"], stats)
    got = pm.state_dict()
    for k in ("running_mean", "running_var"):
        _close(got[pre + k].numpy(), want[pre + k].numpy())
    ra = torch.from_numpy(np.asarray(var["batch_stats"]["bn"]["var"]
                                     if pre else var["batch_stats"]["var"]))
    unbiased = (momentum * ra + (1 - momentum) * torch.var(
        xt.detach(), dim=(0, 2, 3), unbiased=True))
    assert (unbiased - want[pre + "running_var"]).abs().max() > \
        1e-5 * want[pre + "running_var"].abs().max()


def test_leaky_relu_matches_jax():
    x = np.random.RandomState(5).randn(100).astype(np.float32)
    np.testing.assert_array_equal(
        pl.leaky_relu(torch.from_numpy(x)).numpy(),
        np.asarray(jl.leaky_relu(jnp.asarray(x))))


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16, 32, 64, 128])
def test_upsample_align_corners_matches_jax_at_each_decoder_size(size):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, max(size // 2, 1), 3).astype(np.float32)
    ref = jl.upsample2x_align_corners(jnp.asarray(x))
    got = pl.upsample2x_align_corners(_nchw(x))
    _close(_nhwc(got), ref, rel=1e-6 + size * 2.0 ** -22)


@pytest.mark.parametrize("eps_case", [False, True])
def test_cosine_similarity_clamps_each_norm(eps_case):
    rs = np.random.RandomState(6)
    a = rs.randn(3, 4, 8).astype(np.float32)
    b = rs.randn(3, 4, 8).astype(np.float32)
    if eps_case:
        a[0] = 0.0                    # a zero vector: its norm clamps
        b[1] *= 1e-9
    ref = jl.cosine_similarity(jnp.asarray(a), jnp.asarray(b), axis=-1)
    got = pl.cosine_similarity(torch.from_numpy(a), torch.from_numpy(b),
                               dim=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_maxpool_pads_with_minus_infinity_like_jax():
    """Flax max_pool pads with -inf, as torch MaxPool2d(3, 2, 1): an
    all-negative input keeps its (negative) maxima at the border."""
    rs = np.random.RandomState(7)
    x = (-1.0 - rs.rand(2, 9, 9, 3)).astype(np.float32)
    # the call of avsep_tpu/models/resnet.py:88
    ref = nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                      padding=((1, 1), (1, 1)))
    got = ResNet18Features().maxpool(_nchw(x))
    np.testing.assert_array_equal(_nhwc(got), np.asarray(ref))
    assert (_nhwc(got) < 0).all()


def test_initializers_follow_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    down = pl.ConvDown(64, 128)
    down.reset_parameters_(g)
    w = down.conv.weight
    assert abs(w.std().item() - 0.001) < 5e-5 and abs(w.mean().item()) < 5e-5
    up = pl.ConvUp(128, 64, use_bias=True)
    up.reset_parameters_(g)
    bound = 1.0 / np.sqrt(128 * 9)
    assert up.conv.bias.abs().max().item() <= bound
    bn = pl.TorchBatchNorm(4096)
    bn.reset_parameters_(g)
    assert abs(bn.bn.weight.mean().item() - 1.0) < 2e-3
    assert abs(bn.bn.weight.std().item() - 0.02) < 2e-3
    assert (bn.bn.bias == 0).all() and (bn.bn.running_var == 1).all()
    # the same seed gives the same weights
    down2 = pl.ConvDown(64, 128)
    down2.reset_parameters_(torch.Generator().manual_seed(0))
    assert torch.equal(down2.conv.weight, w)
