"""The port's AudioUnet and FrameEncoder (avsep_tpu_torch/models/) against
the JAX package's, with the same weights carried over by
avsep_tpu_torch/models/from_jax.py.

The weights are random numpy values in the shapes of the JAX ``init`` (He-
scaled convs, BN statistics away from (0, 1)), so that every layer moves
the output; the reference init (N(0, 0.001) convs) would leave the masks at
0.5 whatever a layer did.

Tolerances: float32 networks with the same arithmetic in another summation
order.  The ResNet is held at 1e-4 relative to its largest output (17
convolutions, each adding ~1e-6); the U-Net's masks at 2e-4 absolute
(torch's upsample rounds its tap weights in float32, see
test_torch_layers.py, across five decoder levels).  The tiny conv encoder
(four convolutions, three BatchNorms) is held at 1e-5 relative, its
running statistics after a train-mode call too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models.resnet import FrameEncoder as JFrameEncoder
from avsep_tpu.models.resnet import TinyConvEncoder as JTinyConvEncoder
from avsep_tpu.models.unet import AudioUnet as JAudioUnet
from avsep_tpu_torch.models.builder import ModelBuilder, activate
from avsep_tpu_torch.models.from_jax import state_dict_from_jax
from avsep_tpu_torch.models.resnet import FrameEncoder, TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet


def random_variables(module, rs, *args, **kw):
    """Random numpy values in the shapes of ``module.init`` (no JAX init
    run): conv kernels He-scaled on fan_in, BN scale near 1, BN statistics
    away from (0, 1)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kw))

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            v = rs.randn(*s.shape) * np.sqrt(2.0 / fan_in)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*s.shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, s.shape)
        else:                      # bias, mean
            v = 0.1 * rs.randn(*s.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(module, variables):
    module.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})), strict=True)
    return module.eval()


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def unet5():
    """unet5 at ngf 16 (bottleneck 128 = 2 x 64-channel chunks)."""
    rs = np.random.RandomState(0)
    jm = JAudioUnet(fc_dim=2, num_downs=5, ngf=16, fusion_type="hidsep",
                    att_type="sig")
    x = jnp.zeros((2, 64, 32, 1))
    v = jnp.zeros((2, 2, 4, 4, 64))
    var = random_variables(jm, rs, x, v, train=False)
    pm = _load(AudioUnet(fc_dim=2, num_downs=5, ngf=16, fusion_type="hidsep",
                         att_type="sig"), var)
    return jm, var, pm


def _unet_inputs(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 64, 32, 1).astype(np.float32) * 2.0
    v = rs.rand(2, 2, 4, 4, 64).astype(np.float32)
    return x, v


def test_unet_state_dict_keys_are_the_jax_module_paths(unet5):
    _, var, pm = unet5
    keys = set(pm.state_dict())
    assert "bn0.bn.weight" in keys and "down0.conv.weight" in keys
    assert "up_bn1.bn.running_var" in keys and "up0.conv.bias" in keys
    assert "down_bn4.bn.weight" not in keys          # innermost: no BN
    assert set(state_dict_from_jax(var["params"], var["batch_stats"])) \
        == keys


@pytest.mark.parametrize("seed", [1, 2])
def test_audio_unet5_av_matches_jax(unet5, seed):
    jm, var, pm = unet5
    x, v = _unet_inputs(seed)
    ref, rmeta = jm.apply(var, jnp.asarray(x), jnp.asarray(v), train=False)
    with torch.no_grad():
        got, meta = pm(torch.from_numpy(x), torch.from_numpy(v))
    assert got.shape == (2, 64, 32, 2)
    masks, rmasks = torch.sigmoid(got).numpy(), jax.nn.sigmoid(ref)
    assert np.abs(masks - np.asarray(rmasks)).max() < 2e-4
    assert masks.std() > 0.05                         # the layers moved it
    assert _rel(meta.att_maps.numpy(), rmeta.att_maps) < 1e-4
    assert meta.features is None


def test_audio_unet5_ao_matches_jax_with_injected_uniforms(unet5):
    jm, var, pm = unet5
    x, _ = _unet_inputs(3)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, (2,)))
    ref, _ = jm.apply(var, jnp.asarray(x), None, train=False,
                      fusion_rng=key)
    with torch.no_grad():
        got, meta = pm(torch.from_numpy(x), None,
                       swap_uniforms=torch.from_numpy(u))
    assert np.abs(torch.sigmoid(got).numpy()
                  - np.asarray(jax.nn.sigmoid(ref))).max() < 2e-4
    assert meta.att_maps is None


@pytest.mark.parametrize("arch,num_downs", [("unet6", 6), ("unet7", 7)])
def test_builder_builds_deeper_unets_with_jax_layout(arch, num_downs):
    pm = ModelBuilder.build_sound(arch, fc_dim=2, fusion_type="hidsep",
                                  att_type="sig")
    jm = JAudioUnet(fc_dim=2, num_downs=num_downs, fusion_type="hidsep",
                    att_type="sig")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 1)),
        jnp.zeros((2, 1, 14, 14, 256)), train=False))
    sd = pm.state_dict()
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    assert len(flat) == sum(1 for k in sd if k.endswith(("weight", "bias")))
    for path, s in flat:
        names = [p.key for p in path]
        if names[-1] == "kernel":
            kh, kw, cin, cout = s.shape
            assert tuple(sd[".".join(names[:-1]) + ".weight"].shape) == (
                cout, cin, kh, kw)


@pytest.fixture(scope="module")
def dilated():
    rs = np.random.RandomState(10)
    jm = JFrameEncoder(fc_dim=32, pool_type="maxpool", dilate_scale=16)
    var = random_variables(jm, rs, jnp.zeros((1, 64, 64, 3)), pool=False,
                           train=False)
    pm = _load(FrameEncoder(fc_dim=32, pool_type="maxpool",
                            dilate_scale=16), var)
    return jm, var, pm


@pytest.mark.parametrize("pool", [False, True])
@pytest.mark.parametrize("frames_shape", [(2, 64, 64, 3), (2, 3, 64, 64, 3)])
def test_frame_encoder_dilated_64_matches_jax(dilated, pool, frames_shape):
    jm, var, pm = dilated
    f = np.random.RandomState(11).randn(*frames_shape).astype(np.float32)
    ref = jm.apply(var, jnp.asarray(f), pool=pool, train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(f), pool=pool)
    if not pool:
        assert got.shape == (2, 4, 4, 32)           # stride 16 at 64x64
    assert _rel(got.numpy(), ref) < 1e-4


@pytest.mark.parametrize("pool_type", ["maxpool", "avgpool"])
def test_frame_encoder_plain_resnet_matches_jax(pool_type):
    rs = np.random.RandomState(12)
    jm = JFrameEncoder(fc_dim=16, pool_type=pool_type, dilate_scale=0)
    var = random_variables(jm, rs, jnp.zeros((1, 64, 64, 3)), pool=True,
                           train=False)
    pm = _load(ModelBuilder.build_frame("resnet18fc", 16, pool_type), var)
    f = rs.randn(2, 64, 64, 3).astype(np.float32)
    for pool in (True, False):
        ref = jm.apply(var, jnp.asarray(f), pool=pool, train=False)
        with torch.no_grad():
            got = pm(torch.from_numpy(f), pool=pool)
        assert _rel(got.numpy(), ref) < 1e-4


def test_builder_rejects_what_this_slice_leaves_out():
    assert isinstance(ModelBuilder.build_frame("tinyconv", 16),
                      TinyConvEncoder)
    with pytest.raises(ValueError):
        ModelBuilder.build_frame("vgg", 16)
    with pytest.raises(ValueError):
        ModelBuilder.build_sound("unet9")


@pytest.fixture(scope="module")
def tiny():
    rs = np.random.RandomState(15)
    jm = JTinyConvEncoder(fc_dim=16, pool_type="maxpool")
    var = random_variables(jm, rs, jnp.zeros((1, 64, 64, 3)), pool=False,
                           train=False)
    pm = _load(ModelBuilder.build_frame("tinyconv", 16, "maxpool"), var)
    return jm, var, pm


def test_tinyconv_state_dict_keys_are_the_flax_scopes(tiny):
    _, var, pm = tiny
    keys = set(pm.state_dict())
    assert "features.Conv_0.bias" in keys and "fc.weight" in keys
    assert "features.BatchNorm_2.running_var" in keys
    assert pm.features.BatchNorm_0.flax_momentum == 0.99


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("frames_shape", [(2, 64, 64, 3), (3, 33, 47, 3),
                                          (2, 2, 20, 17, 3)])
def test_tinyconv_matches_jax(tiny, train, frames_shape):
    """SAME padding on even and odd sizes (stride 2 pads (0, 1) on an even
    size, (1, 1) on an odd one), multi-frame stacks, and train mode: the
    map, then the BN statistics the call leaves behind."""
    jm, var, pm = tiny
    f = np.random.RandomState(16).randn(*frames_shape).astype(np.float32)
    pool = len(frames_shape) == 5
    if train:
        ref, upd = jm.apply(var, jnp.asarray(f), pool=pool, train=True,
                            mutable=["batch_stats"])
    else:
        ref = jm.apply(var, jnp.asarray(f), pool=pool, train=False)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    pm.train(train)
    with torch.no_grad():
        got = pm(torch.from_numpy(f), pool=pool)
    assert _rel(got.numpy(), ref) < 1e-5
    if train:
        want = state_dict_from_jax(var["params"], upd["batch_stats"])
        for k, v in pm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert _rel(v.numpy(), want[k].numpy()) < 1e-5, k
        pm.load_state_dict(before)
    pm.eval()


@pytest.mark.parametrize("act", ["sigmoid", "softmax", "relu", "tanh", "no"])
def test_activate_matches_jax(act):
    from avsep_tpu.models.builder import activate as jactivate
    x = np.random.RandomState(13).randn(3, 5).astype(np.float32)
    ref = jactivate(jnp.asarray(x), act)
    got = activate(torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_from_jax_rejects_unknown_leaves():
    with pytest.raises(ValueError):
        state_dict_from_jax({"conv": {"kernel": np.zeros((3, 3))}}, {})
    with pytest.raises(ValueError):
        state_dict_from_jax({"dense": {"embedding": np.zeros(3)}}, {})
