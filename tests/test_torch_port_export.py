"""The port's ``models/torch_export.py`` against the JAX package's.

The same weights go to both (random values in the JAX shapes, carried to
the port by ``from_jax``): the port's export of its ``state_dict`` must
equal ``avsep_tpu.models.torch_export``'s output of the JAX trees key for
key, ``num_batches_tracked`` included, bit for bit (the export moves
tensors, it computes nothing).  Then a trained ``state_dict`` (running
statistics moved, counts above 0) must round-trip through the port's
export and ``torch_import`` to the identical ``state_dict``, in memory and
through a ``.pth`` file.  Sizes: unet5 and unet7 at ngf 8, the dilated and
the plain ResNet18 at 32 channels, both synthesizer heads.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models import torch_export as jexport
from avsep_tpu.models.resnet import FrameEncoder as JFrameEncoder
from avsep_tpu.models.synthesizer import Bias as JBias
from avsep_tpu.models.synthesizer import InnerProd as JInnerProd
from avsep_tpu.models.unet import AudioUnet as JAudioUnet
from avsep_tpu_torch.models import torch_export as export
from avsep_tpu_torch.models import torch_import
from avsep_tpu_torch.models.from_jax import (
    state_dict_from_jax, synthesizer_state_dict_from_jax)
from avsep_tpu_torch.models.resnet import FrameEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from tests.test_torch_models import random_variables


def assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        g = got[k].numpy()
        assert g.dtype == v.dtype and g.shape == v.shape, (k, g.dtype,
                                                           v.dtype)
        np.testing.assert_array_equal(g, v, err_msg=k)


def unet_variables(num_downs, seed=0):
    net = JAudioUnet(fc_dim=2, num_downs=num_downs, ngf=8,
                     fusion_type="hidsep", att_type="sig")
    side = 2 ** num_downs
    return random_variables(net, np.random.RandomState(seed),
                            jnp.zeros((1, side, side, 1)),
                            jnp.zeros((2, 1, 2, 2, 32)), train=False)


def resnet_variables(dilate_scale, seed=1):
    net = JFrameEncoder(fc_dim=32, pool_type="maxpool",
                        dilate_scale=dilate_scale)
    return random_variables(net, np.random.RandomState(seed),
                            jnp.zeros((1, 64, 64, 3)), pool=False,
                            train=False)


@pytest.mark.parametrize("num_downs", [5, 7])
def test_unet_export_matches_jax(num_downs):
    v = unet_variables(num_downs)
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    assert_same(export.unet_to_torch(sd, num_downs=num_downs),
                jexport.unet_to_torch(v["params"], v["batch_stats"],
                                      num_downs=num_downs))


@pytest.mark.parametrize("dilate_scale", [16, 0])
def test_resnet_export_matches_jax(dilate_scale):
    v = resnet_variables(dilate_scale)
    sd = state_dict_from_jax(v["params"], v["batch_stats"])
    assert_same(export.resnet_to_torch(sd),
                jexport.resnet_to_torch(v["params"], v["batch_stats"]))


@pytest.mark.parametrize("head", [JInnerProd(fc_dim=8), JBias()])
def test_synthesizer_export_matches_jax(head):
    params = random_variables(head, np.random.RandomState(2),
                              jnp.zeros((1, 8)),
                              jnp.zeros((1, 4, 4, 8)))["params"]
    assert_same(export.synthesizer_to_torch(
        synthesizer_state_dict_from_jax(params)),
        jexport.synthesizer_to_torch(params))


def trained(module, x, *args):
    """``module`` after two train-mode forwards: running statistics moved
    and ``num_batches_tracked`` at 2."""
    module.train()
    with torch.no_grad():
        for _ in range(2):
            module(x, *args)
    return module.state_dict()


def test_roundtrip_through_torch_import_is_the_identity(tmp_path):
    g = torch.Generator().manual_seed(3)
    unet = AudioUnet(fc_dim=2, num_downs=7, ngf=8, fusion_type="hidsep",
                     att_type="sig")
    unet.reset_parameters_(g)
    sd_u = trained(unet, torch.randn(2, 128, 128, 1, generator=g),
                   torch.randn(2, 2, 2, 2, 32, generator=g))
    frame = FrameEncoder(32, "maxpool", dilate_scale=16)
    frame.reset_parameters_(g)
    sd_f = trained(frame, torch.randn(2, 64, 64, 3, generator=g))
    assert sd_u["down_bn1.bn.num_batches_tracked"].item() == 2
    ref_u = export.unet_to_torch(sd_u, num_downs=7)
    ref_f = export.resnet_to_torch(sd_f)
    assert "unet_block.mid_forward.down_forward.1.weight" in ref_u
    assert "features.7.0.downsample.1.num_batches_tracked" in ref_f
    for name, ref in (("sound", ref_u), ("frame", ref_f)):
        export.save_torch_checkpoint(ref, str(tmp_path / f"{name}_best.pth"))
    back_u = torch_import.unet_state_dict_from_torch(
        torch_import.load_torch_checkpoint(str(tmp_path / "sound_best.pth")),
        num_downs=7)
    back_f = torch_import.resnet_state_dict_from_torch(
        torch_import.load_torch_checkpoint(str(tmp_path / "frame_best.pth")))
    for back, sd in ((back_u, sd_u), (back_f, sd_f),
                     (torch_import.unet_state_dict_from_torch(
                         ref_u, num_downs=7), sd_u)):
        assert set(back) == set(sd)
        for k, v in sd.items():
            assert torch.equal(back[k], v), k
    AudioUnet(fc_dim=2, num_downs=7, ngf=8).load_state_dict(back_u,
                                                            strict=True)
    FrameEncoder(32, "maxpool").load_state_dict(back_f, strict=True)
