"""The port's CoLoc, CoLoc_Sel and MixVis fusions and the duet option
(avsep_tpu_torch/models/fusion.py) against the JAX package's, on the same
numpy inputs, with the JAX package's own uniforms injected into the
audio-only slot swap.

Tolerance: the fusion is float32 reductions (max, sums over Dc, norms) in
another order, 1e-5 relative; the permutation choice and the argmax pixel
must agree exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models import fusion as jf
from avsep_tpu_torch.models import fusion as pf


def _inputs(seed, B=3, h=2, w=2, D=32, C=2, H=5, W=5):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, h, w, D).astype(np.float32)
    v = rs.rand(C, B, H, W, D // C).astype(np.float32)
    return x, v


def _close(got, ref, rel=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("att_type", ["cos", "sig"])
@pytest.mark.parametrize("select", [False, True])
@pytest.mark.parametrize("C", [2, 3])
def test_coloc_matches_jax(att_type, select, C):
    x, v = _inputs(C, D=12 * C, C=C)
    ref = jf.coloc(jnp.asarray(x), jnp.asarray(v), att_type=att_type,
                   select=select)
    got = pf.coloc(torch.from_numpy(x), torch.from_numpy(v),
                   att_type=att_type, select=select)
    _close(got.features.numpy(), ref.features)
    _close(got.att_maps.numpy(), ref.att_maps)
    _close(got.match_ps.numpy(), ref.match_ps)
    _close(got.match_loss.numpy(), ref.match_loss)


@pytest.mark.parametrize("att_temp", [0.5, 2.0])
def test_coloc_attention_temperature_matches_jax(att_temp):
    x, v = _inputs(11)
    for att_type in ("cos", "sig"):
        ref = jf.coloc(jnp.asarray(x), jnp.asarray(v), att_type=att_type,
                       att_temp=att_temp)
        got = pf.coloc(torch.from_numpy(x), torch.from_numpy(v),
                       att_type=att_type, att_temp=att_temp)
        _close(got.features.numpy(), ref.features)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ao_path_matches_jax_with_injected_uniforms(seed):
    x, _ = _inputs(20 + seed, B=8)
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (x.shape[0],)))
    ref = jf.coloc(jnp.asarray(x), None, rng=key, n_sources=2)
    got = pf.coloc(torch.from_numpy(x), None, n_sources=2,
                   uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(ref.features))
    assert got.match_loss is None and got.att_maps is None


def test_ao_path_draws_from_a_generator():
    x, _ = _inputs(30, B=64)
    a = pf.coloc(torch.from_numpy(x), None,
                 generator=torch.Generator().manual_seed(3))
    b = pf.coloc(torch.from_numpy(x), None,
                 generator=torch.Generator().manual_seed(3))
    assert torch.equal(a.features, b.features)
    # some clips swapped and some not
    g = torch.amax(torch.from_numpy(x), dim=(1, 2)).reshape(64, 2, -1)
    guide = a.features[:, 0, 0, :32].reshape(64, 2, -1)
    swapped = torch.all(guide == g.flip(1), dim=(1, 2))
    assert 0 < int(swapped.sum()) < 64
    with pytest.raises(ValueError):
        pf.coloc(torch.from_numpy(x), None)


def test_ties_go_to_the_identity_permutation():
    """Equal scores for every permutation: both pick index 0 (identity)."""
    x = np.ones((2, 1, 1, 8), np.float32)
    v = np.ones((2, 2, 3, 3, 4), np.float32)
    ref = jf._score_and_sort(jf._attend(jf._perm_stack(jf._pool_chunks(
        jnp.asarray(x), 2)), jnp.moveaxis(jnp.asarray(v), 0, 1)[:, None],
        "sig"))
    got = pf._score_and_sort(pf._attend(pf._perm_stack(pf._pool_chunks(
        torch.from_numpy(x), 2)), torch.from_numpy(v).movedim(0, 1)[:, None],
        "sig"))
    assert got[2].tolist() == np.asarray(ref[2]).tolist() == [0, 0]


def test_perm_table_is_itertools_order():
    np.testing.assert_array_equal(pf._perms(3).numpy(),
                                  np.asarray(jf._perms(3)))


def test_get_fusion_dispatch():
    x, v = _inputs(40)
    for name, select in (("hidsep", False), ("share", False),
                         ("CoLoc_Sel", True)):
        got = pf.get_fusion(name)(torch.from_numpy(x), torch.from_numpy(v),
                                  att_type="cos")
        ref = jf.coloc(jnp.asarray(x), jnp.asarray(v), att_type="cos",
                       select=select)
        _close(got.features.numpy(), ref.features)
    assert pf.get_fusion("MixVis") is pf.mixvis
    with pytest.raises(ValueError):
        pf.get_fusion("nope")
    with pytest.raises(ValueError):
        pf.coloc(torch.zeros(1, 1, 1, 7), torch.zeros(2, 1, 2, 2, 3))


@pytest.mark.parametrize("option", ["duet", "duet_h", "duet_w"])
@pytest.mark.parametrize("select", [False, True])
def test_coloc_duet_option_matches_jax(option, select):
    x, v = _inputs(60, H=4, W=6)
    ref = jf.coloc(jnp.asarray(x), jnp.asarray(v), att_type="sig",
                   option=option, select=select)
    got = pf.coloc(torch.from_numpy(x), torch.from_numpy(v), att_type="sig",
                   option=option, select=select)
    want = (2, 3, 8, 6) if option != "duet_w" else (2, 3, 4, 12)
    assert tuple(got.att_maps.transpose(0, 1).shape) == want
    _close(got.features.numpy(), ref.features)
    _close(got.att_maps.numpy(), ref.att_maps)
    _close(got.match_ps.numpy(), ref.match_ps)


@pytest.mark.parametrize("att_type", ["cos", "sig"])
@pytest.mark.parametrize("att_temp", [1.0, 0.5])
def test_mixvis_matches_jax(att_type, att_temp):
    """One mixture map [1, B, H, W, D/2]: attention maps, the argmax-pixel
    guidance, and the match loss with its area and cosine terms."""
    rs = np.random.RandomState(70)
    x = rs.randn(3, 2, 2, 32).astype(np.float32)
    v = rs.rand(1, 3, 4, 10, 16).astype(np.float32)
    ref = jf.mixvis(jnp.asarray(x), jnp.asarray(v), att_type=att_type,
                    att_temp=att_temp)
    got = pf.get_fusion("MixVis")(torch.from_numpy(x), torch.from_numpy(v),
                                  att_type=att_type, att_temp=att_temp)
    _close(got.features.numpy(), ref.features)
    _close(got.att_maps.numpy(), ref.att_maps)
    _close(got.match_ps.numpy(), ref.match_ps)
    _close(got.match_loss.numpy(), ref.match_loss)


def test_mixvis_audio_only_matches_jax_with_injected_uniforms():
    x, _ = _inputs(80, B=8)
    key = jax.random.PRNGKey(4)
    ref = jf.mixvis(jnp.asarray(x), None, rng=key)
    got = pf.mixvis(torch.from_numpy(x), None, uniforms=torch.from_numpy(
        np.array(jax.random.uniform(key, (8,)))))
    np.testing.assert_array_equal(got.features.numpy(),
                                  np.asarray(ref.features))
