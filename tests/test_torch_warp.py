"""The port's log-frequency warp and mixture preparation
(avsep_tpu_torch/ops/{warp,prepare}.py) against the JAX package's.

Tolerance: both sides are two float32 GEMMs against the same float32
interpolation matrices, differing only in summation order: 1e-6 relative to
the output's largest value; thresholded masks agree exactly away from ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.ops import prepare as jp
from avsep_tpu.ops import warp as jw
from avsep_tpu_torch.ops import prepare as pp
from avsep_tpu_torch.ops import warp as pw


def _close(got, ref, rel=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("warp", [True, False])
def test_warpgrid_and_interp_matrices_are_the_jax_ones(warp):
    np.testing.assert_array_equal(pw.warpgrid(2, 256, 64, warp),
                                  jw.warpgrid(2, 256, 64, warp))
    gx, gy = pw.warpgrid_coords(256, 64, warp)
    np.testing.assert_array_equal(pw._interp_matrix(gy, 512),
                                  jw._interp_matrix(gy, 512))


@pytest.mark.parametrize("shape", [(2, 512, 64), (2, 3, 512, 32)])
def test_warp_spectrogram_matches_jax(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32) * 5
    ref = jw.warp_spectrogram(jnp.asarray(x), HO=256)
    got = pw.warp_spectrogram(torch.from_numpy(x), HO=256)
    _close(got.numpy(), ref)


def test_unwarp_mask_matches_jax():
    m = np.random.RandomState(1).rand(2, 2, 256, 64).astype(np.float32)
    ref = jw.unwarp_mask(jnp.asarray(m), HO=512)
    got = pw.unwarp_mask(torch.from_numpy(m), HO=512)
    assert got.shape == (2, 2, 512, 64)
    _close(got.numpy(), ref)


def test_warp_matches_torch_grid_sample():
    """The separable GEMMs equal the reference's F.grid_sample, which
    unnormalizes its coordinates in float32: one ulp at 512 pixels is
    2**-14, so the weights agree to about 6e-5."""
    x = np.random.RandomState(2).rand(2, 1, 512, 32).astype(np.float32)
    grid = torch.from_numpy(pw.warpgrid(2, 256, 32, True))
    ref = torch.nn.functional.grid_sample(torch.from_numpy(x), grid,
                                          align_corners=False)
    got = pw.warp_spectrogram(torch.from_numpy(x), HO=256)
    _close(got.numpy(), ref.numpy(), rel=6e-5)



@pytest.mark.parametrize("shape,span", [
    ((2, 3, 16, 24, 9, 13), 1.0),     # every point inside [-1, 1]
    ((2, 3, 16, 24, 9, 13), 1.4),     # points off the image: zero taps
    ((1, 2, 7, 5, 11, 4), 2.5),       # odd sizes, most points far off
])
def test_grid_sample_matches_jax(shape, span):
    """The general sampler on random grids against the JAX package's
    gather, and both against float64, at 1e-5 of the output's largest
    value: each side unnormalizes the coordinates in float32 and reads up
    to 3e-6 of it away from the float64 result.  A point beyond the
    border by more than a pixel takes zeros."""
    B, C, H, W, HO, WO = shape
    rs = np.random.RandomState(3)
    x = rs.randn(B, C, H, W).astype(np.float32)
    grid = rs.uniform(-span, span, (B, HO, WO, 2)).astype(np.float32)
    grid[0, 0, 0] = (-1.0, 1.0)                  # the corners exactly
    grid[0, 0, 1] = (1.0, -1.0)
    ref = np.asarray(jw.grid_sample(jnp.asarray(x), jnp.asarray(grid)))
    got = pw.grid_sample(torch.from_numpy(x), torch.from_numpy(grid))
    assert got.shape == (B, C, HO, WO)
    _close(got.numpy(), ref, rel=1e-5)
    exact = torch.nn.functional.grid_sample(
        torch.from_numpy(x).double(), torch.from_numpy(grid).double(),
        align_corners=False).numpy()
    _close(got.numpy(), exact, rel=1e-5)
    _close(ref, exact, rel=1e-5)
    if span > 1.2:
        off = (np.abs(grid) > 1.0 + 1.0 / min(H, W)).any(-1)
        assert off.any()
        assert np.all(got.numpy()[np.broadcast_to(off[:, None],
                                                  got.shape)] == 0.0)


@pytest.mark.parametrize("log_freq", [True, False])
@pytest.mark.parametrize("weighted_loss", [True, False])
@pytest.mark.parametrize("binary_mask", [True, False])
def test_prepare_matches_jax(log_freq, weighted_loss, binary_mask):
    rs = np.random.RandomState(3)
    mags = (rs.rand(2, 2, 512, 32) ** 3).astype(np.float32)
    mag_mix = mags.sum(axis=1)
    kw = dict(log_freq=log_freq, weighted_loss=weighted_loss,
              binary_mask=binary_mask)
    ref = jp.prepare(jnp.asarray(mag_mix), jnp.asarray(mags), **kw)
    got = pp.prepare(torch.from_numpy(mag_mix), torch.from_numpy(mags), **kw)
    assert got._fields == ref._fields
    for name in ("mag_mix", "mags", "weights"):
        _close(getattr(got, name).numpy(), getattr(ref, name))
    # log of a value known to rel 1e-6 is known to abs 1e-6
    np.testing.assert_allclose(got.log_mag_mix.numpy(),
                               np.asarray(ref.log_mag_mix), atol=2e-5)
    gm, rm = got.gt_masks.numpy(), np.asarray(ref.gt_masks)
    if binary_mask:
        assert np.mean(gm != rm) < 1e-3
    else:
        np.testing.assert_allclose(gm, rm, atol=1e-4)


def test_prepare_log_input_carries_no_gradient():
    mags = torch.rand(1, 2, 512, 8, requires_grad=True)
    out = pp.prepare(mags.sum(1), mags)
    assert not out.log_mag_mix.requires_grad
    assert out.mag_mix.requires_grad
