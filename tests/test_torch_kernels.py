"""The port's STFT kernels (avsep_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.

On the CPU the wrappers take the plain PyTorch versions (the CUDA kernels
cannot run here); the tests that launch the CUDA kernels skip without a
card.  Tolerances: the plain versions repeat the Pallas kernels' float32
arithmetic in the same order (one multiply per framed sample; adds in
ascending m from zero, then one divide), so both agree to the bit.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsep_tpu.ops import pallas_kernels as jk
from avsep_tpu.ops.stft import _reflect_pad as jax_reflect_pad
from avsep_tpu_torch.ops import kernels as pk
from avsep_tpu_torch.ops.stft import istft_denominator

N_FFT, HOP = 1022, 256


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (the CUDA
    kernels have no interpret mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _padded(rs, B, L):
    x = rs.randn(B, L).astype(np.float32)
    return np.array(jax_reflect_pad(jnp.asarray(x), N_FFT // 2))


@pytest.mark.parametrize("B,L", [(2, 64 * HOP - 1), (3, 8 * HOP),
                                 (1, 5 * HOP + 17)])
def test_frame_window_plain_matches_pallas(B, L):
    rs = np.random.RandomState(B)
    padded = _padded(rs, B, L)
    T = 1 + L // HOP
    ref = np.asarray(jk.frame_window(jnp.asarray(padded), T, N_FFT, HOP,
                                     interpret=True))
    got = pk.frame_window_plain(torch.from_numpy(padded), T, N_FFT, HOP)
    assert got.shape == (B, T, N_FFT)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("T", [64, 9])
def test_overlap_add_normalize_plain_matches_pallas(T, clip):
    rs = np.random.RandomState(T)
    # scale 3 so that clipping bites on some samples
    frames = (rs.randn(2, T, N_FFT) * 3.0).astype(np.float32)
    full_len = N_FFT + HOP * (T - 1)
    denom = istft_denominator(N_FFT, HOP, T)
    ref = np.asarray(jk.overlap_add_normalize(
        jnp.asarray(frames), HOP, full_len, np.array(denom), clip=clip,
        interpret=True))
    got = pk.overlap_add_normalize_plain(
        torch.from_numpy(frames), HOP, full_len, torch.from_numpy(
            np.array(denom)), clip=clip)
    assert got.shape == (2, full_len)
    np.testing.assert_array_equal(got.numpy(), ref)
    if clip:
        assert np.abs(got.numpy()).max() <= 1.0


def test_wrappers_take_plain_version_on_cpu_without_counting():
    rs = np.random.RandomState(5)
    padded = torch.from_numpy(_padded(rs, 2, 16 * HOP - 1))
    fw0 = pk.frame_window.launches
    ola0 = pk.overlap_add_normalize.launches
    got = pk.frame_window(padded, 16, N_FFT, HOP)
    np.testing.assert_array_equal(
        got.numpy(), pk.frame_window_plain(padded, 16, N_FFT, HOP).numpy())
    full_len = N_FFT + HOP * 15
    denom = istft_denominator(N_FFT, HOP, 16)
    out = pk.overlap_add_normalize(got, HOP, full_len, denom, clip=False)
    assert out.shape == (2, full_len)
    assert pk.frame_window.launches == fw0
    assert pk.overlap_add_normalize.launches == ola0


@pytest.mark.parametrize("bad, err", [
    (torch.zeros(2, 4000, dtype=torch.float64), TypeError),
    (torch.zeros(2, 2, 4000), ValueError),
    (torch.zeros(4000, 2).t(), ValueError),
    (np.zeros((2, 4000), np.float32), TypeError),
])
def test_frame_window_rejects_what_the_kernel_does_not_take(bad, err):
    with pytest.raises(err):
        pk.frame_window(bad, 4, N_FFT, HOP)


def test_overlap_add_normalize_rejects_short_denominator():
    frames = torch.zeros(1, 4, N_FFT)
    with pytest.raises(ValueError):
        pk.overlap_add_normalize(frames, HOP, N_FFT + 3 * HOP,
                                 np.ones(10, np.float32))
    with pytest.raises(ValueError):
        pk.overlap_add_normalize(torch.zeros(4, N_FFT), HOP, 10,
                                 np.ones(10, np.float32))


def test_build_targets_hopper_and_keys_on_the_source():
    flags = " ".join(pk.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name, (src, _) in pk.SOURCES.items():
        assert os.path.exists(os.path.join(pk.CSRC_DIR, src))
        path = pk.library_path(name)
        assert path.startswith(pk.BUILD_DIR) and path.endswith(".so")
        assert path == pk.library_path(name)
    assert len({pk.library_path(n) for n in pk.SOURCES}) == len(pk.SOURCES)


def test_cuda_sources_name_the_tpu_kernel_they_replace():
    for src, tpu_fn in (("frame_window.cu", "frame_window"),
                        ("overlap_add.cu", "overlap_add_normalize")):
        with open(os.path.join(pk.CSRC_DIR, src)) as f:
            text = f.read()
        assert f"avsep_tpu/ops/pallas_kernels.py::{tpu_fn}" in text
        assert 'extern "C"' in text


def test_kernels_match_plain_on_cuda(cuda_device):
    rs = np.random.RandomState(7)
    padded = torch.from_numpy(_padded(rs, 4, 64 * HOP - 1))
    T = 64
    n0 = pk.frame_window.launches
    got = pk.frame_window(padded.to(cuda_device), T, N_FFT, HOP)
    torch.cuda.synchronize()
    assert pk.frame_window.launches == n0 + 1
    ref = pk.frame_window_plain(padded, T, N_FFT, HOP)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.numpy())

    full_len = N_FFT + HOP * (T - 1)
    denom = istft_denominator(N_FFT, HOP, T)
    frames = ref * 3.0
    for clip in (True, False):
        m0 = pk.overlap_add_normalize.launches
        out = pk.overlap_add_normalize(frames.to(cuda_device), HOP, full_len,
                                       denom, clip=clip)
        torch.cuda.synchronize()
        assert pk.overlap_add_normalize.launches == m0 + 1
        ref_o = pk.overlap_add_normalize_plain(
            frames, HOP, full_len, torch.from_numpy(np.array(denom)),
            clip=clip)
        np.testing.assert_allclose(out.cpu().numpy(), ref_o.numpy(),
                                   rtol=0, atol=1e-6)
