"""The port's STFT kernels (avsep_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs them.

On the CPU the wrappers take the plain PyTorch versions (the CUDA kernels
cannot run here); the tests that launch the CUDA kernels skip without a
card.  Tolerances: the plain versions repeat the Pallas kernels' float32
arithmetic in the same order (one multiply per framed sample; adds in
ascending m from zero, then one divide), so both agree to the bit.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.ops import pallas_kernels as jk
from avsep_tpu.ops.stft import _reflect_pad as jax_reflect_pad
from avsep_tpu_torch.ops import kernels as pk
from avsep_tpu_torch.ops.stft import istft_denominator

N_FFT, HOP = 1022, 256
# (n_fft, hop, B, T) that the flagship never reaches: odd n_fft, hop not
# dividing n_fft, one frame, hop above n_fft (K = 1), odd B
RAGGED = [(1021, 256, 3, 7), (512, 160, 1, 5), (400, 160, 2, 9),
          (1022, 256, 1, 1), (300, 512, 2, 4)]


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none (the CUDA
    kernels have no interpret mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _padded(rs, B, L, n_fft=N_FFT):
    """Rows as the STFT pads ``L`` samples: reflect-padded by n_fft // 2
    (by the JAX package), or, where a row is too short to reflect, random
    rows of the padded length."""
    pad = n_fft // 2
    if L <= pad:
        return rs.randn(B, L + 2 * pad).astype(np.float32)
    x = rs.randn(B, L).astype(np.float32)
    return np.array(jax_reflect_pad(jnp.asarray(x), pad))


# audio of (T - 1) * hop and one more samples: both give T frames, padded
# rows of both parities
@pytest.mark.parametrize("n_fft,hop,B,L", [
    pytest.param(N_FFT, HOP, 2, 64 * HOP - 1, id="2-16383"),
    pytest.param(N_FFT, HOP, 3, 8 * HOP, id="3-2048"),
    pytest.param(N_FFT, HOP, 1, 5 * HOP + 17, id="1-1297"),
    *[pytest.param(n, h, b, (t - 1) * h + extra,
                   id=f"{n}-{h}-{b}-{t}-L{(t - 1) * h + extra}")
      for n, h, b, t in RAGGED for extra in (0, 1)],
])
def test_frame_window_plain_matches_pallas(n_fft, hop, B, L):
    rs = np.random.RandomState(B)
    padded = _padded(rs, B, L, n_fft)
    T = 1 + L // hop
    ref = np.asarray(jk.frame_window(jnp.asarray(padded), T, n_fft, hop,
                                     interpret=True))
    got = pk.frame_window_plain(torch.from_numpy(padded), T, n_fft, hop)
    assert got.shape == (B, T, n_fft)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("n_fft,hop,B,T", [
    pytest.param(N_FFT, HOP, 2, 64, id="64"),
    pytest.param(N_FFT, HOP, 2, 9, id="9"),
    *[pytest.param(n, h, b, t, id=f"{n}-{h}-{b}-{t}")
      for n, h, b, t in RAGGED],
])
def test_overlap_add_normalize_plain_matches_pallas(n_fft, hop, B, T, clip):
    rs = np.random.RandomState(T)
    # scale 3 so that clipping bites on some samples
    frames = (rs.randn(B, T, n_fft) * 3.0).astype(np.float32)
    full_len = n_fft + hop * (T - 1)
    denom = istft_denominator(n_fft, hop, T)
    ref = np.asarray(jk.overlap_add_normalize(
        jnp.asarray(frames), hop, full_len, np.array(denom), clip=clip,
        interpret=True))
    got = pk.overlap_add_normalize_plain(
        torch.from_numpy(frames), hop, full_len, torch.from_numpy(
            np.array(denom)), clip=clip)
    assert got.shape == (B, full_len)
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


@pytest.mark.parametrize("n_fft,hop,frames,smem", [
    (N_FFT, HOP, 16, 4 * (1024 + 15 * HOP + N_FFT)),   # the flagship
    (300, 512, 16, 4 * (300 + 15 * 512 + 300)),
    (2048, 2048, 4, 4 * (2048 + 3 * 2048 + 2048)),     # halved to fit 48 KiB
    (8192, 2048, 1, 4 * (8192 + 8192)),                 # opts in above 48 KiB
])
def test_frame_window_plan_fits_the_block(n_fft, hop, frames, smem):
    assert pk.frame_window_plan(n_fft, hop) == (frames, smem)
    assert smem <= 232448


def test_frame_window_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="shared memory"):
        pk.frame_window_plan(40000, 256)


def _c_params(src: str, fn: str):
    """The parameter declarations of C function ``fn`` in ``src``."""
    head = src[src.index(f"int {fn}("):]
    return [p.strip() for p in head[head.index("(") + 1:
                                    head.index(")")].split(",")]


def test_ctypes_argtypes_match_the_c_signatures():
    # a pointer (or the stream) passed as c_int would be cut to 32 bits, a
    # long long as c_int too, and a float passed as c_int is not a float
    for name, (src, fn) in pk.SOURCES.items():
        with open(os.path.join(pk.CSRC_DIR, src)) as f:
            params = _c_params(f.read(), fn)
        want = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
                else ctypes.c_longlong if p.startswith("long long ")
                else ctypes.c_float if p.startswith("float ")
                else ctypes.c_int for p in params]
        assert all(p.startswith(("int ", "long long ", "float ",
                                 "const float*", "float*", "const void*",
                                 "void*", "cudaStream_t"))
                   for p in params), params
        assert pk.ARGTYPES[name] == want, name


def test_build_targets_hopper_and_keys_on_the_source():
    flags = " ".join(pk.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    for name, (src, _) in pk.SOURCES.items():
        assert os.path.exists(os.path.join(pk.CSRC_DIR, src))
        path = pk.library_path(name)
        assert path.startswith(pk.BUILD_DIR) and path.endswith(".so")
        assert path == pk.library_path(name)
    # one library per source, whatever number of kernels it holds
    assert len({pk.library_path(n) for n in pk.SOURCES}) == \
        len({src for src, _ in pk.SOURCES.values()})


def test_cuda_sources_name_the_tpu_kernel_they_replace():
    for src, tpu_fn in (("frame_window.cu", "frame_window"),
                        ("overlap_add.cu", "overlap_add_normalize")):
        with open(os.path.join(pk.CSRC_DIR, src)) as f:
            text = f.read()
        assert f"avsep_tpu/ops/pallas_kernels.py::{tpu_fn}" in text
        assert 'extern "C"' in text


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(cuda_device):
    # both kernels are bit-exact by design: tolerance 0
    shapes = [(N_FFT, HOP, 4, 64)] + RAGGED
    for n_fft, hop, B, T in shapes:
        for extra in (0, 1):
            rs = np.random.RandomState(7 + extra)
            padded = torch.from_numpy(
                _padded(rs, B, (T - 1) * hop + extra, n_fft))
            n0 = pk.frame_window.launches
            got = pk.frame_window(padded.to(cuda_device), T, n_fft, hop)
            torch.cuda.synchronize()
            assert pk.frame_window.launches == n0 + 1
            ref = pk.frame_window_plain(padded, T, n_fft, hop)
            assert torch.equal(got.cpu(), ref), (n_fft, hop, B, T, extra)

        full_len = n_fft + hop * (T - 1)
        denom = istft_denominator(n_fft, hop, T)
        frames = ref * 3.0
        for clip in (True, False):
            m0 = pk.overlap_add_normalize.launches
            out = pk.overlap_add_normalize(frames.to(cuda_device), hop,
                                           full_len, denom, clip=clip)
            torch.cuda.synchronize()
            assert pk.overlap_add_normalize.launches == m0 + 1
            ref_o = pk.overlap_add_normalize_plain(
                frames, hop, full_len, torch.from_numpy(np.array(denom)),
                clip=clip)
            assert torch.equal(out.cpu(), ref_o), (n_fft, hop, B, T, clip)
