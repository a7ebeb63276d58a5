"""The port's STFT / iSTFT (avsep_tpu_torch/ops/stft.py) against the JAX
package's, on the same numpy inputs, for each DFT mode.

Tolerances, relative to the largest magnitude of the compared output:
* fft and matmul: both sides are float32 transforms of float32 frames
  (pocketfft or a GEMM in torch, XLA's on the JAX side); they differ only in
  summation order, 2e-6.
* matmul_fast: the port rounds both operands to bfloat16 and accumulates in
  float32 on every device, while XLA on the CPU ignores the JAX package's
  DEFAULT precision and runs float32.  So it is held, at 2e-6, to a numpy
  product of the same bfloat16-rounded operands, and to the fft path at
  2**-7, the relative size of bfloat16 rounding (8 mantissa bits).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch.ops import stft as ps

# the module, not the function that avsep_tpu.ops re-exports under its name
js = importlib.import_module("avsep_tpu.ops.stft")
N_FFT, HOP = 1022, 256


def _audio(seed, B=2, L=32 * HOP - 1):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, L) * 0.2).astype(np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(
        np.asarray(b)).max()


def _bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dft", ["fft", "matmul"])
def test_stft_matches_jax(dft):
    x = _audio(0)
    ref = np.asarray(js.stft(jnp.asarray(x), N_FFT, HOP, dft=dft))
    got = ps.stft(torch.from_numpy(x), N_FFT, HOP, dft=dft).numpy()
    assert got.shape == ref.shape == (2, N_FFT // 2 + 1, 32)
    assert got.dtype == np.complex64
    assert _rel(got, ref) < 2e-6


def test_stft_matches_jax_pallas_path_in_interpret_mode():
    x = _audio(1)
    ref = np.asarray(js.stft(jnp.asarray(x), N_FFT, HOP, use_pallas=True,
                             dft="matmul"))
    got = ps.stft(torch.from_numpy(x), N_FFT, HOP, dft="matmul").numpy()
    assert _rel(got, ref) < 2e-6


def test_stft_matmul_fast_is_bf16_operands_f32_accumulation():
    x = _audio(2, B=1)
    got = ps.stft(torch.from_numpy(x), N_FFT, HOP,
                  dft="matmul_fast").numpy()
    # numpy reference: same framing, bf16-rounded operands, float64 sums
    padded = np.pad(x, ((0, 0), (N_FFT // 2, N_FFT // 2)), mode="reflect")
    T = 1 + x.shape[-1] // HOP
    idx = np.arange(T)[:, None] * HOP + np.arange(N_FFT)[None]
    frames = _bf16(padded[:, idx] * js.hann_periodic(N_FFT))
    C, S = (_bf16(m).astype(np.float64) for m in js._rdft_mats(N_FFT))
    ref = (frames @ C + 1j * (frames @ S)).swapaxes(-1, -2)
    assert _rel(got, ref) < 2e-6
    fft = np.asarray(js.stft(jnp.asarray(x), N_FFT, HOP, dft="fft"))
    assert _rel(got, fft) < 2 ** -7


@pytest.mark.parametrize("dft", ["fft", "matmul", "matmul_fast"])
def test_stft_magphase_matches_jax(dft):
    x = _audio(3)
    jmag, jph = js.stft_magphase(jnp.asarray(x), N_FFT, HOP, dft="fft")
    mag, ph = ps.stft_magphase(torch.from_numpy(x), N_FFT, HOP, dft=dft)
    tol = 2 ** -7 if dft == "matmul_fast" else 2e-6
    assert _rel(mag.numpy(), jmag) < tol
    # the phase through the spectrum it rebuilds (the angle alone is
    # ill-conditioned where the magnitude is near zero)
    got = mag.numpy() * np.exp(1j * ph.numpy())
    ref = np.asarray(jmag) * np.exp(1j * np.asarray(jph))
    assert _rel(got, ref) < tol


@pytest.mark.parametrize("dft", ["fft", "matmul", "matmul_fast"])
def test_istft_matches_jax(dft):
    x = _audio(4)
    spec = np.array(js.stft(jnp.asarray(x), N_FFT, HOP))
    jdft = "fft" if dft == "matmul_fast" else dft
    ref = np.asarray(js.istft(jnp.asarray(spec), HOP, dft=jdft))
    got = ps.istft(torch.from_numpy(spec), HOP, dft=dft).numpy()
    assert got.shape == ref.shape == (2, HOP * (spec.shape[-1] - 1))
    assert _rel(got, ref) < (2 ** -7 if dft == "matmul_fast" else 2e-6)


def test_istft_matches_jax_pallas_path_in_interpret_mode():
    x = _audio(5)
    spec = np.array(js.stft(jnp.asarray(x), N_FFT, HOP))
    ref = np.asarray(js.istft(jnp.asarray(spec), HOP, use_pallas=True))
    got = ps.istft(torch.from_numpy(spec), HOP).numpy()
    assert _rel(got, ref) < 2e-6


def test_stft_istft_round_trip():
    x = _audio(6)
    wav = ps.istft(ps.stft(torch.from_numpy(x), N_FFT, HOP), HOP).numpy()
    L = wav.shape[-1]
    np.testing.assert_allclose(wav, x[:, :L], atol=1e-5)


def test_istft_reconstruction_matches_jax():
    x = _audio(7) * 40.0   # loud enough that the clip bites
    mag, ph = js.stft_magphase(jnp.asarray(x), N_FFT, HOP)
    ref = np.asarray(js.istft_reconstruction(mag, ph, HOP))
    got = ps.istft_reconstruction(torch.from_numpy(np.array(mag)),
                                  torch.from_numpy(np.array(ph)),
                                  HOP).numpy()
    assert np.abs(ref).max() == 1.0
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("T", [1, 2, 256])
def test_istft_denominator_is_the_jax_numpy_one(T):
    d = ps.istft_denominator(N_FFT, HOP, T)
    window = js.hann_periodic(N_FFT)
    full_len = N_FFT + HOP * (T - 1)
    wss = np.zeros(full_len, np.float32)
    for t in range(T):
        wss[t * HOP: t * HOP + N_FFT] += (window ** 2).astype(np.float64)
    ref = np.where(wss > np.finfo(np.float32).tiny, wss, 1.0).astype(
        np.float32)
    np.testing.assert_array_equal(d, ref)
    assert ps.istft_denominator(N_FFT, HOP, T) is d
    assert not d.flags.writeable


@pytest.mark.parametrize("shape", [(3, 100), (2, 2, 50)])
def test_reflect_pad_matches_numpy(shape):
    x = np.random.RandomState(8).randn(*shape).astype(np.float32)
    got = ps._reflect_pad(torch.from_numpy(x), 7).numpy()
    ref = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(7, 7)], mode="reflect")
    np.testing.assert_array_equal(got, ref)


def test_frame_signal_and_overlap_add_match_jax():
    rs = np.random.RandomState(9)
    padded = rs.randn(2, 20 * HOP).astype(np.float32)
    ref = np.asarray(js.frame_signal(jnp.asarray(padded), 17, N_FFT, HOP))
    got = ps.frame_signal(torch.from_numpy(padded), 17, N_FFT, HOP).numpy()
    np.testing.assert_array_equal(got, ref)
    out_len = N_FFT + HOP * 16
    ref = np.asarray(js.overlap_add(jnp.asarray(ref), HOP, out_len))
    got = ps.overlap_add(torch.from_numpy(got), HOP, out_len).numpy()
    np.testing.assert_array_equal(got, ref)


def test_unknown_dft_mode_raises():
    with pytest.raises(ValueError):
        ps.stft(torch.zeros(1, 2000), N_FFT, HOP, dft="dct")
