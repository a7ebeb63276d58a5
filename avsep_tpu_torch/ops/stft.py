"""Batched STFT / iSTFT with librosa semantics, in PyTorch.

Port of ``avsep_tpu/ops/stft.py``.  The semantics are librosa's
(``librosa.stft(y, n_fft=1022, hop_length=256)`` / ``librosa.istft``):

* window: periodic Hann of length ``n_fft``;
* ``center=True``: reflect padding by ``n_fft // 2`` on both sides;
* frame count ``1 + len(y) // hop`` (65535 samples -> 256 frames);
* iSTFT: windowed overlap-add normalized by the summed squared window,
  trimmed by ``n_fft // 2`` at both ends (65280 samples for 256 frames).

The framing (head of the STFT) and the overlap-add with normalization (tail
of the iSTFT) are the two kernels of ``ops/kernels.py``: on a CUDA tensor
they launch the hand-written CUDA kernels, on a CPU tensor their plain
versions, which are built from :func:`frame_signal` and :func:`overlap_add`
below.

DFT modes (``dft``), each in float32 in and out:

* ``"fft"``: ``torch.fft.rfft`` / ``irfft`` in float32 (cuFFT on the card,
  pocketfft on the CPU).
* ``"matmul"``: one GEMM each for the real and the imaginary part against
  the float32 cos/sin matrices of :func:`_rdft_mats` / :func:`_irdft_mats`.
  Full float32 as long as ``torch.backends.cuda.matmul.allow_tf32`` is False,
  which is PyTorch's default; this module does not change that flag.
* ``"matmul_fast"``: the same GEMMs with both operands rounded to bfloat16
  and the products accumulated in float32 (the products of two bfloat16
  values are exact in float32, so this is a bf16-operand, f32-accumulate
  product on any device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

DFT_MODES = ("fft", "matmul", "matmul_fast")


def hann_periodic(n: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window, identical to scipy ``get_window('hann', n)``."""
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _rdft_mats(n_fft: int):
    """cos/sin forward real-DFT matrices ``[n_fft, F]`` (float32)."""
    F_ = n_fft // 2 + 1
    ang = (-2.0 * np.pi / n_fft) * np.arange(n_fft)[:, None] \
        * np.arange(F_)[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _irdft_mats(n_fft: int):
    """Inverse real-DFT matrices ``[F, n_fft]`` such that
    ``x = Re(spec) @ A + Im(spec) @ B`` reproduces ``irfft(spec, n_fft)``
    (bin 0 and, for even n_fft, the Nyquist bin carry weight 1/n and their
    imaginary parts are discarded, as numpy's irfft does)."""
    F_ = n_fft // 2 + 1
    ang = (2.0 * np.pi / n_fft) * np.arange(F_)[:, None] \
        * np.arange(n_fft)[None, :]
    c = np.full((F_, 1), 2.0 / n_fft)
    c[0, 0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0 / n_fft
    A = (c * np.cos(ang)).astype(np.float32)
    B = (-c * np.sin(ang)).astype(np.float32)
    B[0] = 0.0
    if n_fft % 2 == 0:
        B[-1] = 0.0
    return A, B


@functools.lru_cache(maxsize=None)
def _dft_tensors(inverse: bool, n_fft: int, dft: str,
                 device: torch.device):
    """The DFT matrix pair for ``dft`` on ``device``, cached for the life of
    the process (a few MiB per device and size)."""
    mats = _irdft_mats(n_fft) if inverse else _rdft_mats(n_fft)
    out = [torch.from_numpy(m).to(device) for m in mats]
    if dft == "matmul_fast":
        out = [m.to(torch.bfloat16).float() for m in out]
    return tuple(out)


def _check_dft(dft: str) -> None:
    if dft not in DFT_MODES:
        raise ValueError(f"dft must be one of {DFT_MODES}; got {dft!r}")


def _rdft(frames: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    """``frames [..., T, n_fft]`` -> complex ``[..., T, F]`` by GEMM."""
    C, S = _dft_tensors(False, n_fft, dft, frames.device)
    if dft == "matmul_fast":
        frames = frames.to(torch.bfloat16).float()
    return torch.complex(torch.matmul(frames, C), torch.matmul(frames, S))


def _irdft(spec_tf: torch.Tensor, n_fft: int, dft: str) -> torch.Tensor:
    """complex ``spec [..., T, F]`` -> real frames ``[..., T, n_fft]``."""
    A, B = _dft_tensors(True, n_fft, dft, spec_tf.device)
    re, im = spec_tf.real, spec_tf.imag
    if dft == "matmul_fast":
        re, im = re.to(torch.bfloat16).float(), im.to(torch.bfloat16).float()
    return torch.matmul(re, A) + torch.matmul(im, B)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect padding of the last axis (no edge repeat), as
    ``np.pad(mode='reflect')``."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])
    return F.pad(flat, (pad, pad), mode="reflect").reshape(
        lead + (x.shape[-1] + 2 * pad,))


def frame_signal(padded: torch.Tensor, n_frames: int, n_fft: int,
                 hop: int) -> torch.Tensor:
    """``padded [..., L']`` -> frames ``[..., T, n_fft]`` (no window).

    The hop-block formulation of the JAX package: reshape into hop-blocks
    and concatenate K = ceil(n_fft / hop) consecutive blocks per frame.
    Samples past the end of ``padded`` read as zeros.
    """
    K = -(-n_fft // hop)
    need = (n_frames + K) * hop
    extra = need - padded.shape[-1]
    if extra > 0:
        padded = F.pad(padded, (0, extra))
    blocks = padded[..., :need].reshape(padded.shape[:-1] + (-1, hop))
    parts = [blocks[..., m:m + n_frames, :] for m in range(K)]
    return torch.cat(parts, dim=-1)[..., :n_fft]


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """``frames [..., T, n_fft]`` -> ``[..., out_len]`` by K shifted adds.

    Chunk m of frame t lands in output hop-block t + m; the adds run in
    ascending m, starting from zeros, as in the JAX package.
    """
    n_fft = frames.shape[-1]
    T = frames.shape[-2]
    K = -(-n_fft // hop)
    pad_tail = K * hop - n_fft
    if pad_tail:
        frames = F.pad(frames, (0, pad_tail))
    chunks = frames.reshape(frames.shape[:-1] + (K, hop))  # [..., T, K, hop]
    nb = T + K - 1
    out = frames.new_zeros(frames.shape[:-2] + (nb, hop))
    for m in range(K):
        out[..., m:m + T, :] += chunks[..., :, m, :]
    flat = out.reshape(frames.shape[:-2] + (nb * hop,))
    return flat[..., :out_len]


@functools.lru_cache(maxsize=None)
def istft_denominator(n_fft: int, hop: int, T: int) -> np.ndarray:
    """Summed squared window over ``T`` frames, with librosa's
    ``finfo(float32).tiny`` threshold (zero sums become 1).

    Computed in numpy exactly as the JAX package does (float64 window
    squares added into a float32 buffer), cached per ``(n_fft, hop, T)``
    and returned read-only.
    """
    window = hann_periodic(n_fft)
    full_len = n_fft + hop * (T - 1)
    wss = np.zeros(full_len, np.float32)
    w2 = (window ** 2).astype(np.float64)
    for t in range(T):
        wss[t * hop: t * hop + n_fft] += w2
    tiny = np.finfo(np.float32).tiny
    denom = np.where(wss > tiny, wss, 1.0).astype(np.float32)
    denom.setflags(write=False)
    return denom


@functools.lru_cache(maxsize=None)
def _denom_tensor(n_fft: int, hop: int, T: int,
                  device: torch.device) -> torch.Tensor:
    return torch.from_numpy(istft_denominator(n_fft, hop, T).copy()).to(
        device)


@functools.lru_cache(maxsize=None)
def _window_tensor(n_fft: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(hann_periodic(n_fft)).to(device)


def stft(audio: torch.Tensor, n_fft: int = 1022, hop: int = 256,
         dft: str = "fft") -> torch.Tensor:
    """Batched STFT of ``audio [..., L]`` -> complex64 ``[..., F, T]``.

    F = n_fft // 2 + 1, T = 1 + L // hop.  See the module docstring for the
    precision of each ``dft`` mode.
    """
    from avsep_tpu_torch.ops.kernels import frame_window
    _check_dft(dft)
    L = audio.shape[-1]
    n_frames = 1 + L // hop
    padded = _reflect_pad(audio.float(), n_fft // 2)
    batch_shape = padded.shape[:-1]
    flat = padded.reshape(-1, padded.shape[-1]).contiguous()
    frames = frame_window(flat, n_frames, n_fft, hop)
    frames = frames.reshape(batch_shape + frames.shape[1:])
    if dft == "fft":
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1)   # [..., T, F]
    else:
        spec = _rdft(frames, n_fft, dft)
    return spec.transpose(-1, -2)                        # [..., F, T]


def stft_magphase(audio: torch.Tensor, n_fft: int = 1022, hop: int = 256,
                  dft: str = "fft"):
    """Magnitude and phase like the reference ``_stft``
    (reference ``dataset/base.py:142-147``)."""
    spec = stft(audio, n_fft=n_fft, hop=hop, dft=dft)
    return spec.abs(), spec.angle()


def istft(spec: torch.Tensor, hop: int = 256,
          dft: str = "fft") -> torch.Tensor:
    """Batched inverse STFT of complex ``spec [..., F, T]`` -> ``[..., L]``.

    Matches ``librosa.istft(spec, hop_length=256)``: windowed overlap-add
    normalized by the summed squared window, trimmed by ``n_fft // 2`` at
    both ends.  Output length ``hop * (T - 1)``.
    """
    from avsep_tpu_torch.ops.kernels import overlap_add_normalize
    _check_dft(dft)
    F_, T = spec.shape[-2], spec.shape[-1]
    n_fft = 2 * (F_ - 1)
    pad = n_fft // 2

    spec_tf = spec.transpose(-1, -2)
    if dft == "fft":
        frames = torch.fft.irfft(spec_tf, n=n_fft, dim=-1)
    else:
        frames = _irdft(spec_tf, n_fft, dft)
    frames = frames * _window_tensor(n_fft, frames.device)  # [..., T, n_fft]

    full_len = n_fft + hop * (T - 1)
    denom = _denom_tensor(n_fft, hop, T, frames.device)
    batch_shape = spec.shape[:-2]
    flat = frames.reshape(-1, T, n_fft).float().contiguous()
    out = overlap_add_normalize(flat, hop, full_len, denom, clip=False)
    out = out.reshape(batch_shape + (full_len,))
    return out[..., pad: full_len - pad]


def istft_reconstruction(mag: torch.Tensor, phase: torch.Tensor,
                         hop: int = 256) -> torch.Tensor:
    """Waveform from magnitude and phase, clipped to [-1, 1]
    (reference ``utils.py:101-104``), batched."""
    spec = mag.to(torch.complex64) * torch.exp(1j * phase.to(torch.complex64))
    return torch.clamp(istft(spec, hop=hop), -1.0, 1.0)
