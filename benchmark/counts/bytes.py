"""Bytes each of the port's two kernels must move, from the shapes of a
launch: every input byte read once and every output byte written once,
whatever the kernel reads again.  The H100's 3.35 TB/s then gives the
least time a launch can take (both kernels are bound by bytes: a
multiply per element, or a few adds).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet
F32 = 4


def stft_frames(length: int, hop: int) -> int:
    return 1 + length // hop


def frame_window(rows: int, length: int, n_fft: int, hop: int) -> int:
    """Reflect-padded rows ``[rows, length + n_fft]`` and the window in,
    windowed frames ``[rows, T, n_fft]`` out (``csrc/frame_window.cu``)."""
    padded = length + 2 * (n_fft // 2)
    return F32 * (rows * padded + n_fft
                  + rows * stft_frames(length, hop) * n_fft)


def overlap_add(rows: int, frames: int, n_fft: int, hop: int) -> int:
    """Frames ``[rows, T, n_fft]`` and the summed squared window in, the
    overlap-added rows ``[rows, n_fft + hop (T - 1)]`` out
    (``csrc/overlap_add.cu``)."""
    out_len = n_fft + hop * (frames - 1)
    return F32 * (rows * frames * n_fft + out_len + rows * out_len)


def least_seconds(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S
