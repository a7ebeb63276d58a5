"""Host audio IO: wav read, resample, crop, gain augment.

The port's own copy of ``avsep_tpu/data/audio_io.py``.  The reference loads
with ``librosa.load(path, sr=11025, mono=True, offset=o, duration=d)``
(reference ``dataset/base.py:149-154``); here wavs are read with the
standard library's ``wave`` module and resampled with a polyphase filter
(``scipy.signal.resample_poly``), and the crop / zero-pad / gain / clamp of
``_load_audio`` (``dataset/base.py:156-172``) are reproduced exactly.  The
wav probe and read-crop go through the C++ host library (``data/native.py``)
when it builds, as the JAX package's do, which also reads the float32 and
24-bit files ``wave`` rejects.
"""

from __future__ import annotations

import wave
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np

from avsep_tpu_torch.data import native


def read_wav(path: str, offset_sec: float = 0.0,
             duration_sec: Optional[float] = None
             ) -> Tuple[np.ndarray, int]:
    """Read (a slice of) a wav file as float32 mono in [-1, 1]: with the C++
    reader when it built, else with the standard library's ``wave``."""
    if native.native_available():
        probe = native.wav_probe(path)
        if probe is not None:
            sr, n_frames = probe
            start = max(0, int(offset_sec * sr))
            if duration_sec is None:
                count = max(n_frames - start, 0)
            else:
                count = int(duration_sec * sr)
            got = native.wav_read_crop(path, start, min(count, 2 ** 31))
            if got is not None:
                return got[0], sr
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_ch = w.getnchannels()
        sw = w.getsampwidth()
        n_frames = w.getnframes()
        start = max(0, int(offset_sec * sr))
        if duration_sec is None:
            count = n_frames - start
        else:
            count = min(int(duration_sec * sr), n_frames - start)
        count = max(count, 0)
        w.setpos(min(start, n_frames))
        raw = w.readframes(count)

    if sw == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sw == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif sw == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 2 ** 23, ints - 2 ** 24, ints)
        data = ints.astype(np.float32) / float(2 ** 23)
    else:
        raise ValueError(f"unsupported sample width {sw}")

    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    return data, sr


def resample(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    if sr_in == sr_out:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly
    frac = Fraction(sr_out, sr_in).limit_denominator(1000)
    out = resample_poly(audio.astype(np.float64), frac.numerator,
                        frac.denominator)
    return out.astype(np.float32)


def load_audio_crop(path: str, center_t: float, *, aud_len: int,
                    aud_rate: int, margin: float, rng=None,
                    train: bool = False) -> np.ndarray:
    """Crop ``aud_len`` samples centered at ``center_t`` seconds.

    Reference ``_load_audio`` (dataset/base.py:156-172): load
    [center - margin - audSec/2, +duration], take the centered window,
    zero-pad to aud_len, gain-augment x[0.5, 1.5) in train, clamp to [-1, 1].
    """
    aud_sec = aud_len / aud_rate
    offset = center_t - margin - aud_sec / 2
    duration = margin * 2 + aud_sec

    read_from = max(offset, 0.0)
    raw, sr = read_wav(path, read_from, duration)
    raw = resample(raw, sr, aud_rate)

    audio = np.zeros(aud_len, np.float32)
    # the crop's center inside the buffer actually read: when the left
    # context is clamped at t = 0, a fixed (margin + audSec/2) index would
    # shift the window late and desync the audio from the frames
    center_idx = int((center_t - read_from) * aud_rate)
    start = max(0, center_idx - aud_len // 2)
    end = min(len(raw), center_idx + aud_len // 2 + aud_len % 2)
    if end > start:
        audio[: end - start] = raw[start:end]

    if train and rng is not None:
        audio *= rng.random() + 0.5  # gain in [0.5, 1.5)
    np.clip(audio, -1.0, 1.0, out=audio)
    return audio


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """PCM-16 wav writer (stands in for soundfile; reference uses
    sf.write / librosa.output.write_wav, utils.py:218-219)."""
    pcm = np.clip(np.asarray(audio, np.float64), -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
