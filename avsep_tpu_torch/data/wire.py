"""The int16 audio wire, host side: about half the host->device audio bytes.

The port's own copy of ``encode_audio_wire`` (``avsep_tpu/data/wire.py:
28-48``).  ``--audio_wire int16`` re-encodes the per-source waveforms at
the device boundary as

    audios_i16 [B, N, L] int16  +  audio_gain [B, N] float32

with ``gain = max|x| / 32767`` per (clip, source).  The device side,
``engine.audios_of``, dequantizes.  This is lossy (about 90 dB SNR against
each source's peak) and so opt-in; the default ``f32`` wire is exact.  The
mixture is rebuilt on the device from the dequantized sources
(``engine.audio_mix_of``), so masks and metrics see the same sources.
"""

from typing import Dict

import numpy as np

WIRE_KINDS = ("f32", "int16")


def encode_audio_wire(dev: Dict, cfg) -> Dict:
    """Replace float32 ``audios`` with int16 samples and per-source gains.

    No-op unless ``cfg.audio_wire == "int16"`` and the batch carries
    ``audios``.  numpy only: it runs in the loader or prefetch thread.
    """
    if cfg.audio_wire not in WIRE_KINDS:
        raise ValueError(f"audio_wire must be one of {WIRE_KINDS}, "
                         f"got {cfg.audio_wire!r}")
    if cfg.audio_wire != "int16" or "audios" not in dev:
        return dev
    a = np.asarray(dev["audios"], np.float32)          # [B, N, L]
    # a silent source gets the gain 1e-8/32767 (not 0), so it dequantizes
    # to exact zeros
    gain = np.maximum(np.abs(a).max(axis=-1), 1e-8) / 32767.0
    q = np.rint(a / gain[..., None]).astype(np.int16)
    out = dict(dev)
    del out["audios"]
    out["audios_i16"] = q
    out["audio_gain"] = gain.astype(np.float32)
    return out
