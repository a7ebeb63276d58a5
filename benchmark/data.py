"""Seeded inputs, made on the device: a pool of MUSIC-shaped clips, and
the training batches and service requests drawn from it.

A clip is one instrument's ``audLen`` samples at ``audRate`` and one RGB
frame of ``imgSize`` x ``imgSize``.  Its sound is a harmonic tone (a
fundamental drawn log-uniform over the range of the MUSIC instruments,
six partials with decaying random amplitudes and phases) under a slow
tremolo, with a little noise; its frame is a smooth random colour field.
So the masks of a mixture of two clips have structure, as real ones do.

A configuration whose visual stream is video (``load_clips``) also gets a
video clip of ``clip_len`` frames per pool entry: a smooth colour field
of a few plane waves, translated by a drawn velocity from frame to frame,
so consecutive frames differ and the temporal kernels see motion.  Its
draws come after every other draw of the pool, so the audio and the
frames are the same with or without clips.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

HARMONICS = 6
F0_HZ = (80.0, 1000.0)
# a video clip: plane waves of these spatial frequencies (cycles per image
# width), moving at these speeds (image widths per frame)
CLIP_WAVES = 4
CLIP_CYCLES = (0.5, 3.0)
CLIP_SPEED = (0.01, 0.03)
# float elements of one [clips, waves, T, H, W] intermediate of a chunk
CLIP_CHUNK_ELEMS = 2 ** 25


def make_pool(n_clips: int, aud_len: int, aud_rate: int, img: int,
              generator: torch.Generator, device,
              clip_len: int = 0) -> Dict[str, torch.Tensor]:
    """``audio [n, aud_len]`` float32 in about [-0.5, 0.5] and ``frames
    [n, img, img, 3]`` uint8, drawn from ``generator`` in a few calls;
    with ``clip_len`` above 0 also ``clips [n, clip_len, img, img, 3]``
    uint8, entry ``i`` the video of the source whose sound is
    ``audio[i]``."""
    g, dev = generator, device
    f0 = torch.exp(math.log(F0_HZ[0]) + (math.log(F0_HZ[1] / F0_HZ[0]))
                   * torch.rand(n_clips, 1, generator=g, device=dev))
    k = torch.arange(1, HARMONICS + 1, device=dev, dtype=torch.float32)
    amp = torch.rand(n_clips, HARMONICS, generator=g, device=dev) / k
    phase = 2 * math.pi * torch.rand(n_clips, HARMONICS, generator=g,
                                     device=dev)
    trem = torch.rand(n_clips, 2, generator=g, device=dev)
    t = torch.arange(aud_len, device=dev, dtype=torch.float32) / aud_rate
    audio = torch.zeros(n_clips, aud_len, device=dev)
    for h in range(HARMONICS):
        audio += amp[:, h:h + 1] * torch.sin(
            2 * math.pi * f0 * (h + 1) * t + phase[:, h:h + 1])
    audio *= 1.0 + 0.5 * torch.sin(2 * math.pi * (0.5 + 3.5 * trem[:, :1])
                                   * t + 2 * math.pi * trem[:, 1:])
    audio /= audio.abs().amax(dim=1, keepdim=True).clamp_min(1e-6) * 2.0
    audio += 0.01 * torch.randn(n_clips, aud_len, generator=g, device=dev)
    low = torch.rand(n_clips, 3, 8, 8, generator=g, device=dev)
    frames = torch.nn.functional.interpolate(
        low, size=(img, img), mode="bilinear", align_corners=False)
    frames = (frames * 255.0).round().clamp(0, 255).to(torch.uint8)
    pool = {"audio": audio.contiguous(),
            "frames": frames.permute(0, 2, 3, 1).contiguous()}
    if clip_len > 0:
        pool["clips"] = make_clips(n_clips, clip_len, img, g, dev)
    return pool


def make_clips(n_clips: int, clip_len: int, img: int,
               generator: torch.Generator, device) -> torch.Tensor:
    """``[n, clip_len, img, img, 3]`` uint8 video clips: per clip and
    channel, 0.5 plus a sum of :data:`CLIP_WAVES` plane waves (random
    frequency, direction, amplitude and phase) over ``sqrt(waves)``,
    translated by the clip's velocity each frame.  Every parameter is
    drawn at once; the clips are rendered a chunk at a time, so the float
    intermediates stay small whatever ``n_clips`` is."""
    g, dev, m = generator, device, CLIP_WAVES
    cycles = CLIP_CYCLES[0] + (CLIP_CYCLES[1] - CLIP_CYCLES[0]) * torch.rand(
        n_clips, m, generator=g, device=dev)
    angle = 2 * math.pi * torch.rand(n_clips, m, generator=g, device=dev)
    amp = torch.rand(n_clips, m, 3, generator=g, device=dev)
    phase = 2 * math.pi * torch.rand(n_clips, m, 3, generator=g, device=dev)
    speed = CLIP_SPEED[0] + (CLIP_SPEED[1] - CLIP_SPEED[0]) * torch.rand(
        n_clips, 1, generator=g, device=dev)
    heading = 2 * math.pi * torch.rand(n_clips, 1, generator=g, device=dev)
    kx, ky = cycles * torch.cos(angle), cycles * torch.sin(angle)
    # the wave's phase moves by -2 pi k.v per frame
    drift = -2 * math.pi * (kx * torch.cos(heading)
                            + ky * torch.sin(heading)) * speed
    pos = torch.arange(img, device=dev, dtype=torch.float32) / img
    t = torch.arange(clip_len, device=dev, dtype=torch.float32)
    out = torch.empty(n_clips, clip_len, img, img, 3, dtype=torch.uint8,
                      device=dev)
    chunk = max(1, CLIP_CHUNK_ELEMS // (m * clip_len * img * img))
    for a in range(0, n_clips, chunk):
        s = slice(a, min(a + chunk, n_clips))

        def col(v):
            return v[s][:, :, None, None, None]      # [c, m, 1, 1, 1]
        arg = (2 * math.pi * (col(kx) * pos[None, None, None, None, :]
                              + col(ky) * pos[None, None, None, :, None])
               + col(drift) * t[None, None, :, None, None])  # [c, m, T, H, W]
        field = torch.stack([
            (amp[s, :, c, None, None, None]
             * torch.cos(arg + phase[s, :, c, None, None, None])).sum(1)
            for c in range(3)], dim=-1)
        field = 0.5 + field / (2.0 * math.sqrt(m))
        out[s] = (field * 255.0).round().clamp(0, 255).to(torch.uint8)
    return out


def source_indices(n_clips: int, rows: int, n_src: int,
                   generator: torch.Generator, device) -> torch.Tensor:
    """``[rows, n_src]`` pool indices, the sources of a row all different."""
    first = torch.randint(n_clips, (rows, 1), generator=generator,
                          device=device)
    step = 1 + torch.randint(n_clips - 1, (rows, n_src - 1),
                             generator=generator, device=device)
    return torch.cat([first, (first + torch.cumsum(step, 1)) % n_clips], 1) \
        if n_src > 1 else first


def distinct_indices(n_clips: int, rows: int, n_src: int, count: int,
                     generator: torch.Generator, device):
    """``count`` index tables of ``[rows, n_src]`` in which no clip comes
    twice: the batches whose results the reference follows."""
    need = count * rows * n_src
    if need > n_clips:
        raise ValueError(f"a pool of {n_clips} clips cannot give {count} "
                         f"batches of {rows} x {n_src} distinct clips")
    perm = torch.randperm(n_clips, generator=generator, device=device)
    return [perm[i * rows * n_src:(i + 1) * rows * n_src].view(rows, n_src)
            for i in range(count)]


def visual_stream(flags: Dict) -> str:
    """The batch key an audio-visual step of a configuration reads:
    ``clips`` under ``fusion_type CoLoc_ClipAtt`` (the motion net over
    video), ``frames`` otherwise."""
    return "clips" if flags["fusion_type"] == "CoLoc_ClipAtt" else "frames"


def train_batch(pool: Dict[str, torch.Tensor], idx: torch.Tensor,
                use_vis: bool, stream: str = "frames"
                ) -> Dict[str, torch.Tensor]:
    """A training batch as the port's loader hands it to a step: ``audios
    [B, N, L]`` already scaled by 1/N (their sum is the mixture) and, for
    an audio-visual step, the ``stream`` the step reads (the loader drops
    the other): uint8 ``frames [B, N, 1, H, W, 3]`` or ``clips [B, N, T,
    H, W, 3]``."""
    n_src = idx.shape[1]
    batch = {"audios": pool["audio"][idx] / n_src}
    if use_vis:
        batch[stream] = pool["clips"][idx] if stream == "clips" \
            else pool["frames"][idx][:, :, None]
    return batch
