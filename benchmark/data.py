"""Seeded inputs, made on the device: a pool of MUSIC-shaped clips, and
the training batches and service requests drawn from it.

A clip is one instrument's ``audLen`` samples at ``audRate`` and one RGB
frame of ``imgSize`` x ``imgSize``.  Its sound is a harmonic tone (a
fundamental drawn log-uniform over the range of the MUSIC instruments,
six partials with decaying random amplitudes and phases) under a slow
tremolo, with a little noise; its frame is a smooth random colour field.
So the masks of a mixture of two clips have structure, as real ones do.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

HARMONICS = 6
F0_HZ = (80.0, 1000.0)


def make_pool(n_clips: int, aud_len: int, aud_rate: int, img: int,
              generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """``audio [n, aud_len]`` float32 in about [-0.5, 0.5] and ``frames
    [n, img, img, 3]`` uint8, drawn from ``generator`` in a few calls."""
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
    return {"audio": audio.contiguous(),
            "frames": frames.permute(0, 2, 3, 1).contiguous()}


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


def train_batch(pool: Dict[str, torch.Tensor], idx: torch.Tensor,
                use_vis: bool) -> Dict[str, torch.Tensor]:
    """A training batch as the port's loader hands it to a step: ``audios
    [B, N, L]`` already scaled by 1/N (their sum is the mixture) and, for
    an audio-visual step, uint8 ``frames [B, N, 1, H, W, 3]``."""
    n_src = idx.shape[1]
    batch = {"audios": pool["audio"][idx] / n_src}
    if use_vis:
        batch["frames"] = pool["frames"][idx][:, :, None]
    return batch
