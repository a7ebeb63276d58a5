"""ImageNet normalization of RGB frames and clips, channels last.

The one statement of the arithmetic that the engine applies to frames and
clips (``engine.normalize_frames``) and that the motion stem's kernel
(``kernels.motion_stem``) does in its load from these same constants.
"""

from __future__ import annotations

import functools

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# uint8 -> [0, 1], as a multiplication in float32
UINT8_SCALE = 1.0 / 255.0


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """The ImageNet mean and std on ``device``, made once per device: a
    copy from the host inside a step would stop a CUDA graph's capture."""
    return (torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=device),
            torch.tensor(IMAGENET_STD, dtype=torch.float32, device=device))


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - ImageNet mean) / std for float RGB in [0, 1], channels last."""
    mean, std = _imagenet_stats(x.device)
    return (x - mean) / std


def normalize_frames(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized float32, on their device; float
    frames pass through unchanged."""
    if x.dtype == torch.uint8:
        return imagenet_normalize(x.float() * UINT8_SCALE)
    return x
