"""Model factory and activation dispatcher.

Port of ``avsep_tpu/models/builder.py`` (reference ``models/__init__.py``,
``ModelBuilder`` / ``activate``) for the nets of the separation path.
"""

from __future__ import annotations

import torch

from avsep_tpu_torch.models.resnet import FrameEncoder, TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet


def activate(x: torch.Tensor, activation: str,
             upcast: bool = True) -> torch.Tensor:
    """Activation dispatcher (reference models/__init__.py:16-28).

    ``upcast=True`` casts to float32 first, the mixed-precision boundary of
    the JAX package at every output-side call site; feature-path call
    sites pass ``upcast=False``.  The port runs in float32, where both are
    the same.
    """
    if upcast:
        x = x.float()
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    if activation == "relu":
        return torch.relu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "no":
        return x
    raise ValueError("Unknown activation!")


_UNET_DOWNS = {"unet5": 5, "unet6": 6, "unet7": 7}


class ModelBuilder:
    """Builds the sound U-Net and the frame encoder from config strings
    (reference models/__init__.py:31-132)."""

    @staticmethod
    def build_sound(arch: str = "unet5", fc_dim: int = 64,
                    fusion_type: str = "hidsep", att_type: str = "cos",
                    num_sources: int = 2, att_temp: float = 1.0
                    ) -> AudioUnet:
        if arch not in _UNET_DOWNS:
            raise ValueError("Architecture undefined!")
        return AudioUnet(fc_dim=fc_dim, num_downs=_UNET_DOWNS[arch],
                         fusion_type=fusion_type, att_type=att_type,
                         num_sources=num_sources, att_temp=att_temp)

    @staticmethod
    def build_frame(arch: str = "resnet18dilated", fc_dim: int = 64,
                    pool_type: str = "avgpool"):
        if arch == "resnet18fc":
            return FrameEncoder(fc_dim=fc_dim, pool_type=pool_type,
                                dilate_scale=0)
        if arch == "resnet18dilated":
            return FrameEncoder(fc_dim=fc_dim, pool_type=pool_type,
                                dilate_scale=16)
        if arch == "tinyconv":
            return TinyConvEncoder(fc_dim=fc_dim, pool_type=pool_type)
        raise ValueError("Architecture undefined!")
