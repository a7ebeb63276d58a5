"""Model factory and activation dispatcher.

Port of ``avsep_tpu/models/builder.py`` (reference ``models/__init__.py``,
``ModelBuilder`` / ``activate``).  Each ``build_*`` takes the compute
``dtype`` (``torch.float32`` or ``torch.bfloat16``), as the JAX package's
does; the parameters are float32 either way.
"""

from __future__ import annotations

import torch

from avsep_tpu_torch.models.motion import (
    ARCH_MOTIONS, ResNet3dFastOnly, ResNet3dSlowFast)
from avsep_tpu_torch.models.resnet import FrameEncoder, TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.models.x3d import X3D


def activate(x: torch.Tensor, activation: str,
             upcast: bool = True) -> torch.Tensor:
    """Activation dispatcher (reference models/__init__.py:16-28).

    ``upcast=True`` (every output-side call site: masks, losses, metrics)
    casts to float32 first, the JAX package's mixed-precision boundary.
    Under ``--dtype bfloat16`` a bfloat16 sigmoid saturates to exactly 1.0
    at logits of about 6 (its resolution near 1 is 2^-8), which would turn
    the BCE input clip at 1 - 1e-7 into a no-op and make the gradient of
    log(1 - p) inf * 0 = NaN; in float32 the loss and its gradient stay
    finite.  Feature-path call sites (the ReLU on the visual features, the
    SoP++ basis) pass ``upcast=False``: those tensors feed straight back
    into bfloat16 layers.  In float32 both are the same.
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
    """Builds the sound U-Net, the frame encoder and the motion net from
    config strings (reference models/__init__.py:31-132)."""

    @staticmethod
    def build_sound(arch: str = "unet5", fc_dim: int = 64,
                    fusion_type: str = "hidsep", att_type: str = "cos",
                    num_sources: int = 2, att_temp: float = 1.0,
                    dtype: torch.dtype = torch.float32) -> AudioUnet:
        if arch not in _UNET_DOWNS:
            raise ValueError("Architecture undefined!")
        return AudioUnet(fc_dim=fc_dim, num_downs=_UNET_DOWNS[arch],
                         fusion_type=fusion_type, att_type=att_type,
                         num_sources=num_sources, att_temp=att_temp,
                         dtype=dtype)

    @staticmethod
    def build_frame(arch: str = "resnet18dilated", fc_dim: int = 64,
                    pool_type: str = "avgpool",
                    dtype: torch.dtype = torch.float32):
        if arch == "resnet18fc":
            return FrameEncoder(fc_dim=fc_dim, pool_type=pool_type,
                                dilate_scale=0, dtype=dtype)
        if arch == "resnet18dilated":
            return FrameEncoder(fc_dim=fc_dim, pool_type=pool_type,
                                dilate_scale=16, dtype=dtype)
        if arch == "tinyconv":
            return TinyConvEncoder(fc_dim=fc_dim, pool_type=pool_type,
                                   dtype=dtype)
        raise ValueError("Architecture undefined!")

    @staticmethod
    def build_motion(arch: str = "slowfast_fast",
                     dtype: torch.dtype = torch.float32, fc_dim: int = 256):
        """``slowfast_fast``: the SlowFast fast pathway at base 8, ``[3, 4,
        6, 3]`` (reference models/__init__.py:94-118), whose 256 channels
        are the map; ``slowfast_r50``: both pathways with their laterals,
        projected to ``fc_dim`` channels; ``x3d_m``: X3D-M, projected to
        ``fc_dim`` channels (``models/x3d.py``)."""
        if arch == "slowfast_fast":
            return ResNet3dFastOnly(dtype=dtype)
        if arch == "slowfast_r50":
            return ResNet3dSlowFast(fc_dim=fc_dim, dtype=dtype)
        if arch == "x3d_m":
            return X3D(fc_dim=fc_dim, dtype=dtype)
        raise ValueError(f"Architecture undefined! --arch_motion {arch!r}: "
                         f"one of {ARCH_MOTIONS}")
