"""ResNet18 frame encoders (plain and dilated).

Port of ``avsep_tpu/models/resnet.py`` (reference ``models/vision_net.py``):
a torchvision ResNet18 truncated before the classifier, then a 3x3 conv
projecting 512 -> ``fc_dim`` channels, with

* ``dilate_scale=0`` (``ResnetFC``, vision_net.py:20-68): stride 32, 7x7 maps
  at 224x224;
* ``dilate_scale=16`` (``ResnetDilated``, vision_net.py:71-147): layer4's
  stride turned into dilation, stride 16, 14x14 maps at 224x224;
* multi-frame input (``forward_multiframe``, vision_net.py:126-147): B*T
  frames through the 2-D CNN, then the temporal mean (``pool=False``, the
  spatial map CoLoc attends over) or global max/avg pooling to a vector;
* ``TinyConvEncoder``: the JAX package's three-block bring-up encoder
  (``--arch_frame tinyconv``) under the same contract.

The convolutions run NCHW; the public interface keeps the JAX package's
NHWC (frames ``[B, H, W, 3]`` or ``[B, T, H, W, 3]`` in, maps
``[B, h, w, fc_dim]`` or vectors ``[B, fc_dim]`` out).  Submodules carry the
JAX package's names (``features.layer4_0.conv1``, ``fc``, ...).  ``dtype``
is the compute dtype of every conv and BatchNorm (``models/layers.py``);
the parameters stay float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsep_tpu_torch.models.layers import (
    BatchNorm, Conv2d, he_normal_init_, reset_batchnorm_)


def _bn(features: int, dtype: torch.dtype) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, eps=1e-5, compute_dtype=dtype)


class BasicBlock(nn.Module):
    """ResNet v1 basic block: 3x3 conv-bn-relu x2 + identity or a 1x1
    downsample."""

    def __init__(self, in_features: int, features: int, strides: int = 1,
                 dilation: int = 1, first_dilation: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d1, d2 = first_dilation, dilation
        self.conv1 = Conv2d(in_features, features, 3, stride=strides,
                            padding=d1, dilation=d1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(features, dtype)
        self.conv2 = Conv2d(features, features, 3, padding=d2, dilation=d2,
                            bias=False, compute_dtype=dtype)
        self.bn2 = _bn(features, dtype)
        self.has_downsample = strides != 1 or in_features != features
        if self.has_downsample:
            self.downsample_conv = Conv2d(in_features, features, 1,
                                          stride=strides, bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = _bn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x
        if self.has_downsample:
            identity = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + identity)


class ResNet18Features(nn.Module):
    """torchvision resnet18 trunk (conv1..layer4), optionally dilated.

    ``dilate_scale=16`` applies the reference's ``_nostride_dilate`` surgery
    to layer4 (vision_net.py:96-109): the strided 3x3 conv loses its stride
    and keeps dilation 1 (dilate // 2), the later 3x3 convs get dilation 2;
    ``dilate_scale=8`` also dilates layer3.
    """

    def __init__(self, dilate_scale: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(64, dtype)
        # torch MaxPool2d pads with -inf, as the JAX package's max_pool
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)

        def layer(name, in_features, features, stride, dilate=0):
            if dilate:
                d_first, d_rest, stride = max(dilate // 2, 1), dilate, 1
            else:
                d_first = d_rest = 1
            self.add_module(f"{name}_0", BasicBlock(
                in_features, features, strides=stride, dilation=d_rest,
                first_dilation=d_first, dtype=dtype))
            self.add_module(f"{name}_1", BasicBlock(
                features, features, strides=1, dilation=d_rest,
                first_dilation=d_rest, dtype=dtype))

        layer("layer1", 64, 64, 1)
        layer("layer2", 64, 128, 2)
        layer("layer3", 128, 256, 2, dilate=2 if dilate_scale == 8 else 0)
        layer("layer4", 256, 512, 2, dilate={8: 4, 16: 2}.get(dilate_scale, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        for li in (1, 2, 3, 4):
            for bi in (0, 1):
                y = getattr(self, f"layer{li}_{bi}")(y)
        return y


class _FrameNet(nn.Module):
    """A trunk (``features``) + a 3x3 ``fc`` conv + the pooling modes.

    ``forward(frames, pool)`` takes [B, H, W, 3] single frames or
    [B, T, H, W, 3] multi-frame stacks.  pool=False -> spatial map
    [B, h, w, fc_dim] (temporal mean for stacks); pool=True -> global
    max/avg-pooled vector [B, fc_dim].  The names ``features`` and ``fc``
    are the optimizer's groups (``train.py``).
    """

    def __init__(self, features: nn.Module, trunk_dim: int, fc_dim: int,
                 pool_type: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pool_type = pool_type
        self.features = features
        self.fc = Conv2d(trunk_dim, fc_dim, 3, padding=1, bias=True,
                         compute_dtype=dtype)

    @torch.no_grad()
    def reset_parameters_(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) convs, zero conv biases, unit BatchNorm: the
        JAX package's init, drawn from ``generator`` in module order."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                he_normal_init_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                reset_batchnorm_(m)

    def forward(self, frames: torch.Tensor, pool: bool = True
                ) -> torch.Tensor:
        multiframe = frames.dim() == 5
        if multiframe:
            B, T = frames.shape[:2]
            x = frames.reshape((B * T,) + frames.shape[2:])
        else:
            x = frames
        y = self.fc(self.features(x.permute(0, 3, 1, 2)))   # NCHW
        y = y.permute(0, 2, 3, 1)                            # NHWC

        if multiframe:
            y = y.reshape((B, T) + y.shape[1:])
            if not pool:
                return torch.mean(y, dim=1)
            dims = (1, 2, 3)
        else:
            if not pool:
                return y
            dims = (1, 2)
        if self.pool_type == "maxpool":
            return torch.amax(y, dim=dims)
        return torch.mean(y, dim=dims)


class FrameEncoder(_FrameNet):
    """ResnetFC / ResnetDilated: the ResNet18 trunk + the 3x3 fc conv."""

    def __init__(self, fc_dim: int = 64, pool_type: str = "maxpool",
                 dilate_scale: int = 16, dtype: torch.dtype = torch.float32):
        super().__init__(ResNet18Features(dilate_scale, dtype), 512, fc_dim,
                         pool_type, dtype)


def _same_pad(size: int, kernel: int, stride: int):
    """Flax/XLA ``SAME`` padding of one spatial dim: ``(lo, hi)`` with the
    odd pixel at the end (stride 2, kernel 3 on an even size pads (0, 1))."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _TinyTrunk(nn.Module):
    """Three stride-2 3x3 conv (with bias) - BN - ReLU blocks, 16/32/64
    channels, ``SAME`` padding.  Submodules carry Flax's automatic names
    (``Conv_0``, ``BatchNorm_0``, ...), so the JAX parameter paths are the
    ``state_dict`` keys.  The BNs keep Flax's default momentum, 0.99."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        cin = 3
        for i, ch in enumerate((16, 32, 64)):
            self.add_module(f"Conv_{i}", Conv2d(cin, ch, 3, stride=2,
                                                padding=0, bias=True,
                                                compute_dtype=dtype))
            self.add_module(f"BatchNorm_{i}", BatchNorm(
                ch, momentum=0.99, compute_dtype=dtype))
            cin = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(3):
            (t, b), (l, r) = (_same_pad(x.shape[2], 3, 2),
                              _same_pad(x.shape[3], 3, 2))
            x = getattr(self, f"Conv_{i}")(F.pad(x, (l, r, t, b)))
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class TinyConvEncoder(_FrameNet):
    """The JAX package's bring-up frame encoder (``--arch_frame tinyconv``,
    ``avsep_tpu/models/resnet.py:159-216``, no reference equivalent): the
    FrameEncoder contract with an 8x-downsampling three-block trunk."""

    def __init__(self, fc_dim: int = 64, pool_type: str = "maxpool",
                 dtype: torch.dtype = torch.float32):
        super().__init__(_TinyTrunk(dtype), 64, fc_dim, pool_type, dtype)
