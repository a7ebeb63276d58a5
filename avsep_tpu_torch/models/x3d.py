"""X3D-M as the clip stream (``--arch_motion x3d_m``).

Feichtenhofer, "X3D: Expanding Architectures for Efficient Video
Recognition", CVPR 2020 (arXiv:2004.04730), as mmaction2 builds X3D-M
(``X3D(gamma_w=1, gamma_b=2.25, gamma_d=2.2)``,
``x3d_m_16x5x1_facebook-kinetics400-rgb.py``, 16 frames at 224x224):

* stem: ``conv1_s``, a 1x3x3 convolution 3 -> 24 at stride (1, 2, 2) with
  no norm and no activation, then ``conv1_t``, a 5x1x1 channelwise
  convolution (groups 24), ``bn1`` and ReLU;
* four stages of ``ceil(2.2 x (1, 2, 5, 3)) = (3, 5, 11, 7)`` blocks
  (:class:`BlockX3D`) to 24, 48, 96 and 192 channels, inner widths
  ``int(2.25 x out)`` = 54, 108, 216, 432, spatial stride 2 in each
  stage's first block and no temporal stride;
* ``conv5``, 1x1x1 192 -> 432, ``bn5`` and ReLU;
* the map's mean over time, then ``fc``, a 3x3 convolution with bias from
  432 channels to ``fc_dim`` (the fusion's channels), as
  ``ResNet3dSlowFast``'s ``fc``.

A block: ``conv1`` 1x1x1 with BatchNorm and ReLU; ``conv2`` 3x3x3
channelwise at stride (1, s, s) with BatchNorm and no activation; in
blocks 0, 2, 4, ... of a stage (mmaction2's ``se_style='half'``) a
squeeze-excitation gate (:class:`SEModule`); swish; ``conv3`` 1x1x1 with
BatchNorm, plus the shortcut (a 1x1x1 ``downsample_conv`` at stride (1, 2,
2) with ``downsample_bn`` in a stage's first block, else the identity),
then ReLU.

Clips come in as ``[B, T, H, W, 3]``, normalized (the net has no uint8
stem kernel, :attr:`X3D.stem_kernel`).  ``conv1_s``, whose one temporal
tap makes it a 2-D convolution, runs over the ``B * T`` frames channels
last, as ``SlowPathway.stem``, and leaves a channels-last-3d ``[B, 24, T,
H/2, W/2]`` view; every later activation stays channels-last-3d.  The
channelwise convolutions, the gate and the swish are cuDNN's and ATen's
ops.  In bfloat16 train mode on one rank each BatchNorm whose width is a
whole number of 8-channel groups, with its ReLU and residual add, is
``ops/kernels.motion_bn`` (``motion.bn_act``): 68 of the 84; the inner
norms of the first two stages (54 and 108 channels) keep the module.

Each channelwise convolution with its BatchNorm (the stem's 5x1x1
included) is the span ``motion.channelwise``, and each block's gate with
the swish after it (the swish alone where the block has no gate) the span
``motion.se`` (``utils/spans.py``).

Departures from mmaction2: the map is kept, not pooled, and goes through
``fc`` (no classification head); BatchNorm scales start at 1 where
mmaction2 zero-initializes the last BatchNorm of each block
(``zero_init_residual``), which on random weights would make every block
the identity; the running variance moves by the biased batch variance,
as for every net here; keys drop mmaction2's ``ConvModule`` level
(``layer2_0.conv2.weight``, ``layer2_0.bn2.weight`` for
``layer2.0.conv2.conv.weight``, ``layer2.0.conv2.bn.weight``; ``bn1`` and
``bn5`` for ``conv1_t.bn`` and ``conv5.bn``).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsep_tpu_torch.models.layers import Conv2d, Conv3d
from avsep_tpu_torch.models.motion import _bn, _Pathway, _reset, bn_act
from avsep_tpu_torch.utils import spans

CHANNELWISE = "motion.channelwise"
SE = "motion.se"
# X3D-M: mmaction2's X3D at gamma_w 1 (base 24), gamma_b 2.25, gamma_d 2.2
BASE_CHANNELS = 24
GAMMA_B = 2.25
STAGE_BLOCKS = tuple(math.ceil(2.2 * n) for n in (1, 2, 5, 3))
SE_RATIO = 1 / 16


def round_width(width: float, multiplier: float, min_width: int = 8,
                divisor: int = 8) -> int:
    """mmaction2's ``SEModule._round_width``: ``width * multiplier`` to the
    nearest multiple of ``divisor``, at least ``min_width``, one
    ``divisor`` more where that falls under 0.9 of the exact value."""
    exact = width * multiplier
    out = max(min_width, int(exact + divisor / 2) // divisor * divisor)
    if out < 0.9 * exact:
        out += divisor
    return int(out)


class SEModule(nn.Module):
    """Squeeze-excitation over ``[B, C, T, H, W]``: ``y * sigmoid(fc2(relu(
    fc1(mean_{T,H,W} y))))``, ``fc1`` and ``fc2`` 1x1x1 convolutions with
    bias through ``round_width(C, ratio)`` channels."""

    def __init__(self, channels: int, ratio: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bottleneck = round_width(channels, ratio)
        self.fc1 = Conv3d(channels, self.bottleneck, 1, bias=True,
                          compute_dtype=dtype)
        self.fc2 = Conv3d(self.bottleneck, channels, 1, bias=True,
                          compute_dtype=dtype)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        g = torch.mean(y, dim=(2, 3, 4), keepdim=True)
        return y * torch.sigmoid(self.fc2(torch.relu(self.fc1(g))))


class BlockX3D(nn.Module):
    """mmaction2's ``BlockX3D`` (module docstring); ``out`` channels."""

    def __init__(self, in_features: int, inner: int, out: int,
                 spatial_stride: int = 1, se_ratio=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        s = spatial_stride
        self.conv1 = Conv3d(in_features, inner, 1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(inner, dtype)
        self.conv2 = Conv3d(inner, inner, 3, stride=(1, s, s), padding=1,
                            groups=inner, bias=False, compute_dtype=dtype)
        self.bn2 = _bn(inner, dtype)
        self.se_module = None if se_ratio is None else \
            SEModule(inner, se_ratio, dtype)
        self.conv3 = Conv3d(inner, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = _bn(out, dtype)
        self.has_downsample = s != 1 or in_features != out
        if self.has_downsample:
            self.downsample_conv = Conv3d(in_features, out, 1,
                                          stride=(1, s, s), bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = _bn(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_act(self.bn1, self.conv1(x))
        with spans.span(CHANNELWISE):
            y = bn_act(self.bn2, self.conv2(y), relu=False)
        with spans.span(SE):
            if self.se_module is not None:
                y = self.se_module(y)
            y = F.silu(y)
        y = self.conv3(y)
        identity = x
        if self.has_downsample:
            identity = bn_act(self.downsample_bn, self.downsample_conv(x),
                              relu=False)
        return bn_act(self.bn3, y, residual=identity)


class X3D(_Pathway):
    """X3D (module docstring), X3D-M by default.  ``base_channels`` the
    stem's width (the first stage's output; stage ``i`` outputs ``base *
    2 ** i``), ``gamma_b`` the inner widths' factor, ``stage_blocks`` the
    depths, ``se_ratio`` the gates' bottleneck ratio, ``fc_dim`` the map's
    channels; ``dtype`` is the compute dtype of every conv and BatchNorm
    (the parameters stay float32)."""

    def __init__(self, base_channels: int = BASE_CHANNELS,
                 gamma_b: float = GAMMA_B,
                 stage_blocks: Sequence[int] = STAGE_BLOCKS,
                 se_ratio: float = SE_RATIO, fc_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        base = base_channels
        self.conv1_s = Conv3d(3, base, (1, 3, 3), stride=(1, 2, 2),
                              padding=(0, 1, 1), bias=False,
                              compute_dtype=dtype)
        self.conv1_t = Conv3d(base, base, (5, 1, 1), padding=(2, 0, 0),
                              groups=base, bias=False, compute_dtype=dtype)
        self.bn1 = _bn(base, dtype)
        self.stages, width = [], base
        for li, n_blocks in enumerate(stage_blocks):
            out = base * 2 ** li
            inner = int(out * gamma_b)
            names = []
            for bi in range(n_blocks):
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, BlockX3D(
                    width, inner, out, spatial_stride=2 if bi == 0 else 1,
                    se_ratio=se_ratio if bi % 2 == 0 else None, dtype=dtype))
                names.append(name)
                width = out
            self.stages.append(names)
        self.conv5 = Conv3d(width, int(width * gamma_b), 1, bias=False,
                            compute_dtype=dtype)
        self.bn5 = _bn(int(width * gamma_b), dtype)
        self.out_features = int(width * gamma_b)
        self.fc = Conv2d(self.out_features, fc_dim, 3, padding=1, bias=True,
                         compute_dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) convs, zero conv biases, unit BatchNorm."""
        _reset(self, generator)

    @property
    def stem_kernel(self) -> bool:
        """False: the net takes normalized clips (no uint8 stem kernel)."""
        return False

    def stem(self, clips: torch.Tensor) -> torch.Tensor:
        """Normalized clips ``[B, T, H, W, 3]`` -> ``[B, C, T, H/2, W/2]``:
        ``conv1_s`` as a 2-D convolution over the ``B * T`` frames, channels
        last, then ``conv1_t``, ``bn1`` and ReLU."""
        B, T, H, W, _ = clips.shape
        d = self.conv1_s.compute_dtype
        x = clips.reshape(B * T, H, W, 3).permute(0, 3, 1, 2).to(d)
        y = F.conv2d(x, self.conv1_s.weight[:, :, 0].to(d), None, (2, 2),
                     (1, 1))
        y = y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], y.shape[1])
        with spans.span(CHANNELWISE):
            return bn_act(self.bn1, self.conv1_t(y.permute(0, 4, 1, 2, 3)))

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """Normalized clips ``[B, T, H, W, 3]`` -> the map after ``conv5``,
        ``[B, 432, T, H/32, W/32]``, a channels-first view."""
        y = self.stem(clips)
        for i in range(len(self.stages)):
            y = self.stage(i, y)
        return bn_act(self.bn5, self.conv5(y))

    def pooled_map(self, clips: torch.Tensor) -> torch.Tensor:
        """The map's mean over time through ``fc``: ``[B, H/32, W/32,
        fc_dim]``."""
        return self.fc(torch.mean(self(clips), dim=2)).permute(0, 2, 3, 1)
