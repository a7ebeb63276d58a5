"""Motion backbone: the SlowFast fast pathway, a ResNet3d at depth 50.

Port of ``avsep_tpu/models/motion.py`` (reference ``ModelBuilder.
build_motion``, ``models/__init__.py:94-118``): mmaction's
``ResNet3dFastOnly``, a Conv3d(5, 7, 7) stem with temporal stride 1, then
four stages of :class:`Bottleneck3d` blocks ``[3, 4, 6, 3]`` at
``base_channels`` 8, a 3x1x1 temporal inflation on each block's first conv,
spatial strides 1, 2, 2, 2 and no lateral connections.  Its 256 output
channels feed the CoLoc attention of ``fusion_type CoLoc_ClipAtt``
(``engine._motion_features``).

Clips come in as the JAX package's ``[B, T, H, W, 3]``; the module permutes
them once to ``[B, 3, T, H, W]``, runs its convolutions NCDHW, and returns
the JAX package's channels-last ``[B, T, H/32, W/32, 32 * base_channels]``.
In bfloat16 at base 8 the stem is ``ops/kernels.motion_stem`` instead
(:attr:`ResNet3dFastOnly.stem_kernel`), which reads the clips as they come,
uint8 included, and normalizes them in its load; ``conv1`` keeps its
weight, and the float32 net its ``nn.Conv3d``.  In bfloat16 train mode on
one rank each BatchNorm, with the ReLU after it and a block's residual add,
is ``ops/kernels.motion_bn`` (:func:`bn_act`).
Submodules carry the JAX package's names (``conv1``, ``bn1``,
``layer{i}_{j}.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample_conv``,
``downsample_bn``), so a JAX parameter path is a ``state_dict`` key
(``models/from_jax.py``).  ``dtype`` is the compute dtype of every conv
and BatchNorm (``models/layers.py``); the parameters stay float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from avsep_tpu_torch.models.layers import (
    BatchNorm, Conv3d, he_normal_init_, reset_batchnorm_)
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.parallel.distributed import world_size


def _bn(features: int, dtype: torch.dtype) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, eps=1e-5, compute_dtype=dtype)


def bn_kernel_applies(bn: BatchNorm) -> bool:
    """Whether ``bn`` runs as ``kernels.motion_bn``: in bfloat16, in train
    mode, on one rank.  Eval mode keeps ``F.batch_norm``, a process group
    the global statistics, the float32 net its modules."""
    return bn.compute_dtype == torch.bfloat16 and bn.training and \
        world_size() == 1


def bn_act(bn: BatchNorm, x: torch.Tensor, relu: bool = True,
           residual=None) -> torch.Tensor:
    """``bn(x)``, plus ``residual``, then the ReLU: one
    ``kernels.motion_bn`` where :func:`bn_kernel_applies` (the running
    buffers updated by ``bn.update_running``), else the modules' ops."""
    if bn_kernel_applies(bn):
        y, mean, var = kernels.motion_bn(x, bn.weight, bn.bias, bn.eps, relu,
                                         residual)
        bn.update_running(mean, var)
        return y
    y = bn(x)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


class Bottleneck3d(nn.Module):
    """mmaction's Bottleneck3d with the '3x1x1' temporal inflation on
    ``conv1``; the output has ``4 * planes`` channels."""

    def __init__(self, in_features: int, planes: int,
                 spatial_stride: int = 1, inflate: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * 4
        k1, p1 = ((3, 1, 1), (1, 0, 0)) if inflate else (1, 0)
        s = spatial_stride
        self.conv1 = Conv3d(in_features, planes, k1, padding=p1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(planes, dtype)
        self.conv2 = Conv3d(planes, planes, (1, 3, 3), stride=(1, s, s),
                            padding=(0, 1, 1), bias=False,
                            compute_dtype=dtype)
        self.bn2 = _bn(planes, dtype)
        self.conv3 = Conv3d(planes, out, 1, bias=False, compute_dtype=dtype)
        self.bn3 = _bn(out, dtype)
        self.has_downsample = s != 1 or in_features != out
        if self.has_downsample:
            self.downsample_conv = Conv3d(in_features, out, 1,
                                          stride=(1, s, s), bias=False,
                                          compute_dtype=dtype)
            self.downsample_bn = _bn(out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = bn_act(self.bn1, self.conv1(x))
        y = self.conv3(bn_act(self.bn2, self.conv2(y)))
        identity = x
        if self.has_downsample:
            identity = bn_act(self.downsample_bn, self.downsample_conv(x),
                              relu=False)
        return bn_act(self.bn3, y, residual=identity)


class ResNet3dFastOnly(nn.Module):
    """The fast pathway: a 5x7x7 stem at stride (1, 2, 2), a (1, 3, 3)
    max-pool at stride (1, 2, 2), then the bottleneck stages."""

    def __init__(self, base_channels: int = 8,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(3, base_channels, (5, 7, 7), stride=(1, 2, 2),
                            padding=(2, 3, 3), bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(base_channels, dtype)
        # MaxPool3d pads with -inf, as the JAX package's max_pool
        self.maxpool = nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2),
                                    padding=(0, 1, 1))
        self.blocks = []
        width = base_channels
        for li, n_blocks in enumerate(stage_blocks):
            planes = base_channels * 2 ** li
            for bi in range(n_blocks):
                stride = 2 if li > 0 and bi == 0 else 1
                name = f"layer{li + 1}_{bi}"
                self.add_module(name, Bottleneck3d(
                    width, planes, spatial_stride=stride, dtype=dtype))
                self.blocks.append(name)
                width = planes * 4
        self.out_features = width

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The JAX package's init: He-normal on fan_out for every conv,
        BatchNorm scale 1 and bias 0, running mean 0 and var 1."""
        for m in self.modules():
            if isinstance(m, Conv3d):
                he_normal_init_(m.weight, generator)
            elif isinstance(m, BatchNorm):
                reset_batchnorm_(m)

    @property
    def stem_kernel(self) -> bool:
        """Whether the stem is ``kernels.motion_stem``: in bfloat16, at its
        one shape (3 -> 8 channels).  Such a net takes uint8 clips as they
        come; otherwise clips are normalized float32."""
        return self.conv1.compute_dtype == torch.bfloat16 and \
            tuple(self.conv1.weight.shape) == kernels.STEM_WEIGHT

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips ``[B, T, H, W, 3]`` -> features ``[B, T, H/32, W/32, C]``
        (channels last, as the JAX package returns them)."""
        if self.stem_kernel:
            y = kernels.motion_stem(clips, self.conv1.weight)
        else:
            y = self.conv1(clips.permute(0, 4, 1, 2, 3))
        y = self.maxpool(bn_act(self.bn1, y))
        for name in self.blocks:
            y = getattr(self, name)(y)
        return y.permute(0, 2, 3, 4, 1)

    def forward_pooled(self, clips: torch.Tensor) -> torch.Tensor:
        """The features' max over time and space: ``[B, C]``."""
        return torch.amax(self(clips), dim=(1, 2, 3))
