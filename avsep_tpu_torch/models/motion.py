"""Motion backbones: the SlowFast fast pathway alone, or SlowFast R50 whole.

Port of ``avsep_tpu/models/motion.py`` (reference ``ModelBuilder.
build_motion``, ``models/__init__.py:94-118``): mmaction's
``ResNet3dFastOnly``, a Conv3d(5, 7, 7) stem with temporal stride 1, then
four stages of :class:`Bottleneck3d` blocks ``[3, 4, 6, 3]`` at
``base_channels`` 8, a 3x1x1 temporal inflation on each block's first conv,
spatial strides 1, 2, 2, 2 and no lateral connections.  Its 256 output
channels feed the CoLoc attention of ``fusion_type CoLoc_ClipAtt``
(``engine._motion_features``).

``--arch_motion slowfast_r50`` (:class:`ResNet3dSlowFast`) is the whole of
mmaction2's Kinetics-400 ``slowfast_r50`` (4x16, arXiv:1812.03982): the
fast pathway above beside a slow pathway, a ResNet3d-50 at base 64 on every
8th frame, joined by 5x1x1 lateral convolutions of stride 8 whose outputs
are concatenated onto the slow pathway's channels.  Each pathway's map is
averaged over its own time axis, the two are concatenated, and a 3x3
``fc`` projects them to ``vis_channels``, as ``resnet18dilated``'s ``fc``.

Clips come in as the JAX package's ``[B, T, H, W, 3]``; the module permutes
them once to ``[B, 3, T, H, W]``, runs its convolutions NCDHW, and returns
the JAX package's channels-last ``[B, T, H/32, W/32, 32 * base_channels]``.
In bfloat16 at base 8 the stem is ``ops/kernels.motion_stem`` instead
(:attr:`ResNet3dFastOnly.stem_kernel`), which reads the clips as they come,
uint8 included, and normalizes them in its load; ``conv1`` keeps its
weight, and the float32 net its ``nn.Conv3d``.  In bfloat16 train mode on
one rank each BatchNorm, with the ReLU after it and a block's residual add,
is ``ops/kernels.motion_bn`` (:func:`bn_act`).  In bfloat16 on a card each
3x1x1 ``conv1`` of up to 64 outputs (the fast pathway's 16) is
``ops/kernels.motion_conv_t3`` on its channels-last-3d input
(:func:`conv_t3`).
The fast pathway's submodules carry the JAX package's names (``conv1``,
``bn1``, ``layer{i}_{j}.conv{1,2,3}``, ``bn{1,2,3}``, ``downsample_conv``,
``downsample_bn``), so a JAX parameter path is a ``state_dict`` key
(``models/from_jax.py``); the slow pathway's follow them
(``slow_path.layer3_0.conv1``, ``slow_path.layer1_lateral``).  ``dtype``
is the compute dtype of every conv and BatchNorm (``models/layers.py``);
the parameters stay float32.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsep_tpu_torch.models.layers import (
    BatchNorm, Conv2d, Conv3d, he_normal_init_, reset_batchnorm_)
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.ops.imagenet import normalize_frames
from avsep_tpu_torch.parallel.distributed import world_size
from avsep_tpu_torch.utils import spans

# --arch_motion: the fast pathway alone, SlowFast R50 whole, or X3D-M
# (models/x3d.py)
ARCH_MOTIONS = ("slowfast_fast", "slowfast_r50", "x3d_m")
# SlowFast R50 (mmaction2's slowfast_r50 4x16): the slow pathway reads 1
# frame in SPEED_RATIO, which is the laterals' temporal stride too; the
# laterals' temporal kernel; the slow stages whose conv1 is 3x1x1
SPEED_RATIO = 8
FUSION_KERNEL = 5
SLOW_INFLATE = (False, False, True, True)


def _bn(features: int, dtype: torch.dtype) -> BatchNorm:
    return BatchNorm(features, momentum=0.9, eps=1e-5, compute_dtype=dtype)


def bn_kernel_applies(bn: BatchNorm) -> bool:
    """Whether ``bn`` runs as ``kernels.motion_bn``: in bfloat16, in train
    mode, on one rank, at a width the kernels take
    (``kernels.motion_bn_fits``: whole groups of 8 channels; X3D-M's 54
    and 108 are not).  Eval mode keeps ``F.batch_norm``, a process group
    the global statistics, the float32 net and other widths its modules."""
    return bn.compute_dtype == torch.bfloat16 and bn.training and \
        world_size() == 1 and kernels.motion_bn_fits(bn.num_features)


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


def conv_t3_takes(conv: Conv3d, x: torch.Tensor) -> bool:
    """Whether ``conv(x)`` is a shape ``kernels.motion_conv_t3`` takes,
    whatever the device: a bfloat16 conv and input, 3x1x1 at stride 1 and
    temporal padding 1 without bias, ``x`` dense channels-last-3d and
    16-byte aligned, and channels the kernels serve
    (``kernels.motion_conv_t3_fits``: at most 64 outputs, below the card's
    operations a byte).  The slow pathway's wide 3x1x1s (256 and 512
    outputs), the float32 net, an NCDHW input and the 1x1x1 ``conv1``s keep
    the module."""
    return (conv.compute_dtype == torch.bfloat16
            and x.dtype == torch.bfloat16 and x.dim() == 5
            and tuple(conv.kernel_size) == (3, 1, 1)
            and tuple(conv.stride) == (1, 1, 1)
            and tuple(conv.padding) == (1, 0, 0)
            and tuple(conv.dilation) == (1, 1, 1) and conv.groups == 1
            and conv.bias is None
            and x.is_contiguous(memory_format=torch.channels_last_3d)
            and x.data_ptr() % 16 == 0
            and kernels.motion_conv_t3_fits(conv.in_channels,
                                            conv.out_channels))


def conv_t3(conv: Conv3d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)``: ``kernels.motion_conv_t3`` on a CUDA tensor where
    :func:`conv_t3_takes` (the weight cast to bfloat16 as the module casts
    it), else the module."""
    if x.is_cuda and conv_t3_takes(conv, x):
        return kernels.motion_conv_t3(x, conv.weight.to(torch.bfloat16))
    return conv(x)


class Bottleneck3d(nn.Module):
    """mmaction's Bottleneck3d with the '3x1x1' temporal inflation on
    ``conv1`` (a 1x1x1 ``conv1`` where ``inflate`` is off); the output has
    ``4 * planes`` channels."""

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
        y = bn_act(self.bn1, conv_t3(self.conv1, x))
        y = self.conv3(bn_act(self.bn2, self.conv2(y)))
        identity = x
        if self.has_downsample:
            identity = bn_act(self.downsample_bn, self.downsample_conv(x),
                              relu=False)
        return bn_act(self.bn3, y, residual=identity)


def _stages(net: nn.Module, in_features: int, base_channels: int,
            stage_blocks: Sequence[int], inflate: Sequence[bool],
            dtype: torch.dtype, lateral: Sequence[int] = ()
            ) -> List[List[str]]:
    """Add ``net``'s bottleneck stages (``layer{i}_{j}``, spatial strides 1,
    2, 2, 2) and return their block names per stage.  ``lateral[i]`` more
    channels come in before stage ``i + 1`` (concatenated from the fast
    pathway)."""
    stages, width = [], in_features
    for li, n_blocks in enumerate(stage_blocks):
        planes = base_channels * 2 ** li
        names = []
        for bi in range(n_blocks):
            stride = 2 if li > 0 and bi == 0 else 1
            name = f"layer{li + 1}_{bi}"
            net.add_module(name, Bottleneck3d(
                width, planes, spatial_stride=stride, inflate=inflate[li],
                dtype=dtype))
            names.append(name)
            width = planes * 4
        stages.append(names)
        if li < len(lateral):
            width += lateral[li]
    net.out_features = width
    return stages


def _reset(net: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's init: He-normal on fan_out for every conv, biases
    0, BatchNorm scale 1 and bias 0, running mean 0 and var 1."""
    for m in net.modules():
        if isinstance(m, (Conv3d, Conv2d)):
            he_normal_init_(m.weight, generator)
            if m.bias is not None:
                with torch.no_grad():
                    m.bias.zero_()
        elif isinstance(m, BatchNorm):
            reset_batchnorm_(m)


class _Pathway(nn.Module):
    """A pathway's stages, ``stages[i]`` the block names of stage ``i``,
    run one at a time on channels-first views ``[B, C, T, h, w]``."""

    stages: List[List[str]]

    def stage(self, i: int, y: torch.Tensor) -> torch.Tensor:
        for name in self.stages[i]:
            y = getattr(self, name)(y)
        return y


class ResNet3dFastOnly(_Pathway):
    """The fast pathway: a 5x7x7 stem at stride (1, 2, 2), a (1, 3, 3)
    max-pool at stride (1, 2, 2), then the bottleneck stages.  :meth:`stem`
    and :meth:`stage` run it a piece at a time, so that
    :class:`ResNet3dSlowFast` takes its laterals between them."""

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
        self.stages = _stages(self, base_channels, base_channels,
                              stage_blocks, [True] * len(stage_blocks), dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The JAX package's init: He-normal on fan_out for every conv,
        BatchNorm scale 1 and bias 0, running mean 0 and var 1."""
        _reset(self, generator)

    @property
    def stem_kernel(self) -> bool:
        """Whether the stem is ``kernels.motion_stem``: in bfloat16, at its
        one shape (3 -> 8 channels).  Such a net takes uint8 clips as they
        come; otherwise clips are normalized float32."""
        return self.conv1.compute_dtype == torch.bfloat16 and \
            tuple(self.conv1.weight.shape) == kernels.STEM_WEIGHT

    def stem(self, clips: torch.Tensor) -> torch.Tensor:
        """clips ``[B, T, H, W, 3]`` -> the max-pooled stem ``[B, C, T,
        H/4, W/4]``."""
        if self.stem_kernel:
            y = kernels.motion_stem(clips, self.conv1.weight)
        else:
            y = self.conv1(clips.permute(0, 4, 1, 2, 3))
        return self.maxpool(bn_act(self.bn1, y))

    def forward(self, clips: torch.Tensor) -> torch.Tensor:
        """clips ``[B, T, H, W, 3]`` -> features ``[B, T, H/32, W/32, C]``
        (channels last, as the JAX package returns them)."""
        y = self.stem(clips)
        for i in range(len(self.stages)):
            y = self.stage(i, y)
        return y.permute(0, 2, 3, 4, 1)

    def pooled_map(self, clips: torch.Tensor) -> torch.Tensor:
        """The features' mean over time: ``[B, H/32, W/32, C]``."""
        return torch.mean(self(clips), dim=1)

    def forward_pooled(self, clips: torch.Tensor) -> torch.Tensor:
        """The features' max over time and space: ``[B, C]``."""
        return torch.amax(self(clips), dim=(1, 2, 3))


class SlowPathway(_Pathway):
    """SlowFast's slow pathway (mmaction2's ``ResNet3dPathway`` with
    ``lateral=True``): a 1x7x7 stem at stride (1, 2, 2) with its BatchNorm
    and ReLU, a (1, 3, 3) max-pool at stride (1, 2, 2), then the bottleneck
    stages, ``conv1`` 1x1x1 in res2 and res3 and 3x1x1 in res4 and res5
    (:data:`SLOW_INFLATE`).  The laterals ``conv1_lateral`` and
    ``layer{1,2,3}_lateral`` are plain convolutions of the fast pathway's
    maps (no BatchNorm, no activation): :data:`FUSION_KERNEL` x1x1 at
    temporal stride :data:`SPEED_RATIO`, C -> 2C; :class:`ResNet3dSlowFast`
    concatenates each onto the slow channels, so each stage takes its
    lateral's channels more."""

    def __init__(self, base_channels: int = 64, fast_channels: int = 8,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv3d(3, base_channels, (1, 7, 7), stride=(1, 2, 2),
                            padding=(0, 3, 3), bias=False,
                            compute_dtype=dtype)
        self.bn1 = _bn(base_channels, dtype)
        self.maxpool = nn.MaxPool3d((1, 3, 3), stride=(1, 2, 2),
                                    padding=(0, 1, 1))

        def lateral(c: int) -> Conv3d:
            return Conv3d(c, 2 * c, (FUSION_KERNEL, 1, 1),
                          stride=(SPEED_RATIO, 1, 1),
                          padding=(FUSION_KERNEL // 2, 0, 0), bias=False,
                          compute_dtype=dtype)

        # the fast pathway's widths after its stem and its first 3 stages
        fast = [fast_channels] + [fast_channels * 4 * 2 ** i
                                  for i in range(len(stage_blocks) - 1)]
        self.conv1_lateral = lateral(fast[0])
        self.laterals = []
        for i, c in enumerate(fast[1:]):
            self.add_module(f"layer{i + 1}_lateral", lateral(c))
            self.laterals.append(f"layer{i + 1}_lateral")
        self.stages = _stages(self, base_channels + 2 * fast[0],
                              base_channels, stage_blocks, SLOW_INFLATE,
                              dtype, lateral=[2 * c for c in fast[1:]])

    @staticmethod
    def frames(clip_len: int) -> int:
        """The frames it reads of a clip of ``clip_len``: every
        :data:`SPEED_RATIO`-th."""
        return -(-clip_len // SPEED_RATIO)

    def stem(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalized frames ``[B, T, H, W, 3]`` -> the max-pooled stem
        ``[B, C, T, H/4, W/4]``.  The 1x7x7 convolution runs as a 2-D one
        over the ``B * T`` frames (its weight's one temporal tap), channels
        last; the result is a channels-last ``[B, C, T, h, w]`` view."""
        B, T, H, W, _ = frames.shape
        d = self.conv1.compute_dtype
        x = frames.reshape(B * T, H, W, 3).permute(0, 3, 1, 2).to(d)
        y = F.conv2d(x, self.conv1.weight[:, :, 0].to(d), None, (2, 2),
                     (3, 3))
        y = y.permute(0, 2, 3, 1).reshape(B, T, *y.shape[2:], y.shape[1])
        y = y.permute(0, 4, 1, 2, 3)
        return self.maxpool(bn_act(self.bn1, y))


class ResNet3dSlowFast(nn.Module):
    """SlowFast R50 (mmaction2's ``ResNet3dSlowFast`` at ``resample_rate``
    8, ``speed_ratio`` 8, ``channel_ratio`` 8, ``fusion_kernel`` 5):
    ``fast_path`` (:class:`ResNet3dFastOnly`) on every frame and
    ``slow_path`` (:class:`SlowPathway`) on frames 0, 8, 16, ... (mmaction2's
    nearest resample at 1/8), each lateral concatenated onto the slow
    pathway after the stem and after each of the first three stages, then
    ``fc``, a 3x3 convolution with bias from the two pathways' time means
    (slow first) to ``fc_dim`` channels.

    The slow stem, each slow stage and each lateral with its concatenation
    are the spans ``motion.slow`` and ``motion.lateral``
    (``utils/spans.py``).  In bfloat16 the fast stem is
    ``kernels.motion_stem`` on the clips as they come (:attr:`stem_kernel`,
    uint8 included); the slow stem normalizes its own frames."""

    def __init__(self, fast_channels: int = 8, slow_channels: int = 64,
                 stage_blocks: Sequence[int] = (3, 4, 6, 3),
                 fc_dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fast_path = ResNet3dFastOnly(fast_channels, stage_blocks, dtype)
        self.slow_path = SlowPathway(slow_channels, fast_channels,
                                     stage_blocks, dtype)
        width = self.slow_path.out_features + self.fast_path.out_features
        self.fc = Conv2d(width, fc_dim, 3, padding=1, bias=True,
                         compute_dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """He-normal (fan_out) convs, zero conv biases, unit BatchNorm."""
        _reset(self, generator)

    @property
    def stem_kernel(self) -> bool:
        """The fast stem's :attr:`ResNet3dFastOnly.stem_kernel`: whether the
        net takes uint8 clips as they come."""
        return self.fast_path.stem_kernel

    def slow_frames(self, clips: torch.Tensor) -> torch.Tensor:
        """The slow pathway's frames, normalized: ``[B, ceil(T / 8), H, W,
        3]``."""
        return normalize_frames(clips[:, ::SPEED_RATIO])

    def forward(self, clips: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """clips ``[B, T, H, W, 3]`` -> the slow and the fast maps,
        ``[B, 32 * slow_channels, ceil(T / 8), H/32, W/32]`` and ``[B,
        32 * fast_channels, T, H/32, W/32]``, channels-first views."""
        fast, slow = self.fast_path, self.slow_path
        x_fast = fast.stem(clips)
        with spans.span("motion.slow"):
            x_slow = slow.stem(self.slow_frames(clips))
        with spans.span("motion.lateral"):
            x_slow = torch.cat([x_slow, slow.conv1_lateral(x_fast)], dim=1)
        for i in range(len(slow.stages)):
            with spans.span("motion.slow"):
                x_slow = slow.stage(i, x_slow)
            x_fast = fast.stage(i, x_fast)
            if i < len(slow.laterals):
                with spans.span("motion.lateral"):
                    lateral = getattr(slow, slow.laterals[i])
                    x_slow = torch.cat([x_slow, lateral(x_fast)], dim=1)
        return x_slow, x_fast

    def pooled_map(self, clips: torch.Tensor) -> torch.Tensor:
        """The two time means concatenated, through ``fc``: ``[B, H/32,
        W/32, fc_dim]``."""
        x_slow, x_fast = self(clips)
        y = torch.cat([torch.mean(x_slow, dim=2), torch.mean(x_fast, dim=2)],
                      dim=1)
        return self.fc(y).permute(0, 2, 3, 1)
