"""Shared layers of the U-Net, with the reference's initializers.

Port of ``avsep_tpu/models/layers.py``.  The reference's building blocks
(``models/audio_net.py:49-122``) are Conv2d(4x4, stride 2, pad 1)
downsamplers, Conv2d(3x3, pad 1) up-projections, BatchNorm2d,
LeakyReLU(0.2) / ReLU and ``nn.Upsample(scale_factor=2, mode='bilinear',
align_corners=True)``.  Modules here are NCHW.  Each wraps its torch layer
under the name the JAX package gives it (``conv``, ``bn``), so a JAX
parameter path maps one to one onto a ``state_dict`` key
(``models/from_jax.py``).

The initializers take an explicit CPU ``torch.Generator`` and draw on the
CPU, so the same seed gives the same weights on every device.

:class:`BatchNorm` is the one BatchNorm of the port's nets (U-Net, ResNet,
tiny encoder, motion net, SoP++ nets): its train mode updates the running
statistics as Flax does, and under a process group of more than one rank
takes the statistics of the global batch (``parallel/distributed.py``).

Compute dtype (Flax's ``dtype``).  :class:`Conv2d`, :class:`Conv3d` and
:class:`BatchNorm` take ``compute_dtype``; their parameters and buffers
stay float32.  Under bfloat16 a conv casts its input, weight and bias to
bfloat16 inside ``forward`` (the gradients reach the float32 parameters
through the cast), and a BatchNorm takes its batch statistics and
normalizes in float32 (Flax's ``force_float32_reductions``), then returns
bfloat16.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsep_tpu_torch.parallel.distributed import all_reduce_sum, world_size

# ---------------------------------------------------------------- initializers


def _draw(shape, generator: torch.Generator, kind: str) -> torch.Tensor:
    if kind == "normal":
        return torch.randn(shape, generator=generator)
    return torch.rand(shape, generator=generator)


@torch.no_grad()
def normal_init_(t: torch.Tensor, std: float,
                 generator: torch.Generator) -> None:
    """Reference ``ModelBuilder.weights_init``: Conv ~ N(0, 0.001)
    (``models/__init__.py:33-41``)."""
    t.copy_(std * _draw(t.shape, generator, "normal"))


@torch.no_grad()
def bn_scale_init_(t: torch.Tensor, generator: torch.Generator) -> None:
    """BatchNorm weight ~ N(1.0, 0.02) (reference
    ``models/__init__.py:37-39``)."""
    t.copy_(1.0 + 0.02 * _draw(t.shape, generator, "normal"))


@torch.no_grad()
def torch_conv_bias_init_(t: torch.Tensor, fan_in: int,
                          generator: torch.Generator) -> None:
    """PyTorch Conv2d default bias: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    t.copy_((2.0 * _draw(t.shape, generator, "uniform") - 1.0) * bound)


@torch.no_grad()
def he_normal_init_(t: torch.Tensor, generator: torch.Generator) -> None:
    """Variance scaling 2.0 on fan_out, normal: the JAX package's ResNet
    and motion-net conv init.  ``t`` is a conv weight ``[out, in, *k]``
    (2-D or 3-D kernel); fan_out is ``out`` times the kernel's size."""
    fan_out = t.shape[0] * math.prod(t.shape[2:])
    t.copy_(math.sqrt(2.0 / fan_out) * _draw(t.shape, generator, "normal"))


@torch.no_grad()
def reset_batchnorm_(bn: nn.BatchNorm2d, generator=None) -> None:
    """Running mean 0, running var 1, bias 0; weight ~ N(1, 0.02) when a
    generator is given (the U-Net), else 1 (the ResNet)."""
    bn.running_mean.zero_()
    bn.running_var.fill_(1.0)
    bn.num_batches_tracked.zero_()
    bn.bias.zero_()
    if generator is None:
        bn.weight.fill_(1.0)
    else:
        bn_scale_init_(bn.weight, generator)


# ------------------------------------------------------------------- layers


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that computes in ``compute_dtype``: the input, the
    weight and the bias are cast to it inside :meth:`forward` (Flax
    ``nn.Conv``'s ``dtype``); the parameters stay float32.  Below float32
    the bias is added to the rounded conv output, as Flax adds it."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(d), self.weight.to(d), None)
        if self.bias is None:
            return y
        return y + self.bias.to(d)[:, None, None]


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` with :class:`Conv2d`'s compute-dtype semantics: the
    input, the weight and the bias are cast to ``compute_dtype`` inside
    :meth:`forward`, and below float32 the bias is added to the rounded
    conv output."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.compute_dtype
        if d == torch.float32:
            return super().forward(x)
        y = self._conv_forward(x.to(d), self.weight.to(d), None)
        if self.bias is None:
            return y
        return y + self.bias.to(d)[:, None, None, None]


class ConvDown(nn.Module):
    """4x4 stride-2 pad-1 conv, bias-free (reference audio_net.py:72-74)."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, 4, stride=2, padding=1,
                           bias=False, compute_dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        normal_init_(self.conv.weight, 0.001, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ConvUp(nn.Module):
    """3x3 pad-1 conv (reference audio_net.py:75-76,85-87)."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_features, features, 3, padding=1,
                           bias=use_bias, compute_dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        normal_init_(self.conv.weight, 0.001, generator)
        if self.conv.bias is not None:
            torch_conv_bias_init_(self.conv.bias,
                                  self.conv.weight[0].numel(), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


_FROZEN = threading.local()


@contextlib.contextmanager
def running_stats_frozen():
    """Inside it, a train-mode :class:`BatchNorm` of this thread normalizes
    with its batch statistics as always but leaves its running statistics
    and ``num_batches_tracked`` alone: the recompute of a rematerialized
    forward (``engine.py``) must not update them a second time."""
    before = getattr(_FROZEN, "on", False)
    _FROZEN.on = True
    try:
        yield
    finally:
        _FROZEN.on = before


def batch_norm_train(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float):
    """Train-mode normalization with the batch's own statistics over every
    dimension but 1: ``(y, mean, biased var)``, the statistics without a
    gradient.  One ``F.batch_norm`` call on zeroed float32 scratch buffers
    with momentum 1 writes the batch mean and the unbiased variance there;
    the biased one is that times ``(n - 1) / n``."""
    batch = torch.zeros(2, x.shape[1], dtype=torch.float32, device=x.device)
    y = F.batch_norm(x, batch[0], batch[1], weight, bias, True, 1.0, eps)
    n = x.numel() // x.shape[1]
    return y, batch[0], batch[1] * ((n - 1) / n)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax ``nn.BatchNorm``'s training semantics, over the
    channels of dimension 1: NCHW (the U-Net, the ResNets) or NCDHW (the
    motion net); the statistics are over every other dimension.

    Eval mode normalizes with the running statistics, as ``nn.BatchNorm2d``.
    Train mode normalizes with the batch statistics and keeps the gradient
    through them, and updates the running buffers without a gradient as
    Flax does: ``ra = m * ra + (1 - m) * batch`` with the *biased* batch
    variance, where ``nn.BatchNorm2d`` uses the unbiased one.  ``momentum``
    is Flax's m (0.9 is torch's 0.1).  The ``state_dict`` keys are
    ``nn.BatchNorm2d``'s; ``num_batches_tracked`` counts updates and is
    read by nothing.

    The batch statistics come out of the normalizing call itself
    (:func:`batch_norm_train`): it gets zeroed scratch buffers and momentum
    1, so it writes the batch mean and the unbiased batch variance there,
    and the biased one is that times ``(n - 1) / n``.  The scratch buffers
    are float32 whatever the input's dtype, as are the parameters and
    running buffers: on a bfloat16 input the statistics and the
    normalization are computed in float32, and the result is returned in
    ``compute_dtype``.

    Under a process group of more than one rank, train mode normalizes with
    the statistics of the global batch, as the JAX package's BatchNorm does
    under a data mesh: the mean from the all-reduced sums and counts, then
    the biased variance from the all-reduced centred squares (two-pass, in
    float32), each collective differentiable (``all_reduce_sum``), so the
    gradient flows through the global statistics; the running buffers
    follow from the same global numbers and stay equal across the ranks.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=eps)
        self.flax_momentum = momentum
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps
                                ).to(self.compute_dtype)
        if world_size() > 1:
            y, mean, var = self._global_batch_norm(x)
        else:
            y, mean, var = batch_norm_train(x, self.weight, self.bias,
                                            self.eps)
        self.update_running(mean, var)
        return y.to(self.compute_dtype)

    def update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Flax's update of the running buffers from a train-mode batch's
        ``mean`` and *biased* ``var``, without a gradient; nothing under
        :func:`running_stats_frozen`.  ``forward`` calls it, and so does
        the motion net around ``kernels.motion_bn``."""
        if getattr(_FROZEN, "on", False):
            return
        m = self.flax_momentum
        with torch.no_grad():
            self.running_mean.mul_(m).add_(mean, alpha=1.0 - m)
            self.running_var.mul_(m).add_(var, alpha=1.0 - m)
            self.num_batches_tracked.add_(1)

    def _global_batch_norm(self, x: torch.Tensor):
        """Train-mode normalization with the global batch's statistics:
        ``(y, mean, biased var)``, the statistics detached.  Two
        collectives forward (sums with the count, then centred squares)
        and their two backward."""
        dims = [0] + list(range(2, x.dim()))
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        count = xf.new_full((1,), xf.numel() // xf.shape[1])
        sums = all_reduce_sum(torch.cat([xf.sum(dims), count]))
        mean = sums[:-1] / sums[-1]
        d = xf - mean.reshape(shape)
        var = all_reduce_sum((d * d).sum(dims)) / sums[-1]
        y = d * torch.rsqrt(var + self.eps).reshape(shape) \
            * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y, mean.detach(), var.detach()


class TorchBatchNorm(nn.Module):
    """BatchNorm with torch's defaults (eps 1e-5, momentum 0.1, which is
    Flax's 0.9) under the JAX package's module name ``bn``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.bn = BatchNorm(features, momentum=0.9, eps=1e-5,
                            compute_dtype=dtype)

    def reset_parameters_(self, generator: torch.Generator) -> None:
        reset_batchnorm_(self.bn, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """NCHW bilinear 2x upsample, as torch ``Upsample(scale_factor=2,
    mode='bilinear', align_corners=True)`` (reference audio_net.py:68-69).
    The same 2-tap sums as the JAX package's interpolation matrices.

    On a bfloat16 input both passes accumulate in float32 and the result is
    rounded to bfloat16 once; the JAX package rounds its H-pass
    intermediate to bfloat16 too, so it rounds twice
    (``tests/test_torch_bf16.py`` holds both)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int,
                      eps: float = 1e-8) -> torch.Tensor:
    """Cosine similarity with each norm clamped to ``eps`` separately before
    the division (written out: ``F.cosine_similarity`` clamps differently
    across torch versions)."""
    na = torch.clamp(torch.linalg.vector_norm(a, dim=dim), min=eps)
    nb = torch.clamp(torch.linalg.vector_norm(b, dim=dim), min=eps)
    return torch.sum(a * b, dim=dim) / (na * nb)
