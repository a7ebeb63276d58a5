"""Plain reference of X3D-M as the clip stream, in plain PyTorch.

Written from the X3D paper (Feichtenhofer, CVPR 2020, arXiv:2004.04730)
as mmaction2 builds X3D-M (``X3D(gamma_w=1, gamma_b=2.25,
gamma_d=2.2)``, ``configs/recognition/x3d/
x3d_m_16x5x1_facebook-kinetics400-rgb.py``), following ``X3D.forward``
and ``BlockX3D.forward``:

* stem: ``conv1_s``, 1x3x3 at stride (1, 2, 2), 3 -> 24, no norm, no
  activation; ``conv1_t``, 5x1x1 channelwise (groups 24), BatchNorm, ReLU;
* stages of :data:`BLOCKS` blocks to 24, 48, 96, 192 channels, inner widths
  ``int(2.25 x out)``, spatial stride 2 in each stage's first block;
* block: ``conv1`` 1x1x1, BatchNorm, ReLU; ``conv2`` 3x3x3 channelwise
  (groups = inner) at stride (1, s, s), BatchNorm; in blocks 0, 2, 4, ...
  (``se_style='half'``) the gate ``y * sigmoid(fc2(relu(fc1(mean_{t,h,w}
  y))))``; swish ``y * sigmoid(y)``; ``conv3`` 1x1x1, BatchNorm; the
  shortcut (a strided 1x1x1 ``downsample_conv`` with BatchNorm in a stage's
  first block, else the identity) added; ReLU;
* ``conv5`` 1x1x1 to 432, BatchNorm, ReLU.

Departures from mmaction2, each as the system uses the net: the map is
averaged over time and goes through the frame net's kind of ``fc`` (a 3x3
convolution with bias to the fusion's channels), then ReLU; no
classification head; the weights are what the caller hands in, drawn from
the seed, with BatchNorm scales of 1 where mmaction2 zero-initializes each
block's last BatchNorm (``zero_init_residual``, which on random weights
makes every block the identity); the running variance moves by the biased
batch variance, as for every net here; keys drop mmaction2's
``ConvModule`` level (``layer2_0.conv2.weight``, ``layer2_0.bn2.*``;
``bn1`` and ``bn5`` for ``conv1_t.bn`` and ``conv5.bn``).

Precision as ``nets.Precision`` states it: each convolution's input and
weight in the compute dtype (bias added after, rounded), fp8 rounding
both; BatchNorm in float32 (``F.batch_norm``), out in the compute dtype.
Every activation is a dense channels-first ``[B, C, T, H, W]`` tensor (on a
CPU, the channels-last BatchNorm's sums move with the thread count by up
to 1e-5 of a statistic, which 84 train-mode norms carry to 1e-3 of the
first layers' gradients).  It imports nothing of the program and of the JAX package.  Run it in
float32 with TF32 off (``nets.tf32(False)``) for a float32 reading.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.nets import Precision

W = Dict[str, torch.Tensor]
BLOCKS = (3, 5, 11, 7)


def conv(x, w: W, name: str, P: Precision, stride=1, padding=0,
         groups: int = 1) -> torch.Tensor:
    """A 3-D convolution of ``groups`` groups in ``P``."""
    weight, bias = w[name + ".weight"], w.get(name + ".bias")
    if P.compute == "float32":
        return F.conv3d(x, weight, bias, stride, padding, 1, groups)
    d = P.dtype
    x, weight = x.to(d), weight.to(d)
    if P.compute == "fp8":
        x, weight = nets._fp8(x), nets._fp8(weight)
    y = F.conv3d(x, weight, None, stride, padding, 1, groups)
    return y if bias is None else y + bias.to(d).view(-1, 1, 1, 1)


def channelwise(x, w: W, name: str, P: Precision, stride=1, padding=1):
    """A channelwise convolution: one group a channel."""
    return conv(x, w, name, P, stride, padding,
                groups=w[name + ".weight"].shape[0])


def batch_norm(x, w: W, name: str, P: Precision, train: bool,
               eps: float = 1e-5, momentum: float = 0.9) -> torch.Tensor:
    """``F.batch_norm`` over the channels in float32, out in the compute
    dtype; train mode moves the running statistics in place in ``w`` by
    the batch mean and biased variance (``ra = m ra + (1 - m) batch``)."""
    xf = x.float()
    rm, rv = w[name + ".running_mean"], w[name + ".running_var"]
    if train:
        with torch.no_grad():
            dims = [0] + list(range(2, x.dim()))
            rm.mul_(momentum).add_(xf.mean(dims), alpha=1 - momentum)
            rv.mul_(momentum).add_(xf.var(dims, unbiased=False),
                                   alpha=1 - momentum)
        y = F.batch_norm(xf, None, None, w[name + ".weight"],
                         w[name + ".bias"], True, 0.0, eps)
    else:
        y = F.batch_norm(xf, rm, rv, w[name + ".weight"], w[name + ".bias"],
                         False, 0.0, eps)
    return y.to(P.dtype)


def _block(h, w: W, name: str, P: Precision, train: bool, stride: int,
           se: bool):
    y = torch.relu(batch_norm(conv(h, w, name + ".conv1", P), w,
                              name + ".bn1", P, train))
    y = batch_norm(channelwise(y, w, name + ".conv2", P,
                               stride=(1, stride, stride)), w, name + ".bn2",
                   P, train)
    if se:
        g = y.mean(dim=(2, 3, 4), keepdim=True)
        g = torch.relu(conv(g, w, name + ".se_module.fc1", P))
        y = y * torch.sigmoid(conv(g, w, name + ".se_module.fc2", P))
    y = y * torch.sigmoid(y)
    y = batch_norm(conv(y, w, name + ".conv3", P), w, name + ".bn3", P,
                   train)
    if stride != 1 or name + ".downsample_conv.weight" in w:
        h = batch_norm(conv(h, w, name + ".downsample_conv", P,
                            stride=(1, stride, stride)), w,
                       name + ".downsample_bn", P, train)
    return torch.relu(y + h)


def backbone(clips, w: W, P: Precision, train: bool,
             pre: str = "motion.") -> torch.Tensor:
    """Normalized clips ``[B, T, H, W, 3]`` -> the map after ``conv5``,
    ``[B, 432, T, H/32, W/32]``."""
    x = clips.permute(0, 4, 1, 2, 3).contiguous()
    h = conv(x, w, pre + "conv1_s", P, stride=(1, 2, 2), padding=(0, 1, 1))
    h = channelwise(h, w, pre + "conv1_t", P, padding=(2, 0, 0))
    h = torch.relu(batch_norm(h, w, pre + "bn1", P, train))
    for stage, n in enumerate(BLOCKS):
        for b in range(n):
            h = _block(h, w, f"{pre}layer{stage + 1}_{b}", P, train,
                       2 if b == 0 else 1, b % 2 == 0)
    return torch.relu(batch_norm(conv(h, w, pre + "conv5", P), w,
                                 pre + "bn5", P, train))


def x3d_map(clips, w: W, P: Precision, train: bool,
            pre: str = "motion.") -> torch.Tensor:
    """One stream's clips ``[B, T, H, W, 3]`` (uint8, or float in [0, 1])
    -> ReLU of the ``fc`` of the map's time mean ``[B, H/32, W/32, D]``."""
    y = backbone(nets.normalize_frames(clips), w, P, train, pre).mean(dim=2)
    return torch.relu(nets.conv(y, w, pre + "fc", P, padding=1)
                      ).permute(0, 2, 3, 1)
