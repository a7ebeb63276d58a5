"""Plain reference of SlowFast R50 as the clip stream: both pathways, their
lateral connections, and the projection to the fusion's channels.

Written from the SlowFast paper (Feichtenhofer et al., ICCV 2019,
arXiv:1812.03982) as mmaction2 builds its Kinetics-400 ``slowfast_r50``
(``ResNet3dSlowFast``: ``resample_rate`` 8, ``speed_ratio`` 8,
``channel_ratio`` 8, ``fusion_kernel`` 5), following
``ResNet3dSlowFast.forward``: the slow pathway takes the clip resampled
to 1/8 of its frames by nearest interpolation, the fast pathway every
frame; after the stems' max-pools and after each of the first three
stages a lateral convolution of the fast map (``fusion_kernel`` x1x1 at
temporal stride 8, C -> 2C, no BatchNorm, no activation) is concatenated
behind the slow map's channels.

* slow pathway (``slow_path``): ResNet3d-50 at base 64, a 1x7x7 stem at
  stride (1, 2, 2) with BatchNorm and ReLU, a (1, 3, 3) max-pool at stride
  (1, 2, 2), stages ``[3, 4, 6, 3]`` of bottlenecks whose ``conv1`` is
  1x1x1 in res2 and res3 and 3x1x1 in res4 and res5 (``inflate (0, 0, 1,
  1)``), each stage's first block with a 1x1x1 downsample from the width
  the lateral left;
* fast pathway (``fast_path``): ``nets.resnet3d_fast``'s net, a stage at a
  time;
* laterals: ``slow_path.conv1_lateral``, ``slow_path.layer{1,2,3}_lateral``.

Departures from mmaction2, each as the system uses the net: the spatial
map is kept, not pooled (each pathway's map is averaged over its own
time axis and the two are concatenated, slow first); there is no
classification head; the frame net's ``fc`` (a 3x3 convolution with bias
to the fusion's channels) follows, then the ReLU; the weights are what
the caller hands in, drawn from the seed (mmaction2 zero-initializes each
``bn3`` scale); the running variance moves by the biased batch variance,
as for every net here; keys name the blocks ``layer2_0`` where mmaction2
writes ``layer2.0``, and the laterals' and convolutions' weights drop
mmaction2's ``.conv`` (``slow_path.layer1_lateral.weight``).

It imports nothing of the program and of the JAX package; it calls
``nets``' layers.  Run it in float32 with TF32 off (``nets.tf32(False)``)
for a float32 reading.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.nets import Precision

W = Dict[str, torch.Tensor]
RESAMPLE_RATE = 8       # the slow pathway's frames: 1 in 8
SPEED_RATIO = 8         # the laterals' temporal stride
BLOCKS = (3, 4, 6, 3)


def _bottleneck(h, w: W, name: str, P: Precision, train: bool, stride):
    """``nets._bottleneck3d``, whose ``conv1`` is 3x1x1; a 1x1x1 ``conv1``
    (the slow pathway's res2 and res3) takes no temporal padding."""
    if w[name + ".conv1.weight"].shape[2] == 3:
        return nets._bottleneck3d(h, w, name, P, train, stride)
    y = torch.relu(nets.batch_norm(nets.conv(h, w, name + ".conv1", P), w,
                                   name + ".bn1", P, train))
    y = nets.conv(y, w, name + ".conv2", P, stride=(1, stride, stride),
                  padding=(0, 1, 1))
    y = torch.relu(nets.batch_norm(y, w, name + ".bn2", P, train))
    y = nets.batch_norm(nets.conv(y, w, name + ".conv3", P), w,
                        name + ".bn3", P, train)
    if name + ".downsample_conv.weight" in w:
        h = nets.batch_norm(nets.conv(h, w, name + ".downsample_conv", P,
                                      stride=(1, stride, stride)), w,
                            name + ".downsample_bn", P, train)
    return torch.relu(y + h)


def _stem(x, w: W, name: str, P: Precision, train: bool, kt: int):
    """A pathway's stem on ``[B, 3, T, H, W]``: the ``kt`` x7x7 convolution
    at stride (1, 2, 2), BatchNorm, ReLU, the (1, 3, 3) max-pool at stride
    (1, 2, 2) padded with -inf."""
    h = nets.conv(x, w, name + "conv1", P, stride=(1, 2, 2),
                  padding=(kt // 2, 3, 3))
    h = torch.relu(nets.batch_norm(h, w, name + "bn1", P, train))
    return F.max_pool3d(F.pad(h, (1, 1, 1, 1), value=-math.inf), (1, 3, 3),
                        stride=(1, 2, 2))


def _stage(h, w: W, pre: str, P: Precision, train: bool, stage: int):
    for b in range(BLOCKS[stage]):
        h = _bottleneck(h, w, f"{pre}layer{stage + 1}_{b}", P, train,
                        2 if stage > 0 and b == 0 else 1)
    return h


def _lateral(x_slow, x_fast, w: W, name: str, P: Precision):
    lat = nets.conv(x_fast, w, name, P, stride=(SPEED_RATIO, 1, 1),
                    padding=(w[name + ".weight"].shape[2] // 2, 0, 0))
    return torch.cat([x_slow, lat], dim=1)


def pathways(clips, w: W, P: Precision, train: bool, pre: str = "motion."
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized clips ``[B, T, H, W, 3]`` -> the slow map ``[B, 2048,
    T/8, H/32, W/32]`` and the fast map ``[B, 256, T, H/32, W/32]``."""
    x = clips.permute(0, 4, 1, 2, 3)
    slow, fast = pre + "slow_path.", pre + "fast_path."
    x_slow = F.interpolate(x, mode="nearest",
                           scale_factor=(1.0 / RESAMPLE_RATE, 1.0, 1.0))
    x_slow = _stem(x_slow, w, slow, P, train, 1)
    x_fast = _stem(x, w, fast, P, train, 5)
    x_slow = _lateral(x_slow, x_fast, w, slow + "conv1_lateral", P)
    for stage in range(len(BLOCKS)):
        x_slow = _stage(x_slow, w, slow, P, train, stage)
        x_fast = _stage(x_fast, w, fast, P, train, stage)
        if stage < len(BLOCKS) - 1:
            x_slow = _lateral(x_slow, x_fast, w,
                              f"{slow}layer{stage + 1}_lateral", P)
    return x_slow, x_fast


def slowfast_map(clips, w: W, P: Precision, train: bool,
                 pre: str = "motion.") -> torch.Tensor:
    """One stream's clips ``[B, T, H, W, 3]`` (uint8, or float in [0, 1])
    -> ReLU of the ``fc`` of the two pathways' time means ``[B, H/32,
    W/32, D]``."""
    x_slow, x_fast = pathways(nets.normalize_frames(clips), w, P, train,
                              pre)
    y = torch.cat([x_slow.mean(dim=2), x_fast.mean(dim=2)], dim=1)
    return torch.relu(nets.conv(y, w, pre + "fc", P, padding=1)
                      ).permute(0, 2, 3, 1)
