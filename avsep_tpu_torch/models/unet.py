"""Spectrogram U-Net mask decoder with the audio-visual fusion bottleneck.

Port of ``avsep_tpu/models/unet.py`` (reference ``models/audio_net.py``):
a 5/6/7-level encoder-decoder over the log-magnitude spectrogram whose
innermost block hosts the CoLoc fusion.

Architecture (unet7, ngf=64, input 256x256x1):
  encoder: conv4x4/s2 features [64,128,256,512,512,512,512] -> 2x2x512
  bottleneck: the fusion doubles the channels -> 2x2x1024
  decoder: ReLU -> bilinear x2 (align_corners=True) -> conv3x3 -> BN,
           skip = channel concat with the same-depth encoder activation
  outermost: no BN, conv with bias, fc_dim output channels, no skip.

The down path applies LeakyReLU(0.2) before each conv after the first and
BatchNorm after it (not on the innermost), and the input passes a learned
BatchNorm2d(1) (``bn0``).  The convolutions run NCHW; the public interface
keeps the JAX package's NHWC: ``x [B, H, W, 1]`` in, masks
``[B, H, W, fc_dim]`` out.  ``dtype`` is the compute dtype of the convs
and BatchNorms; the fusion runs in float32 whatever it is, its inputs cast
up and its output back down to ``dtype`` (``avsep_tpu/models/unet.py:93-98``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from avsep_tpu_torch.models.fusion import FusionOut, get_fusion
from avsep_tpu_torch.models.layers import (
    ConvDown, ConvUp, TorchBatchNorm, leaky_relu, upsample2x_align_corners)


def _down_features(ngf: int, num_downs: int) -> List[int]:
    feats = [ngf, ngf * 2, ngf * 4, ngf * 8]
    feats += [ngf * 8] * (num_downs - 4)
    return feats[:num_downs]


class AudioUnet(nn.Module):
    """U-Net over ``[B, H, W, 1]`` log-magnitude, fusion at the bottleneck.

    ``forward(x, v, option, swap_uniforms, generator)``:
      x: [B, H, W, 1] log-magnitude spectrogram.
      v: stacked visual maps [C, B, Hv, Wv, vis_ch], or None (audio-only).
      swap_uniforms / generator: the audio-only slot swap's draw.
    Returns (masks [B, H, W, fc_dim], FusionOut with ``features=None``).

    Submodules carry the JAX package's names (``bn0.bn``, ``down{d}.conv``,
    ``down_bn{d}.bn``, ``up{d}.conv``, ``up_bn{d}.bn``).
    """

    def __init__(self, fc_dim: int = 64, num_downs: int = 5, ngf: int = 64,
                 fusion_type: str = "hidsep", att_type: str = "cos",
                 att_temp: float = 1.0, num_sources: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_downs = num_downs
        self.att_type = att_type
        self.att_temp = att_temp
        self.num_sources = num_sources
        self.fuse = get_fusion(fusion_type)
        feats = _down_features(ngf, num_downs)

        self.bn0 = TorchBatchNorm(1, dtype)
        for d in range(num_downs):
            self.add_module(f"down{d}", ConvDown(
                1 if d == 0 else feats[d - 1], feats[d], dtype))
            if 0 < d < num_downs - 1:
                self.add_module(f"down_bn{d}", TorchBatchNorm(feats[d], dtype))
        for d in range(num_downs - 1, -1, -1):
            out = fc_dim if d == 0 else feats[d - 1]
            self.add_module(f"up{d}", ConvUp(2 * feats[d], out,
                                             use_bias=(d == 0), dtype=dtype))
            if d > 0:
                self.add_module(f"up_bn{d}", TorchBatchNorm(out, dtype))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The reference initializers, drawn from ``generator`` in module
        order."""
        for m in self.children():
            m.reset_parameters_(generator)

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor] = None,
                option: Optional[str] = None,
                swap_uniforms: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, FusionOut]:
        nd = self.num_downs
        h = self.bn0(x.permute(0, 3, 1, 2))          # NHWC -> NCHW

        # ---- encoder ----
        skips = []
        for d in range(nd):
            if d > 0:
                h = leaky_relu(h, 0.2)
            h = getattr(self, f"down{d}")(h)
            if 0 < d < nd - 1:
                h = getattr(self, f"down_bn{d}")(h)
            skips.append(h)

        # ---- fusion bottleneck (channels-last, float32) ----
        out: FusionOut = self.fuse(
            h.permute(0, 2, 3, 1).float(),
            None if v is None else v.float(),
            att_type=self.att_type, option=option,
            n_sources=self.num_sources, att_temp=self.att_temp,
            uniforms=swap_uniforms, generator=generator)
        h = out.features.to(self.dtype).permute(0, 3, 1, 2)

        # ---- decoder ----
        for d in range(nd - 1, -1, -1):
            h = torch.relu(h)
            h = upsample2x_align_corners(h)
            h = getattr(self, f"up{d}")(h)
            if d > 0:
                h = getattr(self, f"up_bn{d}")(h)
                h = torch.cat([skips[d - 1], h], dim=1)

        return h.permute(0, 2, 3, 1), out._replace(features=None)
