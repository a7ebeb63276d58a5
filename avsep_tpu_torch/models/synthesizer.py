"""Sound-of-Pixels mask synthesizer heads.

Port of ``avsep_tpu/models/synthesizer.py`` (reference
``models/synthesizer_net.py``): inner-product heads that combine a visual
feature vector with the per-pixel sound basis.

* ``InnerProd`` (synthesizer_net.py:6-38): ``scale * <img, sound> + bias``
  with a learned per-channel ``scale``;
* ``Bias`` (synthesizer_net.py:41-70): the plain inner product + ``bias``.

Channels last, as the JAX package: sound features ``[B, H, W, C]``, image
features ``[B, C]`` (or ``[B, HI, WI, C]`` for the pixelwise demo).  The
parameters carry the JAX package's names (``scale``, ``bias``), so a JAX
parameter tree is the ``state_dict`` as it stands.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class InnerProd(nn.Module):
    def __init__(self, fc_dim: int = 64):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(fc_dim))
        self.bias = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters_(self, generator=None) -> None:
        """Ones and zeros (the JAX package's initializers); draws nothing."""
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, feat_img: torch.Tensor,
                feat_sound: torch.Tensor) -> torch.Tensor:
        """[B, C] x [B, H, W, C] -> [B, H, W, 1] masks
        (synthesizer_net.py:12-19)."""
        z = torch.einsum("bc,bhwc->bhw", feat_img * self.scale, feat_sound)
        return z[..., None] + self.bias

    def forward_nosum(self, feat_img: torch.Tensor,
                      feat_sound: torch.Tensor) -> torch.Tensor:
        """Per-channel product without the sum (synthesizer_net.py:21-26)."""
        return (feat_img * self.scale)[:, None, None, :] * feat_sound \
            + self.bias

    def forward_pixelwise(self, feats_img: torch.Tensor,
                          feat_sound: torch.Tensor) -> torch.Tensor:
        """[B, HI, WI, C] x [B, HS, WS, C] -> [B, HI, WI, HS, WS]
        (synthesizer_net.py:29-38)."""
        z = torch.einsum("bijc,bhwc->bijhw", feats_img * self.scale,
                         feat_sound)
        return z + self.bias


class Bias(nn.Module):
    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def reset_parameters_(self, generator=None) -> None:
        self.bias.zero_()

    def forward(self, feat_img: torch.Tensor,
                feat_sound: torch.Tensor) -> torch.Tensor:
        z = torch.einsum("bc,bhwc->bhw", feat_img, feat_sound)
        return z[..., None] + self.bias

    def forward_nosum(self, feat_img: torch.Tensor,
                      feat_sound: torch.Tensor) -> torch.Tensor:
        return feat_img[:, None, None, :] * feat_sound + self.bias

    def forward_pixelwise(self, feats_img: torch.Tensor,
                          feat_sound: torch.Tensor) -> torch.Tensor:
        z = torch.einsum("bijc,bhwc->bijhw", feats_img, feat_sound)
        return z + self.bias
