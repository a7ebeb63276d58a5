"""SoP++ model family: the basis U-Net with an extra-channel bottleneck, and
the PIT attention modules.

Port of ``avsep_tpu/models/sop.py`` (reference SoP++ tree):

* :class:`BasisUnet`: a U-Net whose innermost conv emits ``extra_size * C``
  extra channels, split off as the per-source *feature weights* instead of
  running a fusion there (reference ``SoP++/audio_net.py:151-198``, the
  split at :195).  It outputs a ``fc_dim``-channel sound basis; the masks
  come from the synthesizer against per-source context vectors.
* :func:`att_model` / :func:`match_att`: the ``AttModel`` / ``MatchAtt``
  cross-modal PIT attention modules (reference ``SoP++/attention_net.py``),
  parameter-free functions.  The reference's ``self.max_pool`` is an
  AdaptiveAvgPool3d (attention_net.py:19): the pooling is an average.

The convolutions run NCHW; the interface keeps the JAX package's channels
last: feature-weight maps ``[C, B, h, w, extra]``, visual maps
``[B, H, W, D]``.  Submodules carry the JAX package's names (``bn0.bn``,
``down{d}.conv``, ``down_bn{d}.bn``, ``up{d}.conv``, ``up_bn{d}.bn``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn

from avsep_tpu_torch.models.layers import (
    ConvDown, ConvUp, TorchBatchNorm, cosine_similarity, leaky_relu,
    upsample2x_align_corners)
from avsep_tpu_torch.models.unet import _down_features


class BasisUnet(nn.Module):
    """Sound-basis U-Net (reference SoP++/audio_net.py:10-43).

    ``forward(x)``: ``x [B, H, W, 1]`` -> (basis ``[B, H, W, fc_dim]``,
    feat_weights ``[B, h, w, extra_size * n_sources]``).
    """

    def __init__(self, fc_dim: int = 64, num_downs: int = 5, ngf: int = 64,
                 extra_size: int = 32, n_sources: int = 2):
        super().__init__()
        self.num_downs = num_downs
        self.extra = extra_size * n_sources
        feats = _down_features(ngf, num_downs)

        self.bn0 = TorchBatchNorm(1)
        for d in range(num_downs):
            # the innermost conv emits the extra feature-weight channels
            width = feats[d] + (self.extra if d == num_downs - 1 else 0)
            self.add_module(f"down{d}",
                            ConvDown(1 if d == 0 else feats[d - 1], width))
            if 0 < d < num_downs - 1:
                self.add_module(f"down_bn{d}", TorchBatchNorm(feats[d]))
        for d in range(num_downs - 1, -1, -1):
            # the innermost up conv sees the bottleneck alone, the others
            # the skip concatenated with the level below
            cin = feats[d] if d == num_downs - 1 else 2 * feats[d]
            out = fc_dim if d == 0 else feats[d - 1]
            self.add_module(f"up{d}", ConvUp(cin, out, use_bias=(d == 0)))
            if d > 0:
                self.add_module(f"up_bn{d}", TorchBatchNorm(out))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        """The reference initializers, drawn from ``generator`` in module
        order (as ``AudioUnet``)."""
        for m in self.children():
            m.reset_parameters_(generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        nd = self.num_downs
        h = self.bn0(x.permute(0, 3, 1, 2))          # NHWC -> NCHW
        skips = []
        for d in range(nd):
            if d > 0:
                h = leaky_relu(h, 0.2)
            h = getattr(self, f"down{d}")(h)
            if 0 < d < nd - 1:
                h = getattr(self, f"down_bn{d}")(h)
            skips.append(h)

        # bottleneck split (reference SoP++/audio_net.py:195: extra first)
        feat_weights = h[:, :self.extra].permute(0, 2, 3, 1)
        h = h[:, self.extra:]

        for d in range(nd - 1, -1, -1):
            h = torch.relu(h)
            h = upsample2x_align_corners(h)
            h = getattr(self, f"up{d}")(h)
            if d > 0:
                h = getattr(self, f"up_bn{d}")(h)
                h = torch.cat([skips[d - 1], h], dim=1)
        return h.permute(0, 2, 3, 1), feat_weights


# ------------------------------------------------------------- attention


class AttOut(NamedTuple):
    ctx_feats: torch.Tensor                 # [B, C, D]
    match_loss: Optional[torch.Tensor]
    reg_loss: Optional[torch.Tensor]
    att_maps: Optional[torch.Tensor]        # [B, C, H, W]


def _avg_pool_feats(feats: torch.Tensor) -> torch.Tensor:
    """[C, B, h, w, D] -> [B, C, D] spatial average (the reference's
    misnamed 'max_pool', an AdaptiveAvgPool3d, attention_net.py:19)."""
    return torch.mean(feats, dim=(2, 3)).movedim(0, 1)


def _att_maps(ctx: torch.Tensor, vis: torch.Tensor,
              att_type: str) -> torch.Tensor:
    """ctx [B, C, D] x vis [B, H, W, D] -> maps [B, C, H, W]
    (attention_net.py:21-34)."""
    x = ctx[:, :, None, None, :]
    v = vis[:, None]
    if att_type == "cos":
        return cosine_similarity(x, v, dim=-1)
    d = ctx.shape[-1]
    return torch.sigmoid(torch.sum(x * v / (float(d) ** 0.5), dim=-1))


def _infer_forward(aud_vecs: torch.Tensor, mix_vis: torch.Tensor,
                   att_type: str):
    """av_infer_forward (attention_net.py:36-57): maps, the reg loss, the
    attended context features.  aud_vecs [B, C, D], mix_vis [B, H, W, D]."""
    maps = _att_maps(aud_vecs, mix_vis, att_type)            # [B, C, H, W]
    reg = -torch.mean(torch.sum(torch.mean(maps, dim=(2, 3)), dim=-1))
    maps = torch.clamp(maps, 0.0, 1.0)
    ctx = torch.mean(mix_vis[:, None] * maps[..., None], dim=(2, 3))
    return ctx, reg, maps


def _pit_reorder(query: torch.Tensor, keys: torch.Tensor):
    """Best-permutation match of query [B, C, D] against keys [B, C, D] by
    summed cosine scores; returns (reordered query, match_loss, order)
    (attention_net.py:93-107; the C = 2 case).  Ties go to the identity,
    the first maximum, as ``jnp.argmax``."""
    qp = torch.stack([query, query.flip(1)], dim=1)          # [B, P, C, D]
    scores = torch.sum(cosine_similarity(qp, keys[:, None], dim=-1), -1)
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(query.shape[0], device=query.device)
    best_score = scores[ar, best]
    match = torch.mean(-best_score + (torch.sum(scores, 1) - best_score))
    return qp[ar, best], match, best


def att_model(aud_feats: torch.Tensor, mix_vis: Optional[torch.Tensor],
              sep_vis: Optional[torch.Tensor], att_type: str = "cos"
              ) -> AttOut:
    """Reference ``AttModel`` (attention_net.py:16-119).

    aud_feats: [C, B, h, w, extra] per-source feature-weight maps.
    mix_vis:   [B, H, W, D] mixture visual map, or None (audio-only).
    sep_vis:   [C, B, H, W, D] separated visual maps, or None (inference).
    """
    aud_vecs = _avg_pool_feats(aud_feats)                    # [B, C, D]
    if mix_vis is None:
        return AttOut(aud_vecs, None, None, None)
    ctx, reg, maps = _infer_forward(aud_vecs, mix_vis, att_type)
    if sep_vis is None:
        # inference: the reference returns (reg-style match loss, maps)
        return AttOut(ctx, None, reg, maps)
    glb = _avg_pool_feats(sep_vis)                           # [B, C, D]
    ctx_re, match, best = _pit_reorder(ctx, glb)
    maps_p = torch.stack([maps, maps.flip(1)], dim=1)
    ar = torch.arange(maps.shape[0], device=maps.device)
    return AttOut(ctx_re, match, reg, maps_p[ar, best])


def match_att(aud_feats: torch.Tensor, mix_vis: Optional[torch.Tensor],
              sep_vis: Optional[torch.Tensor], att_type: str = "cos"
              ) -> AttOut:
    """Reference ``MatchAtt`` (attention_net.py:121-232): permutes the
    *audio* vectors against the separated visual features first, then runs
    the attention inference with the reordered slots."""
    aud_vecs = _avg_pool_feats(aud_feats)                    # [B, C, D]
    if mix_vis is None:
        return AttOut(aud_vecs, None, None, None)
    if sep_vis is None:
        ctx, reg, maps = _infer_forward(aud_vecs, mix_vis, att_type)
        return AttOut(ctx, None, reg, maps)
    glb = _avg_pool_feats(sep_vis)
    aud_re, match, _ = _pit_reorder(aud_vecs, glb)
    ctx, _, maps = _infer_forward(aud_re, mix_vis, att_type)
    return AttOut(ctx, match, None, maps)


def get_attmodule(fusion_type: str):
    """Dispatch (reference SoP++/attention_net.py:8-13)."""
    if fusion_type == "Base":
        return att_model
    if fusion_type == "MatchAtt":
        return match_att
    raise ValueError(f"unknown SoP++ fusion_type {fusion_type}")
