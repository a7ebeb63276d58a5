"""Mixture preparation: warp -> loss weights -> GT masks -> log.

Port of ``avsep_tpu/ops/prepare.py`` (reference ``NetWrapper.prepare``,
``main.py:51-95``):

1. ``mag_mix += 1e-10``
2. log-frequency warp of the mixture and of each source magnitude
3. loss weights ``clamp(log1p(mag_mix), 1e-3, 10)`` if ``weighted_loss``
4. ground-truth masks after the warp: binary ``mags > 0.5 * mag_mix`` or
   ratio ``clamp(mags / mag_mix, 0, 5)``
5. ``log(mag_mix)`` as the U-Net input, detached from the graph (reference
   ``main.py:85``).

Magnitudes are ``[B, F, T]``, sources stacked at axis 1 ``[B, N, F, T]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from avsep_tpu_torch.ops.warp import warp_spectrogram


class PreparedBatch(NamedTuple):
    mag_mix: torch.Tensor      # [B, FO, T] warped mixture magnitude
    mags: torch.Tensor         # [B, N, FO, T] warped source magnitudes
    log_mag_mix: torch.Tensor  # [B, FO, T] U-Net input
    gt_masks: torch.Tensor     # [B, N, FO, T]
    weights: torch.Tensor      # [B, FO, T]


def prepare(mag_mix: torch.Tensor, mags: torch.Tensor, *,
            log_freq: bool = True, weighted_loss: bool = True,
            binary_mask: bool = True, warp_bins: int = 256) -> PreparedBatch:
    """See the module docstring.  ``mag_mix [B, F, T]``,
    ``mags [B, N, F, T]``."""
    mag_mix = mag_mix.float() + 1e-10
    mags = mags.float()

    if log_freq:
        mag_mix = warp_spectrogram(mag_mix, HO=warp_bins)
        mags = warp_spectrogram(mags, HO=warp_bins)

    if weighted_loss:
        weights = torch.clamp(torch.log1p(mag_mix), 1e-3, 10.0)
    else:
        weights = torch.ones_like(mag_mix)

    if binary_mask:
        gt_masks = (mags > 0.5 * mag_mix[:, None]).float()
    else:
        gt_masks = torch.clamp(mags / mag_mix[:, None], 0.0, 5.0)

    with torch.no_grad():
        log_mag_mix = torch.log(mag_mix)
    return PreparedBatch(mag_mix, mags, log_mag_mix, gt_masks, weights)
