"""Plain reference of ``clipatt_x3d_m``: ``music_hidsep``'s U-Net7
and co-localization fusion trained on audio-visual and audio-only batches,
its visual stream each source's video clip of 16 frames through X3D-M
(``x3d.x3d_map``) in place of the SlowFast fast pathway.

The AV step runs the U-Net twice (the maps reversed against the reversed
ground truth, then in order): the mean of the two weighted BCEs plus
``match_weight`` times the sum of the match losses.  The AO step swaps
the pooled bottleneck's chunks per row where the row's uniform is at most
0.5, and takes the permutation-invariant BCE.  The fusion, the audio-only
fusion and the spectra are ``music_hidsep``'s.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import nets
from benchmark.reference.music_hidsep import _spectra, ao_fuse, coloc
from benchmark.reference.nets import Precision
from benchmark.reference.x3d import x3d_map

W = Dict[str, torch.Tensor]


def train_loss(w: W, batch: Dict, use_vis: bool, flags: Dict,
               P: Precision, uniforms: Optional[torch.Tensor] = None,
               stage: int = 0) -> torch.Tensor:
    """The training loss of one batch (train-mode BatchNorm)."""
    nd = int(flags["arch_sound"][-1])
    mag_mix, mags = _spectra(batch["audios"], flags)
    _, gt, weights, log_mag = nets.prepare(
        mag_mix, mags, bool(flags["log_freq"]), bool(flags["weighted_loss"]))
    x = log_mag[:, None]
    N = flags["num_mix"]
    if not use_vis:
        out, _ = nets.unet(x, w, P, True, nd,
                           lambda h: ao_fuse(h, uniforms, P, N))
        loss, _ = nets.pit(torch.sigmoid(out.float()), gt, weights)
        return loss.mean()
    feats = [x3d_map(batch["clips"][:, n], w, P, True)
             for n in range(N)]

    def one_pass(vis, target):
        v = torch.stack(vis)
        box = {}

        def fuse(h):
            fused, box["match"] = coloc(h, v, P)
            return fused
        out, _ = nets.unet(x, w, P, True, nd, fuse)
        preds = torch.sigmoid(out.float()).movedim(1, 0)     # [N, B, H, W]
        err = (nets.bce(preds, target.movedim(1, 0)) * weights).mean()
        return err, box["match"].mean()

    err1, m1 = one_pass(feats[::-1], gt.flip(1))
    err0, m0 = one_pass(feats, gt)
    return (err1 + err0) / 2 + flags["match_weight"] * (m1 + m0)
