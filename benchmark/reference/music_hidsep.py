"""Plain reference of ``music_hidsep``: the U-Net7 mask decoder with the
co-localization fusion (``hidsep``, scaled-dot sigmoid attention) against
dilated ResNet18 maps, trained jointly on audio-visual and audio-only
batches, and its separation of a mixture into two wavs.  Under
``fusion_type CoLoc_ClipAtt`` the same fusion attends over the SlowFast
fast pathway's maps of each source's video clip instead
(``nets.motion_map``), and the frame net does not run.

* the AV step (reference ``main.py``, ``NetWrapper.forward``): the U-Net
  runs twice, once with the visual maps in reverse order against the
  reversed ground truth, once in order; the loss is the mean of the two
  weighted BCEs plus ``match_weight`` times the sum of the match losses;
* the AO step: the pooled bottleneck's two chunks swapped per row where
  the row's uniform is at most 0.5, broadcast as the guidance, and the
  permutation-invariant BCE;
* separation: sigmoid masks, the unwarp to 512 bins, the 0.5 threshold,
  the masked magnitude with the mixture's phase, the inverse STFT and a
  clip to [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import nets
from benchmark.reference.nets import Precision

W = Dict[str, torch.Tensor]


def coloc(h: torch.Tensor, v: torch.Tensor, P: Precision):
    """The fusion at the bottleneck ``h [B, D, h, w]`` against the visual
    maps ``v [C, B, H, W, D/C]``, in float32: each source's chunk of the
    max-pooled bottleneck scored against each map (sigmoid of the dot
    product over sqrt(D/C)), the best of the C! assignments kept, each map
    max-pooled under its attention, broadcast as guidance in front of the
    bottleneck.  Returns ``(fused [B, 2D, h, w], match loss per row)``."""
    x = h.permute(0, 2, 3, 1).float()
    B, hh, ww, D = x.shape
    C = v.shape[0]
    Dc = D // C
    chunks = x.amax(dim=(1, 2)).reshape(B, C, Dc)
    vb = v.float().movedim(0, 1)                          # [B, C, H, W, Dc]
    orders = [chunks, chunks.flip(1)] if C == 2 else None
    maps = torch.stack([torch.sigmoid(
        (o[:, :, None, None, :] * vb / Dc ** 0.5).sum(-1)) for o in orders],
        dim=1)                                             # [B, P, C, H, W]
    scores = maps.amax(dim=(3, 4)).sum(dim=2)              # [B, P]
    best = torch.argmax(scores, dim=1)
    best_score = scores.gather(1, best[:, None])[:, 0]
    match_ps = -best_score + (scores.sum(1) - best_score)
    att = maps[torch.arange(B, device=x.device), best]      # [B, C, H, W]
    feat = (vb * att[..., None]).amax(dim=(2, 3))           # [B, C, Dc]
    guide = feat.reshape(B, 1, 1, C * Dc).expand(B, hh, ww, C * Dc)
    fused = torch.cat([guide, x], dim=-1).to(P.dtype)
    return fused.permute(0, 3, 1, 2), match_ps


def ao_fuse(h: torch.Tensor, uniforms: torch.Tensor, P: Precision,
            C: int = 2) -> torch.Tensor:
    """The audio-only fusion: the pooled chunks swapped where u <= 0.5."""
    x = h.permute(0, 2, 3, 1).float()
    B, hh, ww, D = x.shape
    chunks = x.amax(dim=(1, 2)).reshape(B, C, D // C)
    swap = (uniforms.to(x.device) <= 0.5)[:, None, None]
    chunks = torch.where(swap, chunks.flip(1), chunks)
    guide = chunks.reshape(B, 1, 1, D).expand(B, hh, ww, D)
    return torch.cat([guide, x], dim=-1).to(P.dtype).permute(0, 3, 1, 2)


def _spectra(audios: torch.Tensor, flags: Dict):
    mix = audios.sum(dim=1)
    n_fft, hop = flags["stft_frame"], flags["stft_hop"]
    return (nets.stft(mix, n_fft, hop).abs(),
            nets.stft(audios, n_fft, hop).abs())


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
        preds = torch.sigmoid(out.float())                  # [B, N, H, W]
        loss, _ = nets.pit(preds, gt, weights)
        return loss.mean()
    if flags["fusion_type"] == "CoLoc_ClipAtt":     # the motion net
        feats = [nets.motion_map(batch["clips"][:, n], w, P, True)
                 for n in range(N)]
    else:
        feats = [nets.frame_map(batch["frames"][:, n], w, P, True)
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


@torch.no_grad()
def separate(w: W, audio_mix: torch.Tensor, frames: Optional[torch.Tensor],
             uniforms: Optional[torch.Tensor], flags: Dict,
             P: Precision) -> torch.Tensor:
    """``audio_mix [B, L]`` and ``frames [B, N, T, H, W, 3]`` (float RGB in
    [0, 1]) or None with ``uniforms [B]`` -> wavs ``[B, N, L']``
    (eval-mode BatchNorm)."""
    nd = int(flags["arch_sound"][-1])
    spec = nets.stft(audio_mix, flags["stft_frame"], flags["stft_hop"])
    mag, phase = spec.abs(), spec.angle()
    log_mag = torch.log(nets.warp(mag + 1e-10, 256, True))
    if frames is None:
        fuse = lambda h: ao_fuse(h, uniforms, P, flags["num_mix"])  # noqa
    else:
        v = torch.stack([nets.frame_map(frames[:, n], w, P, False)
                         for n in range(frames.shape[1])])
        fuse = lambda h: coloc(h, v, P)[0]  # noqa: E731
    out, _ = nets.unet(log_mag[:, None], w, P, False, nd, fuse)
    masks = torch.sigmoid(out.float())                       # [B, N, 256, T]
    lin = nets.warp(masks, flags["stft_frame"] // 2 + 1, False)
    binary = (lin > flags["mask_thres"]).float()
    pred = (mag[:, None] * binary).to(torch.complex64) * torch.exp(
        1j * phase[:, None].to(torch.complex64))
    return torch.clamp(nets.istft(pred, flags["stft_hop"]), -1.0, 1.0)
