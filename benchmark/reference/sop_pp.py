"""Plain reference of ``sop_pp``: SoP++'s basis U-Net, whose innermost
convolution emits extra per-source feature-weight channels, the
inner-product synthesizer and the PIT attention module (``AttModel`` with
cosine attention), at curriculum stage 3 and on audio-only batches
(SoP++ ``main.py``: ``train_av_forward3``, ``ao_forward``).

* stage 3: the separated frames' maps in eval mode without a gradient;
  the duet image (the sources' frames side by side) through the frame net
  in train mode; the feature-weight vectors attend over its map (the
  regularization loss); the attended contexts reordered against the
  separated maps by the best permutation (the match loss); their sigmoid
  drives the synthesizer; loss = the weighted BCE + ``match_weight`` x
  (reg + match);
* audio-only: the pooled feature-weight vectors drive the synthesizer
  directly, with the permutation-invariant BCE.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from benchmark.reference import nets
from benchmark.reference.nets import Precision

W = Dict[str, torch.Tensor]


def synth(w: W, feat: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``sigmoid(<feat * scale, basis> + bias)``: ``[B, C] x [B, H, W, C]``
    -> ``[B, H, W]``."""
    z = torch.einsum("bc,bhwc->bhw", feat * w["synthesizer.scale"], basis)
    return torch.sigmoid(z + w["synthesizer.bias"])


def train_loss(w: W, batch: Dict, use_vis: bool, flags: Dict,
               P: Precision, uniforms: Optional[torch.Tensor] = None,
               stage: int = 3) -> torch.Tensor:
    if use_vis and stage != 3:
        raise ValueError("the reference follows curriculum stage 3 only")
    nd = int(flags["arch_sound"][-1])
    N, C = flags["num_mix"], flags["num_channels"]
    audios = batch["audios"]
    n_fft, hop = flags["stft_frame"], flags["stft_hop"]
    mag_mix = nets.stft(audios.sum(dim=1), n_fft, hop).abs()
    mags = nets.stft(audios, n_fft, hop).abs()
    _, gt, weights, log_mag = nets.prepare(
        mag_mix, mags, bool(flags["log_freq"]), bool(flags["weighted_loss"]))
    out, side = nets.unet(log_mag[:, None], w, P, True, nd, None,
                          extra=C * N)
    basis = out.permute(0, 2, 3, 1)                          # [B, H, W, C]
    fw = side.permute(0, 2, 3, 1)
    aud = torch.stack(torch.chunk(fw, N, dim=-1)).mean(dim=(2, 3))
    aud = aud.movedim(0, 1)                                  # [B, N, D]
    if not use_vis:
        preds = torch.stack([synth(w, aud[:, n], basis) for n in range(N)],
                            dim=1)
        loss, _ = nets.pit(preds, gt, weights)
        return loss.mean()
    frames = batch["frames"]
    with torch.no_grad():
        sep = torch.stack([nets.frame_map(frames[:, n], w, P, False)
                           for n in range(N)])               # [N, B, h, w, D]
    duet = torch.cat([frames[:, n] for n in range(N)], dim=-2)
    mix = nets.frame_map(duet, w, P, True)                   # [B, h, 2w, D]
    maps = nets.cosine(aud[:, :, None, None, :], mix[:, None], dim=-1)
    reg = -torch.mean(torch.sum(maps.mean(dim=(2, 3)), dim=-1))
    maps = torch.clamp(maps, 0.0, 1.0)
    ctx = (mix[:, None] * maps[..., None]).mean(dim=(2, 3))  # [B, N, D]
    glb = sep.mean(dim=(2, 3)).movedim(0, 1)
    orders = torch.stack([ctx, ctx.flip(1)], dim=1)          # [B, 2, N, D]
    scores = nets.cosine(orders, glb[:, None], dim=-1).sum(-1)
    best = torch.argmax(scores, dim=1)
    rows = torch.arange(ctx.shape[0], device=ctx.device)
    best_score = scores[rows, best]
    match = torch.mean(-best_score + (scores.sum(1) - best_score))
    ctx = torch.sigmoid(orders[rows, best])
    preds = torch.stack([synth(w, ctx[:, n], basis) for n in range(N)],
                        dim=1)
    err = (nets.bce(preds, gt) * weights[:, None]).mean()
    return err + flags["match_weight"] * (reg + match)
