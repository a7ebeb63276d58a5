"""SoP++ forward engine: the 3-stage curriculum and the audio-only PIT.

Port of ``avsep_tpu/sop_engine.py`` (reference ``SoP++/main.py``
NetWrapper, :39-246): the basis U-Net (``sound``), the frame encoder
(``frame``), the synthesizer (``synthesizer``) and the parameter-free PIT
attention module (``pit``: the function :func:`attmodule` picks from
``cfg.fusion_type``), trained in three stages:

1. SoP-style: the per-source pooled visual vectors drive the synthesizer
   (``train_av_forward1`` :94-127).
2. The separated visual features are frozen; ``pit`` on the duet image
   (the sources' frames side by side) adds a regularization loss
   (``train_av_forward2`` :129-170).
3. ``pit``'s context features drive the synthesizer; match + reg losses
   (``train_av_forward3`` :172-213).

AO: ``pit`` slots from the bottleneck's feature weights and a PIT BCE
(``ao_forward`` :215-246).

Frozen features (stages 2 and 3) run the frame net in eval mode, with its
running statistics and no update of them, and without a gradient, as the
JAX package's ``stop_grad`` path (``train=False`` + ``stop_gradient``).  In
train mode the BatchNorms update in place in the JAX package's order: the
sound net, then the frame net per source (stage 1), then the frame net on
the duet image (stages 2 and 3).  No draw: the SoP++ forward is
deterministic.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import criterion as crit
from avsep_tpu_torch.models.builder import activate
from avsep_tpu_torch.models.sop import get_attmodule
from avsep_tpu_torch.parallel import distributed as pdist


class SopNets(NamedTuple):
    """The SoP++ nets with parameters (the JAX package's fourth field, the
    attention module, is a function of ``cfg.fusion_type``)."""
    sound: Any        # BasisUnet
    frame: Any        # FrameEncoder
    synthesizer: Any  # InnerProd / Bias


def stage_for_iter(i: int, train_steps) -> int:
    """Reference train_step_3stage (SoP++/main.py:670-688)."""
    if i < train_steps[0]:
        return 1
    if train_steps[0] <= i < train_steps[1]:
        return 2
    return 3


def _apply_frame(nets: SopNets, frames_n: torch.Tensor, cfg: Config,
                 stop_grad: bool = False) -> torch.Tensor:
    """The frame net on one stream, activated.  ``stop_grad``: in eval mode
    (running statistics, no update) and without a gradient, the net's mode
    restored after."""
    frames_n = engine.normalize_frames(frames_n)  # uint8 wire -> float32
    if stop_grad:
        mode = nets.frame.training
        nets.frame.eval()
        try:
            with torch.no_grad():
                out = nets.frame(frames_n, pool=cfg.not_pool_vis)
        finally:
            nets.frame.train(mode)
    else:
        out = nets.frame(frames_n, pool=cfg.not_pool_vis)
    return activate(out, cfg.img_activation, upcast=False)


def _apply_sound(nets: SopNets, log_mag: torch.Tensor, cfg: Config):
    basis, fw = nets.sound(log_mag[..., None])
    return activate(basis, cfg.sound_activation, upcast=False), fw


def _split_feat_weights(fw: torch.Tensor, n: int) -> torch.Tensor:
    """[B, h, w, extra*C] -> [C, B, h, w, extra] (tensor_split dim=1,
    SoP++/main.py:103)."""
    return torch.stack(torch.chunk(fw, n, dim=-1))


def _synthesize(nets: SopNets, ctx_n: torch.Tensor, basis: torch.Tensor,
                cfg: Config) -> torch.Tensor:
    """The synthesizer's mask for one source (SoP++/main.py:119-121)."""
    mask = nets.synthesizer(ctx_n, basis)
    return activate(mask[..., 0], cfg.output_activation)   # [B, H, W]


def attmodule(cfg: Config):
    """``get_attmodule(cfg.fusion_type)``; the flagship's fusion types
    (``hidsep``...) mean ``Base``, as the JAX package's ``sop_forward``."""
    return get_attmodule(cfg.fusion_type if cfg.fusion_type in (
        "Base", "MatchAtt") else "Base")


def sop_forward(nets: SopNets, batch, cfg: Config, use_vis: bool, *,
                train: bool, stage: int = 3):
    """Dispatch (reference SoP++/main.py:249-260).  ``batch`` as
    ``engine.forward`` takes it.  Returns ``(err, outputs)``; in train mode
    the BatchNorms' running statistics update in place."""
    nets.sound.train(train)
    nets.frame.train(train)
    dev = next(nets.sound.parameters()).device
    batch = {k: engine._to_device(v, dev) for k, v in batch.items()}
    prep = engine._prepare(batch, cfg)
    N = cfg.num_mix
    att = attmodule(cfg)

    basis, fw = _apply_sound(nets, prep.log_mag_mix, cfg)
    feat_weights = _split_feat_weights(fw, N)     # [C, B, h, w, extra]

    if not use_vis:
        # ---------------- AO: pit slots + PIT BCE (:215-246)
        out = att(feat_weights, None, None, att_type=cfg.att_type)
        preds = torch.stack(
            [_synthesize(nets, out.ctx_feats[:, n], basis, cfg)
             for n in range(N)], dim=-1)           # [B, H, W, C]
        gt = prep.gt_masks.movedim(1, -1)
        w = torch.stack([prep.weights] * N, dim=-1)
        losses, perms = crit.pit_loss(preds, gt, w, kind="bce")
        ordered = crit.reorder_sources(preds, perms)
        outputs = {"pred_masks": ordered.movedim(-1, 1),
                   "gt_masks": prep.gt_masks, "mag_mix": prep.mag_mix,
                   "mags": prep.mags, "weight": prep.weights,
                   "match_loss": torch.zeros((), device=dev),
                   "err_ps": losses}  # [B] per-sample PIT losses
        return torch.mean(losses), outputs

    # ---------------- AV stages
    frames = batch["frames"]                       # [B, N, T, H, W, 3]
    stop_sep = stage in (2, 3)  # sep feats frozen in stages 2/3 (:139-143)
    sep_vis = torch.stack([_apply_frame(nets, frames[:, n], cfg,
                                        stop_grad=stop_sep)
                           for n in range(N)])    # [C, B, H, W, D]

    match_loss = torch.zeros((), device=dev)
    if stage == 1:
        ctx = torch.mean(sep_vis, dim=(2, 3)).movedim(0, 1)   # [B, C, D]
        ctx = activate(ctx, cfg.output_activation)
        extra_loss = None
    else:
        # the duet image: the sources' frames along the width (:147-149)
        mix_frames = torch.cat([frames[:, n] for n in range(N)], dim=-2)
        mix_vis = _apply_frame(nets, mix_frames, cfg)
        out = att(feat_weights, mix_vis, sep_vis, att_type=cfg.att_type)
        reg = out.reg_loss if out.reg_loss is not None else match_loss
        mtc = out.match_loss if out.match_loss is not None else match_loss
        if stage == 2:
            ctx = torch.mean(sep_vis, dim=(2, 3)).movedim(0, 1)
            ctx = activate(ctx, cfg.output_activation)
            match_loss = reg
        else:  # stage 3: the pit context drives the synthesizer (:193-206)
            ctx = activate(out.ctx_feats, cfg.output_activation)
            match_loss = reg + mtc
        extra_loss = match_loss * cfg.match_weight

    preds = torch.stack(
        [_synthesize(nets, ctx[:, n], basis, cfg) for n in range(N)],
        dim=1)                                     # [B, N, H, W]
    # [B] per-sample losses whose mean is the batch scalar (the scalar
    # extra loss is shared across samples)
    err_ps = crit.multi_source_loss(preds.movedim(1, 0),
                                    prep.gt_masks.movedim(1, 0),
                                    prep.weights, kind=cfg.loss,
                                    per_sample=True)
    err = torch.mean(err_ps)
    if extra_loss is not None:
        err = err + extra_loss
        # the extra loss is a mean over the batch's rows: under a process
        # group the samples share the global batch's, the ranks' mean
        shared = extra_loss.detach().clone()
        pdist.mean_([shared])
        err_ps = err_ps + shared
    outputs: Dict[str, torch.Tensor] = {
        "pred_masks": preds, "gt_masks": prep.gt_masks,
        "mag_mix": prep.mag_mix, "mags": prep.mags, "weight": prep.weights,
        "match_loss": match_loss, "err_ps": err_ps}
    return err, outputs
