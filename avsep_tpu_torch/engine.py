"""Forward engines: the training losses and end-to-end separation.

Port of ``avsep_tpu/engine.py`` (reference ``NetWrapper``, ``main.py:39-160``,
and the inference wrapper, ``inference.py:29-136``):

* ``forward_av`` is the symmetric double pass: the U-Net runs once with the
  visual order reversed against the reversed ground truth, then forward;
  the losses are averaged and the match losses summed (``main.py:113-148``).
* ``forward_ao`` is the audio-only PIT path (``main.py:97-111``).
* ``forward_avmiximg`` is the MixVis duet path (``main.py:162-192``).
* ``separate``: stft -> +1e-10 -> warp -> log -> U-Net with the fusion
  against the frame encoder's maps -> sigmoid -> unwarp -> binary threshold
  -> mask * mag -> iSTFT with the mixture phase -> clip.

Batches are dicts with the JAX package's keys and shapes, batch first:
``audios [B, N, L]`` (or the int16 wire's ``audios_i16`` + ``audio_gain``),
optional ``audio_mix [B, L]`` (else the sum of ``audios``), ``frames
[B, N, T, H, W, 3]`` (uint8 or float), or precomputed ``mag_mix``/``mags``.
Separation's public shapes: ``audio_mix [B, L]``, ``frames
[B, N, T, H, W, 3]``, ``wavs [B, N, L']``, ``masks [B, N, FO, T]``,
``masks_linear [B, N, F, T]``, ``att_maps [B, C, H, W]``.

The forwards put the nets in train or eval mode as ``train`` says.  In
train mode the BatchNorms normalize with batch statistics and update their
running statistics in place (Flax's update, ``models/layers.py``), in the
JAX package's order: the frame net once per source, each call from the
previous call's statistics, and the sound net's second pass from the
first's.  The audio-only slot swap takes injected uniforms or a
``torch.Generator``.

The entry points (:func:`build_nets`, :func:`init_params`, :func:`separate`
and the forwards through the nets they are given) run on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU they raise rather than
fall back to the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data.wire import encode_audio_wire
from avsep_tpu_torch.models import criterion as crit
from avsep_tpu_torch.models.builder import ModelBuilder, activate
from avsep_tpu_torch.ops.prepare import PreparedBatch, prepare
from avsep_tpu_torch.ops.stft import istft, stft_magphase
from avsep_tpu_torch.ops.warp import unwarp_mask

# ROADMAP.md, "Queue 1": what the port leaves for later slices
MOTION_ITEM = "ROADMAP.md Queue 1, 'models/motion.py'"
REMAT_ITEM = "ROADMAP.md Queue 1, 'remat'"


class Nets(NamedTuple):
    """The sound U-Net and the frame encoder (the reference builds
    (net_sound, net_frame), main.py:608-625)."""
    sound: Any
    frame: Any


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, and raises when
    there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def nets_device(nets: Nets, device=None) -> torch.device:
    """:func:`resolve_device` of ``device``, checked against ``nets``: raises
    if a parameter lies on another device."""
    dev = resolve_device(device)
    for net_name, net in nets._asdict().items():
        for name, p in net.named_parameters():
            if p.device.type != dev.type:
                raise ValueError(f"{net_name}.{name} lies on {p.device}, "
                                 f"not {dev}")
    return dev


def build_nets(cfg: Config, device=None) -> Nets:
    """The sound U-Net and the frame encoder of ``cfg`` on ``device``, in
    eval mode (weights as PyTorch initializes them; see
    :func:`init_params` for the reference's initializers)."""
    dev = resolve_device(device)
    if cfg.load_clips or cfg.fusion_type == "CoLoc_ClipAtt":
        raise NotImplementedError(
            "the motion branch (--load_clips, fusion_type CoLoc_ClipAtt) is "
            f"not ported yet ({MOTION_ITEM})")
    sound = ModelBuilder.build_sound(
        arch=cfg.arch_sound, fc_dim=cfg.num_channels,
        fusion_type=cfg.fusion_type, att_type=cfg.att_type,
        num_sources=cfg.num_mix, att_temp=cfg.att_temp)
    frame = ModelBuilder.build_frame(
        arch=cfg.arch_frame, fc_dim=cfg.vis_channels,
        pool_type=cfg.img_pool)
    return Nets(sound.to(dev).eval(), frame.to(dev).eval())


def init_params(cfg: Config, nets: Nets, generator: torch.Generator,
                device=None) -> Nets:
    """Fill ``nets`` with the reference's initializers (U-Net convs
    N(0, 0.001), BatchNorm weight N(1, 0.02), the outer conv's bias
    U(+-1/sqrt(fan_in)); ResNet convs He-normal on fan_out), drawn on the
    CPU from ``generator``, so one seed gives the same weights on every
    device.  Returns the nets on ``device``, in eval mode."""
    dev = resolve_device(device)
    if generator.device.type != "cpu":
        raise ValueError("init_params draws on the CPU; pass a CPU "
                         "torch.Generator")
    nets.sound.reset_parameters_(generator)
    nets.frame.reset_parameters_(generator)
    return Nets(nets.sound.to(dev).eval(), nets.frame.to(dev).eval())


# ------------------------------------------------------------------ helpers

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - ImageNet mean) / std for float RGB in [0, 1], channels last."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def normalize_frames(x: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized float32, on their device; float
    frames pass through unchanged."""
    if x.dtype == torch.uint8:
        return imagenet_normalize(x.float() * (1.0 / 255.0))
    return x


def _frame_features(nets: Nets, frames_n: torch.Tensor,
                    cfg: Config) -> torch.Tensor:
    """One source's frames -> activated feature map (reference
    main.py:120-122).  ``pool=cfg.not_pool_vis`` as in the JAX package:
    the flag's torch-argparse inversion means False returns the map."""
    frames_n = normalize_frames(frames_n)
    feats = nets.frame(frames_n, pool=cfg.not_pool_vis)
    return activate(feats, cfg.img_activation, upcast=False)


def _sound_forward(nets: Nets, log_mag: torch.Tensor,
                   v: Optional[torch.Tensor], swap_uniforms=None,
                   generator=None):
    x = log_mag[..., None]  # [B, F, T] -> NHWC
    return nets.sound(x, v, swap_uniforms=swap_uniforms, generator=generator)


def _to_device(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev)


def to_device(batch: Dict, device: torch.device, drop=(), cfg=None
              ) -> Dict[str, torch.Tensor]:
    """The arrays of a host batch that a step reads, on ``device``:
    ``audio_mix`` is rebuilt there from the sources (:func:`audio_mix_of`),
    ``class`` and the string fields are never read, ``drop`` names the
    visual streams the branch does not read; ``cfg.audio_wire`` int16
    re-encodes the sources (``data/wire.py``).  A copy to a GPU goes from
    pinned memory without blocking the host, ordered on the current
    stream."""
    skip = ("class", "audio_mix") + tuple(drop)
    host = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)
            and v.dtype != object and k not in skip}
    if cfg is not None:
        host = encode_audio_wire(host, cfg)
    pinned = device.type == "cuda"
    out = {}
    for k, v in host.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if pinned:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=pinned)
    return out


def _set_mode(nets: Nets, train: bool) -> None:
    nets.sound.train(train)
    nets.frame.train(train)


# ------------------------------------------------------------ batch helpers


def unused_visual_streams(cfg: Config) -> tuple:
    """Visual batch keys the forwards never read for this config: the AV
    forward reads clips under fusion_type CoLoc_ClipAtt, frames otherwise,
    so a loader drops the other."""
    if cfg.fusion_type == "CoLoc_ClipAtt":
        return ("frames",)
    return ("clips",)


def audios_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-source waveforms ``[B, N, L]`` whatever the wire format: float32
    ``audios``, or the int16 wire's ``audios_i16 [B, N, L]`` times
    ``audio_gain [B, N]`` (``avsep_tpu/data/wire.py:51-56``)."""
    if "audios" in batch:
        return batch["audios"]
    return batch["audios_i16"].float() * batch["audio_gain"][..., None]


def audio_mix_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The mixture waveform: shipped as ``audio_mix``, or the sum of the
    per-source waveforms (already scaled by 1/N on the host, so the sum is
    the host's mixture bit for bit in float32)."""
    if "audio_mix" in batch:
        return batch["audio_mix"]
    return torch.sum(audios_of(batch), dim=1)


def batch_spectrograms(batch: Dict[str, torch.Tensor], cfg: Config):
    """``(mag_mix [B, F, T], mags [B, N, F, T])``: precomputed, or the STFT
    of the mixture and of the sources, two ``frame_window`` launches on a
    CUDA batch (reference ``_mix_n_and_stft``, dataset/base.py:174-189)."""
    if "mag_mix" in batch:
        return batch["mag_mix"], batch["mags"]
    mag_mix, _ = stft_magphase(audio_mix_of(batch), cfg.stft_frame,
                               cfg.stft_hop, dft=cfg.dft)
    mags, _ = stft_magphase(audios_of(batch), cfg.stft_frame, cfg.stft_hop,
                            dft=cfg.dft)
    return mag_mix, mags


def _prepare(batch, cfg: Config) -> PreparedBatch:
    mag_mix, mags = batch_spectrograms(batch, cfg)
    return prepare(mag_mix, mags, log_freq=bool(cfg.log_freq),
                   weighted_loss=bool(cfg.weighted_loss),
                   binary_mask=bool(cfg.binary_mask))


def _start(nets: Nets, batch, cfg: Config, train: bool) -> Dict:
    """Checks, sets the nets' mode and moves the batch to their device."""
    if train and cfg.remat:
        # torch.utils.checkpoint re-runs the forward in the backward pass,
        # which would update every train-mode BatchNorm's running
        # statistics twice; jax.checkpoint does not
        raise NotImplementedError(f"cfg.remat is not ported yet "
                                  f"({REMAT_ITEM})")
    _set_mode(nets, train)
    dev = next(nets.sound.parameters()).device
    return {k: _to_device(v, dev) for k, v in batch.items()}


# ------------------------------------------------------------ forward passes


def forward_ao(nets: Nets, batch, cfg: Config, *, train: bool,
               swap_uniforms=None, generator=None):
    """Audio-only PIT forward (reference main.py:97-111).  Returns ``(err,
    outputs)``; ``swap_uniforms [B]`` or ``generator`` draw the fusion's
    slot swap."""
    batch = _start(nets, batch, cfg, train)
    prep = _prepare(batch, cfg)
    pred, _ = _sound_forward(nets, prep.log_mag_mix, None,
                             swap_uniforms=swap_uniforms, generator=generator)
    pred_masks = activate(pred, cfg.output_activation)  # [B, H, W, C]

    gt = prep.gt_masks.movedim(1, -1)                   # [B, H, W, N]
    w = torch.stack([prep.weights] * pred_masks.shape[-1], dim=-1)
    losses, perms = crit.pit_loss(pred_masks, gt, w, kind="bce")
    err = torch.mean(losses)
    ordered = crit.reorder_sources(pred_masks, perms)
    outputs = {"pred_masks": ordered.movedim(-1, 1),    # [B, N, H, W]
               "gt_masks": prep.gt_masks, "mag_mix": prep.mag_mix,
               "mags": prep.mags, "weight": prep.weights,
               "match_loss": torch.zeros((), device=err.device),
               "err_ps": losses, "match_ps": torch.zeros_like(losses)}
    return err, outputs


def forward_av(nets: Nets, batch, cfg: Config, *, train: bool,
               swap_uniforms=None, generator=None):
    """Audio-visual symmetric double forward (reference main.py:113-148):
    pass 1 with the visual order reversed against the reversed GT, pass 2
    forward; ``err = (err1 + err0) / 2 + match_weight * (match1 +
    match0)``.  The slot-swap arguments are unused (no audio-only fusion
    here) and accepted for the common signature."""
    batch = _start(nets, batch, cfg, train)
    prep = _prepare(batch, cfg)
    N = cfg.num_mix
    frames = batch["frames"]
    feats = [_frame_features(nets, frames[:, n], cfg) for n in range(N)]

    def one_pass(vis_list, gt):
        v = torch.stack(vis_list)                       # [C, B, h, w, Dv]
        pred, meta = _sound_forward(nets, prep.log_mag_mix, v)
        preds = [activate(pred[..., n], cfg.output_activation)
                 for n in range(N)]
        err_ps = crit.multi_source_loss(torch.stack(preds), gt.movedim(1, 0),
                                        prep.weights, kind=cfg.loss,
                                        per_sample=True)
        # the scalar is the mean of the per-sample losses exactly
        return preds, torch.mean(err_ps), err_ps, meta

    _, err1, ps1, meta1 = one_pass(feats[::-1], prep.gt_masks.flip(1))
    preds0, err0, ps0, meta0 = one_pass(feats, prep.gt_masks)

    match_loss = meta1.match_loss + meta0.match_loss
    match_ps = meta1.match_ps + meta0.match_ps
    err = (err1 + err0) / 2.0 + cfg.match_weight * match_loss
    err_ps = (ps1 + ps0) / 2.0 + cfg.match_weight * match_ps
    outputs = {"pred_masks": torch.stack(preds0, dim=1),
               "gt_masks": prep.gt_masks, "mag_mix": prep.mag_mix,
               "mags": prep.mags, "weight": prep.weights,
               "match_loss": match_loss, "att_maps": meta0.att_maps,
               "err_ps": err_ps, "match_ps": match_ps}
    return err, outputs


def forward_avmiximg(nets: Nets, batch, cfg: Config, *, train: bool,
                     swap_uniforms=None, generator=None):
    """MixVis duet path (reference main.py:162-192): the sources' frames
    concatenated along the width into one mixture image, PIT loss over the
    masks plus the weighted match loss."""
    N = cfg.num_mix
    if N != 2:
        raise ValueError(
            f"fusion_type=MixVis supports num_mix=2 only (got {N})")
    batch = _start(nets, batch, cfg, train)
    prep = _prepare(batch, cfg)
    frames = batch["frames"]
    mix_frames = torch.cat([frames[:, n] for n in range(N)], dim=-2)
    feat = _frame_features(nets, mix_frames, cfg)

    pred, meta = _sound_forward(nets, prep.log_mag_mix,
                                torch.stack([feat]))
    pred_masks = activate(pred, cfg.output_activation)  # [B, H, W, S]
    gt = prep.gt_masks.movedim(1, -1)
    w = torch.stack([prep.weights] * N, dim=-1)
    losses, perms = crit.pit_loss(pred_masks, gt, w, kind="bce")
    err = torch.mean(losses) + meta.match_loss * cfg.match_weight
    err_ps = losses + meta.match_ps * cfg.match_weight
    ordered = crit.reorder_sources(pred_masks, perms)
    outputs = {"pred_masks": ordered.movedim(-1, 1),
               "gt_masks": prep.gt_masks, "mag_mix": prep.mag_mix,
               "mags": prep.mags, "weight": prep.weights,
               "match_loss": meta.match_loss, "maps": meta.att_maps,
               "err_ps": err_ps, "match_ps": meta.match_ps}
    return err, outputs


def forward(nets: Nets, batch, cfg: Config, use_vis: bool, *, train: bool,
            swap_uniforms=None, generator=None):
    """Dispatch like reference NetWrapper.forward (main.py:150-160).
    Returns ``(err, outputs)``."""
    if use_vis:
        fwd = forward_avmiximg if cfg.fusion_type == "MixVis" else forward_av
    else:
        fwd = forward_ao
    return fwd(nets, batch, cfg, train=train, swap_uniforms=swap_uniforms,
               generator=generator)


# --------------------------------------------------------------- separation


@torch.no_grad()
def separate(nets: Nets, audio_mix, frames, cfg: Config, *,
             device=None, swap_uniforms=None,
             generator: Optional[torch.Generator] = None,
             share_blank: bool = False) -> Dict[str, torch.Tensor]:
    """End-to-end batched separation: waveform mixture -> per-source wavs.

    Args:
      nets: from :func:`build_nets`, on ``device``.
      audio_mix: [B, L] mixture waveforms (tensor or numpy).
      frames: [B, N, T, H, W, 3] (AV), [B, 1, T, H, W, 3] (duet: the one
        stream is duplicated) or None (audio-only).
      swap_uniforms / generator: the audio-only slot swap's draw, one
        uniform in [0, 1) per clip; needed when ``frames`` is None.
      share_blank: feed all-zero (normalized) frames.
    Returns a dict with 'wavs' [B, N, L'], 'masks_linear' [B, N, F, T],
    'masks' [B, N, FO, T], 'mag_mix', 'phase_mix' and 'att_maps' (None on
    the audio-only path).
    """
    dev = resolve_device(device)
    _set_mode(nets, False)
    audio_mix = _to_device(audio_mix, dev)
    mag_mix, phase_mix = stft_magphase(audio_mix, cfg.stft_frame,
                                       cfg.stft_hop, dft=cfg.dft)
    prep = prepare(mag_mix, mag_mix[:, None],  # mags unused here
                   log_freq=bool(cfg.log_freq), weighted_loss=False,
                   binary_mask=True)

    if frames is not None:
        # normalize BEFORE any blanking: the reference's blank frame is
        # zeros in normalized space (inference.py:103-107)
        frames = normalize_frames(_to_device(frames, dev))
    if share_blank and frames is not None:
        frames = torch.zeros_like(frames)
    if frames is None:
        v = None
    else:
        n_streams = frames.shape[1]
        duet = n_streams == 1 and cfg.fusion_type != "MixVis"
        feats = []
        for n in range(n_streams):
            if duet and not share_blank:
                # duet: the reference duplicates the frame feature WITHOUT
                # img_activation (inference.py:71-73), unlike the non-duet
                # branch (:76-77) and the share path (:100-107)
                f = nets.frame(frames[:, n], pool=cfg.not_pool_vis)
            else:
                f = _frame_features(nets, frames[:, n], cfg)
            feats.append(f)
        if duet:
            feats = feats * 2
        v = torch.stack(feats)

    pred, meta = _sound_forward(nets, prep.log_mag_mix, v,
                                swap_uniforms=swap_uniforms,
                                generator=generator)
    masks = activate(pred, cfg.output_activation)        # [B, FO, T, C]
    masks = masks.movedim(-1, 1)                         # [B, C, FO, T]
    masks_linear = unwarp_mask(masks, HO=cfg.HS)         # [B, C, F, T]
    if cfg.binary_mask:
        masks_linear = (masks_linear > cfg.mask_thres).float()

    pred_mag = mag_mix[:, None] * masks_linear
    spec = pred_mag.to(torch.complex64) * torch.exp(
        1j * phase_mix[:, None].to(torch.complex64))
    wavs = istft(spec, hop=cfg.stft_hop, dft=cfg.dft)
    wavs = torch.clamp(wavs, -1.0, 1.0)
    return {"wavs": wavs, "masks_linear": masks_linear, "masks": masks,
            "mag_mix": mag_mix, "phase_mix": phase_mix,
            "att_maps": meta.att_maps}
