"""End-to-end batched separation, waveform to waveforms.

Port of the separation path of ``avsep_tpu/engine.py`` (reference
``inference.py:29-136``): stft -> +1e-10 -> warp -> log -> U-Net with the
CoLoc fusion against the frame encoder's maps -> sigmoid -> unwarp ->
binary threshold -> mask * mag -> iSTFT with the mixture phase -> clip.

Public shapes are the JAX package's: ``audio_mix [B, L]``, ``frames
[B, N, T, H, W, 3]`` (uint8 or float), ``wavs [B, N, L']``, ``masks
[B, N, FO, T]``, ``masks_linear [B, N, F, T]``, ``att_maps [B, C, H, W]``.

The entry points (:func:`build_nets`, :func:`init_params`,
:func:`separate`) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise rather than fall back to the CPU.
Training waits for a later slice of the port.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models.builder import ModelBuilder, activate
from avsep_tpu_torch.ops.prepare import prepare
from avsep_tpu_torch.ops.stft import istft, stft_magphase
from avsep_tpu_torch.ops.warp import unwarp_mask


class Nets(NamedTuple):
    """The separation nets (the reference builds (net_sound, net_frame),
    main.py:608-625)."""
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


def build_nets(cfg: Config, device=None) -> Nets:
    """The sound U-Net and the frame encoder of ``cfg`` on ``device``, in
    eval mode (weights as PyTorch initializes them; see
    :func:`init_params` for the reference's initializers)."""
    dev = resolve_device(device)
    if cfg.load_clips or cfg.fusion_type == "CoLoc_ClipAtt":
        raise NotImplementedError(
            "the motion branch (--load_clips, fusion_type CoLoc_ClipAtt) is "
            "not ported yet (ROADMAP.md Queue 1, 'models/motion.py')")
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
        duet = n_streams == 1
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
