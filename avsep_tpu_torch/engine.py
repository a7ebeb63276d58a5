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
[B, N, T, H, W, 3]`` (uint8 or float), ``clips [B, N, clip_len, H, W, 3]``
(under ``fusion_type CoLoc_ClipAtt``), or precomputed ``mag_mix``/``mags``.
Separation's public shapes: ``audio_mix [B, L]``, ``frames
[B, N, T, H, W, 3]``, ``wavs [B, N, L']``, ``masks [B, N, FO, T]``,
``masks_linear [B, N, F, T]``, ``att_maps [B, C, H, W]``.

The forwards put the nets in train or eval mode as ``train`` says.  In
train mode the BatchNorms normalize with batch statistics and update their
running statistics in place (Flax's update, ``models/layers.py``), in the
JAX package's order: the frame (or motion) net once per source, each call
from the previous call's statistics, and the sound net's second pass from
the first's.  The audio-only slot swap takes injected uniforms or a
``torch.Generator``.

``cfg.dtype`` is the nets' compute dtype (:func:`build_nets`): under
``bfloat16`` the convolutions and the BatchNorm outputs are bfloat16,
while the parameters, the running statistics, the fusion, the STFT, the
masks and the losses stay float32 (``activate(upcast=True)``).
``cfg.remat`` rematerializes the visual and sound nets' forwards of a train
step in the backward pass (``torch.utils.checkpoint``), as the JAX package
wraps them in ``jax.checkpoint``: the recompute leaves the BatchNorm running
statistics alone, and an audio-only slot swap is drawn before it, so the
losses, gradients and statistics are the plain path's.

The entry points (:func:`build_nets`, :func:`init_params`, :func:`separate`
and the forwards through the nets they are given) run on ``cuda`` unless
the caller passes ``device="cpu"``; without a GPU they raise rather than
fall back to the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint

from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data.wire import encode_audio_wire
from avsep_tpu_torch.models import criterion as crit
from avsep_tpu_torch.models.builder import ModelBuilder, activate
from avsep_tpu_torch.models.fusion import swap_uniforms as draw_swap
from avsep_tpu_torch.models.layers import running_stats_frozen
# imagenet_normalize under engine's name too: serve and the benchmark call it
from avsep_tpu_torch.ops.imagenet import (  # noqa: F401
    imagenet_normalize, normalize_frames)
from avsep_tpu_torch.ops.prepare import PreparedBatch, prepare
from avsep_tpu_torch.ops.stft import istft, stft_magphase
from avsep_tpu_torch.ops.warp import unwarp_mask
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.utils import spans

# cfg.dtype -> the nets' compute dtype
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Nets(NamedTuple):
    """The sound U-Net, the frame encoder and, under ``--load_clips``, the
    motion net (the reference builds (net_sound, net_frame) and a
    net_motion, main.py:608-625)."""
    sound: Any
    frame: Any
    motion: Any = None


def full_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS matmuls, so that
    float32 computes in float32 (torch lets cuDNN use TF32 by default).
    The command lines call it in their ``__main__`` blocks, under either
    ``--dtype``: the float32 islands of a bfloat16 run are float32 too.
    Library code never sets these flags."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU, and raises when
    there is none.  Under a process group, None and a bare ``cuda`` mean
    the rank's own card, ``cuda:{rank % device_count}``
    (``parallel/distributed.py``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and pdist.active():
        return torch.device("cuda", pdist.local_device_index())
    return dev


def nets_device(nets: Nets, device=None) -> torch.device:
    """:func:`resolve_device` of ``device``, checked against ``nets``: raises
    if a parameter lies on another device."""
    dev = resolve_device(device)
    for net_name, net in nets._asdict().items():
        if net is None:
            continue
        for name, p in net.named_parameters():
            if p.device.type != dev.type or (
                    dev.index is not None and p.device.index != dev.index):
                raise ValueError(f"{net_name}.{name} lies on {p.device}, "
                                 f"not {dev}")
    return dev


def build_nets(cfg: Config, device=None) -> Nets:
    """The sound U-Net, the frame encoder and, under ``cfg.load_clips``,
    the motion net of ``cfg`` on ``device``, in eval mode, computing in
    ``cfg.dtype`` with float32 parameters (weights as PyTorch initializes
    them; see :func:`init_params` for the reference's initializers).
    ``fusion_type CoLoc_ClipAtt`` attends over the motion net's maps, so it
    needs ``load_clips``."""
    dev = resolve_device(device)
    if cfg.fusion_type == "CoLoc_ClipAtt" and not cfg.load_clips:
        raise ValueError("fusion_type=CoLoc_ClipAtt requires --load_clips "
                         "(the visual stream is the motion net over clips)")
    dtype = COMPUTE_DTYPES[cfg.dtype]
    sound = ModelBuilder.build_sound(
        arch=cfg.arch_sound, fc_dim=cfg.num_channels,
        fusion_type=cfg.fusion_type, att_type=cfg.att_type,
        num_sources=cfg.num_mix, att_temp=cfg.att_temp, dtype=dtype)
    frame = ModelBuilder.build_frame(
        arch=cfg.arch_frame, fc_dim=cfg.vis_channels,
        pool_type=cfg.img_pool, dtype=dtype)
    motion = None
    if cfg.load_clips:
        motion = ModelBuilder.build_motion(
            cfg.arch_motion, dtype=dtype, fc_dim=cfg.vis_channels
        ).to(dev).eval()
    return Nets(sound.to(dev).eval(), frame.to(dev).eval(), motion)


def init_params(cfg: Config, nets: Nets, generator: torch.Generator,
                device=None) -> Nets:
    """Fill ``nets`` with the reference's initializers (U-Net convs
    N(0, 0.001), BatchNorm weight N(1, 0.02), the outer conv's bias
    U(+-1/sqrt(fan_in)); ResNet and motion-net convs He-normal on fan_out),
    drawn on the CPU from ``generator`` in the order sound, frame, motion,
    so one seed gives the same weights on every device.  Returns the nets
    on ``device``, in eval mode."""
    dev = resolve_device(device)
    if generator.device.type != "cpu":
        raise ValueError("init_params draws on the CPU; pass a CPU "
                         "torch.Generator")
    out = []
    for net in nets:
        if net is not None:
            net.reset_parameters_(generator)
            net = net.to(dev).eval()
        out.append(net)
    return Nets(*out)


# ------------------------------------------------------------------ helpers

def _remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn``: nothing around the
    forward, the BatchNorm running statistics frozen around the
    recompute."""
    return contextlib.nullcontext(), running_stats_frozen()


def _call(net, remat: bool, *args, **kw):
    """``net(*args, **kw)``, rematerialized in the backward pass if
    ``remat`` (the JAX package's ``_maybe_remat``)."""
    if not remat:
        return net(*args, **kw)
    return torch.utils.checkpoint.checkpoint(
        net, *args, use_reentrant=False, context_fn=_remat_contexts, **kw)


def _frame_features(nets: Nets, frames_n: torch.Tensor, cfg: Config,
                    remat: bool = False) -> torch.Tensor:
    """One source's frames -> activated feature map (reference
    main.py:120-122).  ``pool=cfg.not_pool_vis`` as in the JAX package:
    the flag's torch-argparse inversion means False returns the map."""
    frames_n = normalize_frames(frames_n)
    feats = _call(nets.frame, remat, frames_n, pool=cfg.not_pool_vis)
    return activate(feats, cfg.img_activation, upcast=False)


def _motion_features(nets: Nets, clips_n: torch.Tensor, cfg: Config,
                     remat: bool = False) -> torch.Tensor:
    """One source's clip ``[B, T, H, W, 3]`` -> the activated motion map
    ``[B, h, w, C]``: the motion net's pooled map (the fast pathway's mean
    over time, the JAX package's live motion branch,
    ``avsep_tpu/engine.py:178-202``; or SlowFast R50's two time means
    through its ``fc``), then the activation.  They are the span
    ``train.motion`` (``clips`` the rows, ``frames`` ``clip_len``), which
    counts its rows under ``motion.clips`` and SlowFast R50's slow frames
    under ``motion.slow_frames`` (``utils/spans.py``).  A net whose stem is
    the kernel (``stem_kernel``) gets the clip as it comes and normalizes
    it in the stem's load."""
    if not nets.motion.stem_kernel:
        clips_n = normalize_frames(clips_n)
    with spans.span("train.motion", clips=clips_n.shape[0],
                    frames=cfg.clip_len):
        spans.count("motion.clips", clips_n.shape[0])
        slow = motion_slow_frames(nets.motion, clips_n.shape[0],
                                  clips_n.shape[1])
        if slow:
            spans.count("motion.slow_frames", slow)
        feats = _call(nets.motion.pooled_map, remat, clips_n)
        return activate(feats, cfg.img_activation, upcast=False)


def motion_slow_frames(net, clips: int, clip_len: int) -> int:
    """The frames the motion ``net``'s slow pathway reads from ``clips``
    clips of ``clip_len`` frames; 0 for a net without one."""
    slow = getattr(net, "slow_path", None)
    return 0 if slow is None else clips * slow.frames(clip_len)


def motion_clips(cfg: Config, use_vis: bool, batch) -> int:
    """The clips a step's forward runs through the motion net: each row's
    clip of each source in an AV step under ``fusion_type
    CoLoc_ClipAtt`` (:func:`forward_av`), none otherwise.  It is what the
    step counts under ``motion.clips``."""
    if not (use_vis and cfg.fusion_type == "CoLoc_ClipAtt"):
        return 0
    return batch["clips"].shape[0] * cfg.num_mix


def motion_counts(cfg: Config, use_vis: bool, batch, net
                  ) -> Dict[str, int]:
    """What a step counts in the span recorder for its motion ``net``: the
    clips (:func:`motion_clips`) under ``motion.clips`` and the slow
    pathway's frames (:func:`motion_slow_frames`) under
    ``motion.slow_frames``, the counters that are not 0."""
    clips = motion_clips(cfg, use_vis, batch)
    if not clips:
        return {}
    out = {"motion.clips": clips}
    slow = motion_slow_frames(net, clips, batch["clips"].shape[2])
    if slow:
        out["motion.slow_frames"] = slow
    return out


def _sound_forward(nets: Nets, log_mag: torch.Tensor,
                   v: Optional[torch.Tensor], swap_uniforms=None,
                   generator=None, remat: bool = False):
    x = log_mag[..., None]  # [B, F, T] -> NHWC
    if remat and v is None:
        # preserve_rng_state does not cover an explicit generator: draw the
        # slot swap once, before the region, for the recompute to reuse
        swap_uniforms = draw_swap(x.shape[0], swap_uniforms, generator)
    return _call(nets.sound, remat, x, v, swap_uniforms=swap_uniforms,
                 generator=generator)


def _to_device(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(dev)


def to_device(batch: Dict, device: torch.device, drop=(), cfg=None,
              mode: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The arrays of a host batch that a step reads, on ``device``:
    ``audio_mix`` is rebuilt there from the sources (:func:`audio_mix_of`),
    ``class`` and the string fields are never read, ``drop`` names the
    visual streams the branch does not read; ``cfg.audio_wire`` int16
    re-encodes the sources (``data/wire.py``).  Under a process group only
    the rank's rows go (``distributed.device_put_global``): ``mode``
    ``replicate`` takes the rank's block of a global batch, ``shard`` its
    block of the process's batch (``cfg.dist_nprocs`` processes); it
    defaults to ``cfg.dist_data`` (``replicate`` without a ``cfg``).  A
    copy to a GPU goes from pinned memory without blocking the host,
    ordered on the current stream."""
    skip = ("class", "audio_mix") + tuple(drop)
    host = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)
            and v.dtype != object and k not in skip}
    if mode is None:
        mode = cfg.dist_data if cfg is not None else "replicate"
    host = pdist.device_put_global(
        host, mode, procs=pdist.process_count(cfg) if cfg is not None else 1)
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
    for net in nets:
        if net is not None:
            net.train(train)


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


def _start(nets: Nets, batch, train: bool) -> Dict:
    """Sets the nets' mode and moves the batch to their device."""
    _set_mode(nets, train)
    dev = next(nets.sound.parameters()).device
    return {k: _to_device(v, dev) for k, v in batch.items()}


# ------------------------------------------------------------ forward passes


def forward_ao(nets: Nets, batch, cfg: Config, *, train: bool,
               swap_uniforms=None, generator=None):
    """Audio-only PIT forward (reference main.py:97-111).  Returns ``(err,
    outputs)``; ``swap_uniforms [B]`` or ``generator`` draw the fusion's
    slot swap."""
    batch = _start(nets, batch, train)
    prep = _prepare(batch, cfg)
    pred, _ = _sound_forward(nets, prep.log_mag_mix, None,
                             swap_uniforms=swap_uniforms, generator=generator,
                             remat=train and cfg.remat)
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
    match0)``.  The visual stream is each source's frames through the
    frame net, or under ``fusion_type CoLoc_ClipAtt`` its clip through the
    motion net.  The slot-swap arguments are unused (no audio-only fusion
    here) and accepted for the common signature."""
    batch = _start(nets, batch, train)
    prep = _prepare(batch, cfg)
    N = cfg.num_mix
    if cfg.fusion_type == "CoLoc_ClipAtt":
        vis_features, stream = _motion_features, batch["clips"]
    else:
        vis_features, stream = _frame_features, batch["frames"]
    remat = train and cfg.remat
    feats = [vis_features(nets, stream[:, n], cfg, remat) for n in range(N)]

    def one_pass(vis_list, gt):
        v = torch.stack(vis_list)                       # [C, B, h, w, Dv]
        pred, meta = _sound_forward(nets, prep.log_mag_mix, v, remat=remat)
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
    batch = _start(nets, batch, train)
    prep = _prepare(batch, cfg)
    frames = batch["frames"]
    mix_frames = torch.cat([frames[:, n] for n in range(N)], dim=-2)
    remat = train and cfg.remat
    feat = _frame_features(nets, mix_frames, cfg, remat)

    pred, meta = _sound_forward(nets, prep.log_mag_mix,
                                torch.stack([feat]), remat=remat)
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
