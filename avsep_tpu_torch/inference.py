"""Single-clip separation demos and attention-overlay videos:
``python -m avsep_tpu_torch.inference --demo_mode vis|share|sweep|synthesis|pixelwise``.

Port of ``avsep_tpu/inference.py`` (reference ``inference.py``: NetWrapper
:29-136, get_audio :230-252, vis_video :537-578, recover_aud :433-491,
plot_save_att :493-534): load a checkpoint, take one duet clip (or mix two
solo clips), separate, and write the separated wavs, mask jpgs,
attention-overlay videos and AV-muxed mp4s.

* ``vis`` / ``sweep``: every display frame of the 6 s window goes through
  one ``engine.separate`` call with the window's audio (the reference
  forwards once per frame): at 30 fps a batch of 180 clips, which peaks at
  25.3 GiB on an 80 GB H100.  One ``frame_window`` and one
  ``overlap_add_normalize`` launch.
* ``share``: the blank-frame ablation (``separate(share_blank=True)``).
* ``synthesis``: two solo clips mixed as (a + b) / 2, separated with each
  clip's center frame.
* ``pixelwise``: the SoP++ nets' per-pixel sound-energy map through
  ``InnerProd.forward_pixelwise`` (one ``frame_window`` launch, no iSTFT).

Images are written with PIL; ``attention_overlay`` needs cv2.  Without
ffmpeg the videos are skipped with the media layer's message, as in the
JAX package.  The entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise without a GPU.
"""

from __future__ import annotations

import os
import random
from typing import List

import numpy as np
import torch
from PIL import Image

from avsep_tpu_torch import checkpoint, engine
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.audio_io import read_wav, resample, write_wav
from avsep_tpu_torch.data.dataset import read_manifest
from avsep_tpu_torch.data.video_transforms import (
    denormalize, val_transform_normalized)
from avsep_tpu_torch.engine import Nets, separate
from avsep_tpu_torch.models.builder import activate
from avsep_tpu_torch.ops.prepare import prepare
from avsep_tpu_torch.ops.stft import stft_magphase
from avsep_tpu_torch.utils.media import (
    combine_video_audio, magnitude2heatmap, makedirs, save_video)

AUD_SEC = 6  # fixed demo window (reference inference.py:198)
DEMO_MODES = ("vis", "share", "sweep", "synthesis", "pixelwise")


def _imwrite(path: str, image: np.ndarray) -> None:
    """A uint8 [H, W] or [H, W, 3] array as an image file (JPEG by the
    extension)."""
    Image.fromarray(np.ascontiguousarray(image)).save(path)


def _load_frame(path: str, cfg: Config) -> np.ndarray:
    return val_transform_normalized([Image.open(path).convert("RGB")],
                                    cfg.imgSize)[0]


def get_demo_audio(a_path: str, num_f, fps, a_len, cfg: Config,
                   seed: int = 8):
    """A random 6 s window (reference get_audfuncs, inference.py:197-228):
    ``(wav [audLen], center time)``."""
    rng = random.Random(seed)
    act_len = min(int(num_f) / float(fps), float(a_len))
    start, end = AUD_SEC / 2, act_len - AUD_SEC / 2
    c_t = rng.uniform(start, end)
    wav = np.zeros(cfg.audLen, np.float32)
    raw, sr = read_wav(a_path, c_t - AUD_SEC / 2, AUD_SEC)
    raw = resample(raw, sr, cfg.audRate)
    center_idx = int((AUD_SEC / 2) * cfg.audRate)
    s = max(0, center_idx - cfg.audLen // 2)
    e = min(len(raw), center_idx + cfg.audLen // 2 + cfg.audLen % 2)
    wav[: e - s] = raw[s:e]
    np.clip(wav, -1.0, 1.0, out=wav)
    return wav, c_t


def load_display_frames(fdir: str, center_t: float, fps: float,
                        cfg: Config, span_sec: float = AUD_SEC
                        ) -> List[np.ndarray]:
    """Every display frame over the window (reference vis_video loop),
    ImageNet-normalized [H, W, 3] float32."""
    n = int(round(fps * span_sec))
    start = int(round((center_t - span_sec / 2) * fps))
    return [_load_frame(os.path.join(fdir, "{:06d}.jpg".format(
        max(start + i, 0))), cfg) for i in range(n)]


def attention_overlay(frame_norm: np.ndarray, att_map: np.ndarray
                      ) -> np.ndarray:
    """A JET heatmap blended 0.4 / 0.6 over the frame (reference
    plot_save_att, inference.py:509-534)."""
    import cv2
    rgb = denormalize(frame_norm)
    H, W = rgb.shape[:2]
    att = np.asarray(att_map, np.float64)
    att = (att - att.min()) / (att.max() - att.min() + 1e-8)
    heat = cv2.applyColorMap((att * 255).astype(np.uint8),
                             cv2.COLORMAP_JET)[:, :, ::-1]
    heat = cv2.resize(heat, (W, H))
    return (0.6 * rgb + 0.4 * heat).astype(np.uint8)


def _mask_image(mask: np.ndarray) -> np.ndarray:
    return (np.clip(mask, 0, 1) * 255).astype(np.uint8)[::-1]


def vis_video(cfg: Config, nets: Nets, duet_info, save_folder: str,
              use_vis: bool = True, write_att_videos: bool = True, *,
              device=None) -> None:
    """The attention video demo for one duet clip (reference vis_video,
    inference.py:537-578): the mid frame's separated wavs and mask jpgs,
    the mixture's wav and spectrogram, and per source an attention-overlay
    mp4 muxed with its wav.  ``write_att_videos=False`` keeps the audio
    artifacts and skips the overlays (``duet_sweep``'s rate limit)."""
    dev = engine.nets_device(nets, device)
    a_path, fdir, num_f, fps, a_len = duet_info[:5]
    fps = float(fps)
    wav, c_t = get_demo_audio(a_path, num_f, fps, a_len, cfg)
    frames = load_display_frames(fdir, c_t, fps, cfg)
    T = len(frames)
    mid = T // 2
    # ONE batched call: the mixture replicated across the T display frames
    out = separate(nets, np.broadcast_to(wav, (T, cfg.audLen)).copy(),
                   np.stack(frames)[:, None, None] if use_vis else None,
                   cfg, device=dev,
                   generator=torch.Generator().manual_seed(0))
    at_mid = {k: out[k][mid].cpu().numpy()
              for k in ("wavs", "masks", "mag_mix")}

    makedirs(save_folder, remove=False)
    # the separated audio of the mid frame (reference recover_aud :433-491)
    for n in range(cfg.num_mix):
        write_wav(os.path.join(save_folder, f"pred{n + 1}.wav"),
                  at_mid["wavs"][n], cfg.audRate)
        _imwrite(os.path.join(save_folder, f"predmask{n + 1}.jpg"),
                 _mask_image(at_mid["masks"][n]))
    write_wav(os.path.join(save_folder, "mix.wav"), wav, cfg.audRate)
    _imwrite(os.path.join(save_folder, "mix.jpg"),
             magnitude2heatmap(at_mid["mag_mix"])[::-1])

    if write_att_videos and use_vis and out["att_maps"] is not None:
        att = out["att_maps"].cpu().numpy()          # [T, C, h, w]
        for n in range(cfg.num_mix):
            overlays = np.stack([
                attention_overlay(frames[t], att[t, n]) for t in range(T)])
            vid = os.path.join(save_folder, f"att{n + 1}.mp4")
            save_video(vid, overlays, fps=fps)
            combine_video_audio(
                vid, os.path.join(save_folder, f"pred{n + 1}.wav"),
                os.path.join(save_folder, f"att_av{n + 1}.mp4"))
    print(f"Saved demo to {save_folder}")


def synthesis_demo(cfg: Config, nets: Nets, info_a, info_b,
                   save_folder: str, *, device=None) -> None:
    """The synthetic two-mix demo: two solo clips mixed as their sum / 2
    (reference get_sythesis_audio, inference.py:237-252), AV separation
    with each clip's center frame; the separated wavs, the mixture and the
    ground truths."""
    dev = engine.nets_device(nets, device)
    wav_a, ct_a = get_demo_audio(info_a[0], info_a[2], float(info_a[3]),
                                 info_a[4], cfg)
    wav_b, ct_b = get_demo_audio(info_b[0], info_b[2], float(info_b[3]),
                                 info_b[4], cfg, seed=9)
    mix = (wav_a + wav_b) / 2.0

    def center_frame(info, ct):
        fdir, fps = info[1], float(info[3])
        return _load_frame(os.path.join(fdir, "{:06d}.jpg".format(
            int(round(ct * fps)))), cfg)

    frames = np.stack([center_frame(info_a, ct_a),
                       center_frame(info_b, ct_b)])  # [2, H, W, 3]
    wavs = separate(nets, mix[None], frames[None, :, None], cfg,
                    device=dev)["wavs"].cpu().numpy()
    makedirs(save_folder, remove=False)
    write_wav(os.path.join(save_folder, "mix.wav"), mix, cfg.audRate)
    for n, gt in enumerate((wav_a, wav_b)):
        write_wav(os.path.join(save_folder, f"pred{n + 1}.wav"),
                  wavs[0, n], cfg.audRate)
        write_wav(os.path.join(save_folder, f"gt{n + 1}.wav"), gt,
                  cfg.audRate)
    print(f"Saved synthetic-mix demo to {save_folder}")


def share_demo(cfg: Config, nets: Nets, duet_info, save_folder: str, *,
               device=None) -> None:
    """'share' blank-frame separation: the one shared visual stream is an
    all-black frame in normalized space, so it carries no information
    (reference share_forward, inference.py:88-107)."""
    dev = engine.nets_device(nets, device)
    a_path, fdir, num_f, fps, a_len = duet_info[:5]
    wav, c_t = get_demo_audio(a_path, num_f, float(fps), a_len, cfg)
    frame = _load_frame(os.path.join(fdir, "{:06d}.jpg".format(
        int(round(c_t * float(fps))))), cfg)
    out = separate(nets, wav[None], frame[None, None, None], cfg,
                   device=dev, share_blank=True)
    wavs, masks = out["wavs"].cpu().numpy(), out["masks"].cpu().numpy()

    makedirs(save_folder, remove=False)
    write_wav(os.path.join(save_folder, "mix.wav"), wav, cfg.audRate)
    for n in range(cfg.num_mix):
        write_wav(os.path.join(save_folder, f"pred{n + 1}.wav"),
                  wavs[0, n], cfg.audRate)
        _imwrite(os.path.join(save_folder, f"predmask{n + 1}.jpg"),
                 _mask_image(masks[0, n]))
    print(f"Saved share (blank-frame) demo to {save_folder}")


def duet_sweep(cfg: Config, nets: Nets, rows, save_root: str,
               use_vis: bool = True, *, device=None) -> None:
    """``vis_video`` over every row of a duet manifest (the reference's
    all-real-mixtures sweep, inference.py:421-426).

    ``--duet_vis_rate r`` rate-limits the attention videos: 0 (what the
    reference scripts pass, scripts/inference.sh:63) renders them for every
    row; 0 < r <= 1 for the first of every ``round(1/r)`` rows, the rest
    still get wavs and mask jpgs (the JAX package's reading of a flag the
    reference declares and never consumes)."""
    r = float(cfg.duet_vis_rate)
    stride = 1 if r <= 0 else max(1, int(round(1.0 / min(r, 1.0))))
    for i, row in enumerate(rows):
        if len(row) < 5:
            continue
        print(f"Processing video {i}.")
        vis_video(cfg, nets, row[:5], os.path.join(save_root, f"duet_{i}"),
                  use_vis, write_att_videos=(i % stride == 0),
                  device=device)


@torch.no_grad()
def sound_map(cfg: Config, nets, wav: np.ndarray, frame: np.ndarray):
    """The pixelwise sound map of one clip through the SoP++ nets in eval
    mode: ``wav [1, L]`` and the normalized ``frame [1, 1, H, W, 3]`` ->
    ``(energy [1, HI, WI], masks [1, HI, WI, FO, T])``.  Every pixel of the
    unpooled frame map (``pool=False`` whatever ``not_pool_vis`` says)
    drives the synthesizer against the sound basis; a pixel's energy is
    the mixture's magnitude its sigmoid mask would claim."""
    from avsep_tpu_torch.sop_engine import _apply_sound
    dev = next(nets.sound.parameters()).device
    nets.sound.eval()
    nets.frame.eval()
    mag_mix, _ = stft_magphase(engine._to_device(wav, dev), cfg.stft_frame,
                               cfg.stft_hop, dft=cfg.dft)
    prep = prepare(mag_mix, mag_mix[:, None], log_freq=bool(cfg.log_freq),
                   weighted_loss=False, binary_mask=True)
    basis, _ = _apply_sound(nets, prep.log_mag_mix, cfg)   # [1, FO, T, C]
    fmap = nets.frame(engine._to_device(frame, dev), pool=False)
    fmap = activate(fmap, cfg.img_activation, upcast=False)
    masks = torch.sigmoid(nets.synthesizer.forward_pixelwise(fmap, basis))
    energy = torch.sum(masks * prep.mag_mix[:, None, None], dim=(-2, -1))
    return energy, masks


def _restore_best_or_latest(ckpt_dir: str, state):
    for tag in ("best", "latest"):
        try:
            return checkpoint.restore_checkpoint(ckpt_dir, state, tag)
        except FileNotFoundError:
            continue
    print("WARNING: no checkpoint found; pixelwise demo will use "
          "random-init params")
    return state


def pixelwise_demo(cfg: Config, duet_info, save_folder: str, *,
                   device=None) -> None:
    """The per-pixel sound-energy map via ``forward_pixelwise`` (reference
    synthesizer_net.py:29-38, implemented there and reachable from
    nothing), overlaid on the frame; needs ``vis_channels ==
    num_channels`` (the SoP configuration).  Restores the SoP++ checkpoint
    ``best``, else ``latest``, else warns and uses the random init."""
    if cfg.vis_channels != cfg.num_channels:
        raise SystemExit(
            f"pixelwise demo needs vis_channels ({cfg.vis_channels}) == "
            f"num_channels ({cfg.num_channels}), the SoP configuration")
    from avsep_tpu_torch.sop_main import build_sop_nets, init_sop_state
    dev = engine.resolve_device(device)
    state = init_sop_state(cfg, build_sop_nets(cfg, device=dev),
                           torch.Generator().manual_seed(cfg.seed),
                           device=dev)
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)
    if cfg.load_ckpt or os.path.exists(os.path.join(ckpt_dir,
                                                    "state_best.pt")):
        state = _restore_best_or_latest(ckpt_dir, state)

    a_path, fdir, num_f, fps, a_len = duet_info[:5]
    wav, c_t = get_demo_audio(a_path, num_f, float(fps), a_len, cfg)
    frame = _load_frame(os.path.join(fdir, "{:06d}.jpg".format(
        int(round(c_t * float(fps))))), cfg)
    energy, masks = sound_map(cfg, state.nets, wav[None], frame[None, None])
    energy, masks = energy.cpu().numpy(), masks.cpu().numpy()

    makedirs(save_folder, remove=False)
    _imwrite(os.path.join(save_folder, "sound_map.jpg"),
             attention_overlay(frame, energy[0]))
    e = energy[0]
    e = (e - e.min()) / (e.max() - e.min() + 1e-8)
    _imwrite(os.path.join(save_folder, "sound_map_raw.jpg"),
             (e * 255).astype(np.uint8))
    np.save(os.path.join(save_folder, "pixel_masks.npy"),
            masks[0].astype(np.float16))
    print(f"Saved pixelwise sound map to {save_folder}")


def main(cfg: Config, device=None) -> None:
    if cfg.demo_mode not in DEMO_MODES:
        raise SystemExit(f"unknown --demo_mode {cfg.demo_mode!r} "
                         f"({' | '.join(DEMO_MODES)})")
    dev = engine.resolve_device(device)
    rows = read_manifest(cfg.list_val[0])
    demo_root = os.path.join(cfg.ckpt, cfg.id, "demo")

    if cfg.demo_mode == "pixelwise":
        # the SoP++ nets, built inside
        pixelwise_demo(cfg, rows[0], os.path.join(demo_root, "pixelwise"),
                       device=dev)
        return

    from avsep_tpu_torch.train import init_state
    state = init_state(cfg, engine.build_nets(cfg, device=dev),
                       torch.Generator().manual_seed(cfg.seed), device=dev)
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)
    if cfg.load_ckpt or (cfg.ckpt and os.path.exists(
            os.path.join(ckpt_dir, "state_best.pt"))):
        state = checkpoint.restore_checkpoint(ckpt_dir, state, "best")
    nets = state.nets

    info = rows[0]
    clip = os.path.basename(info[0]).split(".")[0]
    if cfg.demo_mode == "vis":
        vis_video(cfg, nets, info, os.path.join(demo_root, clip),
                  device=dev)
    elif cfg.demo_mode == "share":
        share_demo(cfg, nets, info, os.path.join(demo_root, f"share_{clip}"),
                   device=dev)
    elif cfg.demo_mode == "sweep":
        duet_sweep(cfg, nets, rows, demo_root, device=dev)
    elif cfg.demo_mode == "synthesis":
        if len(rows) < 2:
            raise SystemExit("synthesis demo needs >= 2 rows in the "
                             "manifest (two solo clips to mix)")
        synthesis_demo(cfg, nets, rows[0], rows[1],
                       os.path.join(demo_root, "synthesis"), device=dev)


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    main(parse_args())
