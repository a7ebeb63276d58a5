"""Evaluation: batched on-device scoring of a val sweep, and media dumps.

Port of ``avsep_tpu/evaluate.py:41-326`` (reference ``evaluate()`` /
``calc_metrics`` / ``output_visuals``, ``main.py:197-503``).  The reference
loops per sample on the host; here one eval step runs the whole batch on
the nets' device, in order:

1. ``engine.forward(train=False)`` (two ``frame_window`` launches, from the
   STFTs of the mixture and of the sources);
2. ``stft_magphase`` of the mixture (one more ``frame_window`` launch);
3. the unwarp of the predicted masks to linear frequency;
4. the ``mask_thres`` threshold (binary masks);
5. the iSTFT with the mixture's phase (one ``overlap_add_normalize``
   launch), then a clip to [-1, 1];
6. the noise floor on all-zero predictions (reference ``main.py:248-249``):
   ``0.01 * U[0, 1)`` in place of a prediction that is zero throughout;
7. ``eval_metrics`` (BSS-eval SDR / SIR / SAR, SI-SDR);
8. ``perm_correct``, on the AV branch only.

The host keeps the meters and writes ``results.csv`` and the media.

Randomness: the audio-only slot swap and the noise floor draw from
``torch.Generator``s seeded from ``cfg.seed`` (the swap on the CPU, as
``engine`` draws it; the noise on the nets' device), or from injected
draws: a JAX PRNG stream cannot be reproduced in torch, so a parity test
passes the JAX package's draws in.

The entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise without a GPU.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data.audio_io import write_wav
from avsep_tpu_torch.data.loader import DevicePrefetcher
from avsep_tpu_torch.data.video_transforms import denormalize
from avsep_tpu_torch.engine import Nets
from avsep_tpu_torch.models import criterion as crit
from avsep_tpu_torch.ops.metrics import eval_metrics
from avsep_tpu_torch.ops.stft import istft, stft_magphase
from avsep_tpu_torch.ops.warp import unwarp_mask
from avsep_tpu_torch.utils.media import (
    combine_video_audio, magnitude2heatmap, makedirs, save_video)
from avsep_tpu_torch.utils.meters import AverageMeter
from avsep_tpu_torch.utils.viz import plot_loss_metrics


def make_eval_step(cfg: Config, nets: Nets, use_vis: bool, device=None):
    """Returns ``step(batch, *, swap_uniforms=None, noise_uniforms=None,
    generator=None, noise_generator=None) -> (metrics, outputs,
    preds_wav)``: one eval step of the AV (``use_vis``) or AO branch
    (reference main.py:444-451 and calc_metrics, :197-286).

    ``metrics`` holds ``[B]`` tensors (``sdr``, ``sir``, ``sar``,
    ``si_sdr``, ``err_ps``, ``match_ps``, and ``perm_correct`` on the AV
    branch) and the scalars ``err`` and ``match_loss``.  The AO slot swap
    takes ``swap_uniforms [B]`` or the CPU ``generator``; the noise floor
    takes ``noise_uniforms`` of ``preds_wav``'s shape in [0, 1), or
    ``noise_generator`` on the nets' device.  The nets must lie on
    ``device`` (``cuda`` unless ``device="cpu"``).
    """
    dev = engine.nets_device(nets, device)

    @torch.no_grad()
    def step(batch, *, swap_uniforms=None, noise_uniforms=None,
             generator=None, noise_generator=None):
        batch = {k: engine._to_device(v, dev) for k, v in batch.items()}
        err, outputs = engine.forward(nets, batch, cfg, use_vis, train=False,
                                      swap_uniforms=swap_uniforms,
                                      generator=generator)
        mag_mix, phase_mix = stft_magphase(engine.audio_mix_of(batch),
                                           cfg.stft_frame, cfg.stft_hop,
                                           dft=cfg.dft)
        pred = outputs["pred_masks"]                         # [B, N, FO, T]
        pred_lin = unwarp_mask(pred, HO=cfg.HS) if cfg.log_freq else pred
        if cfg.binary_mask:
            pred_lin = (pred_lin > cfg.mask_thres).float()

        spec = (mag_mix[:, None] * pred_lin).to(torch.complex64) * torch.exp(
            1j * phase_mix[:, None].to(torch.complex64))
        preds_wav = torch.clamp(istft(spec, cfg.stft_hop, dft=cfg.dft),
                                -1.0, 1.0)

        # all-zero predictions -> noise floor (reference main.py:248-249)
        if noise_uniforms is None:
            if noise_generator is None:
                raise ValueError("the noise floor needs noise_uniforms or a "
                                 "noise_generator")
            noise_uniforms = torch.rand(preds_wav.shape,
                                        generator=noise_generator, device=dev)
        allzero = torch.all(preds_wav == 0, dim=-1, keepdim=True)
        noise = 0.01 * torch.as_tensor(noise_uniforms, dtype=torch.float32,
                                       device=dev)
        preds_wav = torch.where(allzero, noise, preds_wav)

        gts_wav = engine.audios_of(batch)[..., :preds_wav.shape[-1]]
        metrics = eval_metrics(gts_wav, preds_wav)
        metrics["err"] = err
        for k in ("match_loss", "err_ps", "match_ps"):
            metrics[k] = outputs[k]
        if use_vis:
            metrics["perm_correct"] = perm_correct(
                outputs["pred_masks"], outputs["gt_masks"],
                outputs["weight"], cfg.loss)
        return metrics, outputs, preds_wav

    return step


def perm_correct(pred_masks: torch.Tensor, gt_masks: torch.Tensor,
                 weight: torch.Tensor, kind: str) -> torch.Tensor:
    """Per-sample audio <-> visual assignment correctness, ``[B]`` in {0, 1}.

    The AV branch has no PIT (reference main.py:133 compares channel n to
    ground truth n), so the output order is right only when the fusion's
    attention gave each audio slot its own visual stream.  Correct iff the
    identity beats every other of the N! assignments (the PIT argmin; a
    pairwise swap test would miss 3-cycles for num_mix > 2), ties going to
    the identity, the first in ``itertools.permutations`` order.

    pred_masks / gt_masks: ``[B, N, F, T]``; weight: ``[B, F, T]``.
    """
    ps = pred_masks.movedim(1, -1)                       # [B, F, T, N]
    gts = gt_masks.movedim(1, -1)
    N = ps.shape[-1]
    w = torch.stack([weight] * N, dim=-1)
    _, best = crit.pit_loss(ps, gts, w, kind=kind)
    ident = torch.arange(N, device=best.device)
    return torch.all(best == ident, dim=-1).float()


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def evaluate(cfg: Config, nets: Nets, loader, history: dict, itera: int,
             use_vis_eval: bool = True, write_visuals: bool = True, *,
             device=None, draws: Optional[Iterable[Dict]] = None) -> None:
    """Full val sweep (reference evaluate(), main.py:421-503): the meters,
    ``history[val_av | val_ao]``, ``results.csv`` under
    ``cfg.ckpt/visualization/{av,ao}/``, the plots after training
    iterations (``itera > 0``), and the media of the first ``cfg.num_vis``
    samples when ``write_visuals``.

    A ragged final batch is padded to the first batch's size by repeating
    its last row, and the padded rows are left out of every meter and row
    (the per-sample ``err_ps`` / ``match_ps``).  ``draws``, if given,
    yields one dict per batch with ``swap_uniforms [B]`` and
    ``noise_uniforms [B, N, L']`` (padded size); else the draws come from
    generators seeded from ``cfg.seed``.  Runs on ``cuda`` unless
    ``device="cpu"``.
    """
    dev = engine.nets_device(nets, device)
    print("Evaluating at {} iterations...".format(itera))
    vis_root = os.path.join(cfg.ckpt, "visualization")
    makedirs(vis_root, remove=False)

    step = make_eval_step(cfg, nets, use_vis_eval, device=dev)
    meters = {k: AverageMeter() for k in
              ("loss", "match", "sdr", "sir", "sar", "si_sdr", "perm_acc")}
    csv_ls: List[Dict] = []
    vis_budget = cfg.num_vis

    print("Start evaluation for",
          "audio visual" if use_vis_eval else "audio only")
    swap_gen = torch.Generator().manual_seed(cfg.seed)
    noise_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    draws = iter(draws) if draws is not None else None
    skip = ("frames", "clips") if not use_vis_eval else \
        engine.unused_visual_streams(cfg)
    pad_state = {"pad_to": None}

    def _pad_and_ship(batch):
        """Pad to the sweep's one batch size and start the copy to the
        device, in the prefetcher's thread: batch i + 1's host work and
        copy run while batch i is on the device.  A branch ships only the
        visual stream its forward reads."""
        true_bs = len(batch["id"])
        if pad_state["pad_to"] is None:
            pad_state["pad_to"] = true_bs
        pad_to = pad_state["pad_to"]
        padded = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.shape[0] < pad_to:
                # the padded rows leave the meters below
                v = np.concatenate(
                    [v, np.repeat(v[-1:], pad_to - v.shape[0], axis=0)])
            padded[k] = v
        return batch, engine.to_device(padded, dev, drop=skip,
                                       cfg=cfg), true_bs

    prefetcher = DevicePrefetcher(iter(loader), _pad_and_ship)
    try:
        for batch, dev_batch, true_bs in prefetcher:
            kw = next(draws) if draws is not None else {
                "generator": swap_gen, "noise_generator": noise_gen}
            metrics, outputs, preds_wav = step(dev_batch, **kw)
            metrics = {k: _host(m)[:true_bs] if m.dim() else float(m)
                       for k, m in metrics.items()}
            meters["loss"].update(float(np.mean(metrics["err_ps"])),
                                  weight=true_bs)
            meters["match"].update(float(np.mean(metrics["match_ps"]))
                                   if use_vis_eval else 0.0, weight=true_bs)
            for k in ("sdr", "sir", "sar", "si_sdr"):
                meters[k].update(float(np.mean(metrics[k])), weight=true_bs)
            if "perm_correct" in metrics:
                meters["perm_acc"].update(
                    float(np.mean(metrics["perm_correct"])), weight=true_bs)
            for n in range(true_bs):
                csv_ls.append({"id": batch["id"][n],
                               "sdr": float(metrics["sdr"][n]),
                               "sir": float(metrics["sir"][n]),
                               "si-snr": float(metrics["si_sdr"][n])})
            if write_visuals and vis_budget > 0:
                n_vis = min(vis_budget, true_bs)
                out_h = {k: _host(v[:n_vis]) if v.dim() else float(v)
                         for k, v in outputs.items() if v is not None}
                output_visuals(vis_root, cfg, batch, out_h,
                               _host(preds_wav[:n_vis]), n_vis,
                               use_vis_eval)
                vis_budget -= n_vis
    finally:
        # an exception mid-sweep must not leave the producer thread parked
        # on the full queue with device batches in flight
        prefetcher.close()

    print("[Eval Summary] iterations: {}, Loss: {:.4f}, Loss_match: {:.4f}, "
          "SDR_mixture: {:.4f}, SI-SDR: {:.4f}, SDR: {:.4f}, SIR: {:.4f}, "
          "SAR: {:.4f}".format(
              itera, meters["loss"].average(), meters["match"].average(),
              0.0, meters["si_sdr"].average(), meters["sdr"].average(),
              meters["sir"].average(), meters["sar"].average()))
    if use_vis_eval:
        print("[Eval Summary] Perm-Acc: {:.4f} (audio<->visual source "
              "assignment; {:.3g} = chance)".format(
                  meters["perm_acc"].average(),
                  1.0 / math.factorial(cfg.num_mix)))

    keyname = "val_av" if use_vis_eval else "val_ao"
    history[keyname]["iter"].append(itera)
    history[keyname]["err"].append(meters["loss"].average())
    for k in ("sdr", "sir", "sar", "si_sdr"):
        history[keyname][k].append(meters[k].average())
    if use_vis_eval:
        history[keyname].setdefault("perm_acc", []).append(
            meters["perm_acc"].average())

    # per-sample results.csv (reference main.py:493-498)
    save_dir = os.path.join(vis_root, "av" if use_vis_eval else "ao")
    makedirs(save_dir, remove=False)
    with open(os.path.join(save_dir, "results.csv"), "w") as f:
        writer = csv.DictWriter(f, fieldnames=["id", "sdr", "sir", "si-snr"])
        writer.writeheader()
        writer.writerows(csv_ls)

    if itera > 0:
        print("Plotting figures...")
        plot_loss_metrics(cfg.ckpt, history)


def output_visuals(vis_root: str, cfg: Config, batch, outputs, preds_wav,
                   n_vis: int, use_vis_eval: bool) -> None:
    """Per-sample media dumps: masks, spectrograms, wavs, frame videos, the
    AV mux (reference output_visuals, main.py:290-418).  ``outputs`` and
    ``preds_wav`` are host arrays of the first ``n_vis`` samples; imageio
    is imported here, cv2 and ffmpeg by the media helpers."""
    from imageio import imwrite as imsave

    save_pth = os.path.join(vis_root, "av" if use_vis_eval else "ao")
    makedirs(save_pth, remove=False)
    gt_masks = outputs["gt_masks"]       # [B, N, FO, T]
    pred_masks = outputs["pred_masks"]   # [B, N, FO, T]
    weight = outputs["weight"]           # [B, FO, T]

    for j in range(n_vis):
        prefix = batch["id"][j]
        makedirs(os.path.join(save_pth, prefix), remove=False)
        imsave(os.path.join(save_pth, prefix, "mix.jpg"),
               magnitude2heatmap(outputs["mag_mix"][j])[::-1, :, :])
        imsave(os.path.join(save_pth, prefix, "weight.jpg"),
               magnitude2heatmap(weight[j], log=False, scale=100.0)[::-1])
        write_wav(os.path.join(save_pth, prefix, "mix.wav"),
                  batch["audio_mix"][j], cfg.audRate)

        for n in range(cfg.num_mix):
            pm = (np.clip(pred_masks[j, n], 0, 1) * 255).astype(np.uint8)
            gm = (np.clip(gt_masks[j, n], 0, 1) * 255).astype(np.uint8)
            imsave(os.path.join(save_pth, prefix,
                                f"predmask{n + 1}.jpg"), pm[::-1])
            imsave(os.path.join(save_pth, prefix,
                                f"gtmask{n + 1}.jpg"), gm[::-1])
            write_wav(os.path.join(save_pth, prefix, f"pred{n + 1}.wav"),
                      preds_wav[j, n], cfg.audRate)
            write_wav(os.path.join(save_pth, prefix, f"gt{n + 1}.wav"),
                      batch["audios"][j, n], cfg.audRate)

            rgb = np.stack([denormalize(f) for f in batch["frames"][j, n]])
            vid_path = os.path.join(save_pth, prefix, f"video{n + 1}.mp4")
            save_video(vid_path, rgb, fps=max(cfg.frameRate
                                              / cfg.stride_frames, 1))
            combine_video_audio(
                vid_path,
                os.path.join(save_pth, prefix, f"gt{n + 1}.wav"),
                os.path.join(save_pth, prefix, f"av{n + 1}.mp4"))
