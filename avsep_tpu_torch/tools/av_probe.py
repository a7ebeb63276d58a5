"""Audio-visual learning probe: does the CoLoc fusion use vision?

Port of ``tools/av_probe.py``.  Three metrics over a deterministic sweep of
the val split (the research core of reference ``models/fusion_net.py:20-110``
and ``main.py:113-148`` is audio-visual co-localization, which AO-only
SI-SDR cannot evidence):

* **perm accuracy**: the AV branch has no PIT (reference ``main.py:133``
  scores channel n against ground truth n), so the output order is right
  only when the attention gave each audio slot its own visual stream.
  Correct iff the as-is source order beats the swap; chance 0.5.
* **pointing-game accuracy**: the argmax cell of each source's attention
  map must land in the image quadrant holding its video's class token
  (``make_synthetic_data --class_tokens`` records the quadrants in
  ``tokens.json``); chance 0.25.  Beside it the quadrant of the largest
  mean attention mass, its confusion against the token's quadrant and the
  mean normalized mass on the token's quadrant.
* **AV vs AO SI-SDR / SDR**, through ``evaluate.evaluate``.

Usage (the training flags, plus the token sidecar and the tag)::

    python -m avsep_tpu_torch.tools.av_probe --id toy_av --ckpt ./ckpt \\
        --list_val build/music_tok/val_split.csv \\
        --tokens_json build/music_tok/tokens.json [--probe_ckpt best|latest] \\
        <model flags>

It restores ``state_{tag}.pt`` (the other tag when it is missing), writes
``<ckpt>/<id>/av_probe.json`` and prints one summary line.  It runs on the
GPU; :func:`run_probe` takes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from avsep_tpu_torch.config import Config, parse_args


def quadrant_of(ay: np.ndarray, ax: np.ndarray, h: int, w: int) -> np.ndarray:
    """Attention argmax cell -> image quadrant (0=TL 1=TR 2=BL 3=BR).

    Valid because the val transform (resize-shorter + center crop,
    data/video_transforms.py) keeps quadrant membership for tokens placed
    at quadrant centers: the vertical extent is kept whole and the
    horizontal center crop removes only the outer margins.
    """
    return (ay * 2 >= h).astype(np.int32) * 2 + (ax * 2 >= w).astype(
        np.int32)


def probe_outputs(nets, batch, cfg: Config):
    """One AV forward in eval mode on a device batch; returns, on the host,
    the per-sample loss against the ground truth and against the swapped
    ground truth (``[B]`` each) and the attention maps ``[B, C, h, w]``:
    the inputs of every decision the probe makes."""
    import torch

    from avsep_tpu_torch import engine
    from avsep_tpu_torch.models import criterion as crit

    with torch.no_grad():
        _, out = engine.forward(nets, batch, cfg, True, train=False)
        ps = out["pred_masks"].movedim(1, 0)               # [N, B, F, T]
        gts = out["gt_masks"].movedim(1, 0)
        l_fwd = crit.multi_source_loss(ps, gts, out["weight"],
                                       kind=cfg.loss, per_sample=True)
        l_swp = crit.multi_source_loss(ps, gts.flip(0), out["weight"],
                                       kind=cfg.loss, per_sample=True)
    return tuple(t.cpu().numpy() for t in (l_fwd, l_swp, out["att_maps"]))


def decisions(l_fwd: np.ndarray, l_swp: np.ndarray, att: np.ndarray):
    """From :func:`probe_outputs`: whether the as-is order beats the swap
    (``[B]``), the quadrant of each source's attention argmax and the four
    quadrants' mean attention ``[B, C, 4]`` (a receptive-field-tolerant
    localization signal: the dilated ResNet's receptive field is nearly
    global at 224 px)."""
    B, C, h, w = att.shape
    am = np.argmax(att.reshape(B, C, h * w), axis=-1)
    quads = np.stack([
        att[:, :, :h // 2, :w // 2].mean(axis=(2, 3)),
        att[:, :, :h // 2, w // 2:].mean(axis=(2, 3)),
        att[:, :, h // 2:, :w // 2].mean(axis=(2, 3)),
        att[:, :, h // 2:, w // 2:].mean(axis=(2, 3))], axis=-1)
    return l_fwd < l_swp, quadrant_of(am // w, am % w, h, w), quads


def restore(cfg: Config, template, tag: str, fallback: str):
    """``state_{tag}.pt`` of ``<ckpt>/<id>`` into ``template``, or
    ``state_{fallback}.pt`` when there is none."""
    from avsep_tpu_torch.checkpoint import restore_checkpoint
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)
    if not os.path.exists(os.path.join(ckpt_dir, f"state_{tag}.pt")):
        tag = fallback
    state = restore_checkpoint(ckpt_dir, template, tag)
    print(f"restored {tag.upper()} checkpoint from {ckpt_dir}")
    return state


def run_probe(cfg: Config, tokens_json: str, tag: str = "best",
              device=None, draws=None) -> dict:
    """Probe the checkpoint ``tag`` of ``<cfg.ckpt>/<cfg.id>`` on
    ``cfg.list_val``; returns the report, which it also writes as
    ``av_probe.json`` there.  ``draws``, if given, is the list of per-batch
    draws that both ``evaluate`` sweeps take (``evaluate(draws=...)``);
    else they come from generators seeded from ``cfg.seed``.  Runs on
    ``cuda`` unless ``device="cpu"``."""
    import torch

    from avsep_tpu_torch import engine
    from avsep_tpu_torch.data.dataset import MusicMixDataset
    from avsep_tpu_torch.data.loader import BatchLoader, ConcatDataset
    from avsep_tpu_torch.evaluate import evaluate
    from avsep_tpu_torch.train import init_state
    from avsep_tpu_torch.utils.meters import new_history

    dev = engine.resolve_device(device)
    tokens = {}
    if tokens_json:
        with open(tokens_json) as f:
            tokens = json.load(f)

    nets = engine.build_nets(cfg, device=dev)
    state = init_state(cfg, nets, torch.Generator().manual_seed(cfg.seed),
                       device=dev)
    state = restore(cfg, state, tag, "latest" if tag == "best" else "best")
    nets = state.nets
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)

    ds = ConcatDataset([MusicMixDataset(p, cfg, split="val")
                        for p in cfg.list_val])
    loader = BatchLoader(ds, cfg.batch_size, shuffle=False, num_workers=4,
                         seed=cfg.seed)

    perm_hits, perm_total = 0, 0
    point_hits, mass_hits, point_total = 0, 0, 0
    # where the mass sits: 4x4 confusion of the argmax-mass quadrant
    # against the token's quadrant, and the mean normalized mass on the
    # token's quadrant (0.25 = uniform attention; 1.0 = all on the token)
    mass_conf = np.zeros((4, 4), np.int64)
    mass_on_token = []
    skip = engine.unused_visual_streams(cfg)
    for batch in loader:
        dev_batch = engine.to_device(batch, dev, drop=skip, cfg=cfg,
                                     mode="replicate")
        correct, quad, quads = decisions(*probe_outputs(nets, dev_batch,
                                                        cfg))
        perm_hits += int(correct.sum())
        perm_total += len(correct)
        if tokens:
            mass_quad = np.argmax(quads, axis=-1)        # [B, C]
            qnorm = quads / np.maximum(quads.sum(-1, keepdims=True), 1e-12)
            for b in range(len(batch["id"])):
                for n, info in enumerate(batch["infos"][b]):
                    meta = tokens.get(os.path.abspath(info[1]))
                    if meta is None or not isinstance(
                            meta.get("quadrant"), int):
                        continue
                    tq = meta["quadrant"]
                    point_hits += int(quad[b, n] == tq)
                    mass_hits += int(mass_quad[b, n] == tq)
                    mass_conf[tq, mass_quad[b, n]] += 1
                    mass_on_token.append(float(qnorm[b, n, tq]))
                    point_total += 1

    history = new_history()
    for use_vis in (True, False):
        evaluate(cfg, nets, loader, history, 1, use_vis_eval=use_vis,
                 write_visuals=False, device=dev, draws=draws)

    report = {
        "perm_acc": perm_hits / max(perm_total, 1),
        "perm_n": perm_total,
        "pointing_acc": (point_hits / point_total) if point_total else None,
        "pointing_mass_acc": (mass_hits / point_total) if point_total
        else None,
        "pointing_n": point_total,
        "av_si_sdr": history["val_av"]["si_sdr"][-1],
        "av_sdr": history["val_av"]["sdr"][-1],
        "ao_si_sdr": history["val_ao"]["si_sdr"][-1],
        "ao_sdr": history["val_ao"]["sdr"][-1],
    }
    if mass_on_token:
        # rows: token quadrant; columns: argmax-mass quadrant.  A diagonal
        # matrix is localization; one hot column whatever the row is the
        # attention parked on a fixed region; flat rows, no preference
        report["mass_confusion"] = mass_conf.tolist()
        report["mean_mass_on_token"] = float(np.mean(mass_on_token))
        report["mass_on_token_uniform"] = 0.25
    out_path = os.path.join(ckpt_dir, "av_probe.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("[AV probe] perm_acc={perm_acc:.3f} (n={perm_n}, chance 0.5)  "
          "pointing_acc={pa} mass_acc={ma} (n={pointing_n}, chance 0.25)  "
          "AV SI-SDR={av_si_sdr:.2f} dB  AO SI-SDR={ao_si_sdr:.2f} dB"
          .format(pa=("%.3f" % report["pointing_acc"])
                  if report["pointing_acc"] is not None else "n/a",
                  ma=("%.3f" % report["pointing_mass_acc"])
                  if report["pointing_mass_acc"] is not None else "n/a",
                  **report))
    print(f"report written to {out_path}")
    return report


def split_argv(argv=None):
    """``(tokens_json, probe_ckpt, the Config)``: the tool's own flags
    peeled off, the rest parsed by ``config.parse_args``."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--tokens_json", default="")
    ap.add_argument("--probe_ckpt", default="best",
                    choices=["best", "latest"],
                    help="which checkpoint tag to probe (best = the "
                         "reference's AO-SI-SDR policy, main.py:524)")
    probe_args, rest = ap.parse_known_args(argv)
    return probe_args.tokens_json, probe_args.probe_ckpt, parse_args(rest)


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    tokens_json, tag, cfg = split_argv()
    run_probe(cfg, tokens_json, tag=tag)
