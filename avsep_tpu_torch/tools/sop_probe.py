"""SoP++ audio-visual learning probe.

Port of ``tools/sop_probe.py``, the companion of ``av_probe`` for the SoP++
nets (reference ``SoP++/main.py:94-246`` and
``SoP++/attention_net.py:75-108``): the stage-3 forward builds each
source's mask from per-source visual context that the PIT attention
selects, so the separation order is visually grounded only if the
attention gave each audio slot its own visual stream.
Over a deterministic sweep of the val split:

* **assignment accuracy** (frames-swap probe): the stage-3 per-sample loss,
  scored against the ground-truth order, must rise when the two visual
  streams are swapped (``frames[:, ::-1]``); ``assign_acc_sisdr`` counts
  where the per-sample SI-SDR falls instead.  Chance 0.5 with
  uninformative vision.
* **AV vs AO SI-SDR / SDR** of the vision-conditioned and the audio-only
  branch.

Usage, the training flags::

    python -m avsep_tpu_torch.tools.sop_probe --id sopproof --ckpt ./ckpt \\
        [--probe_ckpt best|latest] <train flags>

``best`` tracks the lowest val loss, which the 3-stage curriculum pins to
an early stage-1 snapshot whose AV path is untrained: probe ``latest`` for
the end of the curriculum.  A missing ``best`` falls back to ``latest``.
It writes ``<ckpt>/<id>/sop_probe_{tag}.json`` and prints one summary
line.  It runs on the GPU; :func:`run_probe` takes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from avsep_tpu_torch.config import Config, parse_args


def run_probe(cfg: Config, tag: str = "best", device=None,
              draws=None) -> dict:
    """Probe the SoP++ checkpoint ``tag`` of ``<cfg.ckpt>/<cfg.id>`` on
    ``cfg.list_val``; returns the report and writes it.  ``draws``, if
    given, holds one ``{"noise_uniforms": ...}`` per batch, which the AV,
    the swapped AV and the AO step of that batch share (the JAX tool passes
    them one key); else the noise floor draws from a generator seeded from
    ``cfg.seed``.  Runs on ``cuda`` unless ``device="cpu"``."""
    import torch

    from avsep_tpu_torch import engine
    from avsep_tpu_torch.data.dataset import MusicMixDataset
    from avsep_tpu_torch.data.loader import BatchLoader, ConcatDataset
    from avsep_tpu_torch.sop_main import (
        build_sop_nets, init_sop_state, make_sop_eval_step)
    from avsep_tpu_torch.tools.av_probe import restore

    dev = engine.resolve_device(device)
    nets = build_sop_nets(cfg, device=dev)
    state = init_sop_state(cfg, nets, torch.Generator().manual_seed(cfg.seed),
                           device=dev)
    state = restore(cfg, state, tag, "latest")
    nets = state.nets
    ckpt_dir = os.path.join(cfg.ckpt, cfg.id)

    ds = ConcatDataset([MusicMixDataset(p, cfg, split="val")
                        for p in cfg.list_val])
    loader = BatchLoader(ds, cfg.batch_size, shuffle=False, num_workers=4,
                         seed=cfg.seed)

    steps = {v: make_sop_eval_step(cfg, nets, use_vis=v, device=dev)
             for v in (True, False)}
    noise_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    batch_draws = iter(draws) if draws is not None else None
    hits = sisdr_hits = total = 0
    acc = {k: [] for k in ("av_si_sdr", "av_sdr", "ao_si_sdr", "ao_sdr")}
    for batch in loader:
        dev_batch = engine.to_device(batch, dev,
                                     drop=engine.unused_visual_streams(cfg),
                                     cfg=cfg, mode="replicate")
        if batch_draws is not None:
            noise = next(batch_draws)["noise_uniforms"]
        else:                          # the iSTFT's length
            B, N, L = dev_batch["audios"].shape
            noise = torch.rand((B, N, L - L % cfg.stft_hop),
                               generator=noise_gen, device=dev)

        def run(use_vis, b):
            m, _, _ = steps[use_vis](b, noise_uniforms=noise)
            return {k: v.cpu().numpy() for k, v in m.items()}

        m = run(True, dev_batch)
        m_swp = run(True, {**dev_batch,
                           "frames": dev_batch["frames"].flip(1)})
        hits += int(np.sum(m["err_ps"] < m_swp["err_ps"]))
        # the direct readout: the fixed-order per-sample SI-SDR must fall
        # when the two visual streams are swapped iff vision orders the
        # outputs
        sisdr_hits += int(np.sum(m["si_sdr"] > m_swp["si_sdr"]))
        total += len(m["err_ps"])
        acc["av_si_sdr"].append(m["si_sdr"])
        acc["av_sdr"].append(m["sdr"])
        m_ao = run(False, dev_batch)
        acc["ao_si_sdr"].append(m_ao["si_sdr"])
        acc["ao_sdr"].append(m_ao["sdr"])

    report = {"assign_acc": hits / max(total, 1),
              "assign_acc_sisdr": sisdr_hits / max(total, 1),
              "assign_n": total}
    report.update({k: float(np.mean(np.concatenate(v)))
                   for k, v in acc.items()})
    report["ckpt_tag"] = tag
    out_path = os.path.join(ckpt_dir, f"sop_probe_{tag}.json")
    with open(out_path, "w") as f:
        json.dump(report, f, indent=1)
    print("[SoP probe] assign_acc={assign_acc:.3f} "
          "assign_acc_sisdr={assign_acc_sisdr:.3f} (n={assign_n}, "
          "chance 0.5)  AV SI-SDR={av_si_sdr:.2f} dB  "
          "AO SI-SDR={ao_si_sdr:.2f} dB  AV SDR={av_sdr:.2f} dB  "
          "AO SDR={ao_sdr:.2f} dB".format(**report))
    print(f"report written to {out_path}")
    return report


def split_argv(argv=None):
    """``(probe_ckpt, the Config)``: the tool's flag peeled off, the rest
    parsed by ``config.parse_args``."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--probe_ckpt", default="best",
                    choices=("best", "latest"))
    probe_args, rest = ap.parse_known_args(argv)
    return probe_args.probe_ckpt, parse_args(rest)


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    tag, cfg = split_argv()
    run_probe(cfg, tag=tag)
