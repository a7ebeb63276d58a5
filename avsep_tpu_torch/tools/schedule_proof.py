"""Compressed long-horizon schedule proof: the learning rate across a resume.

Port of ``tools/schedule_proof.py``.  The reference trains 95k iterations
with the learning rate x0.1 at {50k, 70k, 90k} (reference
``main.py:550-555``), evaluates and checkpoints on a cadence
(``main.py:736-760``), and a run may resume across a decay boundary.  This
tool runs that shape compressed about 500x through ``main.main`` on the
card (unet5 + the tiny conv encoder, 16383 samples, 64x64 frames):

  phase 1: iterations 1..124, lr_steps (100, 140, 160)   -> crosses 100
  phase 2: ``--load_ckpt latest``, continues 121..200   -> crosses 140, 160

and then checks the schedule from the artifacts, not the logs:

* the restored state's ``step`` is the last eval iteration (200);
* the largest group count is 200: group ``sound`` advances every step
  (``frame`` counts the AV steps only), so the schedule's position
  survived the resume (the reference recomputes the rate from scratch
  each run, so its resume would restart at the base rate);
* ``train.lr_at`` at that count is ``lr_sound * 1e-3`` (all three decays);
* the history's iterations increase across the resume;
* an eval ran at every multiple of ``eval_iter``.

It writes a JSON report (``--out``, default
``<ckpt>/sched/schedule_proof.json``) and exits non-zero on any failed
invariant.  Usage::

    python -m avsep_tpu_torch.tools.schedule_proof [--csv CSV] [--ckpt DIR] \\
        [--out PATH]

``--csv`` defaults to the ``train.csv`` that ``make_synthetic_data`` writes
with its defaults; both defaults lie under the temporary directory.

The command line runs on the GPU; :func:`run_schedule_proof` takes
``device="cpu"`` and a smaller shape.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Optional, Sequence

import numpy as np

RUN_ID = "sched"


def cli_args(csv: str, ckpt: str, num_iters: int, resume: bool,
             lr_steps: Sequence[int] = (100, 140, 160), eval_iter: int = 40,
             disp_iter: int = 20, batch_size: int = 8, val_repeat: int = 12):
    """The train flags of one phase: the JAX tool's ``cli_args`` (whose
    ``val_repeat`` is the default, 12)."""
    a = ["--mode", "train", "--id", RUN_ID, "--ckpt", ckpt,
         "--av_list_train", csv, "--ao_list_train", csv,
         "--list_val", csv,
         "--arch_sound", "unet5", "--arch_frame", "tinyconv",
         "--arch_synthesizer", "linear",
         "--num_channels", "2", "--vis_channels", "256",
         "--fusion_type", "hidsep", "--att_type", "sig", "--not_pool_vis",
         "--loss", "bce", "--binary_mask", "1", "--weighted_loss", "1",
         "--num_mix", "2", "--log_freq", "1", "--match_weight", "0.1",
         "--one_frame", "--audLen", "16383", "--imgSize", "64",
         "--audRate", "11025", "--num_gpus", "1",
         "--batch_size_per_gpu", str(batch_size), "--workers", "0",
         "--train_repeat", "10", "--val_repeat", str(val_repeat),
         "--start_av_first", "--num_fsteps", "0",
         "--iter_per_av", "2",
         "--lr_steps", *[str(s) for s in lr_steps],
         "--num_iters", str(num_iters), "--eval_iter", str(eval_iter),
         "--disp_iter", str(disp_iter), "--num_vis", "0", "--num_val", "8"]
    if resume:
        a += ["--load_ckpt", "latest"]
    return a


def run_schedule_proof(csv: str, ckpt: str, *,
                       lr_steps: Sequence[int] = (100, 140, 160),
                       iters: Sequence[int] = (125, 201), eval_iter: int = 40,
                       disp_iter: int = 20, batch_size: int = 8,
                       val_repeat: int = 12, device=None) -> dict:
    """Phase 1 fresh to ``num_iters = iters[0]``, phase 2 resumed to
    ``iters[1]``, each through ``main.main(cfg, device=device)``; then the
    invariants, checked from the checkpoint and the history.  Returns the
    report (``failures`` empty when every invariant holds).  Runs on
    ``cuda`` unless ``device="cpu"``."""
    import torch

    from avsep_tpu_torch import main as train_main
    from avsep_tpu_torch.checkpoint import load_history, restore_checkpoint
    from avsep_tpu_torch.config import parse_args
    from avsep_tpu_torch.engine import build_nets
    from avsep_tpu_torch.train import init_state, lr_at

    run_dir = os.path.join(ckpt, RUN_ID)
    shutil.rmtree(run_dir, ignore_errors=True)
    flags = dict(lr_steps=lr_steps, eval_iter=eval_iter,
                 disp_iter=disp_iter, batch_size=batch_size,
                 val_repeat=val_repeat)
    for phase, (n, resume) in enumerate(
            [(iters[0], False), (iters[1], True)], start=1):
        print(f"[phase {phase}] {'resume' if resume else 'fresh'} -> "
              f"iter {n}", flush=True)
        train_main.main(parse_args(cli_args(csv, ckpt, n, resume, **flags)),
                        device=device)

    # the artifacts, read on the CPU
    cfg = parse_args(cli_args(csv, ckpt, iters[1], True, **flags))
    template = init_state(cfg, build_nets(cfg, device="cpu"),
                          torch.Generator().manual_seed(0), device="cpu")
    state = restore_checkpoint(run_dir, template, "latest")

    final = iters[1] - 1
    failures = []
    counts = {g: s.count for g, s in state.opt_state.items()
              if s is not None}
    count = max(counts.values()) if counts else -1
    if state.step != final:
        failures.append(f"final step {state.step} != {final} (the last "
                        "checkpoint is the last eval multiple)")
    if count != final:
        failures.append(f"schedule count {count} != {final} (the learning "
                        "rate's position lost across the resume)")
    lr_final = lr_at(cfg.lr_sound, cfg.lr_steps, count)
    want = cfg.lr_sound * 1e-3
    if not np.isclose(lr_final, want, rtol=1e-6):
        failures.append(f"final lr {lr_final} != base*0.001 {want}")

    hist = load_history(run_dir)
    train_iters = hist["train"]["iter"]
    if sorted(train_iters) != train_iters or len(set(train_iters)) != len(
            train_iters):
        failures.append("history iters non-monotonic across resume")
    evals = hist["val_av"]["iter"]
    missing = [i for i in range(eval_iter, final + 1, eval_iter)
               if i not in evals]
    if missing:
        failures.append(f"eval cadence missed iters {missing}")

    return {
        "phases": {"1": f"fresh 1..{iters[0] - 1} (lr x0.1 at "
                        f"{lr_steps[0]})",
                   "2": f"resume ..{final} (x0.1 at "
                        f"{', '.join(str(s) for s in lr_steps[1:])})"},
        "final_step": state.step,
        "group_counts": counts,
        "schedule_count": count,
        "lr_final": lr_final,
        "lr_base": cfg.lr_sound,
        "eval_iters": evals,
        "train_loss_first": hist["train"]["err"][0],
        "train_loss_last": hist["train"]["err"][-1],
        "failures": failures,
        "ok": not failures,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    tmp = tempfile.gettempdir()
    ap.add_argument("--csv", default=os.path.join(tmp, "music_toy",
                                                  "train.csv"))
    ap.add_argument("--ckpt", default=os.path.join(tmp, "sched_proof"))
    ap.add_argument("--out", default="",
                    help="the report (default <ckpt>/sched/"
                         "schedule_proof.json)")
    args = ap.parse_args(argv)
    report = run_schedule_proof(args.csv, args.ckpt)
    out = args.out or os.path.join(args.ckpt, RUN_ID, "schedule_proof.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    raise SystemExit(main())
