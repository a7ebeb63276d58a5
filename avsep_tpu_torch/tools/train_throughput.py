"""Training-step throughput on the card, the port of
``tools/train_throughput.py``.

``n_steps`` full flagship AV train steps (the symmetric double forward,
the backward and the SGD update, in place) through
``train.make_train_step`` on seeded synthetic batches drawn on the card
(the JAX tool's draws: mixtures and per-source waveforms ``0.1 * N(0, 1)``,
frames uniform in [0, 1) as normalized float input), after ``WARMUP``
steps; synchronized host clock around the timed steps.  Each step launches
``frame_window`` twice (the mixture's and the sources' STFT) and no
``overlap_add_normalize``.  Prints steps/s and clips/s.

    python -m avsep_tpu_torch.tools.train_throughput [batch] [n_steps]
        [dtype] [dft]

(the JAX tool's argv: defaults 8, 8, float32, fft).  Runs on the GPU only.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import torch

from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.tools import measure

WARMUP = 2


def synthetic_batches(cfg: Config, batch: int, n: int,
                      device: torch.device, seed: int = 2) -> List[Dict]:
    """``n`` seeded AV batches on ``device`` (drawn there)."""
    g = torch.Generator(device=device).manual_seed(seed)
    T = 1 if cfg.one_frame else cfg.num_frames
    out = []
    for _ in range(n):
        out.append({
            "audios": 0.1 * torch.randn(batch, cfg.num_mix, cfg.audLen,
                                        generator=g, device=device),
            "audio_mix": 0.1 * torch.randn(batch, cfg.audLen, generator=g,
                                           device=device),
            "frames": torch.rand(batch, cfg.num_mix, T, cfg.imgSize,
                                 cfg.imgSize, 3, generator=g,
                                 device=device)})
    return out


def run(cfg: Config, state: train.TrainState, batch: int, n_steps: int,
        warmup: int = WARMUP, device=None) -> Dict:
    """``warmup`` then ``n_steps`` timed AV steps of ``state`` (updated in
    place) on :func:`synthetic_batches`; returns steps/s, clips/s, the
    losses and the ``calls`` made."""
    dev = engine.nets_device(state.nets, device)
    step = train.make_train_step(cfg, state.nets, use_vis=True, device=dev)
    batches = synthetic_batches(cfg, batch, warmup + n_steps, dev)
    errs = [step(state, b)[1]["err"] for b in batches[:warmup]]
    measure.synchronize(dev)
    t0 = time.perf_counter()
    errs += [step(state, b)[1]["err"] for b in batches[warmup:]]
    measure.synchronize(dev)
    dt = time.perf_counter() - t0
    losses = [float(e) for e in errs]
    if not all(math.isfinite(x) for x in losses):
        raise FloatingPointError(f"train_throughput: losses {losses}")
    return {"batch": batch, "n_steps": n_steps, "dtype": cfg.dtype,
            "dft": cfg.dft, "seconds": dt, "steps_per_s": n_steps / dt,
            "clips_per_s": batch * n_steps / dt,
            "ms_per_step": 1e3 * dt / n_steps, "losses": losses,
            "calls": {"train_step": warmup + n_steps}}


def main(argv=None, device=None) -> Dict:
    """``argv``: ``[batch] [n_steps] [dtype] [dft]``; prints the line."""
    argv = sys.argv[1:] if argv is None else list(argv)
    batch = int(argv[0]) if len(argv) > 0 else 8
    n_steps = int(argv[1]) if len(argv) > 1 else 8
    dtype = argv[2] if len(argv) > 2 else "float32"
    dft = argv[3] if len(argv) > 3 else "fft"
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship(dtype=dtype, dft=dft)
    state = train.init_state(cfg, engine.build_nets(cfg, device=dev),
                             torch.Generator().manual_seed(0), device=dev)
    r = run(cfg, state, batch, n_steps, device=dev)
    print(f"[{card}] train: {r['steps_per_s']:.2f} steps/s, "
          f"{r['clips_per_s']:.1f} clips/s (AV step, batch {batch}, "
          f"{n_steps} steps in {r['seconds']:.2f}s, {dtype}, dft {dft})",
          flush=True)
    return {**r, "card": card}


if __name__ == "__main__":
    engine.full_float32()
    main()
