"""Batch separation command line: ``python -m avsep_tpu_torch.separate_cli``.

Port of ``avsep_tpu/separate_cli.py``: reads wav mixtures (and optional
frame directories), separates them in one batch on the GPU with the
flagship model (``config.FLAGSHIP``) and writes one wav per source.

    python -m avsep_tpu_torch.separate_cli --inputs mix1.wav mix2.wav \\
        --out_dir separated/ [--frames dir1 dir2] [--ckpt ckpt --id RUN]

One ``separate`` call: one ``frame_window`` and one
``overlap_add_normalize`` launch.  Without frames (or if a directory holds
no jpg) the separation is audio-only, its slot swap drawn from a CPU
generator seeded 0.  ``main(argv)`` runs on ``cuda`` and raises without a
GPU; ``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from avsep_tpu_torch.config import FLAGSHIP, Config
from avsep_tpu_torch.data.audio_io import read_wav, resample, write_wav
from avsep_tpu_torch.data.video_transforms import val_transform_normalized


def load_mixture(path: str, cfg: Config) -> np.ndarray:
    wav, sr = read_wav(path)
    wav = resample(wav, sr, cfg.audRate)
    out = np.zeros(cfg.audLen, np.float32)
    n = min(len(wav), cfg.audLen)
    out[:n] = wav[:n]
    return np.clip(out, -1.0, 1.0)


def load_frame_dir(fdir: Optional[str], cfg: Config) -> Optional[np.ndarray]:
    """The first two jpgs of ``fdir`` (the last repeated if there is one),
    ImageNet-normalized, ``[2, 1, H, W, 3]`` float32; None without any."""
    if not fdir:
        return None
    from PIL import Image
    jpgs = sorted(glob.glob(os.path.join(fdir, "*.jpg")))[:2]
    if not jpgs:
        return None
    imgs = [val_transform_normalized([Image.open(p).convert("RGB")],
                                     cfg.imgSize)[0] for p in jpgs]
    while len(imgs) < 2:
        imgs.append(imgs[-1])
    return np.stack(imgs)[:, None]  # [2, 1, H, W, 3]


def main(argv=None, device=None) -> None:
    import torch

    from avsep_tpu_torch import checkpoint
    from avsep_tpu_torch.engine import build_nets, resolve_device, separate
    from avsep_tpu_torch.train import init_state

    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", nargs="+", required=True)
    ap.add_argument("--frames", nargs="*", default=None,
                    help="per-input frame dirs (optional; AO without)")
    ap.add_argument("--out_dir", default="./separated")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--id", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    cfg = FLAGSHIP
    state = init_state(cfg, build_nets(cfg, device=dev),
                       torch.Generator().manual_seed(0), device=dev)
    if args.ckpt:
        state = checkpoint.restore_checkpoint(
            os.path.join(args.ckpt, args.id), state, "best")

    mixes = np.stack([load_mixture(p, cfg) for p in args.inputs])
    frames = None
    if args.frames:
        fs = [load_frame_dir(d, cfg) for d in args.frames]
        if all(f is not None for f in fs):
            frames = np.stack(fs)
    wavs = separate(state.nets, mixes, frames, cfg, device=dev,
                    generator=torch.Generator().manual_seed(0)
                    )["wavs"].cpu().numpy()

    os.makedirs(args.out_dir, exist_ok=True)
    for i, p in enumerate(args.inputs):
        stem = os.path.splitext(os.path.basename(p))[0]
        for n in range(cfg.num_mix):
            write_wav(os.path.join(args.out_dir, f"{stem}_src{n + 1}.wav"),
                      wavs[i, n], cfg.audRate)
        print(f"{p} -> {args.out_dir}/{stem}_src[12].wav")


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    full_float32()
    main()
