"""The host loader's rate: batches/s and clips/s on real jpg + wav IO.

Port of ``tools/bench_loader.py``: the port's process-pool loader (or the
thread loader) over a manifest, to set beside the train step's rate on the
card.  Usage::

    python -m avsep_tpu_torch.tools.bench_loader --csv build/toy/train.csv \\
        [--bs 16] [--workers 8] [--n 60] [--threads] [--one_frame]

It prints one line.  The module imports numpy, PIL and the standard
library, never torch, so it and its loader's workers stay light.
"""

from __future__ import annotations

import argparse
import time

from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data.dataset import MusicMixDataset
from avsep_tpu_torch.data.loader import (
    BatchLoader, ProcessBatchLoader, iter_forever)


def main(argv=None) -> None:
    """Run the bench on ``argv`` and print its line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True)
    ap.add_argument("--bs", type=int, default=16)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n", type=int, default=60)
    ap.add_argument("--threads", action="store_true",
                    help="use the thread loader instead of processes")
    ap.add_argument("--frame_decode", default="auto",
                    choices=["auto", "native", "fast", "pil"])
    ap.add_argument("--one_frame", action="store_true")
    ap.add_argument("--load_clips", action="store_true")
    ap.add_argument("--clip_len", type=int, default=8)
    args = ap.parse_args(argv)

    cfg = Config(num_mix=2, num_frames=3, stride_frames=8, frameRate=30,
                 audLen=65535, audRate=11025, imgSize=224,
                 one_frame=args.one_frame, train_repeat=50, rate_dc=1,
                 max_silent=0.87, frame_decode=args.frame_decode,
                 load_clips=args.load_clips, clip_len=args.clip_len)
    ds = MusicMixDataset(args.csv, cfg, split="train")
    cls = BatchLoader if args.threads else ProcessBatchLoader
    ld = cls(ds, args.bs, num_workers=args.workers, seed=0, drop_last=True)
    try:
        it = iter_forever(ld)
        for _ in range(10):  # warm-up: the forkserver and the first wave
            next(it)
        t0 = time.perf_counter()
        for _ in range(args.n):
            next(it)
        dt = time.perf_counter() - t0
    finally:
        ld.close()
    print(f"{'thread' if args.threads else 'process'} loader "
          f"[{args.frame_decode}"
          f"{', clips' if args.load_clips else ''}]: "
          f"{args.n / dt:.1f} batches/s = {args.n * args.bs / dt:.0f} "
          f"clips/s ({dt / args.n * 1000:.0f} ms/batch) at B={args.bs}, "
          f"{args.workers} workers, real jpg+wav IO")


if __name__ == "__main__":
    main()
