"""Side-by-side frame + optical-flow demo video.

The port's own copy of ``avsep_tpu/data/scripts/make_optical_video.py``.
Equivalent of reference ``data/scripts/make_optical_video.py``: stitches
each RGB frame next to its x/y flow images and writes an mp4 via the
ffmpeg pipe writer.

Usage:
    python -m avsep_tpu_torch.data.scripts.make_optical_video \
        --frames_dir data/frames/cello/X.mp4 --fps 8 --out demo.mp4
"""

import argparse
import glob
import os

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames_dir", required=True)
    ap.add_argument("--fps", type=float, default=8.0)
    ap.add_argument("--out", default="optical_demo.mp4")
    args = ap.parse_args()

    import cv2
    from avsep_tpu_torch.utils.media import save_video

    optical_dir = args.frames_dir.replace("/frames/", "/optical/")
    frames = sorted(glob.glob(os.path.join(args.frames_dir,
                                           "[0-9]" * 6 + ".jpg")))
    tiles = []
    for f in frames:
        stem = os.path.splitext(os.path.basename(f))[0]
        fx = os.path.join(optical_dir, stem + "_x.jpg")
        fy = os.path.join(optical_dir, stem + "_y.jpg")
        if not (os.path.exists(fx) and os.path.exists(fy)):
            continue
        rgb = cv2.imread(f)[:, :, ::-1]
        x = cv2.cvtColor(cv2.imread(fx, 0), cv2.COLOR_GRAY2RGB)
        y = cv2.cvtColor(cv2.imread(fy, 0), cv2.COLOR_GRAY2RGB)
        h = min(rgb.shape[0], x.shape[0], y.shape[0])
        w = min(rgb.shape[1], x.shape[1], y.shape[1])
        tiles.append(np.hstack([rgb[:h, :w], x[:h, :w], y[:h, :w]]))
    if not tiles:
        print("no frame/flow pairs found")
        return
    save_video(args.out, np.stack(tiles), fps=args.fps)
    print(f"wrote {args.out} ({len(tiles)} frames)")


if __name__ == "__main__":
    main()
