"""TV-L1 dense optical flow extraction over frame directories.

The port's own copy of ``avsep_tpu/data/scripts/extract_optflow.py``.
Equivalent of reference ``data/scripts/extract_optflow.py``: per frame pair,
``cv2.optflow.createOptFlow_DualTVL1`` (falls back to Farneback when the
cv2 contrib module is absent), x/y components bounded to ±bound and written
as ``NNNNNN_x.jpg`` / ``NNNNNN_y.jpg`` under ``optical/``; parallelized
with a process pool like the reference's ``Pool(4)`` (:235).

Usage:
    python -m avsep_tpu_torch.data.scripts.extract_optflow --frames_root \
        data/frames --workers 4 --bound 15
"""

import argparse
import glob
import os
from multiprocessing import Pool

import numpy as np


def flow_to_u8(comp: np.ndarray, bound: float) -> np.ndarray:
    comp = np.clip(comp, -bound, bound)
    return ((comp + bound) / (2 * bound) * 255.0).astype(np.uint8)


def process_dir(args_tuple):
    frame_dir, bound = args_tuple
    import cv2
    out_dir = frame_dir.replace("/frames/", "/optical/")
    os.makedirs(out_dir, exist_ok=True)
    frames = sorted(glob.glob(os.path.join(frame_dir, "[0-9]" * 6 + ".jpg")))
    if len(frames) < 2:
        return frame_dir
    try:
        tvl1 = cv2.optflow.createOptFlow_DualTVL1()
        calc = lambda a, b: tvl1.calc(a, b, None)
    except AttributeError:
        calc = lambda a, b: cv2.calcOpticalFlowFarneback(
            a, b, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    prev = cv2.cvtColor(cv2.imread(frames[0]), cv2.COLOR_BGR2GRAY)
    for f in frames[1:]:
        cur = cv2.cvtColor(cv2.imread(f), cv2.COLOR_BGR2GRAY)
        flow = calc(prev, cur)
        stem = os.path.splitext(os.path.basename(f))[0]
        cv2.imwrite(os.path.join(out_dir, stem + "_x.jpg"),
                    flow_to_u8(flow[..., 0], bound))
        cv2.imwrite(os.path.join(out_dir, stem + "_y.jpg"),
                    flow_to_u8(flow[..., 1], bound))
        prev = cur
    return frame_dir


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames_root", default="./data/frames")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--bound", type=float, default=15.0)
    args = ap.parse_args()

    dirs = sorted(d for d in glob.glob(
        os.path.join(args.frames_root, "*", "*")) if os.path.isdir(d))
    print(f"{len(dirs)} frame dirs")
    with Pool(args.workers) as pool:
        for done in pool.imap_unordered(
                process_dir, [(d, args.bound) for d in dirs]):
            print("done:", done)


if __name__ == "__main__":
    main()
