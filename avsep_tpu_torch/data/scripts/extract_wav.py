"""Extract mono 11025 Hz wavs (and optionally frames) from source videos.

The port's own copy of ``avsep_tpu/data/scripts/extract_wav.py``.
Equivalent of reference ``data/scripts/extract_wav.py`` (ffmpeg-python audio
extraction at 11025 Hz — the reference's live body is commented out at
:20-26; this version actually runs).  Path layout follows the reference's
converters (``utils.py:221-259``): ``videos/solo/<cls>/X.mp4`` ->
``audio/<cls>/X.wav`` and ``frames/<cls>/X.mp4/%06d.jpg``.

Usage:
    python -m avsep_tpu_torch.data.scripts.extract_wav --video_root data/videos \
        --rate 11025 [--frames --fps -1]
"""

import argparse
import glob
import os
import subprocess as sp


def audio_out_path(video_path: str) -> str:
    p = video_path.replace("/videos/solo/", "/audio/")
    p = p.replace("/videos/duet/", "/audio_duet/")
    return os.path.splitext(p)[0] + ".wav"


def frames_out_dir(video_path: str) -> str:
    p = video_path.replace("/videos/solo/", "/frames/")
    return p.replace("/videos/duet/", "/frames_duet/")


def extract_audio(video: str, rate: int) -> None:
    out = audio_out_path(video)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = ["ffmpeg", "-y", "-loglevel", "quiet", "-i", video, "-vn",
           "-ac", "1", "-ar", str(rate), out]
    sp.run(cmd, check=False)


def extract_frames(video: str, fps: float) -> None:
    out_dir = frames_out_dir(video)
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-loglevel", "quiet", "-i", video]
    if fps > 0:
        cmd += ["-vf", f"fps={fps}"]
    cmd += ["-start_number", "0", os.path.join(out_dir, "%06d.jpg")]
    sp.run(cmd, check=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--video_root", default="./data/videos")
    ap.add_argument("--rate", type=int, default=11025)
    ap.add_argument("--frames", action="store_true")
    ap.add_argument("--fps", type=float, default=-1)
    args = ap.parse_args()

    videos = sorted(glob.glob(os.path.join(args.video_root, "**", "*.mp4"),
                              recursive=True))
    print(f"{len(videos)} videos")
    for v in videos:
        extract_audio(v, args.rate)
        if args.frames:
            extract_frames(v, args.fps)
        print("done:", v)


if __name__ == "__main__":
    main()
