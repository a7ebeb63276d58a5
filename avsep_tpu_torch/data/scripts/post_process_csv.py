"""Build / post-process CSV manifests.

The port's own copy of ``avsep_tpu/data/scripts/post_process_csv.py``.
Equivalent of reference ``data/scripts/post_process_csv.py``: probe each
audio/frames pair for frame count, fps, and audio length, and write rows
``audio_path, frames_dir, num_frames, fps, audio_len_sec, class`` — the
manifest schema consumed by MusicMixDataset (reference dataset row format,
data/train.csv).

Two modes:

* default: probe one (audio_root, frames_root) tree into a single CSV.
* ``--emit_splits``: probe a reference-layout extracted tree
  (``<root>/{audio,frames}/<cls>/...`` plus optional
  ``<root>/{audio_duet,frames_duet}/"<cls1> <cls2>"/...``) and emit the
  full five-manifest set the reference ships (``data/{train,val,train_av,
  train_ao,duet}.csv``): ``val`` takes ``--val_per_class`` recordings per
  class, the rest is ``train``, and ``train_av``/``train_ao`` are the
  alternating halves of ``train`` (deterministic; the reference's own
  av/ao lists are curated subsets of train).

Usage:
    python -m avsep_tpu_torch.data.scripts.post_process_csv \
        --audio_root data/audio --frames_root data/frames --out data/all.csv
    python -m avsep_tpu_torch.data.scripts.post_process_csv \
        --emit_splits --root data/mini --out_dir data --val_per_class 1
"""

import argparse
import glob
import os
import wave


def probe_audio_len(path: str) -> float:
    with wave.open(path, "rb") as w:
        return w.getnframes() / w.getframerate()


def probe_frames(frames_dir: str):
    jpgs = glob.glob(os.path.join(frames_dir, "[0-9]" * 6 + ".jpg"))
    return len(jpgs)


def probe_fps(video_path: str) -> float:
    """ffprobe when the source video is available; else caller supplies."""
    import subprocess as sp
    try:
        out = sp.run(["ffprobe", "-v", "quiet", "-select_streams", "v:0",
                      "-show_entries", "stream=r_frame_rate", "-of",
                      "default=nw=1:nk=1", video_path],
                     capture_output=True, text=True, timeout=20).stdout
        num, den = out.strip().split("/")
        return float(num) / float(den)
    except Exception:
        return 0.0


def probe_tree(audio_root: str, frames_root: str, fps_fallback: float = 0.0):
    """Rows for every wav with a matching frames dir, sorted by path."""
    rows = []
    for wav in sorted(glob.glob(os.path.join(audio_root, "*", "*.wav"))):
        cls = os.path.basename(os.path.dirname(wav))
        stem = os.path.splitext(os.path.basename(wav))[0]
        fdir = os.path.join(frames_root, cls, stem + ".mp4")
        if not os.path.isdir(fdir):
            continue
        n_frames = probe_frames(fdir)
        a_len = probe_audio_len(wav)
        fps = fps_fallback or (n_frames / a_len if a_len else 0.0)
        rows.append([wav, fdir, str(n_frames), str(round(fps, 2)),
                     str(round(a_len, 3)), cls])
    return rows


def write_csv(path: str, rows) -> None:
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(r) + "\n")
    print(f"wrote {len(rows)} rows to {path}")


def emit_splits(root: str, out_dir: str, val_per_class: int,
                fps_fallback: float = 0.0) -> None:
    """The five-manifest reference set from one extracted tree."""
    rows = probe_tree(os.path.join(root, "audio"),
                      os.path.join(root, "frames"), fps_fallback)
    if not rows:
        raise SystemExit(f"no (wav, frames) pairs under {root}/audio + "
                         f"{root}/frames")
    by_cls = {}
    for r in rows:
        by_cls.setdefault(r[-1], []).append(r)

    train, val = [], []
    for cls in sorted(by_cls):
        recs = by_cls[cls]
        k = min(val_per_class, max(0, len(recs) - 1))  # keep >=1 for train
        val += recs[len(recs) - k:]
        train += recs[:len(recs) - k]

    os.makedirs(out_dir, exist_ok=True)
    write_csv(os.path.join(out_dir, "train.csv"), train)
    write_csv(os.path.join(out_dir, "val.csv"), val)
    write_csv(os.path.join(out_dir, "train_av.csv"), train[0::2])
    write_csv(os.path.join(out_dir, "train_ao.csv"), train[1::2])

    duet = probe_tree(os.path.join(root, "audio_duet"),
                      os.path.join(root, "frames_duet"), fps_fallback)
    if duet:
        write_csv(os.path.join(out_dir, "duet.csv"), duet)
    else:
        print("no duet tree found; skipping duet.csv")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio_root", default="./data/audio")
    ap.add_argument("--frames_root", default="./data/frames")
    ap.add_argument("--out", default="./data/all.csv")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="fallback fps when no source video to probe")
    ap.add_argument("--emit_splits", action="store_true",
                    help="emit the five reference manifests from --root")
    ap.add_argument("--root", default="./data",
                    help="extracted tree root (emit_splits mode)")
    ap.add_argument("--out_dir", default="./data",
                    help="manifest output dir (emit_splits mode)")
    ap.add_argument("--val_per_class", type=int, default=1)
    args = ap.parse_args()

    if args.emit_splits:
        emit_splits(args.root, args.out_dir, args.val_per_class, args.fps)
        return

    rows = probe_tree(args.audio_root, args.frames_root, args.fps)
    write_csv(args.out, rows)


if __name__ == "__main__":
    main()
