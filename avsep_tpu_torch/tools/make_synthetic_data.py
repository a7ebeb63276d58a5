"""Generate a tiny synthetic MUSIC-style dataset and its manifests.

Port of ``examples/make_synthetic_data.py``: the same flags, the same
``RandomState(0)`` stream drawn in the same order, so the same flags write
the same wavs and jpgs byte for byte, the same ``train.csv`` rows and the
same ``tokens.json``.  Per-class tone wavs and frame jpgs, manifests in the
reference schema, so the port's train / eval / probe stack runs without
downloading MUSIC:

    python -m avsep_tpu_torch.tools.make_synthetic_data \
        --root build/music_toy --class_tokens
    python -m avsep_tpu_torch.main --mode train --id toy \
        --av_list_train build/music_toy/train.csv \
        --ao_list_train build/music_toy/train.csv \
        --list_val build/music_toy/train.csv <model flags>

With ``--layout reference`` the tree mirrors the reference repo's
extracted-MUSIC layout (``audio/<cls>/*.wav`` + ``frames/<cls>/*.mp4/`` +
optional ``audio_duet``/``frames_duet`` pairs), which
``avsep_tpu_torch.data.scripts.post_process_csv --emit_splits`` consumes.

The module imports numpy, PIL and the standard library, never torch.  Its
default ``--root`` lies under the temporary directory (``TMPDIR``).
"""

import argparse
import json
import os
import tempfile

import numpy as np

from avsep_tpu_torch.data.audio_io import write_wav

SR = 11025


def _tone(ci: int, vid: int, n: int, rs) -> np.ndarray:
    t = np.arange(n) / SR
    f0 = 180 + 90 * ci + 17 * vid
    return (0.35 * np.sin(2 * np.pi * f0 * t)
            + 0.15 * np.sin(2 * np.pi * 2 * f0 * t)
            + 0.01 * rs.randn(n)).astype(np.float32)


# distinct saturated colors, one per class (class-token identity)
TOKEN_PALETTE = [
    (230, 25, 75), (60, 180, 75), (0, 130, 200), (255, 225, 25),
    (145, 30, 180), (70, 240, 240), (240, 50, 230), (250, 190, 212),
]


def _draw_token(img: np.ndarray, ci: int, quadrant: int,
                scale: float = 0.30) -> None:
    """Class-informative visual token: a class-colored square with
    ``(ci % 4) + 1`` dark inner bars, centered in one image quadrant
    (0=TL, 1=TR, 2=BL, 3=BR).  Gives the CoLoc fusion something a frame
    encoder can actually localize — the default noise-texture frames carry
    no class signal.  ``scale`` is the token edge
    as a fraction of the short image side (capped so the token stays
    inside its quadrant)."""
    h, w = img.shape[:2]
    s = int(min(scale, 0.5) * min(h, w))
    qy, qx = divmod(quadrant, 2)
    cy, cx = h // 4 + qy * (h // 2), w // 4 + qx * (w // 2)
    y0, x0 = cy - s // 2, cx - s // 2
    img[y0:y0 + s, x0:x0 + s] = TOKEN_PALETTE[ci % len(TOKEN_PALETTE)]
    nb = (ci % 4) + 1
    bw = max(1, s // (2 * nb + 1))
    for b in range(nb):
        xb = x0 + (2 * b + 1) * bw
        img[y0 + s // 4: y0 + 3 * s // 4, xb:xb + bw] = (0, 0, 0)


def _frames(fdir: str, n_frames: int, rs, size, tokens=(),
            shared_background: bool = False,
            token_scale: float = 0.30) -> None:
    from PIL import Image
    os.makedirs(fdir, exist_ok=True)
    h, w = size
    # shared_background: one noise texture for EVERY video, so a class
    # token (if any) is the only video-distinguishing visual content —
    # otherwise a small encoder can pass train-set checks by memorizing
    # each video's unique background instead of reading the token
    bg_rs = np.random.RandomState(12345) if shared_background else rs
    base = bg_rs.randint(0, 200, (h, w, 3), np.uint8)
    stripe_w = min(10, max(1, w // 2))
    span = max(1, w - stripe_w)  # keep the moving stripe in-frame for any w
    for fi in range(n_frames):
        img = base.copy()
        x0 = (fi * 5) % span
        img[:, x0:x0 + stripe_w] = 255
        for ci, quadrant in tokens:  # tokens sit on top of the stripe
            _draw_token(img, ci, quadrant, token_scale)
        Image.fromarray(img).save(
            os.path.join(fdir, "{:06d}.jpg".format(fi)), quality=70)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                  "music_toy"))
    ap.add_argument("--classes", nargs="+",
                    default=["cello", "flute", "violin", "trumpet"])
    ap.add_argument("--videos_per_class", type=int, default=2)
    ap.add_argument("--duration", type=float, default=14.0)
    ap.add_argument("--fps", type=float, default=8.0)
    ap.add_argument("--layout", choices=["flat", "reference"],
                    default="flat",
                    help="flat: <root>/<cls>/v.wav (+.mp4/); reference: "
                         "<root>/{audio,frames}/<cls>/... + duet trees")
    ap.add_argument("--duets", type=int, default=0,
                    help="duet recordings per adjacent class pair "
                         "(reference layout only)")
    ap.add_argument("--img_size", type=int, nargs=2, default=[120, 160],
                    metavar=("H", "W"))
    ap.add_argument("--shared_background", action="store_true",
                    help="every video shares ONE background texture, so "
                         "class tokens are the only distinguishing visual "
                         "content (held-out generalization can't be faked "
                         "by background memorization)")
    ap.add_argument("--token_scale", type=float, default=0.30,
                    help="class-token edge as a fraction of the short "
                         "image side (<=0.5 keeps it inside its quadrant); "
                         "larger tokens make the visual task easier for "
                         "small encoders at small resolutions")
    ap.add_argument("--class_tokens", action="store_true",
                    help="draw a class-informative visual token (distinct "
                         "color+glyph per class) at a per-video random "
                         "quadrant, recorded in <root>/tokens.json — makes "
                         "the frames carry real class signal so the CoLoc "
                         "AV branch can learn from vision")
    args = ap.parse_args(argv)

    rs = np.random.RandomState(0)
    n = int(SR * args.duration)
    n_frames = int(args.duration * args.fps) + 2
    rows = []
    token_meta = {}

    for ci, cls in enumerate(args.classes):
        for vid in range(args.videos_per_class):
            wav = _tone(ci, vid, n, rs)
            if args.layout == "flat":
                adir = os.path.join(args.root, cls)
                fdir = os.path.join(args.root, cls, f"v{ci}{vid}.mp4")
            else:
                adir = os.path.join(args.root, "audio", cls)
                fdir = os.path.join(args.root, "frames", cls,
                                    f"v{ci}{vid}.mp4")
            os.makedirs(adir, exist_ok=True)
            apath = os.path.join(adir, f"v{ci}{vid}.wav")
            write_wav(apath, wav, SR)
            tokens = ()
            if args.class_tokens:
                q = int(rs.randint(4))
                tokens = ((ci, q),)
                token_meta[os.path.abspath(fdir)] = {
                    "class": cls, "class_index": ci, "quadrant": q}
            _frames(fdir, n_frames, rs, args.img_size, tokens,
                    args.shared_background, args.token_scale)
            rows.append([apath, fdir, str(int(args.duration * args.fps)),
                         str(args.fps), str(args.duration), cls])

    if args.layout == "reference" and args.duets:
        for ci in range(len(args.classes) - 1):
            c1, c2 = args.classes[ci], args.classes[ci + 1]
            pair = f"{c1} {c2}"  # reference duet class format, duet.csv
            for vid in range(args.duets):
                wav = 0.5 * (_tone(ci, vid, n, rs)
                             + _tone(ci + 1, vid, n, rs))
                adir = os.path.join(args.root, "audio_duet", pair)
                fdir = os.path.join(args.root, "frames_duet", pair,
                                    f"d{ci}{vid}.mp4")
                os.makedirs(adir, exist_ok=True)
                write_wav(os.path.join(adir, f"d{ci}{vid}.wav"), wav, SR)
                tokens = ()
                if args.class_tokens:
                    qa = int(rs.randint(4))
                    qb = (qa + 1 + int(rs.randint(3))) % 4  # distinct
                    tokens = ((ci, qa), (ci + 1, qb))
                    token_meta[os.path.abspath(fdir)] = {
                        "class": pair, "class_index": [ci, ci + 1],
                        "quadrant": [qa, qb]}
                _frames(fdir, n_frames, rs, args.img_size, tokens,
                        args.shared_background, args.token_scale)

    csv_path = os.path.join(args.root, "train.csv")
    with open(csv_path, "w") as f:
        for r in rows:
            f.write(",".join(r) + "\n")
    if args.class_tokens:
        with open(os.path.join(args.root, "tokens.json"), "w") as f:
            json.dump(token_meta, f, indent=1)
        print(f"wrote token positions for {len(token_meta)} videos")
    print(f"wrote {len(rows)} rows to {csv_path}")


if __name__ == "__main__":
    main()
