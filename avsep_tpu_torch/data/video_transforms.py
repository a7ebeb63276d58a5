"""Temporally consistent video frame transforms (numpy / PIL, NHWC output).

The port's own copy of ``avsep_tpu/data/video_transforms.py`` (reference
``dataset/video_transforms.py``): each transform applies ONE random draw to
the whole list of frames so a clip stays temporally consistent.  The
loaders ship uint8 ``[T, H, W, 3]`` frames; ImageNet normalization runs on
the device (``engine.normalize_frames``).
"""

from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np
from PIL import Image

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def resize_shorter_dims(w: int, h: int, size: int):
    """Target dims for a shorter-side-to-``size`` resize."""
    if w < h:
        return size, int(round(size * h / w))
    return int(round(size * w / h)), size


def resize_shorter(frames: List[Image.Image], size: int) -> List[Image.Image]:
    """Resize the shorter side to ``size`` (bicubic), like torchvision
    Resize with an int argument (reference base.py:100,104)."""
    out = []
    for img in frames:
        nw, nh = resize_shorter_dims(*img.size, size)
        out.append(img.resize((nw, nh), Image.BICUBIC))
    return out


def center_crop(frames: List[Image.Image], size: int) -> List[Image.Image]:
    out = []
    for img in frames:
        left, top = center_crop_box(*img.size, size)
        out.append(img.crop((left, top, left + size, top + size)))
    return out


def random_crop(frames: List[Image.Image], size: int,
                rng: random.Random) -> List[Image.Image]:
    """One crop position for the whole clip (reference
    video_transforms.py:68-123: get_params drawn once)."""
    w, h = frames[0].size
    if w == size and h == size:
        return frames
    left = rng.randint(0, max(w - size, 0))
    top = rng.randint(0, max(h - size, 0))
    return [img.crop((left, top, left + size, top + size)) for img in frames]


def rrc_params(w: int, h: int, rng: random.Random,
               scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop parameter draw (one draw per clip).  Returns
    (left, top, cw, ch) or None for the 10-attempt fallback (center crop
    of min(w, h))."""
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        log_r = (math.log(ratio[0]), math.log(ratio[1]))
        ar = math.exp(rng.uniform(*log_r))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw)
            top = rng.randint(0, h - ch)
            return left, top, cw, ch
    return None


def center_crop_box(w: int, h: int, size: int):
    """(left, top) of a PIL-convention center crop."""
    return int(round((w - size) / 2.0)), int(round((h - size) / 2.0))


def random_resized_crop(frames: List[Image.Image], size: int,
                        rng: random.Random,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)
                        ) -> List[Image.Image]:
    """torchvision/mmaction-style RandomResizedCrop with one draw for the
    whole clip (the clip pipeline, reference dataset/music.py:181)."""
    w, h = frames[0].size
    p = rrc_params(w, h, rng, scale, ratio)
    if p is None:  # fallback: center crop
        return [img.resize((size, size), Image.BICUBIC)
                for img in center_crop(frames, min(w, h))]
    left, top, cw, ch = p
    return [img.crop((left, top, left + cw, top + ch))
            .resize((size, size), Image.BICUBIC) for img in frames]


def random_hflip(frames: List[Image.Image],
                 rng: random.Random) -> List[Image.Image]:
    """One coin for the whole clip (reference video_transforms.py:126-152)."""
    if rng.random() < 0.5:
        return [img.transpose(Image.FLIP_LEFT_RIGHT) for img in frames]
    return frames


def to_uint8_array(frames: Sequence[Image.Image]) -> np.ndarray:
    """PIL list -> [T, H, W, 3] uint8, the loaders' wire format."""
    return np.stack([np.asarray(img.convert("RGB"), np.uint8)
                     for img in frames])


def train_transform(frames: List[Image.Image], img_size: int,
                    rng: random.Random) -> np.ndarray:
    """Resize(1.1x) -> RandomCrop -> RandomHFlip (reference
    dataset/base.py:99-110), uint8."""
    frames = resize_shorter(frames, int(img_size * 1.1))
    frames = random_crop(frames, img_size, rng)
    frames = random_hflip(frames, rng)
    return to_uint8_array(frames)


def val_transform(frames: List[Image.Image], img_size: int) -> np.ndarray:
    """Resize -> CenterCrop (reference dataset/base.py:103-106), uint8."""
    frames = resize_shorter(frames, img_size)
    frames = center_crop(frames, img_size)
    return to_uint8_array(frames)


def denormalize(frame: np.ndarray) -> np.ndarray:
    """[H, W, 3] normalized -> uint8 RGB (reference utils.recover_rgb).
    uint8 wire-format frames are already RGB and pass through."""
    if frame.dtype == np.uint8:
        return frame
    x = frame * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)
