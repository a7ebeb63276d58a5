"""MUSIC mixture dataset: manifests, mixing policy, deterministic sampling.

The port's own copy of ``avsep_tpu/data/dataset.py`` (reference
``dataset/base.py`` + ``dataset/music.py``): CSV manifests (rows
``audio_path, frames_dir, num_frames, fps, audio_len_sec, class``),
on-the-fly mixing with partner selection (``dc`` different class / ``sc``
same class / ``sv`` same video / ``random`` / ``vis1``), silence-rejecting
crop retries, and center frames with temporally consistent transforms.

Each ``__getitem__`` draws from a local ``random.Random((seed << 32) ^
index)``, so a sample depends on its index and seed alone, whatever thread
or process builds it, and equals the JAX dataset's sample bit for bit.
Frames are decoded with PIL; the JAX package's C++ decode
(``frame_decode native|fast``) is not ported and raises
(``config.check_frame_decode``).  No STFT happens here: raw waveforms and
uint8 frames go to the device.  This module imports numpy and PIL, never
torch, so loader worker processes stay light.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from avsep_tpu_torch.config import Config, check_frame_decode
from avsep_tpu_torch.data.audio_io import load_audio_crop
from avsep_tpu_torch.data.video_transforms import (
    center_crop, random_hflip, random_resized_crop, resize_shorter,
    to_uint8_array, train_transform, val_transform)

MUSIC11_CLASSES = [
    "accordion", "acoustic_guitar", "cello", "clarinet", "erhu", "flute",
    "saxophone", "trumpet", "tuba", "violin", "xylophone"]


def read_manifest(csv_path: str) -> List[List[str]]:
    """Rows with >= 2 columns (reference dataset/base.py:61-70)."""
    rows = []
    with open(csv_path, "r") as f:
        for row in csv.reader(f, delimiter=","):
            if len(row) < 2:
                continue
            rows.append(row)
    return rows


class MusicMixDataset:
    """Deterministic-by-index mixture sampler (reference MUSICMixDataset)."""

    def __init__(self, csv_path, cfg: Config, split: str = "val",
                 seed: Optional[int] = None, random_sample: bool = False,
                 vis_data: Optional[str] = None, classes=None):
        check_frame_decode(cfg.frame_decode)
        self.cfg = cfg
        self.split = split
        self.random_sample = random_sample
        self.vis_data = vis_data
        self.seed = seed if seed is not None else cfg.seed
        self.classes = list(classes or MUSIC11_CLASSES)
        self.class_int_map = {k: v for v, k in enumerate(self.classes)}

        if isinstance(csv_path, str):
            self.list_samples = read_manifest(csv_path)
        else:
            self.list_samples = list(csv_path)
        self.dict_samples: Dict[str, list] = {}
        for s in self.list_samples:
            self.dict_samples.setdefault(s[-1], []).append(s)

        # repeat + shuffle (reference dataset/base.py:75-81)
        if split == "train":
            self.list_samples = self.list_samples * cfg.train_repeat
            random.Random(self.seed).shuffle(self.list_samples)
        else:
            self.list_samples = self.list_samples * cfg.val_repeat
        if not self.list_samples:
            raise ValueError(f"manifest {csv_path!r} has no rows")

    def __len__(self):
        return len(self.list_samples)

    # ---------------------------------------------------------- sampling

    def get_samples(self, index: int, option: str, rng: random.Random):
        """Partner selection (reference dataset/music.py:57-93)."""
        cfg = self.cfg
        infos = [self.list_samples[index]]
        sound_cls = self.list_samples[index][-1]
        if option == "dc":
            # classes present in the manifest only (the reference assumes
            # all of MUSIC-11 is populated)
            left = [c for c in self.classes
                    if c != sound_cls and c in self.dict_samples]
            for _ in range(cfg.num_mix - 1):
                cls = rng.choice(left)
                infos.append(rng.choice(self.dict_samples[cls]))
        elif option == "sc":
            for _ in range(cfg.num_mix - 1):
                infos.append(rng.choice(self.dict_samples[sound_cls]))
        elif option == "sv":
            for _ in range(cfg.num_mix - 1):
                infos.append(self.list_samples[index])
        elif option == "random":
            for _ in range(cfg.num_mix - 1):
                infos.append(self.list_samples[
                    rng.randint(0, len(self.list_samples) - 1)])
        elif option == "vis1":
            infos = [rng.choice(self.dict_samples["cello"])]
            for _ in range(cfg.num_mix - 1):
                infos.append(rng.choice(self.dict_samples["flute"]))
        return infos

    def get_audios(self, infos, rng: random.Random):
        """Silence-rejecting crops; each source scaled by 1/N then summed
        (reference dataset/music.py:96-130)."""
        cfg = self.cfg
        aud_sec = cfg.audSec
        audios, center_times = [], []
        for info in infos:
            apath, num_f, fps, a_len = info[0], info[2], info[3], info[4]
            act_len = min(float(num_f) / float(fps), float(a_len))
            for j in range(10):
                end = act_len - cfg.margin - aud_sec / 2
                start = cfg.margin + aud_sec / 2
                if start > end:
                    end = act_len - aud_sec / 2
                    start = aud_sec / 2
                t = rng.uniform(0 + start, end)
                aud = load_audio_crop(
                    apath, t, aud_len=cfg.audLen, aud_rate=cfg.audRate,
                    margin=cfg.margin, rng=rng, train=self.split == "train")
                if self.split == "train":
                    is_silent = bool(np.all(aud == 0))
                else:
                    frac = (np.abs(aud) < 0.001).sum() / cfg.audLen
                    is_silent = frac > cfg.max_silent
                if not is_silent or j == 9:
                    if is_silent:
                        print(f"Load {apath} failed.")
                    center_times.append(t)
                    audios.append(aud / cfg.num_mix)
                    break
        mixture = np.sum(np.asarray(audios), axis=0)
        return audios, mixture, center_times

    def frame_paths(self, info, center_t: float, rng: random.Random
                    ) -> List[str]:
        """Center-frame index arithmetic (reference dataset/music.py:
        132-156), indices clamped to [0, num_frames - 1] (the reference
        crashes on rows shorter than 2 * margin + audSec)."""
        cfg = self.cfg
        fpath, num_f, fps = info[1], info[2], float(info[3])
        last = max(int(float(num_f)) - 1, 0)
        center_idx = round(center_t * fps)
        idxs = []
        if cfg.one_frame:
            idxs.append(center_idx
                        + rng.randint(-cfg.stride_frames, cfg.stride_frames))
        else:
            idxs = [center_idx + (i - cfg.num_frames // 2) * cfg.stride_frames
                    for i in range(cfg.num_frames)]
        return [os.path.join(fpath,
                             "{:06d}.jpg".format(min(max(i, 0), last)))
                for i in idxs]

    def get_frames(self, infos, center_times, rng: random.Random):
        cfg = self.cfg
        out = []
        for info, t in zip(infos, center_times):
            paths = self.frame_paths(info, t, rng)
            imgs = [Image.open(p).convert("RGB") for p in paths]
            if self.split == "train":
                out.append(train_transform(imgs, cfg.imgSize, rng))
            else:
                out.append(val_transform(imgs, cfg.imgSize))
        return np.stack(out)

    def get_frames_clips(self, infos, center_times, rng: random.Random):
        """Clip pipeline (reference ``get_frames_mmcv``, dataset/
        music.py:202-229): ``clip_len`` frames uniform over ``audSec``
        seconds around the center time, plus the strided center frames;
        train: Resize(-1, 256) -> RandomResizedCrop -> imgSize, flip; val:
        Resize(-1, 256) -> CenterCrop(min(imgSize, 224))."""
        cfg = self.cfg
        center_list, clip_list = [], []
        for info, center_t in zip(infos, center_times):
            fpath, num_f, fps = info[1], float(info[2]), float(info[3])
            t0 = center_t - cfg.audSec / 2
            idxs = [int(round((t0 + cfg.audSec * k / cfg.clip_len) * fps))
                    for k in range(cfg.clip_len)]
            idxs = [min(max(i, 0), int(num_f) - 1) for i in idxs]
            center_idx = round(center_t * fps)
            if cfg.one_frame:
                cidx = [center_idx]
            else:
                cidx = [center_idx + (i - cfg.num_frames // 2)
                        * cfg.stride_frames for i in range(cfg.num_frames)]
            cidx = [min(max(i, 0), int(num_f) - 1) for i in cidx]
            all_imgs = [Image.open(os.path.join(fpath, "{:06d}.jpg".format(i)))
                        .convert("RGB") for i in idxs + cidx]
            all_imgs = resize_shorter(all_imgs, 256)
            if self.split == "train":
                all_imgs = random_resized_crop(all_imgs, cfg.imgSize, rng)
                all_imgs = random_hflip(all_imgs, rng)
            else:
                all_imgs = center_crop(all_imgs, min(cfg.imgSize, 224))
            arr = to_uint8_array(all_imgs)
            clip_list.append(arr[: cfg.clip_len])
            center_list.append(arr[cfg.clip_len:])
        return np.stack(center_list), np.stack(clip_list)

    def get_ids_labels(self, infos, index, center_times):
        """Sample name string + class ids (reference dataset/music.py:
        231-243)."""
        cls_ls, cls_ids, id_ls = [], [], []
        cts = [str(round(t)) for t in center_times]
        for info in infos:
            ci = self.class_int_map[info[-1]]
            cls_ls.append(str(ci))
            cls_ids.append(ci)
            id_ls.append(os.path.basename(info[0]).split(".")[0][:4])
        name = (str(index) + "_cls" + "_".join(cls_ls) + "_ids"
                + "_".join(id_ls) + "_ct" + "_".join(cts))
        return name, np.asarray(cls_ids, np.int32)

    # ---------------------------------------------------------- getitem

    def __getitem__(self, index: int) -> Dict:
        cfg = self.cfg
        rng = random.Random((self.seed << 32) ^ index)

        if self.random_sample:
            infos = self.get_samples(index, "random", rng)
        elif self.vis_data:
            infos = self.get_samples(index, self.vis_data, rng)
        else:
            # nested fresh draws, faithfully (reference music.py:288-293)
            if rng.random() < cfg.rate_dc:
                infos = self.get_samples(index, "dc", rng)
            elif rng.random() < cfg.rate_dc + cfg.rate_sc:
                infos = self.get_samples(index, "sc", rng)
            elif rng.random() < cfg.rate_dc + cfg.rate_sc + cfg.rate_sv:
                infos = self.get_samples(index, "sv", rng)
            else:
                infos = self.get_samples(index, "dc", rng)

        audios, mixture, center_times = self.get_audios(infos, rng)
        out = {"audios": np.asarray(audios, np.float32),      # [N, L]
               "audio_mix": mixture.astype(np.float32)}       # [L]
        if cfg.load_clips:
            # [N, T, H, W, 3] and [N, clip_len, H, W, 3], both uint8
            out["frames"], out["clips"] = self.get_frames_clips(
                infos, center_times, rng)
        else:
            out["frames"] = self.get_frames(infos, center_times, rng)
        out["id"], out["class"] = self.get_ids_labels(infos, index,
                                                      center_times)
        out["infos"] = infos
        return out
