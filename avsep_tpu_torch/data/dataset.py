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

Frames and clips are decoded as ``cfg.frame_decode`` says, with the JAX
package's rules (``avsep_tpu/data/dataset.py:183-220``): ``pil``; ``auto``,
the C++ libjpeg decode (``data/native.py``) when its library loads and
decodes as PIL does on this host, else PIL; ``native``, the C++ decode or
raise; ``fast``, the C++ decode at a reduced DCT scale (approximate pixels)
or raise.  The C++ route draws the same random numbers as the PIL route
and gives the same pixels; a frame it cannot decode after the draws sends
that clip through PIL with the same parameters.  The route is settled when
the dataset is made (``frame_route``, from :meth:`decode_route`), so the
library is built before any loader worker starts.

No STFT happens here: raw waveforms and uint8 frames go to the device.
This module imports numpy and PIL, never torch, so loader worker processes
stay light.
"""

from __future__ import annotations

import csv
import os
import random
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from avsep_tpu_torch.config import Config, check_frame_decode
from avsep_tpu_torch.data import native
from avsep_tpu_torch.data.audio_io import load_audio_crop
from avsep_tpu_torch.data.video_transforms import (
    center_crop, center_crop_box, random_hflip, random_resized_crop,
    resize_shorter, resize_shorter_dims, rrc_params, to_uint8_array,
    train_transform, val_transform)

MUSIC11_CLASSES = [
    "accordion", "acoustic_guitar", "cello", "clarinet", "erhu", "flute",
    "saxophone", "trumpet", "tuba", "violin", "xylophone"]


# The reference ships a compiled-only MUSICAODataset (dataset/__pycache__/
# music_ao.cpython-37.pyc, imported by SoP++/main.py:30) whose method surface
# matches MUSICMixDataset (SURVEY.md section 2.1); the audio-only loaders
# here use the same class.
def MusicAODataset(*args, **kwargs):
    return MusicMixDataset(*args, **kwargs)


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
        self.frame_route = self.decode_route()
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

    # ------------------------------------------------------ frame decode

    def decode_route(self) -> str:
        """``"native"`` or ``"fast"`` when frames go through the C++ decode,
        ``"pil"`` otherwise; raises ``RuntimeError`` when ``frame_decode``
        is ``native`` or ``fast`` and the frames library is unavailable
        (``native.load_error("frames")`` says why)."""
        fd = self.cfg.frame_decode
        if fd == "pil":
            return "pil"
        if fd == "auto":
            # prints why when it fails
            return "native" if native.frames_selfcheck_ok() else "pil"
        if not native.frames_available():
            raise RuntimeError(
                f"--frame_decode {fd}: the C++ frames library is "
                f"unavailable ({native.load_error('frames')})")
        return fd

    @staticmethod
    def _pil_apply(paths, resize, crop, final, flip) -> np.ndarray:
        """Already-drawn transform parameters applied with PIL: the route
        for a clip the C++ decode failed on after its draws."""
        imgs = [Image.open(p).convert("RGB") for p in paths]
        if resize:
            imgs = [im.resize(resize, Image.BICUBIC) for im in imgs]
        if crop:
            left, top, cw, ch = crop
            imgs = [im.crop((left, top, left + cw, top + ch)) for im in imgs]
        if final:
            imgs = [im.resize(final, Image.BICUBIC) for im in imgs]
        if flip:
            imgs = [im.transpose(Image.FLIP_LEFT_RIGHT) for im in imgs]
        return to_uint8_array(imgs)

    def _native_batch(self, paths, size, resize, crop, final, flip, route):
        arr = native.frame_pipeline_batch(paths, size, size, resize=resize,
                                          crop=crop, final=final, hflip=flip,
                                          fast=route == "fast")
        if arr is None:     # a decode failed after the draws
            arr = self._pil_apply(paths, resize, crop, final, flip)
        return arr

    def _native_center_frames(self, paths, rng: random.Random, route: str):
        """The C++ route of ``train_transform`` / ``val_transform``: the
        same geometry and the same draws, in the same order; None (no draw
        taken) when the first frame is not a readable JPEG."""
        dims = native.jpeg_probe_dims(paths[0])
        if dims is None:
            return None
        S = self.cfg.imgSize
        if self.split == "train":
            rw, rh = resize_shorter_dims(*dims, int(S * 1.1))
            if (rw, rh) == (S, S):   # random_crop returns without a draw
                crop = None
            else:
                crop = (rng.randint(0, max(rw - S, 0)),
                        rng.randint(0, max(rh - S, 0)), S, S)
            flip = rng.random() < 0.5
        else:
            rw, rh = resize_shorter_dims(*dims, S)
            crop = (*center_crop_box(rw, rh, S), S, S)
            flip = False
        return self._native_batch(paths, S, (rw, rh), crop, None, flip,
                                  route)

    def _native_clip_frames(self, paths, rng: random.Random, route: str):
        """The C++ route of the clip transform chain: Resize(-1, 256), then
        train: RandomResizedCrop -> imgSize and a flip; val:
        CenterCrop(min(imgSize, 224)); the same draws as the PIL route."""
        dims = native.jpeg_probe_dims(paths[0])
        if dims is None:
            return None
        rw, rh = resize_shorter_dims(*dims, 256)
        final = None
        if self.split == "train":
            S = self.cfg.imgSize
            crop = rrc_params(rw, rh, rng)
            if crop is None:         # the 10-attempt fallback
                m = min(rw, rh)
                crop = (*center_crop_box(rw, rh, m), m, m)
            final = (S, S)
            flip = rng.random() < 0.5
        else:
            S = min(self.cfg.imgSize, 224)
            crop = (*center_crop_box(rw, rh, S), S, S)
            flip = False
        return self._native_batch(paths, S, (rw, rh), crop, final, flip,
                                  route)

    def get_frames(self, infos, center_times, rng: random.Random):
        cfg = self.cfg
        route = self.frame_route
        out = []
        for info, t in zip(infos, center_times):
            paths = self.frame_paths(info, t, rng)
            arr = None
            if route != "pil":
                arr = self._native_center_frames(paths, rng, route)
            if arr is None:
                imgs = [Image.open(p).convert("RGB") for p in paths]
                if self.split == "train":
                    arr = train_transform(imgs, cfg.imgSize, rng)
                else:
                    arr = val_transform(imgs, cfg.imgSize)
            out.append(arr)
        return np.stack(out)

    def get_frames_clips(self, infos, center_times, rng: random.Random):
        """Clip pipeline (reference ``get_frames_mmcv``, dataset/
        music.py:202-229): ``clip_len`` frames uniform over ``audSec``
        seconds around the center time, plus the strided center frames;
        train: Resize(-1, 256) -> RandomResizedCrop -> imgSize, flip; val:
        Resize(-1, 256) -> CenterCrop(min(imgSize, 224))."""
        cfg = self.cfg
        route = self.frame_route
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
            paths = [os.path.join(fpath, "{:06d}.jpg".format(i))
                     for i in idxs + cidx]
            arr = None
            if route != "pil":
                arr = self._native_clip_frames(paths, rng, route)
            if arr is None:
                all_imgs = resize_shorter(
                    [Image.open(p).convert("RGB") for p in paths], 256)
                if self.split == "train":
                    all_imgs = random_resized_crop(all_imgs, cfg.imgSize,
                                                   rng)
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
