"""Typed configuration for avsep_tpu_torch, and its command line.

The same flag names and defaults as the reference's ``arguments.py``
(reference ``arguments.py:6-169``), as a frozen dataclass.  This is the
port's own copy of ``avsep_tpu/config.py``: the port imports nothing of the
JAX package.  It leaves out the fields of features the port lacks (the
compute dtype, the Pallas switch, the device mesh, multi-host bring-up): on
a CUDA tensor the port always runs its kernels, on a CPU tensor their plain
versions, in float32 on one device.

:func:`parse_args` accepts every flag string of the JAX package, so the
repository's ``scripts/*.sh`` option strings parse unchanged.  A flag of a
feature the port lacks (``UNPORTED_FLAGS``), or ``--frame_decode native`` /
``fast``, raises at a value other than its default, naming the
``ROADMAP.md`` item it waits for: nothing is silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class Config:
    # ---- model (reference arguments.py:9-52) ----
    id: str = ""
    num_mix: int = 2
    arch_sound: str = "unet7"
    arch_frame: str = "resnet18dilated"
    arch_synthesizer: str = "linear"
    fusion_type: str = "con"
    weights_sound: str = ""
    weights_frame: str = ""
    weights_synthesizer: str = ""
    num_channels: int = 32
    num_frames: int = 1
    stride_frames: int = 1
    img_pool: str = "maxpool"
    img_activation: str = "sigmoid"
    sound_activation: str = "no"
    output_activation: str = "sigmoid"
    binary_mask: int = 1
    mask_thres: float = 0.5
    loss: str = "l1"
    weighted_loss: int = 0
    log_freq: int = 1
    vis_channels: int = 512
    # torch argparse quirk: --not_pool_vis stores False.  The frame encoder
    # is called with pool=not_pool_vis, so the default True pools to a
    # vector and False returns the spatial map that CoLoc attends over.
    not_pool_vis: bool = True

    # ---- data (reference arguments.py:55-73) ----
    num_gpus: int = 1
    batch_size_per_gpu: int = 32
    workers: int = 32
    num_val: int = -1
    num_vis: int = 40
    audLen: int = 65535
    audRate: int = 11025
    stft_frame: int = 1022
    stft_hop: int = 256

    # ---- video (reference arguments.py:76-83) ----
    imgSize: int = 224
    frameRate: float = 8.0
    load_clips: bool = False
    clip_len: int = 32

    # ---- misc (reference arguments.py:86-93) ----
    seed: int = 1234
    ckpt: str = "./ckpt"
    disp_iter: int = 20
    eval_epoch: int = 1

    # ---- train (reference arguments.py:100-135) ----
    mode: str = "train"
    list_train: Tuple[str, ...] = ("data/train.csv",)
    list_val: Tuple[str, ...] = ("data/val.csv",)
    av_list_train: Tuple[str, ...] = ("data/train_av.csv",)
    ao_list_train: Tuple[str, ...] = ("data/train_ao.csv",)
    num_epoch: int = 100
    num_iters: int = 120000
    eval_iter: int = 7500
    iter_per_av: int = 2
    lr_frame: float = 1e-4
    lr_sound: float = 1e-3
    lr_motion: float = 1e-4
    lr_synthesizer: float = 1e-3
    lr_steps: Tuple[int, ...] = (20000, 40000)
    start_av_first: bool = False
    num_fsteps: int = 40000
    beta1: float = 0.9
    weight_decay: float = 1e-4
    train_repeat: int = 100

    # ---- other (reference arguments.py:145-168) ----
    load_ckpt: str = ""
    use_spec: bool = True
    rate_dc: float = 1.0
    rate_sc: float = 0.05
    rate_sv: float = 0.0
    margin: float = 3.0
    max_silent: float = 0.67
    val_repeat: int = 12
    match_weight: float = 0.6
    one_frame: bool = False
    fix_vis: bool = False
    att_type: str = "cos"

    # ---- script-only / SoP++ flags the reference never declared ----
    duet_vis_rate: float = 0.0
    restart_from_latest: bool = False
    train_steps: Tuple[int, ...] = (20000, 40000)
    extra_size: int = 32

    # ---- additions beyond the reference ----
    # DFT backend of the STFT/iSTFT (ops/stft.py): "fft" (torch.fft),
    # "matmul" (one f32 GEMM against cos/sin matrices) or "matmul_fast"
    # (bf16-rounded operands, f32 accumulation).
    dft: str = "fft"
    # temperature dividing the CoLoc attention scores (models/fusion.py);
    # 1.0 is the reference's behaviour
    att_temp: float = 1.0
    demo_mode: str = "vis"
    # rematerialize the nets' forwards in the backward pass; not ported yet,
    # True raises in the train forwards (engine.REMAT_ITEM)
    remat: bool = False
    # host->device audio encoding: "f32" (bit-exact) or "int16" (+ one gain
    # per source, about half the audio bytes; data/wire.py)
    audio_wire: str = "f32"
    # host frame decode: "auto" and "pil" both decode with PIL here (the
    # JAX package's C++ decode gives the same pixels); "native" and "fast"
    # raise (FRAME_DECODE_ITEM)
    frame_decode: str = "auto"
    # torch.profiler trace of iterations [profile_start, profile_start +
    # profile_steps) of the train loop, written to profile_dir (off if "")
    profile_dir: str = ""
    profile_start: int = 10
    profile_steps: int = 5

    # -------------------------------------------------------------- helpers
    @property
    def batch_size(self) -> int:
        return self.num_gpus * self.batch_size_per_gpu

    @property
    def audSec(self) -> float:
        return 1.0 * self.audLen / self.audRate

    @property
    def HS(self) -> int:
        """STFT freq bins (reference dataset/base.py:40)."""
        return self.stft_frame // 2 + 1

    @property
    def WS(self) -> int:
        """STFT frames (reference dataset/base.py:41)."""
        return (self.audLen + 1) // self.stft_hop

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ROADMAP.md, where each feature the port lacks waits
DTYPE_ITEM = "ROADMAP.md Queue 2, item 2 (a bf16 or TF32 mode)"
MESH_ITEM = "ROADMAP.md Queue 1, 'parallel/' (torch.distributed DDP)"
FRAME_DECODE_ITEM = "ROADMAP.md Queue 1, 'data/native.py' (C++ decode)"
KERNEL_SWITCH_ITEM = ("ROADMAP.md, 'Flags that raise' (the port runs its "
                      "kernels on every CUDA tensor; nothing switches them)")

# flags of the JAX package that the port's Config has no field for: their
# default (the only value the port accepts) and the ROADMAP.md item
UNPORTED_FLAGS = {
    "dtype": ("float32", DTYPE_ITEM),
    "use_pallas": (False, KERNEL_SWITCH_ITEM),
    "data_axis": ("data", MESH_ITEM),
    "mesh_shape": ((), MESH_ITEM),
    "dist_coordinator": ("", MESH_ITEM),
    "dist_nprocs": (1, MESH_ITEM),
    "dist_procid": (0, MESH_ITEM),
    "dist_data": ("replicate", MESH_ITEM),
}
FRAME_DECODES = ("auto", "pil")


def check_frame_decode(frame_decode: str) -> None:
    """The port decodes frames with PIL: ``auto`` and ``pil`` do that;
    ``native`` and ``fast`` (the JAX package's C++ decode) raise."""
    if frame_decode not in FRAME_DECODES:
        raise NotImplementedError(
            f"--frame_decode {frame_decode} is not ported yet "
            f"({FRAME_DECODE_ITEM}); use auto or pil")


_STORE_TRUE = ("load_clips", "one_frame", "fix_vis", "start_av_first",
               "restart_from_latest")
# reference arguments.py:52 and :148: store_false with default True
_STORE_FALSE = ("not_pool_vis", "use_spec")


def _add_flag(p: argparse.ArgumentParser, name: str, default) -> None:
    flag = "--" + name
    if name in _STORE_FALSE:
        p.add_argument(flag, action="store_false", default=True)
    elif name in _STORE_TRUE:
        p.add_argument(flag, action="store_true", default=False)
    elif isinstance(default, tuple):
        elem = int if all(isinstance(x, int) for x in default) else str
        p.add_argument(flag, nargs="+", type=elem, default=list(default))
    elif isinstance(default, bool):
        p.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                       default=default)
    else:
        p.add_argument(flag, type=type(default), default=default)


def _build_parser() -> argparse.ArgumentParser:
    """An argparse parser accepting the reference's exact flag strings, and
    every flag of the JAX package."""
    p = argparse.ArgumentParser(description="avsep_tpu_torch")
    d = Config()
    for f in dataclasses.fields(Config):
        _add_flag(p, f.name, getattr(d, f.name))
    for name, (default, _) in UNPORTED_FLAGS.items():
        _add_flag(p, name, default)
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    """Parse reference-compatible CLI flags into a Config.  Raises
    ``NotImplementedError`` for a flag of a feature the port lacks, set to
    anything but its default."""
    kw = vars(_build_parser().parse_args(argv))
    for name, (default, item) in UNPORTED_FLAGS.items():
        value = kw.pop(name)
        if isinstance(default, tuple):
            value = tuple(value)
        if value != default:
            raise NotImplementedError(
                f"--{name} {value!r} is not ported (only {default!r}); see "
                f"{item}")
    check_frame_decode(kw["frame_decode"])
    for f in dataclasses.fields(Config):
        if isinstance(kw[f.name], list):
            kw[f.name] = tuple(kw[f.name])
    cfg = Config(**kw)
    print("Input arguments:")  # reference arguments.py:138-141
    for k, v in sorted(dataclasses.asdict(cfg).items()):
        print("{:16} {}".format(k, v))
    return cfg
