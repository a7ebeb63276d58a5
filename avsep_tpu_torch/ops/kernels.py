"""The STFT head and iSTFT tail as hand-written CUDA kernels for Hopper.

Port of ``avsep_tpu/ops/pallas_kernels.py``:

* :func:`frame_window` (TPU kernel ``pallas_kernels.py:138``): reflect-padded
  audio ``[B, L']`` -> windowed frames ``[B, T, n_fft]``;
  source ``csrc/frame_window.cu``.
* :func:`overlap_add_normalize` (TPU kernel ``pallas_kernels.py:71``):
  windowed inverse-DFT frames ``[B, T, n_fft]`` -> overlap-added samples
  ``[B, out_len]`` divided by the summed squared window, optionally clipped
  to [-1, 1]; source ``csrc/overlap_add.cu``.

Each wrapper checks its inputs and then dispatches on the tensor's device
alone: a CPU tensor goes to the plain PyTorch version in this module, a CUDA
tensor launches the kernel on the current stream or raises.  Each wrapper
counts its kernel launches in a plain integer attribute
(``frame_window.launches``, ``overlap_add_normalize.launches``) so that a run
can show that the main path went through the kernels.

The sources are compiled at first use by ``nvcc`` (for ``sm_90a``) into one
shared library each, with a plain C interface, under ``build/avsep_tpu_torch/``
beside the package, keyed by a hash of the source and the flags, and loaded
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict

import numpy as np
import torch

from avsep_tpu_torch.ops.stft import (
    _window_tensor, frame_signal, hann_periodic, overlap_add)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "avsep_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# kernel name -> (source file, C function name)
SOURCES = {
    "frame_window": ("frame_window.cu", "avsep_frame_window"),
    "overlap_add_normalize": ("overlap_add.cu", "avsep_overlap_add_normalize"),
}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# kernel name -> the C function's argument types, in order: c_void_p for
# every pointer and the stream (a shorter type would cut a pointer to 32
# bits), c_int for every int
ARGTYPES = {
    "frame_window": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    "overlap_add_normalize": [_PTR] * 3 + [_INT] * 6 + [_PTR],
}
# dynamic shared memory of one block: what a launch gets without opting in,
# and the most an H100 block can opt in to
_SMEM_DEFAULT = 48 * 1024
_SMEM_OPTIN_MAX = 232448
_FRAMES_PER_BLOCK = 16
_INT32_MAX = 2 ** 31 - 1
_MAX_GRID_Y = 65535


# ------------------------------------------------------------------ build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> str:
    """Where the shared library of kernel ``name`` is built."""
    src = os.path.join(CSRC_DIR, SOURCES[name][0])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(SOURCES[name][0])[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def build() -> Dict[str, str]:
    """Compile every kernel library that is not built yet: one ``nvcc`` per
    source, all started together.  Returns kernel name -> library path;
    raises with the compiler's output if a compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    procs = {}
    try:
        for name, so in paths.items():
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            src = os.path.join(CSRC_DIR, SOURCES[name][0])
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {SOURCES[name][0]}:\n{log}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


@functools.lru_cache(maxsize=None)
def _library(name: str):
    """The loaded C function of kernel ``name`` (built on first use)."""
    lib = ctypes.CDLL(build()[name])
    fn = getattr(lib, SOURCES[name][1])
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


# --------------------------------------------------------------- helpers


def _check_f32(x: torch.Tensor, name: str, ndim: int) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must lie on the CPU or a CUDA device, "
                         f"got {x.device}")
    if x.numel() > _INT32_MAX:
        raise ValueError(f"{name} has {x.numel()} elements; the kernels "
                         "take at most 2**31 - 1")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")


# ---------------------------------------------------------------- framing


def frame_window_plan(n_fft: int, hop: int):
    """``(frames_per_block, smem_bytes)`` of the frame_window kernel: a block
    stages the window (padded to a multiple of 4 floats) and the input span
    of its frames in shared memory.  Frames per block start at 16 and are
    halved while the block would need more than the 48 KiB a launch gets
    without opting in; a single frame that still needs more opts in, up to
    the H100's 227 KiB.  Raises ValueError for a shape that needs more."""
    def smem(f):
        return 4 * (-(-n_fft // 4) * 4 + (f - 1) * hop + n_fft)

    f = _FRAMES_PER_BLOCK
    while f > 1 and smem(f) > _SMEM_DEFAULT:
        f //= 2
    if smem(f) > _SMEM_OPTIN_MAX:
        raise ValueError(f"frame_window kernel: n_fft {n_fft} needs "
                         f"{smem(f)} bytes of shared memory per block, more "
                         f"than the {_SMEM_OPTIN_MAX} a block can have")
    return f, smem(f)


def frame_window_plain(padded: torch.Tensor, n_frames: int, n_fft: int,
                       hop: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`frame_window`: the hop-block framing
    of ``ops/stft.py`` times the periodic Hann window."""
    win = _window_tensor(n_fft, padded.device)
    return frame_signal(padded, n_frames, n_fft, hop) * win


def frame_window(padded: torch.Tensor, n_frames: int, n_fft: int,
                 hop: int) -> torch.Tensor:
    """``padded [B, L']`` float32 -> windowed frames ``[B, T, n_fft]``.

    ``out[b, t, j] = padded[b, t*hop + j] * hann(n_fft)[j]``, samples past
    the end of a row reading as zero.  CPU tensor: plain version.  CUDA
    tensor: the kernel of ``csrc/frame_window.cu``.

    The kernel has no backward, as the TPU kernel has none: its input is
    data.  A ``padded`` that requires grad while grad mode is on raises
    (on every device, so that the CPU's differentiable plain version does
    not hide what the card would do) instead of returning an output cut
    off from the graph.
    """
    _check_f32(padded, "padded", 2)
    if padded.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("frame_window has no backward: its input must "
                           "not require grad (detach it, or call under "
                           "torch.no_grad())")
    if n_frames < 1 or n_fft < 1 or hop < 1:
        raise ValueError(f"need n_frames, n_fft, hop >= 1; got {n_frames}, "
                         f"{n_fft}, {hop}")
    if padded.device.type == "cpu":
        return frame_window_plain(padded, n_frames, n_fft, hop)
    frames_per_block, smem = frame_window_plan(n_fft, hop)
    B, Lp = padded.shape
    out = torch.empty((B, n_frames, n_fft), dtype=torch.float32,
                      device=padded.device)
    if out.numel() > _INT32_MAX:
        raise ValueError("frame_window output exceeds 2**31 - 1 elements")
    if out.numel() == 0:
        return out
    win = _window_tensor(n_fft, padded.device)
    _launch("frame_window", padded.device, padded.data_ptr(), win.data_ptr(),
            out.data_ptr(), B, Lp, n_frames, n_fft, hop, frames_per_block,
            smem)
    frame_window.launches += 1
    return out


frame_window.launches = 0


# ------------------------------------------------------------- overlap-add


def overlap_add_normalize_plain(frames: torch.Tensor, hop: int, out_len: int,
                                denom: torch.Tensor, *,
                                clip: bool = True) -> torch.Tensor:
    """Plain PyTorch version of :func:`overlap_add_normalize`: K shifted
    adds in ascending m, divided by ``denom``, optionally clipped."""
    out = overlap_add(frames, hop, out_len) / denom[:out_len]
    return torch.clamp(out, -1.0, 1.0) if clip else out


def overlap_add_normalize(frames: torch.Tensor, hop: int, out_len: int,
                          denom, *, clip: bool = True) -> torch.Tensor:
    """``frames [B, T, n_fft]`` float32 (windowed inverse-DFT frames) ->
    ``[B, out_len]``: overlap-added, divided by ``denom`` (the summed squared
    window, a numpy array or tensor of at least ``out_len`` values),
    optionally clipped to [-1, 1].

    CPU tensor: plain version.  CUDA tensor: the kernel of
    ``csrc/overlap_add.cu``.
    """
    _check_f32(frames, "frames", 3)
    B, T, n_fft = frames.shape
    if hop < 1 or out_len < 0:
        raise ValueError(f"need hop >= 1 and out_len >= 0; got {hop}, "
                         f"{out_len}")
    if isinstance(denom, np.ndarray):
        denom = torch.from_numpy(np.array(denom, np.float32))
    denom = denom.to(device=frames.device, dtype=torch.float32)
    if denom.dim() != 1 or denom.shape[0] < out_len:
        raise ValueError(f"denom must be 1-D with >= {out_len} values, got "
                         f"{tuple(denom.shape)}")
    if frames.device.type == "cpu":
        return overlap_add_normalize_plain(frames, hop, out_len, denom,
                                           clip=clip)
    if B > _MAX_GRID_Y:
        raise ValueError(f"overlap_add_normalize kernel takes at most "
                         f"{_MAX_GRID_Y} rows, got {B}")
    denom = denom.contiguous()
    out = torch.empty((B, out_len), dtype=torch.float32, device=frames.device)
    if out.numel() > _INT32_MAX:
        raise ValueError("overlap_add_normalize output exceeds 2**31 - 1 "
                         "elements")
    if out.numel() == 0:
        return out
    _launch("overlap_add_normalize", frames.device, frames.data_ptr(),
            denom.data_ptr(), out.data_ptr(), B, T, n_fft, hop, out_len,
            int(clip))
    overlap_add_normalize.launches += 1
    return out


overlap_add_normalize.launches = 0
