"""The STFT head and iSTFT tail as hand-written CUDA kernels for Hopper.

Port of ``avsep_tpu/ops/pallas_kernels.py``:

* :func:`frame_window` (TPU kernel ``pallas_kernels.py:138``): reflect-padded
  audio ``[B, L']`` -> windowed frames ``[B, T, n_fft]``;
  source ``csrc/frame_window.cu``.
* :func:`overlap_add_normalize` (TPU kernel ``pallas_kernels.py:71``):
  windowed inverse-DFT frames ``[B, T, n_fft]`` -> overlap-added samples
  ``[B, out_len]`` divided by the summed squared window, optionally clipped
  to [-1, 1]; source ``csrc/overlap_add.cu``.
* :func:`motion_stem` and :func:`motion_stem_wgrad` (no TPU kernel: the JAX
  package leaves the convolution to XLA): the motion net's 5x7x7 stem in
  bfloat16, uint8 clips normalized in its load, and its weight gradient;
  source ``csrc/motion_stem.cu``.  They are the ops ``avsep::motion_stem``
  and ``avsep::motion_stem_wgrad``, the first with the second as its
  backward, so that a profiler links their kernels to a named op and to
  the autograd backward function of its sequence number.
* :func:`motion_bn` and :func:`motion_bn_backward` (no TPU kernel: the JAX
  package leaves BatchNorm to XLA): the motion net's train-mode BatchNorm
  in bfloat16 on channels-last clips' activations, with the ReLU after it
  and a bottleneck's residual add; source ``csrc/motion_bn.cu``.  The ops
  ``avsep::motion_bn`` and ``avsep::motion_bn_backward``, as the stem's.
* :func:`motion_conv_t3` and :func:`motion_conv_t3_wgrad` (no TPU kernel:
  the JAX package leaves the convolution to XLA): the motion net's 3x1x1
  temporal convolutions in bfloat16 on channels-last-3d activations, whose
  input gradient is the same op with the taps transposed and reversed,
  and their weight gradient; source ``csrc/motion_conv_t3.cu``.  The ops
  ``avsep::motion_conv_t3`` and ``avsep::motion_conv_t3_wgrad``.

Each wrapper checks its inputs and then dispatches on the tensor's device
alone: a CPU tensor goes to the plain PyTorch version in this module, a CUDA
tensor launches the kernel on the current stream or raises.  Each wrapper
counts its kernel launches in a plain integer attribute
(``frame_window.launches``, ``overlap_add_normalize.launches``,
``motion_stem.launches``, ``motion_stem_wgrad.launches``,
``motion_bn.launches``, ``motion_bn_backward.launches``,
``motion_conv_t3.launches``, ``motion_conv_t3_wgrad.launches``, one a call;
:func:`launch_counts` reads them all) so that a run can show that the main
path went through the kernels.

The sources are compiled at first use by ``nvcc`` (for ``sm_90a``) into one
shared library per source, with a plain C interface, under
``build/avsep_tpu_torch/`` beside the package, keyed by a hash of the source
and the flags, and loaded with ``ctypes``.
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
import torch.nn.functional as F

from avsep_tpu_torch.models.layers import batch_norm_train
from avsep_tpu_torch.ops.imagenet import (
    IMAGENET_MEAN, IMAGENET_STD, UINT8_SCALE, normalize_frames)
from avsep_tpu_torch.ops.stft import (
    _window_tensor, frame_signal, hann_periodic, overlap_add)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "avsep_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# kernel name -> (source file, C function name); one library per source
SOURCES = {
    "frame_window": ("frame_window.cu", "avsep_frame_window"),
    "overlap_add_normalize": ("overlap_add.cu", "avsep_overlap_add_normalize"),
    "motion_stem": ("motion_stem.cu", "avsep_motion_stem"),
    "motion_stem_wgrad": ("motion_stem.cu", "avsep_motion_stem_wgrad"),
    "motion_bn": ("motion_bn.cu", "avsep_motion_bn"),
    "motion_bn_backward": ("motion_bn.cu", "avsep_motion_bn_backward"),
    "motion_conv_t3": ("motion_conv_t3.cu", "avsep_motion_conv_t3"),
    "motion_conv_t3_wgrad": ("motion_conv_t3.cu",
                             "avsep_motion_conv_t3_wgrad"),
}
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_I64, _F32 = ctypes.c_longlong, ctypes.c_float
# the stem's clip arguments after its pointers: B, T, H, W, the clips' five
# strides, the scale, three means and three stds
_CLIP_DIMS = [_INT] * 4 + [_I64] * 5 + [_F32] * 7
# kernel name -> the C function's argument types, in order: c_void_p for
# every pointer and the stream (a shorter type would cut a pointer to 32
# bits), c_int for every int, c_longlong for a long long, c_float for a
# float
ARGTYPES = {
    "frame_window": [_PTR] * 3 + [_INT] * 7 + [_PTR],
    "overlap_add_normalize": [_PTR] * 3 + [_INT] * 6 + [_PTR],
    "motion_stem": [_PTR, _INT, _PTR, _PTR] + _CLIP_DIMS + [_PTR],
    "motion_stem_wgrad": [_PTR, _INT, _PTR, _PTR, _PTR] + _CLIP_DIMS
    + [_PTR],
    "motion_bn": [_PTR] * 8 + [_I64, _INT, _INT, _INT, _F32, _INT, _PTR],
    "motion_bn_backward": [_PTR] * 12
    + [_I64, _INT, _INT, _INT, _F32, _INT, _PTR],
    "motion_conv_t3": [_PTR] * 3 + [_INT] * 11 + [_PTR],
    "motion_conv_t3_wgrad": [_PTR] * 4 + [_INT] * 9 + [_PTR],
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
            if os.path.exists(so) or so in procs:
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            src = os.path.join(CSRC_DIR, SOURCES[name][0])
            procs[so] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, src)
        failed = []
        for so, (proc, tmp, src) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"nvcc failed on {os.path.basename(src)}:\n"
                              f"{log}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, *_ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return paths


def launch_counts() -> Dict[str, int]:
    """Each kernel's launch counter, by the kernel's name: every kernel of
    :data:`SOURCES`."""
    return {name: globals()[name].launches for name in SOURCES}


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


# ------------------------------------------------------------ motion stem

# ResNet3dFastOnly.conv1 (models/motion.py): weight [8, 3, 5, 7, 7]
STEM_WEIGHT = (8, 3, 5, 7, 7)
STEM_STRIDE = (1, 2, 2)
STEM_PADDING = (2, 3, 3)
# a block's output tile in rows and columns (csrc/motion_stem.cu): the
# weight gradient's scratch holds one column of 5880 sums per block
_STEM_TILE = 16


def _stem_input(clips: torch.Tensor) -> torch.Tensor:
    """The stem's input as the net computed it before the kernel: the clips
    normalized (``imagenet.normalize_frames``), permuted to ``[B, 3, T, H,
    W]`` and cast to bfloat16 (``layers.Conv3d.forward``)."""
    return normalize_frames(clips).permute(0, 4, 1, 2, 3).to(
        torch.bfloat16)


def motion_stem_plain(clips: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`motion_stem`: the bfloat16
    ``Conv3d`` on the normalized clips, as the net ran it before."""
    return F.conv3d(_stem_input(clips), weight.to(torch.bfloat16), None,
                    STEM_STRIDE, STEM_PADDING)


def motion_stem_wgrad_plain(clips: torch.Tensor, grad: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`motion_stem_wgrad`: the weight
    gradient autograd takes through the bfloat16 ``Conv3d`` (the input
    needs none) and the cast's backward to float32."""
    _, gw, _ = torch.ops.aten.convolution_backward(
        grad, _stem_input(clips), weight.to(torch.bfloat16), None,
        STEM_STRIDE, STEM_PADDING, (1, 1, 1), False, (0, 0, 0), 1,
        (False, True, False))
    return gw.to(torch.float32)


def _stem_shape(clips: torch.Tensor):
    B, T, H, W, _ = clips.shape
    return B, T, (H - 1) // 2 + 1, (W - 1) // 2 + 1


def _stem_clip_args(clips: torch.Tensor):
    """The C functions' clip arguments: pointer, uint8 flag, B, T, H, W, the
    element strides, and the normalization as ``imagenet.normalize_frames``
    holds it in float32."""
    B, T, H, W, _ = clips.shape
    scale = float(np.float32(UINT8_SCALE))
    mean = [float(v) for v in np.float32(IMAGENET_MEAN)]
    std = [float(v) for v in np.float32(IMAGENET_STD)]
    return ([clips.data_ptr(), int(clips.dtype == torch.uint8)],
            [B, T, H, W, *clips.stride(), scale, *mean, *std])


def _motion_stem_cuda(clips: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    B, T, OH, OW = _stem_shape(clips)
    out = torch.empty((B, T, OH, OW, STEM_WEIGHT[0]), dtype=torch.bfloat16,
                      device=clips.device)
    if out.numel():
        head, dims = _stem_clip_args(clips)
        _launch("motion_stem", clips.device, *head,
                weight.contiguous().data_ptr(), out.data_ptr(), *dims)
        motion_stem.launches += 1
    return out.permute(0, 4, 1, 2, 3)


def _motion_stem_wgrad_cuda(clips: torch.Tensor, grad: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    B, T, OH, OW = _stem_shape(clips)
    g = grad.permute(0, 2, 3, 4, 1).to(torch.bfloat16).contiguous()
    out = torch.empty(STEM_WEIGHT, dtype=torch.float32, device=clips.device)
    blocks = B * -(-OH // _STEM_TILE) * -(-OW // _STEM_TILE)
    if blocks == 0:
        return out.zero_()
    partial = torch.empty((out.numel(), blocks), dtype=torch.float32,
                          device=clips.device)
    head, dims = _stem_clip_args(clips)
    _launch("motion_stem_wgrad", clips.device, *head, g.data_ptr(),
            partial.data_ptr(), out.data_ptr(), *dims)
    motion_stem_wgrad.launches += 1
    return out


def _stem_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0], inputs[1])


def _stem_backward(ctx, grad: torch.Tensor):
    clips, weight = ctx.saved_tensors
    if not ctx.needs_input_grad[1]:
        return None, None
    return None, torch.ops.avsep.motion_stem_wgrad(clips, grad, weight)


# The two ops, each with the plain version on the CPU and the kernel on a
# card, the second the first's backward.  Defined through a Library rather
# than ``torch.library.custom_op``, whose first call imports torch._dynamo
# (seconds of set-up) to wrap the implementation.
_LIB = torch.library.Library("avsep", "DEF")
_LIB.define("motion_stem(Tensor clips, Tensor weight) -> Tensor")
_LIB.define("motion_stem_wgrad(Tensor clips, Tensor grad, Tensor weight) "
            "-> Tensor")
_LIB.impl("motion_stem", motion_stem_plain, "CPU")
_LIB.impl("motion_stem", _motion_stem_cuda, "CUDA")
_LIB.impl("motion_stem_wgrad", motion_stem_wgrad_plain, "CPU")
_LIB.impl("motion_stem_wgrad", _motion_stem_wgrad_cuda, "CUDA")
torch.library.register_autograd("avsep::motion_stem", _stem_backward,
                                setup_context=_stem_setup, lib=_LIB)


def _check_stem(clips: torch.Tensor, weight: torch.Tensor) -> None:
    if not isinstance(clips, torch.Tensor) or \
            clips.dtype not in (torch.uint8, torch.float32):
        raise TypeError("clips must be a uint8 or float32 tensor, got "
                        f"{getattr(clips, 'dtype', type(clips))}")
    if clips.dim() != 5 or clips.shape[-1] != 3:
        raise ValueError(f"clips must be [B, T, H, W, 3], got "
                         f"{tuple(clips.shape)}")
    if tuple(weight.shape) != STEM_WEIGHT or weight.dtype != torch.float32:
        raise ValueError(f"weight must be float32 {STEM_WEIGHT}, got "
                         f"{weight.dtype} {tuple(weight.shape)}")
    if clips.device != weight.device or \
            clips.device.type not in ("cpu", "cuda"):
        raise ValueError(f"clips ({clips.device}) and weight "
                         f"({weight.device}) must lie on one CPU or CUDA "
                         "device")
    if clips.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("motion_stem gives no gradient to its clips: "
                           "they must not require grad")


def motion_stem(clips: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The motion net's stem in bfloat16: clips ``[B, T, H, W, 3]`` (uint8,
    normalized here as ``imagenet.normalize_frames`` does, or float32 already
    normalized; any strides) and the float32 weight ``[8, 3, 5, 7, 7]`` ->
    ``[B, 8, T, ceil(H / 2), ceil(W / 2)]`` bfloat16, a channels-last view.

    The convolution at stride (1, 2, 2) and padding (2, 3, 3), input and
    weight rounded to bfloat16, as ``layers.Conv3d`` at compute dtype
    bfloat16 computes it.  CPU tensor: plain version.  CUDA tensor: the
    kernels of ``csrc/motion_stem.cu``; the weight gradient is
    :func:`motion_stem_wgrad`.  The clips get no gradient: clips that
    require grad while grad mode is on raise, on every device."""
    _check_stem(clips, weight)
    return torch.ops.avsep.motion_stem(clips, weight)


motion_stem.launches = 0


def motion_stem_wgrad(clips: torch.Tensor, grad: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The float32 gradient of :func:`motion_stem`'s weight given the
    output's gradient ``grad`` ``[B, 8, T, OH, OW]``: float32 sums over
    every output position, rounded to bfloat16 and back (the cast's
    backward).  On a card the sums are taken in a fixed order, so two calls
    give the same bits.  CPU tensor: plain version."""
    _check_stem(clips, weight)
    return torch.ops.avsep.motion_stem_wgrad(clips, grad, weight)


motion_stem_wgrad.launches = 0


# ---------------------------------------------------- motion net BatchNorm

# csrc/motion_bn.cu: threads a block; the most blocks a shape launches
# (two waves of the H100's 132 SMs at four resident blocks each; the
# combine takes up to 5 x 256) and the fewest where a thread reads 4 rows
_BN_THREADS = 256
_BN_BLOCKS = 1056
_BN_MIN_BLOCKS = 264
_BN_ROWS_PER_THREAD = 4
_BN_MAX_CHANNELS = 8 * _BN_THREADS


def motion_bn_fits(channels: int) -> bool:
    """Whether the kernels take a BatchNorm of ``channels``: whole 16-byte
    groups of 8 bfloat16 channels, at most :data:`_BN_MAX_CHANNELS` (a
    thread a group, a row read by at most one block of threads)."""
    return channels % 8 == 0 and 0 < channels <= _BN_MAX_CHANNELS


def motion_bn_plan(rows: int, channels: int):
    """``(rows_per_block, blocks)`` of the motion_bn kernels: a block
    reads ``256 // (channels // 8)`` rows an iteration (a thread a 16-byte
    group of 8 channels) and takes as many iterations as keep the blocks
    at most :data:`_BN_BLOCKS`, and at least 4 where that leaves
    :data:`_BN_MIN_BLOCKS` blocks (fewer, longer blocks spend less on
    their trees and on the combine)."""
    per_iter = _BN_THREADS // (channels // 8)
    iters = max(1, -(-rows // (per_iter * _BN_BLOCKS)),
                min(_BN_ROWS_PER_THREAD, rows // (per_iter * _BN_MIN_BLOCKS)))
    per_block = per_iter * iters
    return per_block, -(-rows // per_block)


def motion_bn_plain(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float, relu: bool,
                    residual=None):
    """Plain PyTorch version of :func:`motion_bn`: ``layers.BatchNorm``'s
    train-mode normalization on one rank (``layers.batch_norm_train``),
    then the residual add and ``torch.relu``, as the motion net ran them
    before the kernels."""
    y, mean, var = batch_norm_train(x, weight, bias, eps)
    y = y.to(x.dtype)
    if residual is not None:
        y = y + residual
    return (torch.relu(y) if relu else y), mean, var


def motion_bn_backward_plain(grad, x, weight, bias, mean, var, eps, relu,
                             residual=None):
    """Plain PyTorch version of :func:`motion_bn_backward`: autograd
    through :func:`motion_bn_plain`, recomputed (``mean`` and ``var`` are
    its own, so they are not read).  ``(dx, dweight, dbias, dresidual)``,
    ``dresidual`` empty without a residual."""
    leaves = [t.detach().requires_grad_() for t in (x, weight, bias)]
    res = None if residual is None else \
        residual.detach().requires_grad_()
    with torch.enable_grad():
        y, _, _ = motion_bn_plain(*leaves, eps, relu, res)
        grads = torch.autograd.grad(
            y, leaves + ([] if res is None else [res]), grad)
    if res is None:
        grads += (x.new_empty(0),)
    return tuple(grads)


def _bn_rows(x: torch.Tensor):
    return x.numel() // x.shape[1], x.shape[1]


def _check_bn_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"motion_bn: {name} must be channels-last-3d "
                         f"(dense NDHWC), got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"motion_bn: {name} must be 16-byte aligned")


def _motion_bn_cuda(x, weight, bias, eps, relu, residual=None):
    rows, C = _bn_rows(x)
    for name, t in (("x", x), ("residual", residual)):
        if t is not None:
            _check_bn_cuda(name, t)
    if not motion_bn_fits(C):
        raise ValueError(f"motion_bn kernel takes a multiple of 8 channels "
                         f"up to {_BN_MAX_CHANNELS}, got {C}")
    if x.numel() > _INT32_MAX:
        raise ValueError(f"motion_bn kernel takes at most 2**31 - 1 "
                         f"elements, got {x.numel()}")
    per_block, blocks = motion_bn_plan(rows, C)
    y = torch.empty_like(x)
    mean = torch.empty(C, dtype=torch.float32, device=x.device)
    var = torch.empty_like(mean)
    partial = torch.empty(2 * C * blocks, dtype=torch.float32,
                          device=x.device)
    _launch("motion_bn", x.device, x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
            y.data_ptr(), mean.data_ptr(), var.data_ptr(), partial.data_ptr(),
            rows, C, per_block, blocks, eps, int(relu))
    motion_bn.launches += 1
    return y, mean, var


def _motion_bn_backward_cuda(grad, x, weight, bias, mean, var, eps, relu,
                             residual=None):
    rows, C = _bn_rows(x)
    if grad.dtype != x.dtype:
        raise TypeError(f"motion_bn_backward: grad must be {x.dtype}, got "
                        f"{grad.dtype}")
    # autograd hands over whatever layout the next layer's backward made
    grad = grad.contiguous(memory_format=torch.channels_last_3d)
    per_block, blocks = motion_bn_plan(rows, C)
    dx = torch.empty_like(x)
    dres = x.new_empty(0) if residual is None else torch.empty_like(x)
    dweight = torch.empty(C, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    partial = torch.empty(2 * C * blocks, dtype=torch.float32,
                          device=x.device)
    _launch("motion_bn_backward", x.device, grad.data_ptr(), x.data_ptr(),
            None if residual is None else residual.data_ptr(),
            weight.contiguous().data_ptr(), bias.contiguous().data_ptr(),
            mean.data_ptr(), var.data_ptr(), dx.data_ptr(),
            None if residual is None else dres.data_ptr(),
            dweight.data_ptr(), dbias.data_ptr(), partial.data_ptr(), rows,
            C, per_block, blocks, eps, int(relu))
    motion_bn_backward.launches += 1
    return dx, dweight, dbias, dres


def _bn_setup(ctx, inputs, output) -> None:
    x, weight, bias, eps, relu, residual = inputs
    _, mean, var = output
    ctx.mark_non_differentiable(mean, var)
    ctx.eps, ctx.relu = eps, relu
    ctx.save_for_backward(x, weight, bias, mean, var, residual)


def _bn_backward(ctx, grad, _grad_mean, _grad_var):
    x, weight, bias, mean, var, residual = ctx.saved_tensors
    dx, dweight, dbias, dres = torch.ops.avsep.motion_bn_backward(
        grad, x, weight, bias, mean, var, ctx.eps, ctx.relu, residual)
    need = ctx.needs_input_grad
    return (dx if need[0] else None, dweight if need[1] else None,
            dbias if need[2] else None, None, None,
            dres if need[5] else None)


_LIB.define("motion_bn(Tensor x, Tensor weight, Tensor bias, float eps, "
            "bool relu, Tensor? residual) -> (Tensor, Tensor, Tensor)")
_LIB.define("motion_bn_backward(Tensor grad, Tensor x, Tensor weight, "
            "Tensor bias, Tensor mean, Tensor var, float eps, bool relu, "
            "Tensor? residual) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.impl("motion_bn", motion_bn_plain, "CPU")
_LIB.impl("motion_bn", _motion_bn_cuda, "CUDA")
_LIB.impl("motion_bn_backward", motion_bn_backward_plain, "CPU")
_LIB.impl("motion_bn_backward", _motion_bn_backward_cuda, "CUDA")
torch.library.register_autograd("avsep::motion_bn", _bn_backward,
                                setup_context=_bn_setup, lib=_LIB)


def _check_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              residual) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.bfloat16 or \
            x.dim() != 5:
        raise TypeError("x must be a bfloat16 [B, C, T, H, W] tensor, got "
                        f"{getattr(x, 'dtype', type(x))} "
                        f"{tuple(getattr(x, 'shape', ()))}")
    C = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be float32 [{C}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    if residual is not None and (residual.dtype != x.dtype
                                 or residual.shape != x.shape):
        raise ValueError(f"residual must be {x.dtype} {tuple(x.shape)}, got "
                         f"{residual.dtype} {tuple(residual.shape)}")
    devices = {t.device for t in (x, weight, bias, residual)
               if t is not None}
    if len(devices) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"motion_bn's tensors must lie on one CPU or CUDA "
                         f"device, got {sorted(map(str, devices))}")
    if x.numel() // C < 2:
        raise ValueError("motion_bn needs more than one value per channel")


def motion_bn(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float, relu: bool, residual=None):
    """The motion net's train-mode BatchNorm on one rank, then the residual
    add and the ReLU: ``x`` ``[B, C, T, H, W]`` bfloat16, ``weight`` and
    ``bias`` float32 ``[C]``, ``residual`` None or bfloat16 like ``x`` ->
    ``(y, mean, biased_var)``, ``y`` bfloat16 like ``x`` and the batch
    statistics float32 ``[C]`` (no gradient flows through them; the
    running buffers are the caller's, ``layers.BatchNorm.update_running``).

    The statistics over every dimension but C in float32; ``y`` is
    ``bf16((x - mean) * weight * rsqrt(var + eps) + bias)``, then
    ``bf16(y + residual)``, then ``relu``, where ``layers.BatchNorm``,
    the add and ``torch.relu`` round.  CPU tensor: plain version, bit for
    bit those ops.  CUDA tensor: the kernels of ``csrc/motion_bn.cu``, which
    take ``x`` and ``residual`` channels-last-3d and C a multiple of 8, and
    raise on anything else; the backward is :func:`motion_bn_backward`."""
    _check_bn(x, weight, bias, residual)
    return torch.ops.avsep.motion_bn(x, weight, bias, float(eps), bool(relu),
                                     residual)


motion_bn.launches = 0


def motion_bn_backward(grad, x, weight, bias, mean, var, eps, relu,
                       residual=None):
    """The gradients of :func:`motion_bn` given ``y``'s gradient ``grad``
    and the forward's inputs and statistics: ``(dx, dweight, dbias,
    dresidual)`` (``dresidual`` empty without a residual).  On a card the
    per-channel sums are taken in a fixed order, so two calls give the
    same bits.  CPU tensor: plain version."""
    _check_bn(x, weight, bias, residual)
    return torch.ops.avsep.motion_bn_backward(
        grad, x, weight, bias, mean, var, float(eps), bool(relu), residual)


motion_bn_backward.launches = 0


# ------------------------------------------- motion net 3x1x1 convolution

# csrc/motion_conv_t3.cu: the (channels, outputs, warps across the
# outputs) the convolution is instantiated for, the fast pathway's conv1s
# and their input gradients, and the (channels, outputs) of the weight
# gradient's; the widest output the design serves (above it the conv is
# compute-bound: the slow pathway's 256 and 512); the shared memory a block
# may use where two share an SM (an SM's 228 KiB, 1 KiB reserved a block);
# the stages of a ring; the H100's SMs; the 16-byte chunks of a weight
# gradient's stage (32 KB)
_T3_CONV_LAYOUTS = frozenset({
    (8, 8, 1), (32, 8, 1), (32, 16, 1), (64, 16, 1), (64, 32, 1),
    (128, 32, 2), (128, 64, 2), (256, 64, 4),
    (8, 32, 1), (16, 32, 1), (16, 64, 2), (32, 64, 2), (32, 128, 4),
    (64, 128, 4), (64, 256, 8)})
_T3_WGRAD_PAIRS = frozenset({
    (8, 8), (32, 8), (32, 16), (64, 16), (64, 32), (128, 32), (128, 64),
    (256, 64)})
T3_MAX_OUT = 64
_T3_SMEM_TWO = 233472 // 2 - 1024
_T3_MAX_STAGES = 5
_T3_SMS = 132
_T3_STAGE_CHUNKS = 2048
# the zero line at the head of a block's shared memory
_T3_ZERO = 128


def _t3_stages(fixed: int, stage: int):
    """``(stages, blocks_per_sm)``: as many ring stages as let two blocks
    share an SM, up to :data:`_T3_MAX_STAGES`; else as many as one block
    holds.  Blocks an SM: as many as their shared memory allows, at most
    3 (the registers of 256 threads at up to 85 each).  Raises ValueError
    where not even 4 stages fit."""
    for budget in (_T3_SMEM_TWO, _SMEM_OPTIN_MAX):
        n = min(_T3_MAX_STAGES, (budget - fixed) // stage)
        if n >= 4:
            smem = fixed + n * stage
            return n, min(3, (2 * _T3_SMEM_TWO + 2048) // (smem + 1024))
    raise ValueError(f"motion_conv_t3: {fixed} + 4 x {stage} bytes of "
                     "shared memory do not fit a block")


def _t3_run(frames: int, pairs: int, slots: int) -> int:
    """The frames a block walks, a divisor of ``frames`` (a shorter last run
    leaves SMs idle): the run whose waves of blocks (``pairs`` of clip and
    position tile, each cut into runs, over ``slots`` blocks resident on
    the card) times its frames plus the two of its halo is least; the
    longer run on a tie."""
    def cost(run):
        return (-(-pairs * (frames // run) // slots) * (run + 2), -run)
    return min((r for r in range(1, frames + 1) if frames % r == 0),
               key=cost)


@functools.lru_cache(maxsize=None)
def motion_conv_t3_plan(hw: int, frames: int, batch: int, channels: int,
                        n_out: int):
    """``(wn, tile_rows, run, stages, smem)`` of the convolution kernel for
    x ``[batch, channels, frames, H, W]`` (``hw`` = H W) and ``n_out``
    outputs: ``wn`` warps across the outputs (each 1 to 4 tiles of 8, the
    rest of the 8 warps across positions, 32 each), as few as keep a stage
    of ``256 / wn`` positions within 32 KB; the plane cut into equal tiles
    of ``tile_rows`` positions, at most ``256 / wn``; ``run`` frames a
    block; ``stages`` of the ring; the block's dynamic shared memory.
    Raises ValueError for a shape the kernel is not built for."""
    wn = min(max(1, n_out // 8), max(1, n_out // 32, channels // 64))
    if (channels, n_out, wn) not in _T3_CONV_LAYOUTS:
        raise ValueError(f"motion_conv_t3 kernel is built for the fast "
                         f"pathway's conv1s and their input gradients, not "
                         f"{channels} -> {n_out} channels")
    bm = 32 * (8 // wn)
    tiles = -(-hw // bm)
    stage = 2 * bm * channels
    fixed = _T3_ZERO + 2 * 3 * n_out * channels
    stages, per_sm = _t3_stages(fixed, stage)
    run = _t3_run(frames, tiles * batch, _T3_SMS * per_sm)
    return wn, -(-hw // tiles), run, stages, fixed + stages * stage


@functools.lru_cache(maxsize=None)
def motion_conv_t3_wgrad_plan(hw: int, frames: int, batch: int,
                              channels: int, n_out: int):
    """``(bm, run, stages, groups, smem, blocks)`` of the weight gradient's
    kernel: ``groups`` of up to 4 chunks of 8 channels with their three
    taps, each a block over the same positions; the plane cut into equal
    tiles of ``bm`` positions (a multiple of 16), as few as keep a stage of
    the group's channels of x and of dy within 32 KB; ``run`` frames a
    block; ``stages`` of the ring; the block's dynamic shared memory; the
    ``blocks`` over positions, each a row of the float32 partial sums.
    Raises ValueError for a shape the kernel is not built for."""
    if (channels, n_out) not in _T3_WGRAD_PAIRS:
        raise ValueError(f"motion_conv_t3_wgrad kernel is built for the fast "
                         f"pathway's conv1s, not {channels} -> {n_out} "
                         "channels")
    c8 = channels // 8
    gc8 = min(c8, 4)
    row = gc8 + n_out // 8
    most = min(512, 16 * (_T3_STAGE_CHUNKS // (16 * row)))
    tiles = -(-hw // most)
    bm = 16 * -(-hw // (16 * tiles))
    stages, per_sm = _t3_stages(_T3_ZERO, 16 * bm * row)
    # the warps' sums of the rows they share, in the ring after the walk
    smem = _T3_ZERO + max(stages * 16 * bm * row, 8 * n_out * 64)
    groups = c8 // gc8
    run = _t3_run(frames, tiles * batch * groups, _T3_SMS * per_sm)
    return bm, run, stages, groups, smem, tiles * batch * -(-frames // run)


@functools.lru_cache(maxsize=None)
def motion_conv_t3_fits(channels: int, n_out: int) -> bool:
    """Whether the kernels take a 3x1x1 conv of ``channels`` -> ``n_out``
    channels, forward, input gradient (``n_out`` -> ``channels``) and
    weight gradient: ``n_out`` at most :data:`T3_MAX_OUT`, where the shape
    stays below the card's 295 operations a byte, and each plan exists."""
    if n_out > T3_MAX_OUT:
        return False
    try:
        motion_conv_t3_plan(1, 1, 1, channels, n_out)
        motion_conv_t3_plan(1, 1, 1, n_out, channels)
        motion_conv_t3_wgrad_plan(1, 1, 1, channels, n_out)
    except ValueError:
        return False
    return True


def _t3_padded(x: torch.Tensor):
    """x ``[B, C, T, H, W]`` -> ``[B, T, H W, C]`` float32 with a zero frame
    each side of T."""
    B, C, T, H, W = x.shape
    xl = x.permute(0, 2, 3, 4, 1).reshape(B, T, H * W, C).float()
    return F.pad(xl, (0, 0, 0, 0, 1, 1))


def motion_conv_t3_plain(x: torch.Tensor, weight: torch.Tensor,
                         grad_input: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`motion_conv_t3`: the three temporal
    taps (with ``grad_input`` each transposed, in reverse order) as float32
    products over the channels-last view, summed in float32 and rounded
    once to ``x``'s dtype; a channels-last-3d result."""
    B, C, T, H, W = x.shape
    xp = _t3_padded(x)
    if grad_input:
        weight = weight.flip(2).transpose(0, 1)
    w = weight[:, :, :, 0, 0].float()
    y = sum(xp[:, k:k + T] @ w[:, :, k].t() for k in range(3))
    return y.to(x.dtype).reshape(B, T, H, W, -1).permute(0, 4, 1, 2, 3)


def motion_conv_t3_wgrad_plain(x: torch.Tensor,
                               grad: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`motion_conv_t3_wgrad`: for each tap
    the float32 sum over every position of the output gradient times the
    shifted input, rounded once to ``x``'s dtype: ``[N, C, 3, 1, 1]``."""
    B, C, T, H, W = x.shape
    xp = _t3_padded(x)
    g = grad.permute(0, 2, 3, 4, 1).reshape(-1, grad.shape[1]).float()
    dw = torch.stack([g.t() @ xp[:, k:k + T].reshape(-1, C)
                      for k in range(3)], dim=-1)
    return dw.to(x.dtype)[..., None, None]


def _check_t3_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous(memory_format=torch.channels_last_3d):
        raise ValueError(f"motion_conv_t3: {name} must be channels-last-3d "
                         f"(dense NDHWC), got strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"motion_conv_t3: {name} must be 16-byte aligned")
    if t.numel() > _INT32_MAX * 8:
        raise ValueError(f"motion_conv_t3: {name} has {t.numel()} elements; "
                         "the kernels index 16-byte chunks in 32 bits")
    if t.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"motion_conv_t3 kernel takes at most {_MAX_GRID_Y}"
                         f" clips, got {t.shape[0]}")


def _motion_conv_t3_cuda(x: torch.Tensor, weight: torch.Tensor,
                         grad_input: bool = False) -> torch.Tensor:
    B, C, T, H, W = x.shape
    N = weight.shape[1 if grad_input else 0]
    _check_t3_cuda("x", x)
    wn, tile_rows, run, stages, smem = motion_conv_t3_plan(H * W, T, B, C,
                                                           N)
    # the kernel gathers its taps from the weight as it lies
    weight = weight.contiguous()
    if weight.data_ptr() % 16:
        raise ValueError("motion_conv_t3: weight must be 16-byte aligned")
    y = torch.empty((B, N, T, H, W), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last_3d)
    if y.numel():
        _launch("motion_conv_t3", x.device, x.data_ptr(), weight.data_ptr(),
                y.data_ptr(), B, T, H * W, C, N, wn, tile_rows, run, stages,
                int(grad_input), smem)
        motion_conv_t3.launches += 1
    return y


def _motion_conv_t3_wgrad_cuda(x: torch.Tensor,
                               grad: torch.Tensor) -> torch.Tensor:
    B, C, T, H, W = x.shape
    N = grad.shape[1]
    _check_t3_cuda("x", x)
    _check_t3_cuda("grad", grad)
    bm, run, stages, _, smem, blocks = motion_conv_t3_wgrad_plan(
        H * W, T, B, C, N)
    dw = torch.empty((N, C, 3, 1, 1), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    partial = torch.empty((blocks, 3 * C * N), dtype=torch.float32,
                          device=x.device)
    _launch("motion_conv_t3_wgrad", x.device, x.data_ptr(), grad.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), B, T, H * W, C, N, bm, run,
            stages, smem)
    motion_conv_t3_wgrad.launches += 1
    return dw


def _t3_setup(ctx, inputs, output) -> None:
    x, weight, grad_input = inputs
    if grad_input:
        ctx.mark_non_differentiable(output)
    ctx.save_for_backward(x, weight)


def _t3_backward(ctx, grad: torch.Tensor):
    x, weight = ctx.saved_tensors
    # autograd hands over whatever layout the next layer's backward made
    grad = grad.contiguous(memory_format=torch.channels_last_3d)
    need = ctx.needs_input_grad
    # the input gradient: the same convolution, taps transposed and reversed
    dx = torch.ops.avsep.motion_conv_t3(grad, weight, True) if need[0] \
        else None
    dw = torch.ops.avsep.motion_conv_t3_wgrad(x, grad) if need[1] else None
    return dx, dw, None


_LIB.define("motion_conv_t3(Tensor x, Tensor weight, bool grad_input=False) "
            "-> Tensor")
_LIB.define("motion_conv_t3_wgrad(Tensor x, Tensor grad) -> Tensor")
_LIB.impl("motion_conv_t3", motion_conv_t3_plain, "CPU")
_LIB.impl("motion_conv_t3", _motion_conv_t3_cuda, "CUDA")
_LIB.impl("motion_conv_t3_wgrad", motion_conv_t3_wgrad_plain, "CPU")
_LIB.impl("motion_conv_t3_wgrad", _motion_conv_t3_wgrad_cuda, "CUDA")
torch.library.register_autograd("avsep::motion_conv_t3", _t3_backward,
                                setup_context=_t3_setup, lib=_LIB)


def _check_t3(x: torch.Tensor, other: torch.Tensor, name: str,
              shape) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.bfloat16 or \
            x.dim() != 5:
        raise TypeError("x must be a bfloat16 [B, C, T, H, W] tensor, got "
                        f"{getattr(x, 'dtype', type(x))} "
                        f"{tuple(getattr(x, 'shape', ()))}")
    if other.dtype != x.dtype or tuple(other.shape) != tuple(shape):
        raise ValueError(f"{name} must be {x.dtype} {tuple(shape)}, got "
                         f"{other.dtype} {tuple(other.shape)}")
    if x.device != other.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x ({x.device}) and {name} ({other.device}) must "
                         "lie on one CPU or CUDA device")


def motion_conv_t3(x: torch.Tensor, weight: torch.Tensor,
                   grad_input: bool = False) -> torch.Tensor:
    """The motion net's 3x1x1 convolution at stride 1, temporal padding 1,
    no bias: ``x`` ``[B, C, T, H, W]`` and the conv's weight ``[N, C, 3, 1,
    1]``, both bfloat16 -> ``[B, N, T, H, W]`` bfloat16, channels-last-3d;
    float32 sums rounded once, as cuDNN's bfloat16 conv rounds them.  With
    ``grad_input`` the weight is ``[C, N, 3, 1, 1]`` and its taps are taken
    transposed and in reverse order: ``x`` is then the conv's output
    gradient and the result its input gradient (no gradient flows through
    such a call).

    CPU tensor: plain version.  CUDA tensor: the kernel of
    ``csrc/motion_conv_t3.cu``, which takes ``x`` channels-last-3d, dense
    and 16-byte aligned, and the channels of the fast pathway's conv1s and
    of their input gradients (``_T3_CONV_LAYOUTS``), and raises on anything
    else.  The input gradient is this op with ``grad_input``, the weight
    gradient :func:`motion_conv_t3_wgrad`."""
    C = x.shape[1] if isinstance(x, torch.Tensor) and x.dim() == 5 else 0
    other = weight.shape[int(grad_input)] if weight.dim() == 5 else 0
    _check_t3(x, weight, "weight",
              (C, other, 3, 1, 1) if grad_input else (other, C, 3, 1, 1))
    return torch.ops.avsep.motion_conv_t3(x, weight, bool(grad_input))


motion_conv_t3.launches = 0


def motion_conv_t3_wgrad(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The bfloat16 gradient of :func:`motion_conv_t3`'s weight given its
    input ``x`` and its output's gradient ``grad`` ``[B, N, T, H, W]``:
    ``[N, C, 3, 1, 1]``, float32 sums over every position rounded once.  On
    a card the kernel takes the fast pathway's conv1s (``_T3_WGRAD_PAIRS``),
    and the sums are taken in a fixed order, so two calls give the same
    bits.  CPU tensor: plain version."""
    _check_t3(x, grad, "grad", (x.shape[0], grad.shape[1], *x.shape[2:])
              if x.dim() == 5 and grad.dim() == 5 else (-1,))
    return torch.ops.avsep.motion_conv_t3_wgrad(x, grad)


motion_conv_t3_wgrad.launches = 0
