"""Drive avsep_tpu_torch's main path on one NVIDIA GPU and check its kernels.

Run from the root of a checkout, on a machine with a CUDA GPU:

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and the exit code is not
0.  Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero before printing any result.

1. card: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.  TF32 is switched off for cuDNN convolutions and cuBLAS
   matmuls, so float32 means float32 (the parity envelope); the port's
   library code never touches these flags.
2. build: compile the CUDA kernels from the checkout's sources (one nvcc
   per source, in parallel).
3. kernels: each kernel against its plain PyTorch version on the card at
   the flagship shapes (B = 16 clips, 65535 samples, n_fft 1022, hop 256;
   frame_window also at the B * 2 rows of the train step's source STFT),
   bit for bit, with median times from CUDA events (L2 flushed by a
   memset before each launch, which leaves it full of dirty lines; and
   again after a read of the same buffer, which leaves it clean), the time
   of one PyTorch library call of the same function, and the bound.
   ragged: both kernels against their plain versions, bit for bit, at
   shapes the flagship never reaches (odd n_fft, hop above n_fft, one
   frame, padded rows of both parities, a misaligned output run, a block
   that opts in to more than 48 KB of shared memory), overlap-add with the
   clip on and off.
4. separate: the flagship configuration of bench.py (unet7,
   resnet18dilated-256, hidsep/sig fusion, log-frequency warp, binary
   masks, dft "matmul") at full width through ``engine.separate``, B = 16,
   frames [16, 2, 1, 224, 224, 3] uint8, random weights from
   ``engine.init_params`` with a seeded generator: a few batches stand in
   for requests.  The launch counters are set to 0 just before and read
   just after; each kernel must have launched once per call.
   profile: torch.profiler over two more flagship calls: device time by
   PyTorch operator and by kernel, and the device's busy share.
5. card_vs_cpu: the same path at B = 2 with binary_mask 0 and dft "fft" on
   the card and on the CPU with the same weights; masks and wavs must agree
   to 1e-4.  Then with binary_mask 1, the share of agreeing mask bins.
6. train: the recipe of scripts/train_MUSIC.sh on one card at full width
   and depth (unet7, resnet18dilated-256, hidsep/sig, bce on binary
   weighted masks, match_weight 0.1, B = 16, 65535 samples, frames
   [16, 2, 1, 224, 224, 3] uint8, lr 1e-3 / 1e-4, AV every second step
   from the start), float32 with TF32 off, dft "matmul", random weights
   from ``train.init_state`` with a seeded generator and seeded random
   batches.  First a CUDA input that requires grad must make frame_window
   raise.  Then 2 warm-up steps and 8 timed steps, AV and AO as
   ``train.batch_scheduler`` says; ms per AV and per AO step (host clock
   around each step, synchronized), samples/s, peak memory; frame_window
   must launch exactly twice per step (counters set to 0 just before the 8
   steps, read per step and just after), every loss must be finite and
   every AO step must leave the frame net (parameters and statistics) bit
   for bit as it was.
   train_profile: torch.profiler over one more AV step.
7. train_card_vs_cpu: one AV and one AO step at a small size (unet5,
   resnet18dilated-256 on 64x64 frames, 16383 samples, B = 2, dft "fft",
   binary_mask 0) from the same weights and batches on the card and on
   the CPU: losses, parameters, momentum buffers and BatchNorm running
   statistics within ``TRAIN_TOL``, group counts equal.
8. eval: the recipe of scripts/eval_MUSIC.sh at full width (unet7,
   resnet18dilated-256, hidsep/sig, bce, binary weighted masks,
   log-frequency warp, one frame, dft "fft", float32 with TF32 off), B = 16,
   65535 samples, frames [16, 2, 1, 224, 224, 3] uint8, random weights from
   ``engine.init_params``: ``evaluate.evaluate`` for the AV branch, then
   the AO branch, over an in-memory loader of EVAL_BATCHES seeded batches,
   once to warm up and once timed.  ms per eval step (CUDA events around
   each step), the share of it in ``eval_metrics`` (CUDA events), clips/s
   (host clock around the sweep), peak memory.  frame_window must launch 3
   times and overlap_add_normalize once per eval step (counters set to 0
   just before the timed sweeps, read per step and just after); each
   results.csv must hold one finite row per clip, and the history's meters
   must equal the means of the rows.
   eval_profile: torch.profiler over one more AV eval step.
9. eval_card_vs_cpu: one AV and one AO eval step at a small size (unet5,
   resnet18dilated-256 on 64x64 frames, 65535 samples as in the eval
   phase, B = 2) from the same He-scaled weights and the same injected
   draws on the card and on the CPU.  With soft masks (binary_mask 0) the
   masks must agree to 1e-4 and the metrics within ``EVAL_TOL``; with
   binary masks the bins must agree as ``EVAL_TOL`` says; and
   ``eval_metrics`` alone on the same inputs on both devices within
   ``EVAL_TOL`` (cuSOLVER and cuFFT against LAPACK and pocketfft).
10. cli_eval, where PIL imports: ``python -m avsep_tpu_torch.main --mode
   eval`` with the flags of scripts/eval_MUSIC.sh on data/mini/train.csv,
   ``--num_vis 0``, checkpoints and results under build/: exit 0, one
   finite results.csv row per clip in each branch.
Then the kernel table as one JSON line (launches summed over the separate,
train and eval runs, and by path), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import csv
import importlib.util
import json
import os
import re
import shlex
import subprocess
import sys
import time

import numpy as np
import torch

from avsep_tpu_torch import engine, evaluate, train
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.loader import BatchLoader
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.ops.stft import _reflect_pad, istft_denominator
from avsep_tpu_torch.ops.warp import unwarp_mask
from avsep_tpu_torch.utils.meters import new_history

# NVIDIA H100 SXM data sheet: HBM3 rate and the float32 rate outside the
# tensor cores (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

FLAGSHIP = dict(arch_sound="unet7", arch_frame="resnet18dilated",
                num_channels=2, vis_channels=256, fusion_type="hidsep",
                att_type="sig", not_pool_vis=False, img_activation="relu",
                output_activation="sigmoid", binary_mask=1, weighted_loss=1,
                log_freq=1, one_frame=True, dft="matmul")
B = 16
N_FFT, HOP, AUD_LEN = 1022, 256, 65535
WARMUP, REQUESTS = 2, 16
# (n_fft, hop, B, T) beyond the flagship, for the ragged phase
RAGGED = [(1021, 256, 3, 7), (512, 160, 1, 5), (400, 160, 2, 9),
          (1022, 256, 1, 1), (300, 512, 2, 4), (1022, 256, 3, 7),
          (8192, 2048, 1, 3)]
SEED = 0
DEVICE = "cuda"
# scripts/train_MUSIC.sh on one card, in float32 (its --dtype bfloat16 is
# outside the parity envelope; the port has no bf16 mode)
TRAIN = dict(FLAGSHIP, loss="bce", match_weight=0.1, mask_thres=0.5,
             img_pool="maxpool", num_mix=2, batch_size_per_gpu=B,
             lr_sound=1e-3, lr_frame=1e-4, lr_steps=(50000, 70000, 90000),
             start_av_first=True, num_fsteps=0, iter_per_av=2)
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# train_card_vs_cpu: unet5 (ngf 64), resnet18dilated-256 on 64x64 frames,
# 16383 samples, B = 2
TRAIN_SMALL = dict(arch_sound="unet5", audLen=16383, imgSize=64, dft="fft",
                   binary_mask=0)
# card vs CPU after an AV and an AO step, from the same random weights
# (spread_weights).  Losses: float32 in another summation order.  Momentum
# buffers (gradient + decay + decayed buffer): the L2 norm of all buffers'
# difference against their norm, 1e-2, and each buffer's against its own
# norm (floored at 1e-4 of the largest), 5e-2.  The deep layers' gradients
# (the U-Net's innermost levels, the ResNet's layer3 and layer4, where a
# BatchNorm sees 32 to 128 values per channel at B = 2) lose digits to
# cancellation in the BatchNorm backward, and an activation within
# rounding of 0 may take the other side of its ReLU on one device.  On an
# H100 (NVIDIA H100 80GB HBM3, 700 W) this read up to 1.45e-2 per buffer in
# L2 norm, 8.4e-4 over all buffers, and 0.127 on a buffer's largest entry;
# the two L2 limits are 3.4x and 12x those readings, and the largest-entry
# error (``momentum_err``) is reported, not bounded: it is one entry of one
# buffer, and the L2 limits hold the buffers.
# Parameters: against their change since the start (floored at 1e-4 of the
# largest change), less 1e-6 of their value (a few float32 ulps).  Running
# statistics: against each buffer's largest value.
TRAIN_TOL = {"loss_rel_err": 1e-5, "momentum_global_l2_err": 1e-2,
             "momentum_l2_err": 5e-2, "param_err": 2e-3, "bn_stats_err": 1e-4}
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO_DIR, "build", "chip_smoke")
# scripts/eval_MUSIC.sh: its dft is the default "fft"
EVAL = dict(FLAGSHIP, dft="fft", loss="bce", mask_thres=0.5,
            img_pool="maxpool", num_mix=2, batch_size_per_gpu=B, num_vis=0)
EVAL_BATCHES = 4
# eval_card_vs_cpu: unet5 (ngf 64), resnet18dilated-256 on 64x64 frames,
# the eval phase's 65535 samples, B = 2
EVAL_SMALL = dict(arch_sound="unet5", imgSize=64)
# card vs CPU of one eval step, from the same weights and draws (limits
# set from the first reading on an H100, NVIDIA H100 80GB HBM3, 700 W).
# Masks (soft): as card_vs_cpu (read 2.8e-5).  Metrics in dB, float32
# Cholesky of the loaded Grams (condition number up to 1e7) on cuSOLVER
# against LAPACK, after cuFFT against pocketfft: end to end with soft
# masks (read 2.9e-5 dB; limit 1e-3), eval_metrics alone on the same
# inputs (read 3.8e-6 dB; limit 1e-4), and on narrowband references, two
# sines whose Grams are singular but for the loading (read 0.033 dB, the
# same in two runs; limit 0.1).  Binary masks: the
# share of bins that agree (read 1.0); a value within rounding of the
# threshold may land on the other side.
EVAL_TOL = {"masks_max_abs_err": 1e-4, "metrics_max_db_err": 1e-3,
            "same_input_metrics_max_db_err": 1e-4,
            "narrowband_metrics_max_db_err": 0.1,
            "binary_mask_agreement_min": 0.999}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, reps: int = 30,
            clean: bool = False) -> float:
    """Median device time of ``fn`` in ms from CUDA events, with the L2
    cache flushed before each run, outside the timed window: by a 256 MiB
    memset (the L2 is left full of dirty lines, which the run must write
    back as it allocates), or with ``clean`` by a sum over the same buffer
    after the memset (the L2 is left full of clean lines)."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        if clean:
            flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound_ms(n_bytes: int, n_ops: int):
    """The least time for the work: bytes over the memory rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_frame_window(dev, gen, flush):
    audio = (0.1 * torch.randn(B, AUD_LEN, generator=gen)).to(dev)
    padded = _reflect_pad(audio, N_FFT // 2).contiguous()
    T = 1 + AUD_LEN // HOP
    win = torch.from_numpy(kernels.hann_periodic(N_FFT)).to(dev)

    got = kernels.frame_window(padded, T, N_FFT, HOP)
    plain = kernels.frame_window_plain(padded, T, N_FFT, HOP)
    library = padded.unfold(-1, N_FFT, HOP)[:, :T] * win
    torch.cuda.synchronize()
    err = (got - plain).abs().max().item()
    if err != 0.0 or not torch.equal(got, library):
        raise AssertionError(f"frame_window disagrees with its plain "
                             f"version: max abs err {err}")
    t = time_ms(lambda: kernels.frame_window(padded, T, N_FFT, HOP), flush)
    t_clean = time_ms(lambda: kernels.frame_window(padded, T, N_FFT, HOP),
                      flush, clean=True)
    t_plain = time_ms(
        lambda: kernels.frame_window_plain(padded, T, N_FFT, HOP), flush)
    t_lib = time_ms(lambda: padded.unfold(-1, N_FFT, HOP)[:, :T] * win,
                    flush)
    # yardsticks under the same flush: writing the output alone, and a
    # launch that does next to no work (the timing's fixed cost)
    t_fill = time_ms(lambda: got.fill_(1.0), flush)
    t_launch = time_ms(lambda: got[:1, :1, :1].zero_(), flush)
    n_bytes = 4 * (padded.numel() + N_FFT + got.numel())
    bnd, by = bound_ms(n_bytes, got.numel())

    # the train step's source STFT: B * num_mix rows
    src_rows = B * TRAIN["num_mix"]
    src = _reflect_pad((0.1 * torch.randn(src_rows, AUD_LEN, generator=gen)
                        ).to(dev), N_FFT // 2).contiguous()
    got_src = kernels.frame_window(src, T, N_FFT, HOP)
    plain_src = kernels.frame_window_plain(src, T, N_FFT, HOP)
    torch.cuda.synchronize()
    err_src = (got_src - plain_src).abs().max().item()
    if not torch.equal(got_src, plain_src):
        raise AssertionError(f"frame_window disagrees with its plain version "
                             f"at [{src_rows}, {src.shape[-1]}]: max abs err "
                             f"{err_src}")
    t_src = time_ms(lambda: kernels.frame_window(src, T, N_FFT, HOP), flush)
    bnd_src, _ = bound_ms(4 * (src.numel() + N_FFT + got_src.numel()),
                          got_src.numel())
    row = dict(name="frame_window", route="cuda",
               source="avsep_tpu_torch/csrc/frame_window.cu",
               replaces="avsep_tpu/ops/pallas_kernels.py:138",
               max_abs_err=max(err, err_src), tolerance=0.0, ms=t,
               plain_ms=t_plain, bound_ms=bnd, bound_by=by, library_ms=t_lib,
               ms_l2_clean=t_clean, share_of_bound=bnd / t,
               fill_out_ms=t_fill, launch_ms=t_launch,
               shape_in=list(padded.shape), shape_out=list(got.shape),
               shapes_checked=[list(padded.shape), list(src.shape)],
               sources_ms=t_src, sources_bound_ms=bnd_src,
               sources_share_of_bound=bnd_src / t_src)
    emit("kernel", **row)
    return row


def check_overlap_add(dev, gen, flush):
    T = 1 + AUD_LEN // HOP
    rows = B * FLAGSHIP["num_channels"]
    full_len = N_FFT + HOP * (T - 1)
    frames = (0.3 * torch.randn(rows, T, N_FFT, generator=gen)).to(dev)
    denom_np = istft_denominator(N_FFT, HOP, T)
    denom = torch.from_numpy(denom_np.copy()).to(dev)

    def library():
        folded = torch.nn.functional.fold(
            frames.transpose(1, 2), output_size=(1, full_len),
            kernel_size=(1, N_FFT), stride=(1, HOP))
        return folded.reshape(rows, full_len) / denom

    err = 0.0
    for clip in (True, False):
        got = kernels.overlap_add_normalize(frames, HOP, full_len, denom,
                                            clip=clip)
        plain = kernels.overlap_add_normalize_plain(frames, HOP, full_len,
                                                    denom, clip=clip)
        torch.cuda.synchronize()
        err = max(err, (got - plain).abs().max().item())
        if not torch.equal(got, plain):
            raise AssertionError(f"overlap_add_normalize (clip={clip}) "
                                 f"disagrees with its plain version: max "
                                 f"abs err {err}")
    lib_err = (kernels.overlap_add_normalize(frames, HOP, full_len, denom,
                                             clip=False)
               - library()).abs().max().item()
    t = time_ms(lambda: kernels.overlap_add_normalize(
        frames, HOP, full_len, denom, clip=False), flush)
    t_clean = time_ms(lambda: kernels.overlap_add_normalize(
        frames, HOP, full_len, denom, clip=False), flush, clean=True)
    t_plain = time_ms(lambda: kernels.overlap_add_normalize_plain(
        frames, HOP, full_len, denom, clip=False), flush)
    t_lib = time_ms(library, flush)
    n_bytes = 4 * (frames.numel() + full_len + rows * full_len)
    n_ops = frames.numel() + rows * full_len       # adds, one divide each
    bnd, by = bound_ms(n_bytes, n_ops)
    row = dict(name="overlap_add_normalize", route="cuda",
               source="avsep_tpu_torch/csrc/overlap_add.cu",
               replaces="avsep_tpu/ops/pallas_kernels.py:71",
               max_abs_err=err, tolerance=0.0, ms=t, plain_ms=t_plain,
               bound_ms=bnd, bound_by=by, library_ms=t_lib,
               ms_l2_clean=t_clean, share_of_bound=bnd / t,
               library_max_abs_err=lib_err,
               shape_in=list(frames.shape), shape_out=[rows, full_len])
    emit("kernel", **row)
    return row


def check_ragged(dev, gen):
    """Both kernels against their plain versions, bit for bit, at the
    shapes of ``RAGGED``, each with padded rows of odd and of even length
    (the lengths of audio of (T - 1) * hop and one more samples after the
    STFT's padding: both give T frames), and overlap-add with the clip on
    and off."""
    cases = []
    for n_fft, hop, nb, T in RAGGED:
        for extra in (0, 1):
            Lp = (T - 1) * hop + extra + 2 * (n_fft // 2)
            padded = (0.1 * torch.randn(nb, Lp, generator=gen)).to(dev)
            got = kernels.frame_window(padded, T, n_fft, hop)
            plain = kernels.frame_window_plain(padded, T, n_fft, hop)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"frame_window disagrees with its plain version at "
                    f"n_fft {n_fft}, hop {hop}, B {nb}, T {T}, L' "
                    f"{padded.shape[-1]}: max abs err "
                    f"{(got - plain).abs().max().item()}")
            cases.append(["frame_window", n_fft, hop, nb, T,
                          padded.shape[-1]])
        full_len = n_fft + hop * (T - 1)
        denom = torch.from_numpy(
            istft_denominator(n_fft, hop, T).copy()).to(dev)
        # scale 3 so that the clip bites on some samples
        frames = (3.0 * torch.randn(nb, T, n_fft, generator=gen)).to(dev)
        for clip in (True, False):
            got = kernels.overlap_add_normalize(frames, hop, full_len, denom,
                                                clip=clip)
            plain = kernels.overlap_add_normalize_plain(frames, hop, full_len,
                                                        denom, clip=clip)
            torch.cuda.synchronize()
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"overlap_add_normalize (clip={clip}) disagrees with its "
                    f"plain version at n_fft {n_fft}, hop {hop}, rows "
                    f"{nb}, T {T}: max abs err "
                    f"{(got - plain).abs().max().item()}")
            cases.append(["overlap_add_normalize", n_fft, hop, nb, T,
                          full_len, clip])
    emit("ragged", tolerance=0.0, max_abs_err=0.0, cases=len(cases),
         shapes=cases)


def flagship_inputs(gen, dev, n, batch):
    audio = [(0.1 * torch.randn(batch, AUD_LEN, generator=gen)).to(dev)
             for _ in range(n)]
    frames = [torch.randint(0, 256, (batch, 2, 1, 224, 224, 3),
                            generator=gen, dtype=torch.uint8).to(dev)
              for _ in range(n)]
    return audio, frames


def run_flagship(dev, gen):
    cfg = Config(**FLAGSHIP)
    nets = engine.init_params(cfg, engine.build_nets(cfg),
                              torch.Generator().manual_seed(SEED))
    audio, frames = flagship_inputs(gen, dev, REQUESTS, B)
    for i in range(WARMUP):
        engine.separate(nets, audio[i], frames[i], cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    kernels.frame_window.launches = 0
    kernels.overlap_add_normalize.launches = 0
    t0 = time.perf_counter()
    outs = [engine.separate(nets, audio[i], frames[i], cfg)
            for i in range(REQUESTS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"frame_window": kernels.frame_window.launches,
                "overlap_add_normalize":
                    kernels.overlap_add_normalize.launches}

    for name, n in launches.items():
        if n != REQUESTS:
            raise AssertionError(f"{name} launched {n} times in {REQUESTS} "
                                 f"separate() calls; expected one per call")
    out = outs[-1]
    T = 1 + AUD_LEN // HOP
    expect = {"wavs": (B, 2, HOP * (T - 1)), "masks": (B, 2, 256, T),
              "masks_linear": (B, 2, N_FFT // 2 + 1, T),
              "att_maps": (B, 2, 14, 14)}
    for key, shape in expect.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"{key} has shape {tuple(out[key].shape)}, "
                                 f"expected {shape}")
    for o in outs:
        w = o["wavs"]
        if not bool(torch.isfinite(w).all()) or w.abs().max().item() > 1.0:
            raise AssertionError("wavs not finite or outside [-1, 1]")
        lin = o["masks_linear"]
        if not bool(((lin == 0) | (lin == 1)).all()):
            raise AssertionError("binary masks hold values other than 0, 1")
    emit("separate", config="bench.py flagship (unet7, resnet18dilated-256, "
         "hidsep/sig, dft matmul, binary masks)", batch=B, requests=REQUESTS,
         wall_s=wall, clips_per_s=B * REQUESTS / wall,
         ms_per_request=1e3 * wall / REQUESTS, launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    profile_flagship(nets, cfg, audio, frames)
    return launches, nets


def profile_flagship(nets, cfg, audio, frames, calls: int = 2):
    """torch.profiler over ``calls`` flagship calls (phase ``profile``)."""
    profile_calls("profile", lambda i: engine.separate(
        nets, audio[i], frames[i], cfg), calls)


def profile_calls(phase: str, fn, calls: int, **fields):
    """torch.profiler over ``fn(0) .. fn(calls - 1)``: device ms per call by
    PyTorch operator (the kernels each one launched) and by kernel, and
    the device's busy share of the wall time (the profiler's own host
    overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernel_us = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernel_us[ev.name] = (kernel_us.get(ev.name, 0.0)
                                  + ev.time_range.elapsed_us())
    ops = [(ev.key, ev.self_device_time_total, ev.count)
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CPU
           and ev.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    kernels_top = sorted(kernel_us.items(), key=lambda kv: -kv[1])
    busy = sum(kernel_us.values())
    per_call = 1e-3 / calls
    # the port's own kernels, too small for the top of the list
    own = {name: per_call * sum(us for k, us in kernel_us.items()
                                if f"{name}_kernel" in k)
           for name in ("frame_window", "overlap_add")}
    emit(phase, calls=calls, batch=B, **fields,
         wall_ms_per_call=wall_us * per_call,
         device_busy_ms_per_call=busy * per_call,
         device_idle_share=max(0.0, 1.0 - busy / wall_us),
         ops_ms_per_call=[[k, us * per_call, n // calls]
                          for k, us, n in ops[:12]],
         kernels_ms_per_call=[[k[:80], us * per_call]
                              for k, us in kernels_top[:16]],
         port_kernels_ms_per_call=own)


def train_batches(gen, dev, n, batch, aud_len=AUD_LEN, img=224):
    """Seeded random training batches: per-source waveforms already scaled
    by 1/N as the loaders ship them, one uint8 frame per source."""
    return [{"audios": (0.05 * torch.randn(batch, 2, aud_len, generator=gen)
                        ).to(dev),
             "frames": torch.randint(0, 256, (batch, 2, 1, img, img, 3),
                                     generator=gen, dtype=torch.uint8
                                     ).to(dev)}
            for _ in range(n)]


def check_no_silent_detach(dev):
    padded = torch.zeros(2, N_FFT + 3 * HOP, device=dev, requires_grad=True)
    try:
        kernels.frame_window(padded, 4, N_FFT, HOP)
    except RuntimeError as e:
        if "no backward" in str(e):
            return
        raise
    raise AssertionError("frame_window on a CUDA input that requires grad "
                         "returned instead of raising")


def run_train(dev, gen):
    """The recipe of scripts/train_MUSIC.sh on one card, float32: 2 warm-up
    steps, then TRAIN_STEPS timed steps, AV and AO by batch_scheduler."""
    check_no_silent_detach(dev)
    cfg = Config(**TRAIN)
    state = train.init_state(cfg, engine.build_nets(cfg),
                             torch.Generator().manual_seed(SEED))
    steps = {v: train.make_train_step(cfg, state.nets, v)
             for v in (True, False)}
    use_vis = train.batch_scheduler(cfg)
    batches = train_batches(gen, dev, TRAIN_WARMUP + TRAIN_STEPS, B)
    swap = torch.Generator().manual_seed(SEED + 1)

    def frame_snapshot():
        return {k: v.clone() for k, v in state.nets.frame.state_dict().items()}

    errs, times, frozen = [], {True: [], False: []}, []
    for i in range(TRAIN_WARMUP):
        state, m = steps[use_vis(i)](state, batches[i], generator=swap)
        errs.append(m["err"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.frame_window.launches = 0
    kernels.overlap_add_normalize.launches = 0
    per_step = []
    wall = 0.0
    for i in range(TRAIN_WARMUP, TRAIN_WARMUP + TRAIN_STEPS):
        av = use_vis(i)
        before = None if av else frame_snapshot()
        n0 = kernels.frame_window.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps[av](state, batches[i], generator=swap)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        wall += dt
        times[av].append(1e3 * dt)
        per_step.append(kernels.frame_window.launches - n0)
        errs.append(m["err"])
        errs.append(m["match_loss"])
        if before is not None:
            after = state.nets.frame.state_dict()
            frozen.append(all(torch.equal(v, after[k])
                              for k, v in before.items()))
    launches = {"frame_window": kernels.frame_window.launches,
                "overlap_add_normalize":
                    kernels.overlap_add_normalize.launches}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if per_step != [2] * TRAIN_STEPS:
        raise AssertionError(f"frame_window launches per train step "
                             f"{per_step}; expected 2 each")
    if launches["overlap_add_normalize"]:
        raise AssertionError("overlap_add_normalize launched in training")
    losses = [float(e) for e in errs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss in training: {losses}")
    if not frozen or not all(frozen):
        raise AssertionError(f"an AO step moved the frame net: {frozen}")
    emit("train", config="scripts/train_MUSIC.sh on one card (unet7, "
         "resnet18dilated-256, hidsep/sig, bce, binary weighted masks, "
         "float32, TF32 off, dft matmul)", batch=B, steps=TRAIN_STEPS,
         av_steps=len(times[True]), ao_steps=len(times[False]),
         ms_per_av_step=float(np.median(times[True])),
         ms_per_ao_step=float(np.median(times[False])),
         av_step_ms=times[True], ao_step_ms=times[False],
         samples_per_s=B * TRAIN_STEPS / wall, peak_mem_gib=peak,
         frame_window_launches_per_step=per_step, launches=launches,
         losses=losses, ao_steps_left_frame_unchanged=frozen,
         silent_detach="raises")
    av_step = steps[True]
    profile_calls("train_profile", lambda i: av_step(
        state, batches[i], generator=swap), 1, step="AV")
    return launches


@torch.no_grad()
def spread_weights(nets, gen) -> None:
    """Random weights that move every layer: He-scaled convs (on fan-in),
    BatchNorm scales near 1, small biases.  Under the reference's
    N(0, 0.001) U-Net init every attention score is sigmoid(~0) = 0.5, so
    the fusion's best permutation is a coin toss of rounding, and the two
    devices may send the match loss's gradient opposite ways."""
    for net in nets:
        for name, p in net.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 4:
                p.copy_(noise * (2.0 / p[0].numel()) ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def train_card_vs_cpu(dev, gen):
    """One AV and one AO step at a small size from the same weights and
    batches on the card and on the CPU (dft fft, binary_mask 0)."""
    cfg = Config(**{**TRAIN, **TRAIN_SMALL})
    batches = train_batches(gen, torch.device("cpu"), 2, 2,
                            aud_len=cfg.audLen, img=cfg.imgSize)
    swap = torch.rand(2, generator=gen)
    states, metrics = {}, {}
    weights = None
    for d in ("cpu", "cuda"):
        st = train.init_state(cfg, engine.build_nets(cfg, device=d),
                              torch.Generator().manual_seed(SEED), device=d)
        if weights is None:
            spread_weights(st.nets, gen)
            weights = [{k: v.clone() for k, v in net.state_dict().items()}
                       for net in st.nets]
        for net, sd in zip(st.nets, weights):
            net.load_state_dict(sd)
        p0 = {n: p.detach().cpu().clone()
              for n, p in train.named_parameters(st.nets)}
        ms = []
        for b, av in zip(batches, (True, False)):
            st, m = train.make_train_step(cfg, st.nets, av, device=d)(
                st, b, swap_uniforms=swap)
            ms.append(float(m["err"]))
        states[d], metrics[d] = st, ms
    res = {"loss_rel_err": max(abs(g / c - 1.0) for g, c in
                               zip(metrics["cuda"], metrics["cpu"]))}
    g_sd, c_sd = states["cuda"].state_dict(), states["cpu"].state_dict()
    g_p = {n: p.detach().cpu()
           for n, p in train.named_parameters(states["cuda"].nets)}
    c_p = dict(train.named_parameters(states["cpu"].nets))
    moves = {n: (p.detach() - p0[n]).abs().max().item()
             for n, p in c_p.items()}
    top_move = max(moves.values())
    # each parameter against its change since the start, less a few float32
    # ulps of its value
    res["param_err"] = max(
        ((g_p[n] - p.detach()).abs().max().item()
         - 1e-6 * p.detach().abs().max().item())
        / max(moves[n], 1e-4 * top_move) for n, p in c_p.items())
    bufs = {k: (g_sd["opt_state"][g]["momentum"][k].cpu(), v)
            for g, s in c_sd["opt_state"].items() if s
            for k, v in s["momentum"].items()}
    top_max = max(v.abs().max().item() for _, v in bufs.values())
    top_l2 = max(v.norm().item() for _, v in bufs.values())
    res["momentum_err"], res["momentum_worst"] = max(
        ((a - v).abs().max().item() / max(v.abs().max().item(),
                                          1e-4 * top_max), k)
        for k, (a, v) in bufs.items())
    res["momentum_l2_err"], res["momentum_l2_worst"] = max(
        ((a - v).norm().item() / max(v.norm().item(), 1e-4 * top_l2), k)
        for k, (a, v) in bufs.items())
    res["momentum_global_l2_err"] = (
        sum(((a - v) ** 2).sum().item() for a, v in bufs.values())
        / sum((v ** 2).sum().item() for _, v in bufs.values())) ** 0.5
    res["bn_stats_err"] = max(
        (g_sd[net][k].cpu() - v).abs().max().item() / v.abs().max().item()
        for net in ("sound", "frame") for k, v in c_sd[net].items()
        if k.endswith(("running_mean", "running_var")))
    res["counts"] = {g: s["count"] for g, s in g_sd["opt_state"].items()}
    emit("train_card_vs_cpu", batch=2, dft="fft", binary_mask=0,
         steps=["AV", "AO"], tolerance=TRAIN_TOL, losses_cuda=metrics["cuda"],
         losses_cpu=metrics["cpu"], **res)
    for key, tol in TRAIN_TOL.items():
        if not res[key] <= tol:
            raise AssertionError(f"train card vs CPU: {key} {res[key]} > "
                                 f"{tol}")
    if res["counts"] != {g: s["count"] for g, s in c_sd["opt_state"].items()}:
        raise AssertionError("train card vs CPU: group counts differ")


def card_vs_cpu(dev, gen, nets_gpu):
    cfg = Config(**{**FLAGSHIP, "binary_mask": 0, "dft": "fft"})
    nets_cpu = engine.init_params(
        cfg, engine.build_nets(cfg, device="cpu"),
        torch.Generator().manual_seed(SEED), device="cpu")
    audio, frames = flagship_inputs(gen, torch.device("cpu"), 1, 2)
    res = {}
    for binary in (0, 1):
        c = cfg.replace(binary_mask=binary)
        g = engine.separate(nets_gpu, audio[0], frames[0], c)
        p = engine.separate(nets_cpu, audio[0], frames[0], c, device="cpu")
        if binary == 0:
            for key in ("masks", "wavs"):
                err = (g[key].cpu() - p[key]).abs().max().item()
                res[f"{key}_max_abs_err"] = err
                if err > 1e-4:
                    raise AssertionError(f"card vs CPU: {key} differ by "
                                         f"{err} > 1e-4")
        else:
            agree = (g["masks_linear"].cpu() == p["masks_linear"]).float()
            res["binary_mask_agreement"] = agree.mean().item()
            if res["binary_mask_agreement"] < 0.99:
                raise AssertionError("card vs CPU: binary masks agree on "
                                     f"{res['binary_mask_agreement']:.4f} "
                                     "of bins < 0.99")
    emit("card_vs_cpu", batch=2, dft="fft", tolerance=1e-4, **res)


class Clips:
    """An in-memory val set of seeded clips, the dataset's sample dicts:
    per-source waveforms scaled by 1/N and their sum, one uint8 frame per
    source."""

    def __init__(self, gen, n, aud_len, img):
        self.items = []
        for i in range(n):
            audios = (0.05 * torch.randn(2, aud_len, generator=gen)).numpy()
            self.items.append({
                "audios": audios, "audio_mix": audios.sum(0),
                "frames": torch.randint(0, 256, (2, 1, img, img, 3),
                                        generator=gen, dtype=torch.uint8
                                        ).numpy(),
                "id": f"clip{i:03d}", "class": np.array([0, 1], np.int32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class EvalTimer:
    """Wraps ``evaluate.make_eval_step`` and ``evaluate.eval_metrics`` for
    the length of a ``with`` block: CUDA events around each eval step and
    each ``eval_metrics`` call, and the kernels' launches per step."""

    def __init__(self):
        self.steps, self.metrics, self.launches = [], [], []

    @staticmethod
    def _events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self._make, self._metrics = (evaluate.make_eval_step,
                                     evaluate.eval_metrics)

        def timed_metrics(refs, ests):
            s, e = self._events()
            s.record()
            out = self._metrics(refs, ests)
            e.record()
            self.metrics.append((s, e))
            return out

        def timed_make(*args, **kw):
            step = self._make(*args, **kw)

            def timed_step(batch, **kw2):
                n0 = (kernels.frame_window.launches,
                      kernels.overlap_add_normalize.launches)
                s, e = self._events()
                s.record()
                out = step(batch, **kw2)
                e.record()
                self.steps.append((s, e))
                self.launches.append(
                    (kernels.frame_window.launches - n0[0],
                     kernels.overlap_add_normalize.launches - n0[1]))
                return out
            return timed_step

        evaluate.make_eval_step = timed_make
        evaluate.eval_metrics = timed_metrics
        return self

    def __exit__(self, *exc):
        evaluate.make_eval_step = self._make
        evaluate.eval_metrics = self._metrics

    def ms(self):
        torch.cuda.synchronize()
        return ([s.elapsed_time(e) for s, e in self.steps],
                [s.elapsed_time(e) for s, e in self.metrics])


def read_results(ckpt, branch):
    with open(os.path.join(ckpt, "visualization", branch,
                           "results.csv")) as f:
        return list(csv.DictReader(f))


def check_results(rows, history, key, n):
    """``n`` finite rows, and the history's meters equal to their means."""
    vals = {k: np.array([float(r[k]) for r in rows])
            for k in ("sdr", "sir", "si-snr")}
    if len(rows) != n or not all(np.isfinite(v).all()
                                 for v in vals.values()):
        raise AssertionError(f"{key}: {len(rows)} rows (expected {n}) or "
                             "non-finite metrics in results.csv")
    for k, col in (("sdr", "sdr"), ("sir", "sir"), ("si_sdr", "si-snr")):
        mean = float(np.mean(vals[col]))
        if abs(history[key][k][-1] - mean) > 1e-4 * max(1.0, abs(mean)):
            raise AssertionError(f"{key} meter {k} {history[key][k][-1]} is "
                                 f"not the mean of the rows {mean}")
    return {k: float(np.mean(v)) for k, v in vals.items()}


def run_eval(dev, gen):
    """The recipe of scripts/eval_MUSIC.sh on one card: AV then AO sweeps
    of ``evaluate.evaluate`` over EVAL_BATCHES batches, warm-up and
    timed."""
    ckpt = os.path.join(OUT_DIR, "eval")
    cfg = Config(**EVAL, ckpt=ckpt)
    nets = engine.init_params(cfg, engine.build_nets(cfg),
                              torch.Generator().manual_seed(SEED))
    clips = Clips(gen, EVAL_BATCHES * B, aud_len=cfg.audLen, img=cfg.imgSize)
    n = len(clips)
    loader = BatchLoader(clips, B, shuffle=False, num_workers=4)
    history = new_history()
    res, per_step = {}, []
    for use_vis in (True, False):      # warm-up: plans, handles, kernels
        evaluate.evaluate(cfg, nets, loader, history, 0, use_vis)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.frame_window.launches = 0
    kernels.overlap_add_normalize.launches = 0
    with EvalTimer() as timer:
        for use_vis in (True, False):
            branch = "av" if use_vis else "ao"
            k0 = len(timer.steps)
            t0 = time.perf_counter()
            evaluate.evaluate(cfg, nets, loader, history, 0, use_vis)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            steps_ms, metrics_ms = timer.ms()
            steps_ms, metrics_ms = steps_ms[k0:], metrics_ms[k0:]
            means = check_results(read_results(ckpt, branch), history,
                                  "val_" + branch, n)
            res[branch] = {
                "ms_per_eval_step": float(np.median(steps_ms)),
                "eval_step_ms": steps_ms,
                "eval_metrics_ms": metrics_ms,
                "eval_metrics_share": sum(metrics_ms) / sum(steps_ms),
                "clips_per_s": n / wall, "wall_s": wall, "mean_metrics": means}
    launches = {"frame_window": kernels.frame_window.launches,
                "overlap_add_normalize":
                    kernels.overlap_add_normalize.launches}
    per_step = timer.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if per_step != [(3, 1)] * (2 * EVAL_BATCHES):
        raise AssertionError(f"(frame_window, overlap_add_normalize) launches "
                             f"per eval step {per_step}; expected (3, 1)")
    emit("eval", config="scripts/eval_MUSIC.sh (unet7, resnet18dilated-256, "
         "hidsep/sig, bce, binary weighted masks, float32, TF32 off, dft "
         "fft)", batch=B, clips=n, steps_per_branch=EVAL_BATCHES,
         launches_per_step=per_step, launches=launches, peak_mem_gib=peak,
         perm_acc=history["val_av"]["perm_acc"][-1], **res)
    batch = {k: np.stack([clips[i][k] for i in range(B)])
             for k in ("audios", "frames")}
    step = evaluate.make_eval_step(cfg, nets, True)
    noise = torch.Generator(device=dev).manual_seed(SEED)
    profile_calls("eval_profile", lambda i: step(batch, noise_generator=noise),
                  1, step="AV eval")
    return launches


def eval_card_vs_cpu(dev, gen):
    """One AV and one AO eval step at a small size on the card and on the
    CPU, from the same weights and draws."""
    cfg = Config(**{**EVAL, **EVAL_SMALL})
    clips = Clips(gen, 2, aud_len=cfg.audLen, img=cfg.imgSize)
    batch = {k: np.stack([c[k] for c in clips.items])
             for k in ("audios", "frames")}
    L = HOP * (cfg.WS - 1)
    draws = {"swap_uniforms": torch.rand(2, generator=gen),
             "noise_uniforms": torch.rand(2, 2, L, generator=gen)}
    nets, weights = {}, None
    for d in ("cpu", "cuda"):
        nets[d] = engine.init_params(cfg, engine.build_nets(cfg, device=d),
                                     torch.Generator().manual_seed(SEED),
                                     device=d)
        if weights is None:
            spread_weights(nets[d], gen)
            weights = [net.state_dict() for net in nets[d]]
        for net, sd in zip(nets[d], weights):
            net.load_state_dict(sd)
    res = {}
    for use_vis in (True, False):
        branch = "av" if use_vis else "ao"
        for binary in (0, 1):
            c = cfg.replace(binary_mask=binary)
            out = {d: evaluate.make_eval_step(c, nets[d], use_vis, device=d)(
                batch, **draws) for d in ("cpu", "cuda")}
            (m_c, o_c, w_c), (m_g, o_g, w_g) = out["cpu"], out["cuda"]
            db = max((m_g[k].cpu() - m_c[k]).abs().max().item()
                     for k in ("sdr", "sir", "sar", "si_sdr"))
            if binary == 0:
                res[f"{branch}_masks_max_abs_err"] = (
                    o_g["pred_masks"].cpu() - o_c["pred_masks"]
                ).abs().max().item()
                res[f"{branch}_wavs_max_abs_err"] = (
                    w_g.cpu() - w_c).abs().max().item()
                res[f"{branch}_metrics_max_db_err"] = db
                same = evaluate.eval_metrics(
                    torch.from_numpy(batch["audios"][..., :L]).to(dev),
                    w_c.to(dev))
                res[f"{branch}_same_input_metrics_max_db_err"] = max(
                    (same[k].cpu() - m_c[k]).abs().max().item()
                    for k in ("sdr", "sir", "sar", "si_sdr"))
            else:
                lin = [unwarp_mask(o["pred_masks"].cpu(), HO=cfg.HS)
                       > cfg.mask_thres for o in (o_c, o_g)]
                res[f"{branch}_binary_mask_agreement"] = (
                    lin[0] == lin[1]).float().mean().item()
                res[f"{branch}_binary_metrics_max_db_err"] = db
    # narrowband references: two sines per clip, singular Grams but for
    # the diagonal loading
    t = torch.arange(L, dtype=torch.float64) / cfg.audRate
    sines = torch.stack([0.4 * torch.sin(2 * np.pi * f * t)
                         for f in (220.0, 330.0)]).float()
    refs = torch.stack([sines, sines.flip(0)])
    ests = refs + 0.05 * torch.randn(refs.shape, generator=gen)
    m_c = evaluate.eval_metrics(refs, ests)
    m_g = evaluate.eval_metrics(refs.to(dev), ests.to(dev))
    narrow = max((m_g[k].cpu() - m_c[k]).abs().max().item()
                 for k in ("sdr", "sir", "sar", "si_sdr"))
    res["narrowband_metrics_max_db_err"] = narrow
    emit("eval_card_vs_cpu", batch=2, aud_len=cfg.audLen, dft=cfg.dft,
         tolerance=EVAL_TOL, **res)
    for key, tol in EVAL_TOL.items():
        name = key.replace("_min", "")
        for k in [name] if name in res else [f"av_{name}", f"ao_{name}"]:
            if (res[k] < tol) if key.endswith("_min") else not res[k] <= tol:
                raise AssertionError(f"eval card vs CPU: {k} {res[k]} "
                                     f"against {tol}")


def script_flags(name: str):
    """The flag strings of the ``args=( ... )`` array of ``scripts/<name>``,
    comments dropped."""
    with open(os.path.join(REPO_DIR, "scripts", name)) as f:
        body = re.search(r"^args=\((.*?)^\)", f.read(), re.S | re.M).group(1)
    return shlex.split("\n".join(line.split("#")[0]
                                 for line in body.splitlines()))


def cli_eval():
    """``python -m avsep_tpu_torch.main --mode eval`` with the flags of
    scripts/eval_MUSIC.sh on data/mini/train.csv, where PIL imports."""
    if importlib.util.find_spec("PIL") is None:
        emit("cli_eval", skipped="PIL is not installed: the CLI's loader "
             "decodes the JPEG frames with PIL")
        return
    manifest = os.path.join("data", "mini", "train.csv")
    argv = script_flags("eval_MUSIC.sh") + [
        "--list_val", manifest, "--num_vis", "0", "--workers", "4",
        "--ckpt", os.path.join(OUT_DIR, "cli")]
    cfg = parse_args(argv)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", "-m", "avsep_tpu_torch.main",
                           *argv], cwd=REPO_DIR, capture_output=True,
                          text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "Evaluation Done!" not in proc.stdout:
        raise AssertionError(f"cli_eval exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(REPO_DIR, manifest)) as f:
        n = cfg.val_repeat * sum(1 for line in f if line.count(",") >= 1)
    run = os.path.join(cfg.ckpt, cfg.id)
    means = {}
    for branch in ("av", "ao"):
        rows = read_results(run, branch)
        vals = [float(r[k]) for r in rows for k in ("sdr", "sir", "si-snr")]
        if len(rows) != n or not np.isfinite(vals).all():
            raise AssertionError(f"cli_eval {branch}: {len(rows)} rows "
                                 f"(expected {n}) or non-finite metrics")
        means[branch] = float(np.mean([float(r["sdr"]) for r in rows]))
    emit("cli_eval", argv=argv, clips=n, wall_s=wall, mean_sdr=means,
         summary=[line for line in proc.stdout.splitlines()
                  if line.startswith("[Eval Summary]")])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(DEVICE)
    emit("card", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         tf32="off for cuDNN convolutions and cuBLAS matmuls")

    t0 = time.perf_counter()
    libs = kernels.build()
    emit("build", seconds=time.perf_counter() - t0,
         libraries=sorted(libs.values()))

    gen = torch.Generator().manual_seed(SEED)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    rows = [check_frame_window(dev, gen, flush),
            check_overlap_add(dev, gen, flush)]
    del flush
    check_ragged(dev, gen)

    sep_launches, nets = run_flagship(dev, gen)
    card_vs_cpu(dev, gen, nets)
    del nets
    launches = {"separate": sep_launches, "train": run_train(dev, gen)}
    train_card_vs_cpu(dev, gen)
    launches["eval"] = run_eval(dev, gen)
    eval_card_vs_cpu(dev, gen)
    cli_eval()

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the sum over the main paths' runs (16 separate calls, 8
    # train steps, 2 x EVAL_BATCHES eval steps), each counted from 0 just
    # before it; by path beside
    table = [{**{k: (sum(p[r["name"]] for p in launches.values())
                     if k == "launches" else r[k]) for k in keys},
              "launches_by_path": {path: p[r["name"]]
                                   for path, p in launches.items()},
              "launches_per_train_step": launches["train"][r["name"]]
              / TRAIN_STEPS,
              "launches_per_eval_step": launches["eval"][r["name"]]
              / (2 * EVAL_BATCHES)}
             for r in rows]
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
