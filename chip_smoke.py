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
   the flagship shapes (B = 16 clips, 65535 samples, n_fft 1022, hop 256),
   with median times from CUDA events (L2 flushed before each launch), the
   time of one PyTorch library call of the same function, and the bound.
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
Then the kernel table as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.ops.stft import _reflect_pad, istft_denominator

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
SEED = 0
DEVICE = "cuda"


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of ``fn`` in ms from CUDA events, with the L2
    cache flushed (a 256 MiB memset) before each run, outside the timed
    window."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
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
    t_plain = time_ms(
        lambda: kernels.frame_window_plain(padded, T, N_FFT, HOP), flush)
    t_lib = time_ms(lambda: padded.unfold(-1, N_FFT, HOP)[:, :T] * win,
                    flush)
    n_bytes = 4 * (padded.numel() + N_FFT + got.numel())
    bnd, by = bound_ms(n_bytes, got.numel())
    row = dict(name="frame_window", route="cuda",
               source="avsep_tpu_torch/csrc/frame_window.cu",
               replaces="avsep_tpu/ops/pallas_kernels.py:138",
               max_abs_err=err, tolerance=0.0, ms=t, plain_ms=t_plain,
               bound_ms=bnd, bound_by=by, library_ms=t_lib,
               shape_in=list(padded.shape), shape_out=list(got.shape))
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
    lib_err = (kernels.overlap_add_normalize(frames, HOP, full_len, denom,
                                             clip=False)
               - library()).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"overlap_add_normalize disagrees with its "
                             f"plain version: max abs err {err}")
    t = time_ms(lambda: kernels.overlap_add_normalize(
        frames, HOP, full_len, denom, clip=False), flush)
    t_plain = time_ms(lambda: kernels.overlap_add_normalize_plain(
        frames, HOP, full_len, denom, clip=False), flush)
    t_lib = time_ms(library, flush)
    n_bytes = 4 * (frames.numel() + full_len + rows * full_len)
    n_ops = frames.numel() + rows * full_len       # adds, one divide each
    bnd, by = bound_ms(n_bytes, n_ops)
    row = dict(name="overlap_add_normalize", route="cuda",
               source="avsep_tpu_torch/csrc/overlap_add.cu",
               replaces="avsep_tpu/ops/pallas_kernels.py:71",
               max_abs_err=err, tolerance=1e-6, ms=t, plain_ms=t_plain,
               bound_ms=bnd, bound_by=by, library_ms=t_lib,
               library_max_abs_err=lib_err,
               shape_in=list(frames.shape), shape_out=[rows, full_len])
    emit("kernel", **row)
    return row


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
    """torch.profiler over ``calls`` flagship calls: device ms per call by
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
            engine.separate(nets, audio[i], frames[i], cfg)
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
    emit("profile", calls=calls, batch=B, wall_ms_per_call=wall_us * per_call,
         device_busy_ms_per_call=busy * per_call,
         device_idle_share=max(0.0, 1.0 - busy / wall_us),
         ops_ms_per_call=[[k, us * per_call, n // calls]
                          for k, us, n in ops[:12]],
         kernels_ms_per_call=[[k[:80], us * per_call]
                              for k, us in kernels_top[:16]])


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

    launches, nets = run_flagship(dev, gen)
    card_vs_cpu(dev, gen, nets)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    table = [{k: (launches[r["name"]] if k == "launches" else r[k])
              for k in keys} for r in rows]
    print(json.dumps({"kernels": table}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
