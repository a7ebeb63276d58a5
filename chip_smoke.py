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
   motion_stem: the motion net's bfloat16 stem kernels (forward, weight
   gradient) against their plain version on the card at the clips cell's
   shape (one source's ``[:, n]`` view of 16 clips of 32 x 224 x 224
   uint8), within the tolerance of tests/test_torch_motion_stem.py; two
   weight gradients bit for bit; the times of the kernels, of the plain
   version and of cuDNN's bf16 convolution alone (``library_ms``), and of
   cuDNN on two tensor-core shapes (the 3 input channels padded to 8; the
   5 temporal taps folded into 15 channels of a 2-D convolution), per
   call and per AV step (two calls), and the bound.  ``--only
   motion_stem`` runs it alone, and counts no launches: the main paths
   below count the stem's.
   motion_bn: the motion net's bfloat16 BatchNorm kernels (with the ReLU
   and the residual add; forward and backward) against their plain version
   on the card at each of the net's 53 BatchNorm calls at the clips cell's
   shape (16 clips of 32 x 224 x 224), within the tolerances of
   tests/test_torch_motion_bn.py; two calls bit for bit; the times per AV
   step (2 x 53 calls) of the kernels, of their byte bound, of the plain
   version and of ``F.batch_norm`` with its autograd backward
   (``library_ms``).  ``--only motion_bn`` runs it alone.
   motion_bn_slowfast: the same at SlowFast R50's 106 BatchNorm calls (the
   slow pathway's 64 to 2048 channels on 4 frames beside the fast
   pathway's), 2 x 106 per AV step.
   motion_bn_x3d: the same at the 68 BatchNorm calls of X3D-M the kernels
   take (16 clips of 16 x 224 x 224; 24 to 432 channels, 3 to 54 threads
   a row; each block's bn2 without a ReLU or residual), 2 x 68 per AV
   step.
   motion_conv_t3: the motion net's bfloat16 3x1x1 convolution kernels
   (forward, input gradient through the reversed taps, weight gradient)
   against their plain version on the card at each of the fast pathway's
   16 conv1 shapes at the clips cell (16 clips of 32 frames on 56 x 56 to
   7 x 7), within the tolerances of tests/test_torch_motion_conv.py; two
   calls bit for bit; the times per AV step (2 x 16 calls of each pass) of
   the kernels, of their byte bound, of the plain version and of cuDNN's
   bf16 ``F.conv3d`` and ``convolution_backward`` (``library_ms``).
   ``--only motion_conv_t3`` runs it alone.
   slowfast_pathways: SlowFast R50 in train mode on 16 clips of 32 x 224 x
   224 against benchmark/reference/slowfast.py in float32, per pathway
   (slow map, fast map, the fc's pooled map): the float32 net within
   PATHWAY_TOL of the reference's norm; a zeroed last lateral and slow
   frames taken from frame 1 each read above it on the slow and pooled
   maps and within it on the fast map; the bfloat16 net read beside the
   reference's own bfloat16.
   x3d_pathway: X3D-M in train mode on 16 clips of 16 x 224 x 224 against
   benchmark/reference/x3d.py in float32 (the map after conv5, the pooled
   map): within X3D_TOL; every gate fixed at 1, or the channelwise
   convolutions' off-centre temporal taps zeroed, each read above it; the
   bfloat16 net read beside the reference's own bfloat16.  ``python3
   chip_smoke.py --only x3d_pathway`` runs it alone.
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
   separate_bf16: the same flagship in bfloat16 (``--dtype bfloat16``)
   from the separate phase's weights, on its inputs: clips/s, the share of
   binary-mask bins that agree with the float32 calls and the largest
   difference of the waveforms (recorded, not bounded), one launch of each
   kernel per call.
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
   for bit as it was; the parameters and momentum buffers stay float32
   and move.
   train_profile: torch.profiler over one more AV step.
   train_bf16, train_bf16_profile: the same in the script's own bfloat16
   (``--dtype bfloat16 --dft matmul``), the float32 phase its A/B partner.
   remat: one AV step at B = 16 with and without ``remat`` from the same
   weights and batch: losses, momentum buffers and running statistics
   within ``TRAIN_TOL`` (whether the buffers are equal bit for bit is
   reported), then timed steps of each: ms per step and peak memory.
7. train_card_vs_cpu: one AV and one AO step at a small size (unet5,
   resnet18dilated-256 on 64x64 frames, 16383 samples, B = 2, dft "fft",
   binary_mask 0) from the same weights and batches on the card and on
   the CPU: losses, parameters, momentum buffers and BatchNorm running
   statistics within ``TRAIN_TOL``, group counts equal.
   bf16_card_vs_cpu: the same in bfloat16, within ``BF16_TOL``.
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
10. cli_eval: ``python -m avsep_tpu_torch.main --mode eval`` with the
   flags of scripts/eval_MUSIC.sh on data/mini/train.csv, ``--num_vis 0``,
   checkpoints and results under build/: exit 0, one finite results.csv
   row per clip in each branch.  PIL must import.
11. serve: ``serve.SeparationService`` with serve.main's defaults
   (config.FLAGSHIP, max_batch 8, max_wait 5 ms) behind a TCP server on
   loopback; 8 closed-loop clients send 64 requests, half AV with uint8
   frames, after a warm-up dispatch per group: requests/s, request and
   dispatch p50 / p95, mean batch, peak memory; one launch of each kernel
   per dispatch; one AO and one AV dispatch bit for bit against a direct
   ``engine.separate`` on the same padded batch and draws; the int16 wire
   over 30 dB SNR against f32.
12. separate_cli, inference (vis, share, sweep, synthesis with the flags
   of scripts/inference.sh on manifests written from data/mini) and, at
   the end, pixelwise (scripts/vis_sound_map.sh): ``python -m`` runs in
   child processes that report their kernels' launches and both TF32
   flags (``run_module``); exit 0, their files, TF32 off, one launch of
   each kernel per separate() call (pixelwise: one frame_window, no
   iSTFT); separate_cli's wavs against the same run on the CPU within
   1e-4.
   vis_t180: ``inference.vis_video`` on a synthetic 30 fps clip, 180
   display frames in one separate() call: wall, peak memory, launches.
13. sop_train: scripts/train_SoPpp.sh at full width on one card (B = 16,
   float32, TF32 off): a warm-up step of each kind (AO, AV stages 1, 2,
   3), then 3 timed steps of each; ms per step by kind, samples/s, peak
   memory; frame_window twice per step, finite losses, AO steps leave the
   frame net and the frame group's momentum bit for bit.
   sop_card_vs_cpu: one step of each kind at a small size, card against
   CPU, within ``SOP_TOL``, under ``settled_cudnn`` (cuDNN's deterministic
   algorithms after the allocator's cache is emptied, so the reading does
   not move with the phases run before).
   sop_cli: ``python -m avsep_tpu_torch.sop_main --mode train`` with the
   script's flags on data/mini/train.csv, iterations 1 to 3 and an eval:
   "Training Done!", one finite row per clip and branch, launches 2 per
   train step and 3 + 1 per eval step.
14. cli_train: ``python -m avsep_tpu_torch.main --mode train`` with the
   flags of scripts/train_MUSIC.sh unchanged (``--dtype bfloat16 --dft
   matmul``, B = 2 x 16 on the one card) on data/mini/train.csv, cut to
   iterations 1 to CLI_TRAIN_ITERS with a loss line every second one:
   "Training Done!", finite losses, TF32 off, 2 frame_window launches per
   step.
15. clipatt_train, clipatt_train_bf16: scripts/train_MUSIC.sh with
   ``--fusion_type CoLoc_ClipAtt --load_clips`` at full width (unet7, the
   fast pathway at base 8 with stages [3, 4, 6, 3], clip_len 32 at
   224x224 per source, B = 16) in float32 and in bfloat16: 2 warm-up
   steps, then timed AV and AO steps, ms per step of each kind, samples/s,
   peak memory; frame_window twice per step, finite losses, an AV step
   leaving the frame net and group bit for bit, an AO step the frame and
   motion nets and groups; the motion stem's pair twice per AV step in
   bfloat16 and never in an AO step or in float32; one profiled AV step
   each, with the 3-D convolutions' share of the device time.
   slowfast_train_bf16: clipatt_train_bf16 with ``--arch_motion
   slowfast_r50`` (SlowFast R50, both pathways and their laterals): the
   stem's pair twice and the BatchNorm pair 2 x 106 times per AV step,
   never per AO step; each slow stage's input channels-last-3d and dense.
   ``python3 chip_smoke.py --only slowfast_train_bf16`` runs it alone,
   after motion_bn_slowfast and slowfast_pathways (phase 3).
   x3d_train_bf16: clipatt_train_bf16 with ``--arch_motion x3d_m`` (X3D-M,
   16-frame clips): the BatchNorm pair 2 x 68 times per AV step (every
   norm but the 16 of 54 and 108 channels), no stem or 3x1x1 launch, none
   per AO step; every convolution's input but the gates' channels-last-3d
   and dense, the outputs in another layout named.  ``python3
   chip_smoke.py --only x3d_train_bf16`` runs it after motion_bn_x3d.
   clipatt_eval: AV and AO eval steps with clips (eval_MUSIC.sh +
   CoLoc_ClipAtt, B = 16, float32): ms per step, 3 + 1 launches per step,
   no stem launch.
   clipatt_card_vs_cpu: one AV and one AO step of the clips branch at a
   small size (unet5, the full-width fast pathway on 4 x 64 x 64 clips,
   B = 2), card against CPU under ``settled_cudnn``, within
   ``CLIPATT_TOL``.
16. native: the C++ host path built from native/ (time of each library),
   the route ``--frame_decode auto`` takes, frame_pipeline_batch against
   PIL bit for bit on every data/mini jpg, the decode rates of C++ and
   PIL over one clip batch on the host CPU (named).  The audio library
   must build; a frames library that cannot (no libjpeg) is said on a
   line of its own, and the CLI phase then runs with ``pil``.
17. cli_clipatt: ``python -m avsep_tpu_torch.main --mode train`` with
   train_MUSIC.sh's flags plus ``--fusion_type CoLoc_ClipAtt --load_clips
   --frame_decode native`` on data/mini (cuts stated in its line): the
   route printed, finite losses, one eval, 2 launches per train step and
   3 + 1 per eval step, the stem's forward 2 per AV train or eval step and
   its weight gradient 2 per AV train step, TF32 off.
18. Data parallelism (avsep_tpu_torch/parallel/), each path in child
   processes of this script (``--dist-child``) that count their own
   kernels' launches.  NCCL refuses two ranks on one card, so the two
   ranks run gloo on CUDA tensors, through the host; the compute mode
   must let two processes share the card.
   dist_train: two ranks, train_MUSIC.sh's float32 recipe at full width,
   B = 16 global (8 rows each), from spread_weights, 2 AV and 2 AO steps:
   per-rank ms per step and peak memory, the ranks' states bit for bit
   equal, and rank 0, after leaving the group, against one process on
   the same global batches within ``DIST_TOL``; 2 frame_window launches
   per step and rank.
   dist_eval: the same ranks' eval sweeps (eval_MUSIC.sh's recipe) over
   16 + 16 + a ragged 8 clips: the gathered meters equal on both ranks
   and within ``DIST_METER_TOL`` of one process's sweep, one finite
   results.csv row per clip from rank 0; 3 + 1 launches per eval step.
   dist_nccl: a one-rank NCCL group through the same sweep (bit for bit
   against no group) and an AV and an AO step (``DIST_TOL``).
   cli_dist: ``main.main`` with train_MUSIC.sh's float32 recipe in two
   ranks that joined a gloo group first, ``replicate`` and ``shard``, and
   in one process, at once: iterations 1 to 3 and an eval; the replicate
   history within ``CLI_DIST_TOL`` of one process's, rank 1 writing
   nothing under the checkpoint directory.
19. cli_launch (avsep_tpu_torch/parallel/launch.py: one command over the
   cards it names, one rank per card), train_MUSIC.sh's float32 recipe
   with cli_dist's cuts and ``--num_gpus 2`` (B = 2 x 2):
   cli_launch_clamp: ``python -m avsep_tpu_torch.main`` shown one card
   (CUDA_VISIBLE_DEVICES) prints width 1 and runs in its own process (its
   own counters see every launch); its history within ``CLI_DIST_TOL`` of
   ``main.main`` alone in a child.
   cli_launch_gloo: ``launch.run`` with ``n_local=2`` and gloo, two ranks
   sharing the card, iterations 1 to 5: per-rank ms per AV and AO step,
   peak memory and launches (2 per train step, 3 + 1 per eval step), TF32
   off in each rank, rank 1 writing nothing, iterations 1 to 3 and the
   eval within ``CLI_DIST_TOL`` of the same reference.
   cli_launch_fail (run beside cli_launch_clamp): a launch whose rank 1
   raises exits non-zero within ``LAUNCH_FAIL_DEADLINE_S`` and leaves no
   rank.
   cli_launch_nccl: with two or more cards, ``--num_gpus 2`` as two NCCL
   ranks on two cards, as cli_launch_gloo; with one card, a line saying it
   did not run and why.  ``python3 chip_smoke.py --only cli_launch`` runs
   this phase alone (for a machine with several cards).
20. proof_tools (avsep_tpu_torch/tools/): on a toy class-token set built
   by ``tools.make_synthetic_data`` (4 classes x 3 videos), ``main.main``
   trains the toy AV recipe of scripts/train_toy_av_proof_torch.sh at full
   width (unet7, resnet18dilated-256, hidsep/sig, B = 16, float32) for a
   few iterations and one eval; ``tools.av_probe`` probes its best
   checkpoint (every key of the JAX report, ``pointing_n == 2 * perm_n``,
   finite SI-SDRs, the kernels' launches); ``tools.export_reference_ckpt``
   writes its ``.pth`` files, read back into fresh nets bit for bit;
   ``sop_main`` trains scripts/train_SoPpp.sh's width for 3 iterations and
   ``tools.sop_probe`` probes it (the same checks, and the export with
   ``--sop``); ``tools.schedule_proof`` runs its 201 iterations and must
   hold every invariant; ``python -m avsep_tpu_torch.tools.bench_loader``
   prints the host loader's clips/s at B = 16 beside the train phase's AV
   and AO samples/s.  ``python3 chip_smoke.py --only proof_tools`` runs
   this phase alone.
21. measure_tools (avsep_tpu_torch/tools/, slice 11): the measurement
   tools at flagship width, each cut short (``measure_tools``): ``python -m
   ...tools.bench`` in a child (its JSON line: bench.py's keys,
   ``vs_baseline`` null), ``serve_bench`` audio-only and AV, a 3-point
   ``latency_report``, ``train_throughput``, ``mfu_report`` (the hand count
   equal to FlopCounterMode on every forward piece, every MFU share at most
   1), ``memory_report`` (f32, remat off, a small budget) and
   ``sep_dtype_ab``: every number finite, 1 / 1 launches per ``separate``
   call and 2 / 0 per train step.  ``python3 chip_smoke.py --only
   measure_tools`` runs this phase alone.
22. trace_tools (avsep_tpu_torch/tools/, slice 12), each tool as a
   ``python -m`` child: ``trace_report`` at flagship width, B = 16, 2
   profiled f32 ``fft`` and 2 bf16 ``matmul`` steps (category shares
   summing to 100, busy at most the wall, the profile's frame_window
   launches equal to its counter's, 2 per step); ``insitu_report
   --batch 16 --n 4`` with ``--workers 0`` and ``4`` on a class-token set
   at 360x640: every key of the JAX
   report, every number finite, arm A's CUDA-graph replay against an
   eager step within ``TRAIN_TOL["loss_rel_err"]``, 2 / 0 launches per
   step.  ``python3 chip_smoke.py --only trace_tools`` runs this phase
   alone.
Every main path's launches are counted for the counter of every kernel
of ``kernels.SOURCES``; a path that names no stem launches must show none.
Then the kernel table as one JSON line, a row per counted kernel
(launches summed over the main paths' runs, by path and per call), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import csv
import importlib.util
import json
import os
import re
import shlex
import shutil
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

from avsep_tpu_torch import config, engine, evaluate, train
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.loader import BatchLoader
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.ops.stft import _reflect_pad, istft_denominator
from avsep_tpu_torch.ops.warp import unwarp_mask
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.parallel import launch
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
# scripts/train_MUSIC.sh on one card: the train phase in float32 (the
# parity envelope), train_bf16 in the script's own --dtype bfloat16
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
# bf16_card_vs_cpu: TRAIN_SMALL's AV and AO steps in bfloat16, the same
# quantities.  Two bfloat16 implementations round some conv outputs the
# other way (cuDNN and oneDNN sum in other orders), and an element that
# rounds differently moves every later layer by up to 2^-8 of its scale.
# On an H100 (NVIDIA H100 80GB HBM3, 700 W; tools/card_vs_cpu_spread.py
# bf16, seeds 0 to 5, and chip_smoke's own draw) this read at most: losses
# 2.9e-4; momentum buffers 5.3e-2 over all buffers and 0.57 per buffer in
# L2 norm (the frame net's BatchNorm biases, 2 x 32 to 2 x 1568 values per
# channel); parameters 0.61 of their change (frame.fc.weight, which moves
# 0.3 % of the largest change); running statistics 8.7e-3.  The limits are
# 3.4x, 2.8x, 1.8x, 1.6x and 2.3x those readings.
BF16_TOL = {"loss_rel_err": 1e-3, "momentum_global_l2_err": 0.15,
            "momentum_l2_err": 1.0, "param_err": 1.0, "bn_stats_err": 2e-2}
# remat: timed steps of each kind after the compared one
REMAT_TIMED = 3
# cli_train: iterations 1 .. CLI_TRAIN_ITERS of train_MUSIC.sh (of 95000)
CLI_TRAIN_ITERS = 4
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
# serve: serve.main's defaults (config.FLAGSHIP, max_batch 8, max_wait 5 ms),
# closed-loop TCP clients on loopback, half of them AO and half AV
SERVE = dict(max_batch=8, max_wait_ms=5.0)
SERVE_CLIENTS, SERVE_REQUESTS = 8, 64
# the mini duet clips and their frames (6.5 s at 11025 Hz, 28 jpgs at 4 fps)
DUET_DIR = os.path.join("data", "mini", "audio_duet", "cello flute")
DUET_FRAMES = os.path.join("data", "mini", "frames_duet", "cello flute")
# vis_video at a 30 fps window: 6 s x 30 display frames
VIS_FPS = 30
# sop_train: each kind of step (AO, AV at stages 1, 2, 3), SOP_WARMUP
# warm-up steps and SOP_STEPS timed steps of each, interleaved
SOP_KINDS = ((False, 1), (True, 1), (True, 2), (True, 3))
SOP_WARMUP, SOP_STEPS = 1, 3
# sop_card_vs_cpu: the SoP++ recipe at unet5 (ngf 64), resnet18dilated-32 on
# 64x64 frames, 16383 samples, B = 2, soft masks, one step of each kind
SOP_SMALL = dict(arch_sound="unet5", audLen=16383, imgSize=64, binary_mask=0,
                 batch_size_per_gpu=2)
# card vs CPU after an AV stage-1, an AO, an AV stage-2 and an AV stage-3
# step from the same He-scaled weights: the quantities and their reasons as
# TRAIN_TOL, under settled_cudnn.  On an H100 (NVIDIA H100 80GB HBM3,
# 700.00 W; tools/card_vs_cpu_spread.py sop, seeds 0 to 5, alone and in
# place in a whole run, and chip_smoke's own draw) this read at most:
# losses 2.3e-7; parameters 1.57e-2 of their change (the U-Net's
# down3 / down2 convs, which move 0.4 to 0.6 % of the largest change);
# momentum buffers 8.69e-3 per buffer (the dilated ResNet's layer1 / 3 /
# 4) and 1.23e-3 over all buffers in L2 norm; running statistics 1.4e-6.
# The port on the CPU against JAX on the CPU, on the same draws
# (tools/port_vs_jax_spread.py sop), reads the same buffers as far or
# farther: 1.26e-2 per buffer, 1.33e-3 over all.  The parameter and
# momentum limits are 1.9x to 2.0x the largest readings; loss and
# statistics keep TRAIN_TOL's (43x, 71x).
SOP_TOL = dict(TRAIN_TOL, param_err=3e-2, momentum_l2_err=1.75e-2,
               momentum_global_l2_err=2.5e-3)


def fork(gen: torch.Generator) -> torch.Generator:
    """A generator in ``gen``'s state: the same draws, ``gen`` untouched."""
    g = torch.Generator()
    g.set_state(gen.get_state())
    return g


def nets_of(nets):
    """The modules of a ``Nets`` / ``SopNets`` tuple, in field order, without
    the absent motion net."""
    return [net for _, net in train.modules(nets)]


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


def graphed_ms(fn, flush: torch.Tensor) -> float:
    """:func:`time_ms` of one replay of ``fn`` captured in a CUDA graph:
    the card's time for its kernels and the gaps between them, without
    the host's time to issue them (a graphed train step issues none)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, flush)


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


# the motion stem at the clips cell: one source of an AV step's batch
STEM_CLIPS = (16, 32, 224, 224)
# the motion net's kernels, and its BatchNorm calls per clip batch
MOTION_KERNELS = ("motion_stem", "motion_stem_wgrad", "motion_bn",
                  "motion_bn_backward", "motion_conv_t3",
                  "motion_conv_t3_wgrad")
MOTION_BNS = 53
# the fast pathway's 3x1x1 conv1s per clip batch (motion_conv_t3)
MOTION_T3S = 16
BF16_FLOPS_PER_S = 989e12


def _stem_error(got, want, magnitudes, chain):
    """The largest error of ``got`` against ``want`` over its tolerance,
    and the median of the tolerance as a share of ``want``'s magnitude:
    each side's bfloat16 rounding (2^-8 of its value) plus ``chain``
    float32 roundings of the summed magnitudes, twice (one per summation
    order); an exact zero against an exact zero reads 0."""
    got, want = got.float(), want.float()
    tol = 2.0 ** -7 * torch.maximum(got.abs(), want.abs()) \
        + 2 * chain * 2.0 ** -24 * magnitudes
    err = (got - want).abs()
    share = (tol / want.abs())[want != 0]
    return (float(torch.where(err == 0, 0.0, err / tol).max()),
            float(share.median()))


def _stem_library_variants(x, wb, grad):
    """The cuDNN stem on a tensor-core shape, two ways, from the stem's
    bfloat16 input ``x`` [B, 3, T, H, W]: the 3 input channels zero-padded
    to 8 (a Conv3d), and the 5 temporal taps folded into 15 channels of a
    2-D convolution over B * T frames.  Each as (forward, weight gradient
    as [8, 3, 5, 7, 7] float32, the two calls to time); the padded or
    folded input is made once, outside the timed calls."""
    import torch.nn.functional as F
    stride, pad = kernels.STEM_STRIDE, kernels.STEM_PADDING
    B, C, T, H, W = x.shape
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 0, 8 - C)).contiguous(
        memory_format=torch.channels_last_3d)
    wp = F.pad(wb, (0, 0, 0, 0, 0, 0, 0, 8 - C)).contiguous(
        memory_format=torch.channels_last_3d)
    xt = F.pad(x, (0, 0, 0, 0, 2, 2))
    xf = torch.stack([xt[:, :, k:k + T] for k in range(5)], 1) \
        .permute(0, 3, 1, 2, 4, 5).reshape(B * T, 5 * C, H, W) \
        .contiguous(memory_format=torch.channels_last)
    wf = wb.permute(0, 2, 1, 3, 4).reshape(8, 5 * C, 7, 7).contiguous(
        memory_format=torch.channels_last)
    gf = grad.permute(0, 2, 1, 3, 4).reshape(B * T, 8, *grad.shape[-2:]) \
        .contiguous(memory_format=torch.channels_last)

    def padded_wgrad():
        return torch.ops.aten.convolution_backward(
            grad, xp, wp, None, stride, pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False))[1]

    def folded_wgrad():
        return torch.ops.aten.convolution_backward(
            gf, xf, wf, None, (2, 2), (3, 3), (1, 1), False, (0, 0), 1,
            (False, True, False))[1]

    def folded():
        return F.conv2d(xf, wf, None, (2, 2), (3, 3))

    def padded():
        return F.conv3d(xp, wp, None, stride, pad)

    out = {"padded": (padded(), padded_wgrad()[:, :C].float(),
                      padded, padded_wgrad),
           "folded": (folded().reshape(B, T, 8, *grad.shape[-2:])
                      .permute(0, 2, 1, 3, 4),
                      folded_wgrad().reshape(8, 5, C, 7, 7)
                      .permute(0, 2, 1, 3, 4).float(), folded, folded_wgrad)}
    return out


def check_motion_stem(dev, flush):
    """``kernels.motion_stem`` and ``motion_stem_wgrad`` at the clips cell's
    shape (phase ``motion_stem``), from a generator of their own, against
    their plain version; beside them cuDNN's bfloat16 Conv3d as the net ran
    it (``library_ms``) and on the two tensor-core shapes of
    :func:`_stem_library_variants`.  The output gradient has mean 1, so
    that the weight gradient's sums do not cancel and its tolerance stays
    a small share of each value.  Returns the table's two rows."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(SEED)
    B, T, H, W = STEM_CLIPS
    batch = torch.randint(0, 256, (B, 2, T, H, W, 3), dtype=torch.uint8,
                          device=dev, generator=g)
    clips = batch[:, 0]
    fan_out = kernels.STEM_WEIGHT[0] * 5 * 7 * 7
    w = torch.randn(kernels.STEM_WEIGHT, device=dev, generator=g) * \
        (2.0 / fan_out) ** 0.5
    OH, OW = (H + 1) // 2, (W + 1) // 2
    grad = (torch.randn((B, 8, T, OH, OW), device=dev, generator=g)
            + 1.0).bfloat16()
    stride, pad = kernels.STEM_STRIDE, kernels.STEM_PADDING
    x = kernels._stem_input(clips)
    wb = w.bfloat16()

    def library_wgrad():
        return torch.ops.aten.convolution_backward(
            grad, x, wb, None, stride, pad, (1, 1, 1), False, (0, 0, 0), 1,
            (False, True, False))[1]

    got = kernels.motion_stem(clips, w)
    plain = kernels.motion_stem_plain(clips, w)
    mags = F.conv3d(x.float().abs(), wb.float().abs(), None, stride, pad)
    err, share = _stem_error(got, plain, mags, 735)
    gw = kernels.motion_stem_wgrad(clips, grad, w)
    gw_plain = kernels.motion_stem_wgrad_plain(clips, grad, w)
    mags_w = torch.ops.aten.convolution_backward(
        grad.float().abs(), x.float().abs(), wb.float().abs(), None, stride,
        pad, (1, 1, 1), False, (0, 0, 0), 1, (False, True, False))[1]
    err_w, share_w = _stem_error(gw, gw_plain, mags_w, 1024)
    repeats = torch.equal(gw, kernels.motion_stem_wgrad(clips, grad, w))
    abs_err = [float((a.float() - b.float()).abs().max())
               for a, b in ((got, plain), (gw, gw_plain))]
    torch.cuda.synchronize()
    if err > 1.0 or err_w > 1.0 or not repeats:
        raise AssertionError(f"motion_stem disagrees with its plain version: "
                             f"forward {err}, weight gradient {err_w} of "
                             f"their tolerances; repeats {repeats}")
    del got, gw
    # cuDNN on tensor-core shapes, held to the plain version as the kernel
    variants = _stem_library_variants(x, wb, grad)
    variant_err = {k: [_stem_error(v[0], plain, mags, 735)[0],
                       _stem_error(v[1], gw_plain, mags_w, 1024)[0]]
                   for k, v in variants.items()}
    del plain, gw_plain, mags, mags_w
    t = {"ms": lambda: kernels.motion_stem(clips, w),
         "plain_ms": lambda: kernels.motion_stem_plain(clips, w),
         "library_ms": lambda: F.conv3d(x, wb, None, stride, pad),
         "wgrad_ms": lambda: kernels.motion_stem_wgrad(clips, grad, w),
         "wgrad_plain_ms": lambda: kernels.motion_stem_wgrad_plain(
             clips, grad, w),
         "wgrad_library_ms": library_wgrad}
    for k, v in variants.items():
        t[f"library_{k}_ms"], t[f"wgrad_library_{k}_ms"] = v[2], v[3]
    ms = {k: time_ms(fn, flush) for k, fn in t.items()}
    del variants
    t_fill = time_ms(lambda: grad.fill_(1.0), flush)
    flops = 2 * B * T * OH * OW * 8 * 735
    n_out = 2 * B * T * OH * OW * 8
    bounds = {"ms": max(flops / BF16_FLOPS_PER_S,
                        (clips.numel() + n_out) / HBM_BYTES_PER_S) * 1e3,
              "wgrad_ms": max(flops / BF16_FLOPS_PER_S,
                              (clips.numel() + n_out + 4 * w.numel())
                              / HBM_BYTES_PER_S) * 1e3}
    emit("kernel", name="motion_stem", route="cuda",
         source="avsep_tpu_torch/csrc/motion_stem.cu",
         replaces="none (cuDNN's bf16 Conv3d of the motion net's stem)",
         max_err_over_tol=err, wgrad_max_err_over_tol=err_w,
         max_abs_err=abs_err[0], wgrad_max_abs_err=abs_err[1],
         tol_share_of_value=share, wgrad_tol_share_of_value=share_w,
         library_variants_err_over_tol=variant_err,
         wgrad_repeats=repeats, shape_in=list(clips.shape),
         strides_in=list(clips.stride()), shape_out=[B, 8, T, OH, OW],
         flops_per_pass=flops, bound_by="operations", **ms,
         bound_ms=bounds["ms"], share_of_bound=bounds["ms"] / ms["ms"],
         wgrad_bound_ms=bounds["wgrad_ms"],
         wgrad_share_of_bound=bounds["wgrad_ms"] / ms["wgrad_ms"],
         tflops=flops / ms["ms"] / 1e9,
         wgrad_tflops=flops / ms["wgrad_ms"] / 1e9,
         per_av_step={k: 2 * v for k, v in ms.items()},
         fill_grad_ms=t_fill, nvidia_smi=nvidia_smi_line())
    # the kernels line's rows, one per counted kernel
    common = dict(route="cuda", source="avsep_tpu_torch/csrc/motion_stem.cu",
                  bound_by="operations")
    return [dict(common, name="motion_stem",
                 replaces="none (cuDNN's bf16 Conv3d of the motion net's "
                 "stem)", max_abs_err=abs_err[0], ms=ms["ms"],
                 plain_ms=ms["plain_ms"], bound_ms=bounds["ms"],
                 library_ms=ms["library_ms"]),
            dict(common, name="motion_stem_wgrad",
                 replaces="none (cuDNN's bf16 weight gradient of the motion "
                 "net's stem)", max_abs_err=abs_err[1], ms=ms["wgrad_ms"],
                 plain_ms=ms["wgrad_plain_ms"], bound_ms=bounds["wgrad_ms"],
                 library_ms=ms["wgrad_library_ms"])]


def motion_bn_bytes(n: int, relu: bool, res: bool):
    """The bytes a ``motion_bn`` call and its backward must move for ``n``
    elements (csrc/motion_bn.cu's note): statistics read x, apply reads x
    (and the residual) and writes y; the backward reduce reads dy and x
    (and the residual under the ReLU, for the mask), the elementwise pass
    reads the same and writes dx (and the residual's gradient)."""
    mask = 2 * (relu and res)
    return (2 + 4 + 2 * res) * n, (4 + mask + 6 + mask + 2 * res) * n


def check_motion_bn(dev, flush, arch: str = "slowfast_fast"):
    """``kernels.motion_bn`` and ``motion_bn_backward`` at every BatchNorm
    call of the motion net ``arch`` that takes them (phase ``motion_bn``:
    the fast pathway at the clips cell, one source's 16 clips of 32 x 224 x
    224, 53 calls, 16 distinct; ``slowfast_r50``, phase
    ``motion_bn_slowfast``: SlowFast R50's 106 calls, the slow pathway's 64
    to 2048 channels on 4 frames beside the fast pathway's; ``x3d_m``,
    phase ``motion_bn_x3d``: X3D-M's 68 calls of whole 8-channel groups at
    16 clips of 16 x 224 x 224, 24 to 432 channels, each block's ``bn2``
    without a ReLU), each against its plain version within the tolerances
    of tests/test_torch_motion_bn.py, and two calls bit for bit; then the
    times of each distinct call, summed per AV step (2 sources x 53, 106 or
    68 calls): the kernels, their byte bound, the plain version (BatchNorm,
    the add and the ReLU as the net ran them, forward; autograd through
    them, backward) and ``F.batch_norm`` alone with its autograd backward
    (``library_ms``), each a CUDA graph's replay (:func:`graphed_ms`), as
    the graphed step runs them.  Returns the table's two rows, per AV
    step."""
    import torch.nn.functional as F

    from avsep_tpu_torch.models.motion import (
        ResNet3dFastOnly, ResNet3dSlowFast)
    from tests.test_torch_motion_bn import (
        activation, bn_module, bn_shapes, errors_over_tolerance,
        output_grad, x3d_cases)
    phase, norms = {"slowfast_fast": ("motion_bn", MOTION_BNS),
                    "slowfast_r50": ("motion_bn_slowfast", 2 * MOTION_BNS),
                    "x3d_m": ("motion_bn_x3d", X3D_BNS)}[arch]
    if arch == "x3d_m":
        calls = [c for c in x3d_cases() if kernels.motion_bn_fits(c[1][1])]
    else:
        calls = bn_shapes(*STEM_CLIPS, ResNet3dSlowFast
                          if arch == "slowfast_r50" else ResNet3dFastOnly)
    cases = {}
    for _, shape, relu, res in calls:
        cases[(shape, relu, res)] = cases.get((shape, relu, res), 0) + 1
    per_av = {k: 0.0 for k in ("ms", "backward_ms", "plain_ms",
                               "plain_backward_ms", "library_ms",
                               "library_backward_ms", "bound_ms",
                               "backward_bound_ms")}
    rows, worst, repeats, flips = [], {}, True, 0
    for i, ((shape, relu, res), n) in enumerate(sorted(cases.items())):
        x = activation(shape, SEED + i, dev)
        bn = bn_module(shape[1], SEED + i).to(dev)
        w, b, eps = bn.weight, bn.bias, bn.eps
        residual = activation(shape, SEED + i + 1, dev, 1.0) if res \
            else None
        grad = output_grad(x, torch.Generator(device=dev).manual_seed(i))
        err, nflip, (y, mean, var), gb = errors_over_tolerance(
            x, w, b, eps, relu, residual, grad)
        flips += nflip
        for k, (r, _) in err.items():
            worst[k] = max(worst.get(k, 0.0), r)
        with torch.no_grad():
            again = kernels.motion_bn(x, w, b, eps, relu, residual)
            again += kernels.motion_bn_backward(grad, x, w, b, mean, var,
                                                eps, relu, residual)
        repeats &= all(torch.equal(p, q) for p, q in
                       zip((y, mean, var) + tuple(gb), again))
        del y, gb, again
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]

        def no_grad(fn):
            def call():
                with torch.no_grad():
                    return fn()
            return call

        def with_backward(forward):
            # autograd runs a backward on its forward's stream, so the
            # graph holds both; the backward's time is the difference
            def call():
                with torch.enable_grad():
                    return torch.autograd.grad(forward(), leaves, grad)
            return call

        def plain():
            return kernels.motion_bn_plain(*leaves, eps, relu, residual)[0]

        def library():
            return F.batch_norm(leaves[0], None, None, leaves[1], leaves[2],
                                True, 0.0, eps)

        t = {"ms": no_grad(lambda: kernels.motion_bn(
                 x, w, b, eps, relu, residual)),
             "backward_ms": no_grad(lambda: kernels.motion_bn_backward(
                 grad, x, w, b, mean, var, eps, relu, residual)),
             "plain_ms": no_grad(plain),
             "plain_backward_ms": with_backward(plain),
             "library_ms": no_grad(library),
             "library_backward_ms": with_backward(library)}
        ms = {k: graphed_ms(fn, flush) for k, fn in t.items()}
        for k in ("plain", "library"):
            ms[f"{k}_backward_ms"] -= ms[f"{k}_ms"]
        fwd_bytes, bwd_bytes = motion_bn_bytes(x.numel(), relu, res)
        ms["bound_ms"] = fwd_bytes / HBM_BYTES_PER_S * 1e3
        ms["backward_bound_ms"] = bwd_bytes / HBM_BYTES_PER_S * 1e3
        for k in per_av:
            per_av[k] += 2 * n * ms[k]
        rows.append({"shape": list(shape), "relu": relu, "residual": res,
                     "calls_per_source": n, **ms})
        del x, residual, grad, leaves, mean, var
        torch.cuda.empty_cache()
    if any(r > 1.0 for r in worst.values()) or not repeats:
        raise AssertionError(f"{phase}: motion_bn disagrees with its plain "
                             f"version: {worst} of the tolerances; repeats "
                             f"{repeats}")
    if sum(cases.values()) != norms:
        raise AssertionError(f"{phase}: {sum(cases.values())} BatchNorm "
                             f"calls per clip, expected {norms}")
    total = per_av["ms"] + per_av["backward_ms"]
    bound = per_av["bound_ms"] + per_av["backward_bound_ms"]
    emit(phase, route="cuda", source="avsep_tpu_torch/csrc/motion_bn.cu",
         replaces="none (PyTorch's batch norm, add and relu kernels of the "
         "motion net's bf16 train step)", max_err_over_tol=worst,
         maskable_elements=flips, repeats=repeats,
         calls_per_av_step=2 * sum(cases.values()), per_av_step=per_av,
         kernels_ms=total, bound_ms=bound, share_of_bound=bound / total,
         plain_total_ms=per_av["plain_ms"] + per_av["plain_backward_ms"],
         library_total_ms=per_av["library_ms"]
         + per_av["library_backward_ms"], shapes=rows,
         nvidia_smi=nvidia_smi_line())
    common = dict(route="cuda", source="avsep_tpu_torch/csrc/motion_bn.cu",
                  bound_by="bytes", max_abs_err=None)
    return [dict(common, name="motion_bn",
                 replaces="none (the motion net's bf16 BatchNorm forward, "
                 "its add and ReLU), ms per AV step", ms=per_av["ms"],
                 plain_ms=per_av["plain_ms"], bound_ms=per_av["bound_ms"],
                 library_ms=per_av["library_ms"]),
            dict(common, name="motion_bn_backward",
                 replaces="none (their backward), ms per AV step",
                 ms=per_av["backward_ms"],
                 plain_ms=per_av["plain_backward_ms"],
                 bound_ms=per_av["backward_bound_ms"],
                 library_ms=per_av["library_backward_ms"])]


def check_motion_conv_t3(dev, flush):
    """``kernels.motion_conv_t3`` (forward, and input gradient through the
    reversed taps) and ``motion_conv_t3_wgrad`` at each of the fast
    pathway's 16 ``conv1`` shapes at the clips cell (phase
    ``motion_conv_t3``: one source's 16 clips of 32 frames, 8 distinct
    shapes), each pass against its plain version within the tolerances of
    tests/test_torch_motion_conv.py, two calls bit for bit; then the times
    of each distinct call, summed per AV step (2 sources x 16 conv1s): the
    kernels, their byte bound (each pass reads one activation and writes or
    reads the other once), the plain version and cuDNN's bfloat16
    ``F.conv3d`` on the same channels-last-3d tensors with its
    ``convolution_backward`` (``library_ms``, as the net ran them before),
    each a CUDA graph's replay (:func:`graphed_ms`).  Returns the table's
    two rows, per AV step: ``motion_conv_t3`` the forward and the input
    gradient (its counter counts both), ``motion_conv_t3_wgrad``."""
    import torch.nn.functional as F

    from tests.test_torch_motion_conv import (
        CONV1, cell_case, check_against_plain)
    B = STEM_CLIPS[0]
    shapes = {}
    for _, c_in, c_out, scale in CONV1:
        shapes[(c_in, c_out, scale)] = shapes.get((c_in, c_out, scale), 0) + 1
    passes = ("forward", "input_gradient", "weight_gradient")
    per_av = {f"{p}_{k}": 0.0 for p in passes
              for k in ("ms", "bound_ms", "plain_ms", "library_ms")}
    rows, worst, repeats = [], {p: 0.0 for p in passes}, True
    for i, ((c_in, c_out, scale), n) in enumerate(sorted(shapes.items())):
        x, w, grad = cell_case(c_in, c_out, scale, dev, seed=SEED + i,
                               clips=B)
        err = check_against_plain(x, w, grad)
        for p, (e, _, _) in err.items():
            worst[p] = max(worst[p], e)
        repeats &= torch.equal(kernels.motion_conv_t3(x, w),
                               kernels.motion_conv_t3(x, w))
        repeats &= torch.equal(kernels.motion_conv_t3_wgrad(x, grad),
                               kernels.motion_conv_t3_wgrad(x, grad))
        pad = (1, 0, 0)

        def library_backward(mask):
            return lambda: torch.ops.aten.convolution_backward(
                grad, x, w, None, (1, 1, 1), pad, (1, 1, 1), False,
                (0, 0, 0), 1, mask)

        t = {"forward_ms": lambda: kernels.motion_conv_t3(x, w),
             "forward_plain_ms": lambda: kernels.motion_conv_t3_plain(x, w),
             "forward_library_ms": lambda: F.conv3d(x, w, None, 1, pad),
             "input_gradient_ms":
                 lambda: kernels.motion_conv_t3(grad, w, True),
             "input_gradient_plain_ms":
                 lambda: kernels.motion_conv_t3_plain(grad, w, True),
             "input_gradient_library_ms":
                 library_backward((True, False, False)),
             "weight_gradient_ms":
                 lambda: kernels.motion_conv_t3_wgrad(x, grad),
             "weight_gradient_plain_ms":
                 lambda: kernels.motion_conv_t3_wgrad_plain(x, grad),
             "weight_gradient_library_ms":
                 library_backward((False, True, False))}
        with torch.no_grad():
            ms = {k: graphed_ms(fn, flush) for k, fn in t.items()}
        n_bytes = 2 * (x.numel() + grad.numel())
        for p in passes:
            ms[f"{p}_bound_ms"] = n_bytes / HBM_BYTES_PER_S * 1e3
        for k in per_av:
            per_av[k] += 2 * n * ms[k]
        rows.append({"c_in": c_in, "c_out": c_out,
                     "plane": [56 // scale] * 2,
                     "shape_in": list(x.shape), "calls_per_source": n,
                     "plan": kernels.motion_conv_t3_plan(
                         x.shape[3] * x.shape[4], x.shape[2], B, c_in, c_out),
                     "plan_input_gradient": kernels.motion_conv_t3_plan(
                         x.shape[3] * x.shape[4], x.shape[2], B, c_out, c_in),
                     "plan_weight_gradient": kernels.motion_conv_t3_wgrad_plan(
                         x.shape[3] * x.shape[4], x.shape[2], B, c_in, c_out),
                     "max_err_over_tol": {p: err[p][0] for p in passes},
                     "unequal_share": {p: err[p][1] for p in passes},
                     "tol_share_of_value": {p: err[p][2] for p in passes},
                     **ms})
        del x, w, grad
        torch.cuda.empty_cache()
    if any(e > 1.0 for e in worst.values()) or not repeats:
        raise AssertionError(f"motion_conv_t3 disagrees with its plain "
                             f"version: {worst} of the tolerances; repeats "
                             f"{repeats}")
    if sum(shapes.values()) != 16:
        raise AssertionError(f"motion_conv_t3: {sum(shapes.values())} "
                             "conv1s, expected 16")
    totals = {p: {"ms": per_av[f"{p}_ms"], "bound_ms": per_av[f"{p}_bound_ms"],
                  "share_of_bound": per_av[f"{p}_bound_ms"]
                  / per_av[f"{p}_ms"],
                  "plain_ms": per_av[f"{p}_plain_ms"],
                  "library_ms": per_av[f"{p}_library_ms"]} for p in passes}
    all_ms = sum(v["ms"] for v in totals.values())
    all_bound = sum(v["bound_ms"] for v in totals.values())
    emit("motion_conv_t3", route="cuda",
         source="avsep_tpu_torch/csrc/motion_conv_t3.cu",
         replaces="none (cuDNN's 3x1x1 convolutions of the motion net's "
         "bf16 train step, with their layout conversions)",
         max_err_over_tol=worst, repeats=repeats,
         calls_per_av_step=2 * sum(shapes.values()), per_av_step=totals,
         kernels_ms=all_ms, bound_ms=all_bound,
         share_of_bound=all_bound / all_ms, shapes=rows,
         nvidia_smi=nvidia_smi_line())
    common = dict(route="cuda",
                  source="avsep_tpu_torch/csrc/motion_conv_t3.cu",
                  bound_by="bytes", max_abs_err=None)
    conv = ("forward", "input_gradient")
    return [dict(common, name="motion_conv_t3",
                 replaces="none (cuDNN's 3x1x1 conv of the fast pathway and "
                 "its input gradient), ms per AV step",
                 **{k: sum(totals[p][k] for p in conv)
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms")}),
            dict(common, name="motion_conv_t3_wgrad",
                 replaces="none (its weight gradient), ms per AV step",
                 **{k: totals["weight_gradient"][k]
                    for k in ("ms", "plain_ms", "bound_ms", "library_ms")})]


# SlowFast R50 in float32 against the plain reference in float32: the norm
# of each map's difference over the reference's norm may reach this (the
# sound net's readings and those of a faulty slow pathway: PERF.md)
PATHWAY_TOL = 1e-2


def reference_maps(clips, w, compute: str):
    """benchmark/reference/slowfast.py in ``compute`` with TF32 off on
    uint8 ``clips`` and weights ``w`` (train-mode BatchNorm): the slow map
    ``[B, 2048, T/8, 7, 7]``, the fast map ``[B, 256, T, 7, 7]`` and the
    pooled map, the ``fc`` of their time means after the ReLU."""
    from benchmark.reference import nets as rnets
    from benchmark.reference import slowfast as rslowfast
    P = rnets.Precision(compute)
    with torch.no_grad(), rnets.tf32(False):
        maps = rslowfast.pathways(rnets.normalize_frames(clips), w, P, True,
                                  pre="")
        return maps + (rslowfast.slowfast_map(clips, w, P, True, pre=""),)


def port_maps(net, clips):
    """SlowFast R50 ``net`` (train mode) on uint8 ``clips``, TF32 off: the
    maps of :func:`reference_maps`."""
    from benchmark.reference import nets as rnets
    x = clips if net.stem_kernel else engine.normalize_frames(clips)
    with torch.no_grad(), rnets.tf32(False):
        return net(x) + (torch.relu(net.pooled_map(x)),)


def map_errors(got, want, names=("map", "pooled")):
    """Per map of ``names``: the norm of the difference over the norm of
    ``want``."""
    return {k: float(torch.linalg.vector_norm(g.float() - r.float())
                     / torch.linalg.vector_norm(r.float()))
            for k, g, r in zip(names, got, want)}


def pathway_errors(got, want):
    """:func:`map_errors` of SlowFast's ``slow``, ``fast`` and ``pooled``
    maps."""
    return map_errors(got, want, ("slow", "fast", "pooled"))


def check_slowfast_pathways(dev, shape=STEM_CLIPS):
    """Phase ``slowfast_pathways``: SlowFast R50 in train mode on one
    source's 16 seeded clips of 32 x 224 x 224 against the plain reference
    in float32, per pathway (:func:`pathway_errors`).  The float32 net
    holds each map within PATHWAY_TOL; with a fault of the slow pathway put
    into it, the last lateral's weight zeroed or the slow frames taken from
    frame 1 on, the slow map and the pooled map read above PATHWAY_TOL and
    the fast map stays within.  The bfloat16 net (``motion_stem``,
    ``motion_bn``) on the same weights is read beside the reference's own
    bfloat16: rounding grows through the 50 train-mode layers alike in
    both, so their readings, not a tolerance, say whether it keeps the
    reference's precision.  Returns the readings."""
    from avsep_tpu_torch.models.builder import ModelBuilder
    from avsep_tpu_torch.models.motion import SPEED_RATIO
    from avsep_tpu_torch.ops.imagenet import normalize_frames
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = ModelBuilder.build_motion("slowfast_r50", dtype)
        net.reset_parameters_(torch.Generator().manual_seed(SEED))
        nets[dtype] = net.to(dev).train()
    net = nets[torch.float32]
    w = {k: v.detach().clone() for k, v in net.state_dict().items()}
    B, T, H, W = shape
    clips = torch.randint(0, 256, (B, T, H, W, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(SEED + 11)
                          ).to(dev)
    want = reference_maps(clips, w, "float32")
    readings = {"sound": pathway_errors(port_maps(net, clips), want)}
    lateral = net.slow_path.layer3_lateral.weight
    with torch.no_grad():
        lateral.zero_()
    readings["last_lateral_zeroed"] = pathway_errors(port_maps(net, clips),
                                                     want)
    with torch.no_grad():
        lateral.copy_(w["slow_path.layer3_lateral.weight"])
    net.slow_frames = lambda c: normalize_frames(c[:, 1::SPEED_RATIO])
    readings["slow_frames_from_1"] = pathway_errors(port_maps(net, clips),
                                                    want)
    del net.slow_frames
    readings["bfloat16"] = pathway_errors(
        port_maps(nets[torch.bfloat16], clips), want)
    readings["reference_bfloat16"] = pathway_errors(
        reference_maps(clips, w, "bfloat16"), want)
    emit("slowfast_pathways", clips=list(shape), tolerance=PATHWAY_TOL,
         readings=readings, nvidia_smi=nvidia_smi_line()
         if torch.cuda.is_available() else None)
    faults = [readings["last_lateral_zeroed"], readings["slow_frames_from_1"]]
    if max(readings["sound"].values()) > PATHWAY_TOL or any(
            r["slow"] <= PATHWAY_TOL or r["pooled"] <= PATHWAY_TOL
            or r["fast"] > PATHWAY_TOL for r in faults):
        raise AssertionError(
            f"slowfast_pathways: SlowFast R50 against the reference "
            f"(tolerance {PATHWAY_TOL}): {readings}")
    return readings


# X3D-M in float32 against the plain reference in float32: the norm of
# each map's difference over the reference's norm may reach this (the
# sound net's readings and those of the two faults below: PERF.md)
X3D_TOL = 1e-2
# X3D-M's clips: one source's 16 clips of 16 frames at 224 x 224
X3D_CLIPS = (16, 16, 224, 224)
# X3D-M's BatchNorm calls per clip batch that take kernels.motion_bn: 68
# of its 84, all but the inner norms of the first two stages (54 and 108
# channels, not whole groups of 8: kernels.motion_bn_fits)
X3D_BNS = 68


@contextlib.contextmanager
def x3d_fault(kind: str):
    """A fault confined to X3D's own mechanism, in force inside the block:
    ``se_one``, every squeeze-excitation gate fixed at 1; ``taps_zeroed``,
    the channelwise convolutions' temporal taps other than the centre one
    zeroed in the forward (the stem's 5x1x1 then reads one frame, each
    3x3x3 its own frame)."""
    from avsep_tpu_torch.models import x3d
    from avsep_tpu_torch.models.layers import Conv3d
    if kind == "se_one":
        owner, name = x3d.SEModule, "forward"

        def faulty(self, y):
            return y
    elif kind == "taps_zeroed":
        owner, name = Conv3d, "_conv_forward"
        conv_forward = Conv3d._conv_forward

        def faulty(self, x, weight, bias):
            k = weight.shape[2]
            if self.groups > 1 and k > 1:
                # made on the weight's device with no host copy, so that
                # it holds inside a CUDA graph's capture too
                mask = torch.arange(k, device=weight.device) == k // 2
                weight = weight * mask.to(weight.dtype).view(1, 1, k, 1, 1)
            return conv_forward(self, x, weight, bias)
    else:
        raise ValueError(f"x3d_fault: se_one or taps_zeroed, not {kind!r}")
    with mock.patch.object(owner, name, faulty):
        yield


def x3d_reference_maps(clips, w, compute: str):
    """benchmark/reference/x3d.py in ``compute`` with TF32 off on uint8
    ``clips`` and weights ``w`` (train-mode BatchNorm): the map after
    ``conv5`` ``[B, 432, T, 7, 7]`` and the pooled map, the ``fc`` of its
    time mean after the ReLU."""
    from benchmark.reference import nets as rnets
    from benchmark.reference import x3d as rx3d
    P = rnets.Precision(compute)
    with torch.no_grad(), rnets.tf32(False):
        return (rx3d.backbone(rnets.normalize_frames(clips), w, P, True,
                              pre=""),
                rx3d.x3d_map(clips, w, P, True, pre=""))


def x3d_port_maps(net, clips):
    """X3D ``net`` (train mode) on uint8 ``clips``, TF32 off: the maps of
    :func:`x3d_reference_maps`."""
    from benchmark.reference import nets as rnets
    x = engine.normalize_frames(clips)
    with torch.no_grad(), rnets.tf32(False):
        return net(x), torch.relu(net.pooled_map(x))


def check_x3d_pathway(dev, shape=X3D_CLIPS):
    """Phase ``x3d_pathway``: X3D-M in train mode on one source's 16 seeded
    clips of 16 x 224 x 224 against the plain reference in float32, the
    map after ``conv5`` and the pooled map (:func:`map_errors`).  The
    float32 net holds both within X3D_TOL; with either fault of
    :func:`x3d_fault` in force, both read above it.  The bfloat16 net
    (``motion_bn``) on the same weights is read beside the reference's
    own bfloat16, as in ``slowfast_pathways``.  Returns the readings."""
    from avsep_tpu_torch.models.builder import ModelBuilder
    nets = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = ModelBuilder.build_motion("x3d_m", dtype)
        net.reset_parameters_(torch.Generator().manual_seed(SEED))
        nets[dtype] = net.to(dev).train()
    net = nets[torch.float32]
    w = {k: v.detach().clone() for k, v in net.state_dict().items()}
    B, T, H, W = shape
    clips = torch.randint(0, 256, (B, T, H, W, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(SEED + 13)
                          ).to(dev)
    want = x3d_reference_maps(clips, w, "float32")
    readings = {"sound": map_errors(x3d_port_maps(net, clips), want)}
    for kind in ("se_one", "taps_zeroed"):
        with x3d_fault(kind):
            readings[kind] = map_errors(x3d_port_maps(net, clips), want)
    readings["bfloat16"] = map_errors(
        x3d_port_maps(nets[torch.bfloat16], clips), want)
    readings["reference_bfloat16"] = map_errors(
        x3d_reference_maps(clips, w, "bfloat16"), want)
    emit("x3d_pathway", clips=list(shape), tolerance=X3D_TOL,
         readings=readings, nvidia_smi=nvidia_smi_line()
         if torch.cuda.is_available() else None)
    if max(readings["sound"].values()) > X3D_TOL or any(
            min(readings[k].values()) <= X3D_TOL
            for k in ("se_one", "taps_zeroed")):
        raise AssertionError(f"x3d_pathway: X3D-M against the reference "
                             f"(tolerance {X3D_TOL}): {readings}")
    return readings


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

    reset_launches()
    t0 = time.perf_counter()
    outs = [engine.separate(nets, audio[i], frames[i], cfg)
            for i in range(REQUESTS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()

    expect_launches("separate", launches, REQUESTS, REQUESTS)
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
    return launches, nets, (audio, frames, outs)


def run_separate_bf16(nets32, flagship):
    """The flagship in bfloat16, from the float32 nets' weights, on the
    separate phase's inputs: clips/s, launches, and how far the outputs
    lie from the float32 calls' (recorded, not bounded)."""
    audio, frames, outs32 = flagship
    cfg = Config(**FLAGSHIP, dtype="bfloat16")
    nets = engine.build_nets(cfg)
    for n16, n32 in zip(nets_of(nets), nets_of(nets32)):
        n16.load_state_dict(n32.state_dict(), strict=True)
    for i in range(WARMUP):
        engine.separate(nets, audio[i], frames[i], cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    outs = [engine.separate(nets, audio[i], frames[i], cfg)
            for i in range(REQUESTS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_launches("separate_bf16", launches, REQUESTS, REQUESTS)
    agree, wav_err, mask_err, mask_mean = [], 0.0, 0.0, []
    for o, o32 in zip(outs, outs32):
        w = o["wavs"]
        if not bool(torch.isfinite(w).all()) or w.abs().max().item() > 1.0 \
                or w.shape != o32["wavs"].shape:
            raise AssertionError("separate_bf16: wavs not finite, outside "
                                 "[-1, 1] or of another shape")
        if o["masks"].dtype != torch.float32:
            raise AssertionError("separate_bf16: masks are not float32")
        agree.append((o["masks_linear"] == o32["masks_linear"]).float()
                     .mean().item())
        wav_err = max(wav_err, (w - o32["wavs"]).abs().max().item())
        d = (o["masks"] - o32["masks"]).abs()
        mask_err = max(mask_err, d.max().item())
        mask_mean.append(d.mean().item())
    emit("separate_bf16", config="bench.py flagship in bfloat16 (the "
         "separate phase's weights and inputs)", batch=B, requests=REQUESTS,
         wall_s=wall, clips_per_s=B * REQUESTS / wall,
         ms_per_request=1e3 * wall / REQUESTS, launches=launches,
         peak_mem_gib=peak, binary_mask_agreement=float(np.mean(agree)),
         binary_mask_agreement_min=min(agree), wavs_max_abs_diff=wav_err,
         soft_masks_max_abs_diff=mask_err,
         soft_masks_mean_abs_diff=float(np.mean(mask_mean)))
    return launches


def profile_flagship(nets, cfg, audio, frames, calls: int = 2):
    """torch.profiler over ``calls`` flagship calls (phase ``profile``)."""
    profile_calls("profile", lambda i: engine.separate(
        nets, audio[i], frames[i], cfg), calls)


def profile_calls(phase: str, fn, calls: int, conv3d: bool = False,
                  **fields):
    """torch.profiler over ``fn(0) .. fn(calls - 1)``: device ms per call by
    PyTorch operator (the kernels each one launched) and by kernel, and
    the device's busy share of the wall time (the profiler's own host
    overhead included); the kernels' times through
    ``tools.trace_report.aggregate``.  ``conv3d`` also records the
    operators' input shapes and reports the device time of the
    convolutions (forward and backward) on 5-D inputs and their share of
    the busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from avsep_tpu_torch.tools import trace_report
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=conv3d) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    agg = trace_report.aggregate(trace_report.kernel_records(prof), calls,
                                 wall_s, top_k=16)
    ops = [(ev.key, ev.self_device_time_total, ev.count)
           for ev in prof.key_averages()
           if ev.device_type == DeviceType.CPU
           and ev.self_device_time_total > 0]
    ops.sort(key=lambda r: -r[1])
    busy = agg["device_busy_ms_per_step"] * calls * 1e3
    per_call = 1e-3 / calls
    if conv3d:
        us = sum(ev.self_device_time_total
                 for ev in prof.key_averages(group_by_input_shape=True)
                 if ev.device_type == DeviceType.CPU
                 and "convolution" in ev.key
                 and any(len(sh) == 5 for sh in ev.input_shapes))
        fields.update(conv3d_ms_per_call=us * per_call,
                      conv3d_share_of_busy=us / busy if busy else 0.0)
    port = agg["port_kernels"]
    emit(phase, calls=calls, batch=B, **fields,
         wall_ms_per_call=agg["wall_ms_per_step"],
         device_busy_ms_per_call=agg["device_busy_ms_per_step"],
         device_idle_share=max(0.0, 1.0 - agg["device_busy_frac_of_wall"]),
         ops_ms_per_call=[[k, us * per_call, n // calls]
                          for k, us, n in ops[:12]],
         kernels_ms_per_call=[[row["op"][:80], row["ms_per_step"]]
                              for row in agg["top_ops_pct"]],
         # the port's own kernels, too small for the top of the list
         port_kernels_ms_per_call={
             "frame_window": port["frame_window"]["ms_per_step"],
             "overlap_add": port["overlap_add_normalize"]["ms_per_step"]})


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


def run_train(dev, gen, dtype="float32"):
    """The recipe of scripts/train_MUSIC.sh on one card in ``dtype`` (phase
    ``train`` in float32, ``train_bf16``): 2 warm-up steps, then
    TRAIN_STEPS timed steps, AV and AO by batch_scheduler.  Returns the
    launches and the samples/s of an AV and of an AO step (medians)."""
    phase = "train" if dtype == "float32" else "train_bf16"
    if dtype == "float32":
        check_no_silent_detach(dev)
    cfg = Config(**TRAIN, dtype=dtype)
    state = train.init_state(cfg, engine.build_nets(cfg),
                             torch.Generator().manual_seed(SEED))
    p0 = {n: p.detach().clone() for n, p in train.named_parameters(state.nets)}
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
    reset_launches()
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
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if per_step != [2] * TRAIN_STEPS:
        raise AssertionError(f"{phase}: frame_window launches per train step "
                             f"{per_step}; expected 2 each")
    if launches["overlap_add_normalize"]:
        raise AssertionError(f"{phase}: overlap_add_normalize launched in "
                             "training")
    losses = [float(e) for e in errs]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss: {losses}")
    if not frozen or not all(frozen):
        raise AssertionError(f"{phase}: an AO step moved the frame net: "
                             f"{frozen}")
    params = dict(train.named_parameters(state.nets))
    bufs = [b for gs in state.opt_state.values() if gs
            for b in gs.momentum.values()]
    if any(t.dtype != torch.float32 for t in [*params.values(), *bufs]):
        raise AssertionError(f"{phase}: a parameter or momentum buffer is "
                             "not float32")
    moved = max((params[n] - p).abs().max().item() for n, p in p0.items())
    if not moved > 0 or not any(b.abs().max().item() > 0 for b in bufs):
        raise AssertionError(f"{phase}: the parameters or momentum did not "
                             "move")
    emit(phase, config="scripts/train_MUSIC.sh on one card (unet7, "
         "resnet18dilated-256, hidsep/sig, bce, binary weighted masks, "
         f"{dtype}, TF32 off, dft matmul)", batch=B, steps=TRAIN_STEPS,
         av_steps=len(times[True]), ao_steps=len(times[False]),
         ms_per_av_step=float(np.median(times[True])),
         ms_per_ao_step=float(np.median(times[False])),
         av_step_ms=times[True], ao_step_ms=times[False],
         samples_per_s=B * TRAIN_STEPS / wall, peak_mem_gib=peak,
         frame_window_launches_per_step=per_step, launches=launches,
         losses=losses, ao_steps_left_frame_unchanged=frozen,
         params_and_momentum_float32=True, largest_param_move=moved,
         **({"silent_detach": "raises"} if dtype == "float32" else {}))
    av_step = steps[True]
    profile_calls(f"{phase}_profile", lambda i: av_step(
        state, batches[i], generator=swap), 1, step="AV")
    return launches, {"av": 1e3 * B / float(np.median(times[True])),
                      "ao": 1e3 * B / float(np.median(times[False]))}


@torch.no_grad()
def spread_weights(nets, gen) -> None:
    """Random weights that move every layer: He-scaled convs (on fan-in),
    BatchNorm scales near 1, small biases.  Under the reference's
    N(0, 0.001) U-Net init every attention score is sigmoid(~0) = 0.5, so
    the fusion's best permutation is a coin toss of rounding, and the two
    devices may send the match loss's gradient opposite ways."""
    for net in nets_of(nets):
        for name, p in net.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() in (4, 5):
                p.copy_(noise * (2.0 / p[0].numel()) ** 0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.1 * noise)
            else:
                p.copy_(0.1 * noise)


def train_card_vs_cpu(dev, gen, dtype="float32"):
    """One AV and one AO step at a small size from the same weights and
    batches on the card and on the CPU (dft fft, binary_mask 0), in
    ``dtype``: phase ``train_card_vs_cpu`` within ``TRAIN_TOL`` in float32,
    ``bf16_card_vs_cpu`` within ``BF16_TOL``."""
    phase, tol = (("train_card_vs_cpu", TRAIN_TOL) if dtype == "float32"
                  else ("bf16_card_vs_cpu", BF16_TOL))
    cfg = Config(**{**TRAIN, **TRAIN_SMALL}, dtype=dtype)
    batches = train_batches(gen, torch.device("cpu"), 2, 2,
                            aud_len=cfg.audLen, img=cfg.imgSize)
    metrics, res = av_ao_card_vs_cpu(cfg, batches, gen)
    emit(phase, batch=2, dft="fft", binary_mask=0, dtype=dtype,
         steps=["AV", "AO"], tolerance=tol, losses_cuda=metrics["cuda"],
         losses_cpu=metrics["cpu"], **res)
    check_tol(phase, res, tol)


def av_ao_card_vs_cpu(cfg, batches, gen):
    """An AV step on ``batches[0]`` and an AO step on ``batches[1]`` on
    the CPU and on the card, from the same weights (``spread_weights``
    from ``gen``, after the AO swap's draw): returns the losses by device
    and ``compare_states``' readings."""
    swap = torch.rand(2, generator=gen)
    states, metrics = {}, {}
    weights = None
    for d in ("cpu", "cuda"):
        st = train.init_state(cfg, engine.build_nets(cfg, device=d),
                              torch.Generator().manual_seed(SEED), device=d)
        if weights is None:
            spread_weights(st.nets, gen)
            weights = [{k: v.clone() for k, v in net.state_dict().items()}
                       for net in nets_of(st.nets)]
        for net, sd in zip(nets_of(st.nets), weights):
            net.load_state_dict(sd)
        p0 = {n: p.detach().cpu().clone()
              for n, p in train.named_parameters(st.nets)}
        ms = []
        for b, av in zip(batches, (True, False)):
            st, m = train.make_train_step(cfg, st.nets, av, device=d)(
                st, b, swap_uniforms=swap)
            ms.append(float(m["err"]))
        states[d], metrics[d] = st, ms
    return metrics, compare_states(states, metrics, p0)


@contextlib.contextmanager
def settled_cudnn():
    """cuDNN's deterministic algorithms for the block, after the caching
    allocator has returned its free blocks, the flag restored after: what
    cuDNN picks, and so what a card-vs-CPU reading reads, no longer moves
    with the phases run before (their allocations and the workspace they
    leave free)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _cpu(sd):
    if isinstance(sd, dict):
        return {k: _cpu(v) for k, v in sd.items()}
    return sd.detach().cpu() if isinstance(sd, torch.Tensor) else sd


# compare_states also reports every parameter's and buffer's reading
# (tools/card_vs_cpu_spread.py, tools/sop_port_vs_jax.py set it)
BY_NAME = False


def compare_states(states, metrics, p0):
    """``states["cuda"]`` against ``states["cpu"]`` (the reference; on any
    device) after the same steps from the same weights (``p0``, the
    parameters before them): losses, parameters against their change,
    momentum buffers, running statistics, group counts."""
    res = {"loss_rel_err": max(abs(g / c - 1.0) for g, c in
                               zip(metrics["cuda"], metrics["cpu"]))}
    g_sd, c_sd = (_cpu(states["cuda"].state_dict()),
                  _cpu(states["cpu"].state_dict()))
    g_p = {n: p.detach().cpu()
           for n, p in train.named_parameters(states["cuda"].nets)}
    c_p = {n: p.detach().cpu()
           for n, p in train.named_parameters(states["cpu"].nets)}
    moves = {n: (p.detach() - p0[n]).abs().max().item()
             for n, p in c_p.items()}
    top_move = max(moves.values())
    # each parameter against its change since the start, less a few float32
    # ulps of its value
    perr = sorted(((((g_p[n] - p.detach()).abs().max().item()
                     - 1e-6 * p.detach().abs().max().item())
                    / max(moves[n], 1e-4 * top_move), n)
                   for n, p in c_p.items()), reverse=True)
    res["param_err"], res["param_worst"] = perr[0]
    res["param_top5"] = [[n, e, moves[n] / top_move] for e, n in perr[:5]]
    if BY_NAME:
        res["param_by_name"] = {n: e for e, n in perr}
    res["param_worst_move"] = moves[res["param_worst"]] / top_move
    bufs = {k: (g_sd["opt_state"][g]["momentum"][k].cpu(), v)
            for g, s in c_sd["opt_state"].items() if s
            for k, v in s["momentum"].items()}
    top_max = max(v.abs().max().item() for _, v in bufs.values())
    top_l2 = max(v.norm().item() for _, v in bufs.values())
    res["momentum_err"], res["momentum_worst"] = max(
        ((a - v).abs().max().item() / max(v.abs().max().item(),
                                          1e-4 * top_max), k)
        for k, (a, v) in bufs.items())
    l2 = sorted((((a - v).norm().item() / max(v.norm().item(),
                                               1e-4 * top_l2), k)
                 for k, (a, v) in bufs.items()), reverse=True)
    res["momentum_l2_err"], res["momentum_l2_worst"] = l2[0]
    res["momentum_l2_top5"] = [[k, e] for e, k in l2[:5]]
    if BY_NAME:
        res["momentum_l2_by_name"] = {k: e for e, k in l2}
    res["momentum_global_l2_err"] = (
        sum(((a - v) ** 2).sum().item() for a, v in bufs.values())
        / sum((v ** 2).sum().item() for _, v in bufs.values())) ** 0.5
    res["bn_stats_err"] = max(
        (g_sd[net][k].cpu() - v).abs().max().item()
        / max(v.abs().max().item(), 1e-30)      # a net no step ran: zeros
        for net, _ in train.modules(states["cpu"].nets)
        for k, v in c_sd[net].items()
        if k.endswith(("running_mean", "running_var")))
    res["counts"] = {g: s["count"] for g, s in g_sd["opt_state"].items()}
    res["counts_equal"] = res["counts"] == {
        g: s["count"] for g, s in c_sd["opt_state"].items()}
    return res


def check_tol(what, res, tol):
    for key, limit in tol.items():
        if not res[key] <= limit:
            raise AssertionError(f"{what}: {key} {res[key]} > {limit}")
    if not res["counts_equal"]:
        raise AssertionError(f"{what}: group counts differ")


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


def run_remat(dev, gen):
    """One AV step of the train_MUSIC.sh recipe (float32) at B = 16 with
    and without ``remat`` from the same weights and batch, within
    ``TRAIN_TOL``; then REMAT_TIMED more AV steps of each kind, in turn:
    ms per step (host clock, synchronized) and peak memory (both states
    resident), and the peak above what was allocated before the step."""
    batches = train_batches(gen, dev, 1 + REMAT_TIMED, B)
    states, metrics, steps, per_step = {}, {}, {}, []
    weights = p0 = None
    reset_launches()
    # "cpu" is the plain step (the reference of compare_states), "cuda" the
    # rematerialized one; both on the card
    for key, remat in (("cpu", False), ("cuda", True)):
        cfg = Config(**TRAIN, remat=remat)
        st = train.init_state(cfg, engine.build_nets(cfg),
                              torch.Generator().manual_seed(SEED))
        if weights is None:
            weights = [{k: v.clone() for k, v in net.state_dict().items()}
                       for net in nets_of(st.nets)]
            p0 = {n: p.detach().cpu().clone()
                  for n, p in train.named_parameters(st.nets)}
        for net, sd in zip(nets_of(st.nets), weights):
            net.load_state_dict(sd)
        steps[key] = train.make_train_step(cfg, st.nets, True)
        n0 = kernels.frame_window.launches
        st, m = steps[key](st, batches[0])
        per_step.append(kernels.frame_window.launches - n0)
        states[key], metrics[key] = st, [float(m["err"])]
    del weights
    diff = compare_states(states, metrics, p0)
    bn_equal = all(
        torch.equal(v, getattr(states["cpu"].nets, name).state_dict()[k])
        for name, net in train.modules(states["cuda"].nets)
        for k, v in net.state_dict().items()
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    res = {k: {"ms": [], "peak_gib": [], "above_resident_gib": []}
           for k in states}
    for b in batches[1:]:
        for key in states:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            n0 = kernels.frame_window.launches
            t0 = time.perf_counter()
            states[key], _ = steps[key](states[key], b)
            torch.cuda.synchronize()
            res[key]["ms"].append(1e3 * (time.perf_counter() - t0))
            peak = torch.cuda.max_memory_allocated()
            res[key]["peak_gib"].append(peak / 2 ** 30)
            res[key]["above_resident_gib"].append((peak - before) / 2 ** 30)
            per_step.append(kernels.frame_window.launches - n0)
    launches = read_launches()
    if per_step != [2] * len(per_step):
        raise AssertionError(f"remat: frame_window launches per step "
                             f"{per_step}; expected 2 each")
    if launches["overlap_add_normalize"]:
        raise AssertionError("remat: overlap_add_normalize launched")
    plain, remat = res["cpu"], res["cuda"]
    emit("remat", config="scripts/train_MUSIC.sh on one card, float32, one "
         "AV step with and without remat from the same weights and batch",
         batch=B, tolerance=TRAIN_TOL, loss_plain=metrics["cpu"][0],
         loss_remat=metrics["cuda"][0], bn_buffers_bit_for_bit=bn_equal,
         **diff, timed_steps=REMAT_TIMED,
         plain_ms_per_av_step=float(np.median(plain["ms"])),
         remat_ms_per_av_step=float(np.median(remat["ms"])),
         plain_peak_mem_gib=max(plain["peak_gib"]),
         remat_peak_mem_gib=max(remat["peak_gib"]),
         plain_above_resident_gib=max(plain["above_resident_gib"]),
         remat_above_resident_gib=max(remat["above_resident_gib"]),
         plain_step_ms=plain["ms"], remat_step_ms=remat["ms"],
         frame_window_launches_per_step=per_step, launches=launches)
    check_tol("remat against the plain step", diff, TRAIN_TOL)
    return launches


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
    reset_launches()
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
    launches = read_launches()
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
            weights = [net.state_dict() for net in nets_of(nets[d])]
        for net, sd in zip(nets_of(nets[d]), weights):
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
    scripts/eval_MUSIC.sh on data/mini/train.csv.  The CLI's loader decodes
    the JPEG frames with PIL, which the card's machine has: without it the
    phase fails."""
    if importlib.util.find_spec("PIL") is None:
        raise AssertionError("cli_eval: PIL is not installed; the CLI's "
                             "loader decodes the JPEG frames with PIL")
    manifest = os.path.join("data", "mini", "train.csv")
    argv = script_flags("eval_MUSIC.sh") + [
        "--list_val", manifest, "--num_vis", "0", "--workers", "4",
        "--ckpt", os.path.join(OUT_DIR, "cli")]
    cfg = parse_args(argv)
    wall, out, launches, tf32 = run_module("cli_eval",
                                           "avsep_tpu_torch.main", argv)
    if "Evaluation Done!" not in out:
        raise AssertionError(f"cli_eval: no 'Evaluation Done!':\n"
                             f"{out[-3000:]}")
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
    eval_steps = 2 * -(-n // cfg.batch_size)
    expect_launches("cli_eval", launches, 3 * eval_steps, eval_steps)
    emit("cli_eval", argv=argv, clips=n, wall_s=wall, mean_sdr=means,
         launches=launches, tf32=tf32,
         summary=[line for line in out.splitlines()
                  if line.startswith("[Eval Summary]")])
    return launches, eval_steps


# ------------------------------------------------------------- slice 5


_CHILD = """
import json, runpy, sys
import torch
from avsep_tpu_torch.ops import kernels
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    print(json.dumps({"launches": kernels.launch_counts(),
        "tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                 "cuda_matmul": torch.backends.cuda.matmul.allow_tf32}}),
        flush=True)
"""


def run_module(phase, module, argv, timeout=600, env=None):
    """``python -m module argv...`` in a child process (through
    ``runpy.run_module``, what ``-m`` runs), from the repository's root;
    the child prints its kernels' launch counts and both TF32 flags as its
    last line.  Returns (wall seconds, stdout, launches, TF32 flags);
    raises if the child fails or left a TF32 flag on."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-u", "-c", _CHILD, module, *argv],
                          cwd=REPO_DIR, capture_output=True, text=True,
                          timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: python -m {module} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    if any(report["tf32"].values()):
        raise AssertionError(f"{phase}: python -m {module} ran with TF32 on: "
                             f"{report['tf32']}")
    return wall, proc.stdout, report["launches"], report["tf32"]


def opts_flags(name: str):
    """The flag strings of the ``OPTS+="..."`` lines of ``scripts/<name>``."""
    with open(os.path.join(REPO_DIR, "scripts", name)) as f:
        parts = re.findall(r'^OPTS\+="([^"]*)"', f.read(), re.M)
    return shlex.split(" ".join(parts))


def reset_launches():
    for k in kernels.SOURCES:
        getattr(kernels, k).launches = 0


read_launches = kernels.launch_counts


def expect_launches(phase, got, frame_window, overlap_add, stem=0,
                    stem_wgrad=0, bn=0, conv=0, conv_wgrad=0):
    """``got`` equal to the given launches of each kernel: the motion
    stem's pair and its 3x1x1 convolution (``conv``: forwards and input
    gradients) launch only where a bfloat16 motion net runs, and its
    BatchNorm's pair (``bn`` each) and the convolution's weight gradient
    only where one trains."""
    want = {"frame_window": frame_window,
            "overlap_add_normalize": overlap_add, "motion_stem": stem,
            "motion_stem_wgrad": stem_wgrad, "motion_bn": bn,
            "motion_bn_backward": bn, "motion_conv_t3": conv,
            "motion_conv_t3_wgrad": conv_wgrad}
    if got != want:
        raise AssertionError(f"{phase}: launches {got}, expected {want}")


def pct(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(p * len(v)))]


def run_serve(dev):
    """``serve.SeparationService`` with serve.main's default model and
    knobs behind a TCP server on loopback; SERVE_CLIENTS closed-loop
    clients send SERVE_REQUESTS requests, half AO and half AV with uint8
    frames, after a warm-up dispatch of each group.  Then one AO and one AV
    dispatch against a direct ``engine.separate`` on the same padded batch
    and draws, and the int16 wire against f32."""
    import socket
    import threading

    from avsep_tpu_torch import serve
    cfg = config.FLAGSHIP
    nets = train.init_state(cfg, engine.build_nets(cfg),
                            torch.Generator().manual_seed(SEED)).nets
    svc = serve.SeparationService(cfg, nets, rng_seed=SEED, **SERVE)
    server = serve.serve_forever(svc, port=0)
    host, port = server.server_address
    rs = np.random.RandomState(SEED)
    mixes = [(0.1 * rs.randn(cfg.audLen)).astype(np.float32)
             for _ in range(SERVE_REQUESTS)]
    frames = [rs.randint(0, 256, svc.frames_shape, dtype=np.uint8)
              for _ in range(SERVE_REQUESTS)]
    outs, lat, errors = {}, [], []
    try:
        for f in (None, frames[0]):         # warm-up: one dispatch each
            serve.separate_remote(host, port, mixes[0], frames=f,
                                  timeout=600)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        svc.stats = serve.ServiceStats()
        reset_launches()

        def client(c):
            try:
                with socket.create_connection((host, port),
                                              timeout=600) as sock:
                    # clients of odd index send frames: half AV, half AO
                    for i in range(c, SERVE_REQUESTS, SERVE_CLIENTS):
                        t0 = time.perf_counter()
                        outs[i] = serve.separate_remote(
                            host, port, mixes[i],
                            frames=frames[i] if c % 2 else None, sock=sock)
                        lat.append(1e3 * (time.perf_counter() - t0))
            except Exception as e:  # reported below, with the others
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve: clients failed or hung: {errors}")
        torch.cuda.synchronize()
        launches = read_launches()
        snap = svc.stats.snapshot()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        server.shutdown()
        server.server_close()
    L = HOP * (cfg.WS - 1)
    if sorted(outs) != list(range(SERVE_REQUESTS)) or snap["requests"] \
            != SERVE_REQUESTS:
        raise AssertionError(f"serve: {len(outs)} replies, "
                             f"{snap['requests']} requests")
    for o in outs.values():
        if o.shape != (2, L) or not np.isfinite(o).all() \
                or np.abs(o).max() > 1.0:
            raise AssertionError("serve: a reply is not finite [2, L'] in "
                                 "[-1, 1]")
    expect_launches("serve", launches, snap["dispatches"],
                    snap["dispatches"])

    # one dispatch of each group against engine.separate on the same padded
    # batch and draws
    svc.max_wait_s = 1.0                    # one dispatch per group
    drawn, draw = [], svc.draw_swap

    def recording_draw():
        drawn.append(draw())
        return drawn[-1]
    svc.draw_swap = recording_draw
    n = svc.max_batch - 1
    padded = np.zeros((svc.max_batch, cfg.audLen), np.float32)
    padded[:n] = np.clip(np.stack(mixes[:n]), -1.0, 1.0)
    parity = {}
    for av in (False, True):
        futs = [svc.submit(mixes[i], frames[i] if av else None)
                for i in range(n)]
        got = np.stack([f.result(timeout=600) for f in futs])
        if av:
            fr = np.stack([frames[i] for i in range(n)] + [frames[0]])
            fr = engine.imagenet_normalize(torch.from_numpy(
                fr.astype(np.float32) / 255.0).to(dev))
            want = engine.separate(nets, padded, fr, cfg)["wavs"]
        else:
            want = engine.separate(nets, padded, None, cfg,
                                   swap_uniforms=drawn[-1])["wavs"]
        want = want[:n].cpu().numpy()
        parity["av" if av else "ao"] = float(np.abs(got - want).max())
        if not np.array_equal(got, want):
            raise AssertionError(f"serve: a dispatch differs from a direct "
                                 f"separate on its padded batch: {parity}")
    svc.close()

    # the int16 wire against f32 on the same AV requests
    snr = []
    svc16 = serve.SeparationService(cfg, nets, rng_seed=SEED, wire="int16",
                                    **SERVE)
    try:
        svc32 = serve.SeparationService(cfg, nets, rng_seed=SEED, **SERVE)
        try:
            for i in range(4):
                a = svc32.submit(mixes[i], frames[i]).result(timeout=600)
                b = svc16.submit(mixes[i], frames[i]).result(timeout=600)
                snr.append(float(20 * np.log10(np.linalg.norm(a) / max(
                    np.linalg.norm(a - b), 1e-12))))
        finally:
            svc32.close()
    finally:
        svc16.close()
    if min(snr) <= 30.0:
        raise AssertionError(f"serve: int16 wire SNR {snr} dB, need > 30")
    emit("serve", config="serve.main's default (bench.py flagship: unet7, "
         "resnet18dilated-256, hidsep/sig, binary masks, dft fft), TF32 off",
         **SERVE, clients=SERVE_CLIENTS, requests=SERVE_REQUESTS,
         ao_requests=SERVE_REQUESTS // 2, frames="uint8 over TCP, f32 wire",
         wall_s=wall, requests_per_s=SERVE_REQUESTS / wall,
         dispatch_p50_ms=snap["p50_ms"], dispatch_p95_ms=snap["p95_ms"],
         request_p50_ms=pct(lat, 0.5), request_p95_ms=pct(lat, 0.95),
         mean_batch=snap["mean_batch"], dispatches=snap["dispatches"],
         peak_mem_gib=peak, launches=launches,
         launches_per_dispatch={k: v / snap["dispatches"]
                                for k, v in launches.items()},
         padded_batch_max_abs_err=parity, int16_snr_db=snr)
    return launches, snap["dispatches"]


def run_separate_cli():
    """``python -m avsep_tpu_torch.separate_cli`` on the two mini duet
    clips with their frame directories: 4 finite wavs, one launch of each
    kernel."""
    from avsep_tpu_torch.data.audio_io import read_wav
    out = os.path.join(OUT_DIR, "separate_cli")
    argv = ["--inputs", *(os.path.join(DUET_DIR, f"d0{i}.wav")
                          for i in range(2)),
            "--frames", *(os.path.join(DUET_FRAMES, f"d0{i}.mp4")
                          for i in range(2)), "--out_dir", out]
    wall, _, launches, tf32 = run_module("separate_cli",
                                         "avsep_tpu_torch.separate_cli", argv)
    expect_launches("separate_cli", launches, 1, 1)
    # the same run on the CPU, in this process
    from avsep_tpu_torch import separate_cli
    out_cpu = out + "_cpu"
    separate_cli.main(argv[:-1] + [out_cpu], device="cpu")
    L = HOP * (config.FLAGSHIP.WS - 1)
    err = 0.0
    for i in range(2):
        for n in (1, 2):
            name = f"d0{i}_src{n}.wav"
            w, sr = read_wav(os.path.join(out, name))
            if w.shape != (L,) or not np.isfinite(w).all():
                raise AssertionError(f"separate_cli: {name} is not {L} "
                                     "finite samples")
            err = max(err, float(np.abs(
                w - read_wav(os.path.join(out_cpu, name))[0]).max()))
    emit("separate_cli", argv=argv, wall_s=wall, wavs=4, launches=launches,
         tf32=tf32, cpu_run_max_abs_err=err, tolerance=1e-4)
    if err > 1e-4:
        raise AssertionError(f"separate_cli: the card's wavs differ from the "
                             f"CPU run's by {err} > 1e-4")
    return launches, 1


def write_manifests():
    """build/chip_smoke/duet.csv (the two mini duet clips, 28 frames at
    4 fps, 6.5 s) and solo.csv (two solo rows of data/mini/train.csv, a
    cello and a flute)."""
    os.makedirs(OUT_DIR, exist_ok=True)
    duet = os.path.join(OUT_DIR, "duet.csv")
    with open(duet, "w") as f:
        for i in range(2):
            f.write(",".join([os.path.join(DUET_DIR, f"d0{i}.wav"),
                              os.path.join(DUET_FRAMES, f"d0{i}.mp4"),
                              "28", "4.0", "6.5", "duet"]) + "\n")
    with open(os.path.join(REPO_DIR, "data", "mini", "train.csv")) as f:
        rows = [line for line in f if line.strip()]
    solo = os.path.join(OUT_DIR, "solo.csv")
    with open(solo, "w") as f:
        f.write(rows[0] + rows[3])
    return duet, solo


def run_inference(duet, solo):
    """``python -m avsep_tpu_torch.inference`` with the flags of
    scripts/inference.sh in each of vis, share, sweep (both duet rows) and
    synthesis (the solo manifest): one launch of each kernel per separate
    call."""
    launches, res = {}, {}
    ckpt = os.path.join(OUT_DIR, "inference")
    calls = {"vis": 1, "share": 1, "sweep": 2, "synthesis": 1}
    for mode, n in calls.items():
        argv = [f.replace("${MODE}", mode) for f in
                opts_flags("inference.sh")] + [
            "--list_val", solo if mode == "synthesis" else duet,
            "--ckpt", ckpt]
        wall, _, got, tf32 = run_module(f"inference {mode}",
                                        "avsep_tpu_torch.inference", argv)
        expect_launches(f"inference {mode}", got, n, n)
        cfg = parse_args(argv)
        root = os.path.join(ckpt, cfg.id, "demo")
        want = {"vis": "d00/pred1.wav", "share": "share_d00/predmask2.jpg",
                "sweep": "duet_1/mix.jpg", "synthesis": "synthesis/gt2.wav"}
        if not os.path.exists(os.path.join(root, want[mode])):
            raise AssertionError(f"inference {mode}: {want[mode]} missing")
        res[mode] = {"wall_s": wall, "separate_calls": n, "launches": got,
                     "tf32": tf32}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    emit("inference", flags="scripts/inference.sh", manifests=[duet, solo],
         modes=res, launches=launches)
    return launches, sum(calls.values())


def write_clip30():
    """A synthetic 6.5 s clip at 30 fps: a seeded wav at 11025 Hz (two
    tones and noise) and 195 seeded jpgs of 128x96."""
    from PIL import Image

    from avsep_tpu_torch.data.audio_io import write_wav
    root = os.path.join(OUT_DIR, "clip30")
    fdir = os.path.join(root, "frames")
    os.makedirs(fdir, exist_ok=True)
    rs = np.random.RandomState(SEED)
    sr, dur = 11025, 6.5
    t = np.arange(int(sr * dur)) / sr
    wav = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 587 * t)
           + 0.05 * rs.randn(len(t))).astype(np.float32)
    write_wav(os.path.join(root, "clip.wav"), wav, sr)
    n = int(dur * VIS_FPS)
    for i in range(n):
        Image.fromarray(rs.randint(0, 256, (96, 128, 3), np.uint8)).save(
            os.path.join(fdir, "{:06d}.jpg".format(i)))
    return [os.path.join(root, "clip.wav"), fdir, str(n), str(VIS_FPS),
            str(dur)]


def run_vis_t180(dev):
    """``inference.vis_video`` on a 30 fps window (T = 180 display frames,
    one separate() call of 180 clips) with the flags of
    scripts/inference.sh: its wall, peak memory and launches."""
    from avsep_tpu_torch import inference
    row = write_clip30()
    cfg = parse_args([f.replace("${MODE}", "vis") for f in
                      opts_flags("inference.sh")])
    nets = train.init_state(cfg, engine.build_nets(cfg),
                            torch.Generator().manual_seed(cfg.seed)).nets
    T = int(round(VIS_FPS * inference.AUD_SEC))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    inference.vis_video(cfg, nets, row, os.path.join(OUT_DIR, "vis180"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_launches("vis_t180", launches, 1, 1)
    emit("vis_t180", frames=T, fps=VIS_FPS, separate_calls=1, wall_s=wall,
         peak_mem_gib=peak, launches=launches)
    return launches, 1


def sop_config():
    """scripts/train_SoPpp.sh on one card: its flags with ``--num_gpus 1``
    (one B = 16 shard of the script's two)."""
    return parse_args(opts_flags("train_SoPpp.sh") + ["--num_gpus", "1"])


def run_sop_train(dev, gen):
    """The recipe of scripts/train_SoPpp.sh at full width (unet7 basis with
    32 channels, resnet18dilated-32, Base / cos, B = 16, 65535 samples),
    float32 with TF32 off: SOP_WARMUP steps of each kind, then SOP_STEPS
    timed steps of each, interleaved (host clock around each step,
    synchronized); frame_window twice per step, finite losses, AO steps
    leave the frame net and the frame group's momentum bit for bit."""
    from avsep_tpu_torch import sop_main
    cfg = sop_config()
    if cfg.batch_size != B:
        raise AssertionError(f"sop_train: batch {cfg.batch_size} != {B}")
    state = sop_main.init_sop_state(cfg, sop_main.build_sop_nets(cfg),
                                    torch.Generator().manual_seed(SEED))
    steps = {k: sop_main.make_sop_train_step(cfg, state.nets, *k)
             for k in SOP_KINDS}
    batches = iter(train_batches(gen, dev,
                                 len(SOP_KINDS) * (SOP_WARMUP + SOP_STEPS), B))
    for _ in range(SOP_WARMUP):
        for k in SOP_KINDS:
            state, _ = steps[k](state, next(batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times = {k: [] for k in SOP_KINDS}
    losses, per_step, frozen = [], [], []
    for _ in range(SOP_STEPS):
        for k in SOP_KINDS:
            av = k[0]
            before = None if av else (
                {n: v.clone() for n, v in
                 state.nets.frame.state_dict().items()},
                {n: v.clone() for n, v in
                 state.opt_state["frame"].momentum.items()})
            n0 = kernels.frame_window.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = steps[k](state, next(batches))
            torch.cuda.synchronize()
            times[k].append(1e3 * (time.perf_counter() - t0))
            per_step.append(kernels.frame_window.launches - n0)
            losses += [float(m["err"]), float(m["match_loss"])]
            if before is not None:
                sd, mom = (state.nets.frame.state_dict(),
                           state.opt_state["frame"].momentum)
                frozen.append(all(torch.equal(v, sd[n])
                                  for n, v in before[0].items())
                              and all(torch.equal(v, mom[n])
                                      for n, v in before[1].items()))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_steps = len(SOP_KINDS) * SOP_STEPS
    if per_step != [2] * n_steps or launches["overlap_add_normalize"]:
        raise AssertionError(f"sop_train: frame_window launches per step "
                             f"{per_step} (expected 2 each), "
                             f"overlap_add_normalize {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"sop_train: non-finite loss {losses}")
    if not frozen or not all(frozen):
        raise AssertionError(f"sop_train: an AO step moved the frame net or "
                             f"the frame group: {frozen}")
    name = {(False, 1): "ao", (True, 1): "av_stage1", (True, 2): "av_stage2",
            (True, 3): "av_stage3"}
    emit("sop_train", config="scripts/train_SoPpp.sh on one card (unet7 "
         "basis-32, resnet18dilated-32, Base/cos, InnerProd, bce, binary "
         "weighted masks, float32, TF32 off, dft fft)", batch=B,
         steps=n_steps,
         ms_per_step={name[k]: float(np.median(v)) for k, v in times.items()},
         step_ms={name[k]: v for k, v in times.items()},
         samples_per_s=B * n_steps / (sum(map(sum, times.values())) / 1e3),
         peak_mem_gib=peak, frame_window_launches_per_step=per_step,
         launches=launches, losses=losses,
         ao_steps_left_frame_unchanged=frozen)
    return launches, n_steps


def sop_card_vs_cpu(dev, gen):
    """One step of each kind (AV stage 1, AO, AV stages 2 and 3) at a small
    size from the same weights and batches on the card and on the CPU,
    under ``settled_cudnn``."""
    from avsep_tpu_torch import sop_main
    cfg = sop_config().replace(**SOP_SMALL)
    kinds = ((True, 1), (False, 1), (True, 2), (True, 3))
    batches = train_batches(gen, torch.device("cpu"), len(kinds), 2,
                            aud_len=cfg.audLen, img=cfg.imgSize)
    states, metrics, weights = {}, {}, None
    with settled_cudnn():
        for d in ("cpu", "cuda"):
            st = sop_main.init_sop_state(
                cfg, sop_main.build_sop_nets(cfg, device=d),
                torch.Generator().manual_seed(SEED), device=d)
            if weights is None:
                spread_weights(st.nets, gen)
                weights = [{k: v.clone() for k, v in net.state_dict().items()}
                           for net in nets_of(st.nets)]
            for net, sd in zip(nets_of(st.nets), weights):
                net.load_state_dict(sd)
            p0 = {n: p.detach().cpu().clone()
                  for n, p in train.named_parameters(st.nets)}
            ms = []
            for b, k in zip(batches, kinds):
                st, m = sop_main.make_sop_train_step(cfg, st.nets, *k,
                                                     device=d)(st, b)
                ms.append(float(m["err"]))
            states[d], metrics[d] = st, ms
    res = compare_states(states, metrics, p0)
    emit("sop_card_vs_cpu", batch=2, dft=cfg.dft, binary_mask=0,
         steps=["AV stage 1", "AO", "AV stage 2", "AV stage 3"],
         cudnn="deterministic, cache emptied", tolerance=SOP_TOL,
         losses_cuda=metrics["cuda"], losses_cpu=metrics["cpu"], **res)
    check_tol("sop card vs CPU", res, SOP_TOL)


def sop_cli():
    """``python -m avsep_tpu_torch.sop_main --mode train`` with the flags of
    scripts/train_SoPpp.sh on data/mini/train.csv: iterations 1 to 3 (AV
    from the start: ``--num_fsteps 0``), an eval and a checkpoint at 3,
    ``--num_vis 0``; exit 0 with "Training Done!", one finite results.csv
    row per clip and branch."""
    manifest = os.path.join("data", "mini", "train.csv")
    argv = opts_flags("train_SoPpp.sh") + [
        "--mode", "train", "--av_list_train", manifest, "--ao_list_train",
        manifest, "--list_val", manifest, "--num_iters", "4",
        "--eval_iter", "3", "--disp_iter", "1", "--num_fsteps", "0",
        "--num_vis", "0", "--ckpt", os.path.join(OUT_DIR, "sop_cli")]
    wall, out, launches, tf32 = run_module(
        "sop_cli", "avsep_tpu_torch.sop_main", argv, timeout=900)
    if "Training Done!" not in out:
        raise AssertionError(f"sop_cli: no 'Training Done!':\n{out[-3000:]}")
    cfg = parse_args(argv)
    with open(os.path.join(REPO_DIR, manifest)) as f:
        n = cfg.val_repeat * sum(1 for line in f if line.count(",") >= 1)
    eval_steps = 2 * -(-n // cfg.batch_size)
    expect_launches("sop_cli", launches, 2 * 3 + 3 * eval_steps, eval_steps)
    run = os.path.join(cfg.ckpt, cfg.id)
    for branch in ("sop_av", "sop_ao"):
        rows = read_results(run, branch)
        vals = [float(r[k]) for r in rows for k in ("sdr", "sir", "si-snr")]
        if len(rows) != n or not np.isfinite(vals).all():
            raise AssertionError(f"sop_cli {branch}: {len(rows)} rows "
                                 f"(expected {n}) or non-finite metrics")
    emit("sop_cli", argv=argv, wall_s=wall, batch=cfg.batch_size,
         train_steps=3, eval_steps=eval_steps, clips=n, launches=launches,
         tf32=tf32,
         eval=[line for line in out.splitlines()
               if line.startswith("[SoP++ Eval]")])
    return launches, 3 + eval_steps


def cli_train():
    """``python -m avsep_tpu_torch.main --mode train`` with the flags of
    scripts/train_MUSIC.sh as they stand (``--dtype bfloat16 --dft
    matmul``) on data/mini/train.csv.  Cuts: the manifests (MUSIC needs a
    download), ``--num_iters`` 95001 -> CLI_TRAIN_ITERS + 1 (the loop stops
    before it) and ``--disp_iter`` 20 -> 2 (a loss line every second
    iteration); no eval or checkpoint tick is reached."""
    manifest = os.path.join("data", "mini", "train.csv")
    argv = ["--mode", "train"] + script_flags("train_MUSIC.sh") + [
        "--av_list_train", manifest, "--ao_list_train", manifest,
        "--list_val", manifest, "--num_iters", str(CLI_TRAIN_ITERS + 1),
        "--disp_iter", "2", "--ckpt", os.path.join(OUT_DIR, "cli_train")]
    cfg = parse_args(argv)
    if (cfg.dtype, cfg.dft) != ("bfloat16", "matmul"):
        raise AssertionError(f"cli_train: train_MUSIC.sh gave dtype "
                             f"{cfg.dtype}, dft {cfg.dft}")
    wall, out, launches, tf32 = run_module("cli_train",
                                           "avsep_tpu_torch.main", argv,
                                           timeout=900)
    losses = [float(m) for m in re.findall(r"loss: ([-+0-9.eE]+|nan|inf),",
                                           out)]
    if "Training Done!" not in out or len(losses) != CLI_TRAIN_ITERS // 2 \
            or not np.isfinite(losses).all():
        raise AssertionError(f"cli_train: no 'Training Done!' or losses "
                             f"{losses}:\n{out[-3000:]}")
    expect_launches("cli_train", launches, 2 * CLI_TRAIN_ITERS, 0)
    emit("cli_train", argv=argv, batch=cfg.batch_size, dtype=cfg.dtype,
         dft=cfg.dft, iterations=CLI_TRAIN_ITERS, wall_s=wall, losses=losses,
         launches=launches, tf32=tf32,
         cuts={"manifests": "data/mini/train.csv", "num_iters":
               [95001, CLI_TRAIN_ITERS + 1], "disp_iter": [20, 2]})
    return launches, CLI_TRAIN_ITERS


def run_pixelwise(duet):
    """``python -m avsep_tpu_torch.inference`` with the flags of
    scripts/vis_sound_map.sh on the mini duet manifest: one frame_window
    launch, no iSTFT, a finite [14, 14, 256, 256] mask map (224x224 frames,
    65535 samples)."""
    argv = opts_flags("vis_sound_map.sh") + [
        "--list_val", duet, "--ckpt", os.path.join(OUT_DIR, "pixelwise")]
    wall, _, launches, tf32 = run_module(
        "pixelwise", "avsep_tpu_torch.inference", argv)
    expect_launches("pixelwise", launches, 1, 0)
    cfg = parse_args(argv)
    masks = np.load(os.path.join(cfg.ckpt, cfg.id, "demo", "pixelwise",
                                 "pixel_masks.npy"))
    # the dilated ResNet's stride 16; the warp's 256 bins; the STFT frames
    side = cfg.imgSize // 16
    if masks.shape != (side, side, 256, cfg.WS) or \
            not np.isfinite(masks).all():
        raise AssertionError(f"pixelwise: masks {masks.shape}, finite "
                             f"{np.isfinite(masks).all()}")
    emit("pixelwise", flags="scripts/vis_sound_map.sh", wall_s=wall,
         masks_shape=list(masks.shape), launches=launches, tf32=tf32)
    return launches, 1


# ------------------------------------------------------------- slice 7

# clipatt_train: scripts/train_MUSIC.sh with --fusion_type CoLoc_ClipAtt
# --load_clips: the fast pathway (base 8, [3, 4, 6, 3]) over clip_len 32
# clips of 224x224 per source, unet7, B = 16
CLIPATT = dict(TRAIN, fusion_type="CoLoc_ClipAtt", load_clips=True,
               clip_len=32)
CLIPATT_WARMUP, CLIPATT_STEPS = 2, 4
# clipatt_eval: eval steps of each branch after one warm-up step each
CLIPATT_EVAL_STEPS = 2
# clipatt_card_vs_cpu: unet5 (ngf 64: its 256-channel bottleneck chunks
# take the fast pathway's 256 channels), the full-width fast pathway on
# 4-frame 64x64 clips, 16383 samples, B = 2, dft fft, soft masks
CLIPATT_SMALL = dict(arch_sound="unet5", audLen=16383, imgSize=64,
                     clip_len=4, dft="fft", binary_mask=0)
# card vs CPU after an AV and an AO step of the clips branch from the same
# He-scaled weights, under settled_cudnn: the quantities of TRAIN_TOL.  The
# fast pathway's BatchNorms at this size see 2 x 4 x 2 x 2 to 2 x 4 x 16 x
# 16 values per channel, and their backward loses digits to cancellation.
# On an H100 (NVIDIA H100 80GB HBM3, 700.00 W; tools/card_vs_cpu_spread.py
# clipatt, seeds 0 to 5, alone and in place in a whole run, and
# chip_smoke's own draw) this read at most: losses 3.3e-7; parameters
# 1.71e-2 of their change (motion.conv1, which moves 1.7 % of the largest
# change); momentum buffers 6.69e-2 per buffer (the fast pathway's
# layer1 / layer2 BatchNorms) and 1.30e-2 over all in L2 norm; running
# statistics 1.8e-5.  The port on the CPU against JAX on the CPU on the
# same draws (tools/port_vs_jax_spread.py clipatt) reads as far: 1.51e-2,
# 7.58e-2 per buffer, 1.62e-2 over all.  The parameter and momentum
# limits are 2.0x to 2.1x the largest card readings; loss and statistics
# keep TRAIN_TOL's (30x, 5.6x).
CLIPATT_TOL = dict(TRAIN_TOL, param_err=3.5e-2, momentum_l2_err=0.135,
                   momentum_global_l2_err=2.7e-2)
# cli_clipatt: iterations 1 .. CLI_CLIPATT_ITERS and one eval, B = 4
CLI_CLIPATT_ITERS = 4
CLI_CLIPATT_BATCH = 4
# native: one clip batch of decode work, B samples x 2 sources x (clip_len
# + 1 centre frame) jpgs
NATIVE_CLIP_LEN = 32


def clip_batches(gen, dev, n, batch, aud_len, img, clip_len):
    """Seeded random batches of the clips branch, drawn on ``gen``'s
    device: per-source waveforms scaled as the loaders ship them, uint8
    clips ``[batch, 2, clip_len, img, img, 3]`` (no frames: the clips
    branch never reads them)."""
    g = gen.device
    return [{"audios": (0.05 * torch.randn(batch, 2, aud_len, generator=gen,
                                           device=g)).to(dev),
             "clips": torch.randint(0, 256, (batch, 2, clip_len, img, img, 3),
                                    generator=gen, device=g,
                                    dtype=torch.uint8).to(dev)}
            for _ in range(n)]


def frozen_snapshot(state, nets):
    """Copies of the named nets' state_dicts and of their groups' counts
    and momentum buffers."""
    return {n: ({k: v.clone() for k, v in
                 getattr(state.nets, n).state_dict().items()},
                state.opt_state[n].count,
                {k: v.clone() for k, v in
                 state.opt_state[n].momentum.items()})
            for n in nets}


def unchanged(state, snap):
    """Whether every net and group of ``snap`` is bit for bit as it was."""
    for n, (sd, count, bufs) in snap.items():
        now = getattr(state.nets, n).state_dict()
        mom = state.opt_state[n].momentum
        if state.opt_state[n].count != count or not all(
                torch.equal(v, now[k]) for k, v in sd.items()) or not all(
                torch.equal(v, mom[k]) for k, v in bufs.items()):
            return False
    return True


def slow_stage_layouts(net, batch):
    """Whether each slow stage's input (the slow map with its lateral
    concatenated) is channels-last-3d and dense, in one train-mode forward
    of the first source's clips without a gradient, the running statistics
    left as they are."""
    from avsep_tpu_torch.models.layers import running_stats_frozen
    seen, hooks = {}, []
    for stage in net.slow_path.stages:
        block = getattr(net.slow_path, stage[0])
        hooks.append(block.register_forward_pre_hook(
            lambda m, args, name=stage[0]: seen.__setitem__(
                name, args[0].is_contiguous(
                    memory_format=torch.channels_last_3d))))
    try:
        with torch.no_grad(), running_stats_frozen():
            net.pooled_map(batch["clips"][:, 0])
    finally:
        for h in hooks:
            h.remove()
    return seen


def x3d_layouts(net, batch):
    """Per convolution of X3D ``net`` but the gates' (whose ``[B, C, 1, 1,
    1]`` maps have no layout), whether its input and its output are
    channels-last-3d and dense, in one train-mode forward of the first
    source's clips without a gradient, the running statistics left as
    they are: ``{name: [input, output]}``."""
    from avsep_tpu_torch.models.layers import Conv3d, running_stats_frozen
    cl = torch.channels_last_3d
    seen, hooks = {}, []
    for name, m in net.named_modules():
        if isinstance(m, Conv3d) and ".se_module." not in f".{name}.":
            hooks.append(m.register_forward_hook(
                lambda m, args, out, name=name: seen.__setitem__(
                    name, [args[0].is_contiguous(memory_format=cl),
                           out.is_contiguous(memory_format=cl)])))
    try:
        with torch.no_grad(), running_stats_frozen():
            net.pooled_map(engine.normalize_frames(batch["clips"][:, 0]))
    finally:
        for h in hooks:
            h.remove()
    return seen


def run_clipatt_train(dev, dtype="float32", arch="slowfast_fast"):
    """scripts/train_MUSIC.sh's flags with ``--fusion_type CoLoc_ClipAtt
    --load_clips`` on one card at full width in ``dtype`` (phase
    ``clipatt_train`` in float32, ``clipatt_train_bf16``; with ``arch``
    ``slowfast_r50``, ``--arch_motion slowfast_r50``, phase
    ``slowfast_train_bf16``): warm-up steps, then timed AV and AO steps as
    batch_scheduler says, host clock around each (synchronized);
    frame_window twice per step, finite losses, an AV step leaves the frame
    net and group bit for bit, an AO step the frame and motion nets and
    groups; in bfloat16 the motion stem's pair twice per AV step (one per
    source) and never in an AO step, in float32 never, its BatchNorm
    pair 2 x 53 times per AV step (2 x 106 with the slow pathway), and its
    3x1x1 convolution 2 x 2 x 16 times (forward and input gradient of the
    fast pathway's conv1s) and their weight gradient 2 x 16, else never;
    with the slow pathway, each slow stage's input channels-last-3d
    and dense; with ``arch`` ``x3d_m`` (phase ``x3d_train_bf16``, 16-frame
    clips) 2 x 68 BatchNorm launches per AV step and no stem or 3x1x1
    launch, every convolution's input but the gates' channels-last-3d and
    dense (the outputs in another layout named); then one profiled AV
    step."""
    slow, x3d = arch == "slowfast_r50", arch == "x3d_m"
    phase = "slowfast_train_bf16" if slow else "x3d_train_bf16" if x3d \
        else "clipatt_train" if dtype == "float32" else "clipatt_train_bf16"
    bf16 = dtype != "float32"
    cfg = Config(**{**CLIPATT, "clip_len": X3D_CLIPS[1] if x3d
                    else CLIPATT["clip_len"]}, dtype=dtype, arch_motion=arch)
    # per clip batch: the stem's kernel calls, motion_bn's, motion_conv_t3's
    stems, norms, t3s = (0, X3D_BNS, 0) if x3d else \
        (1, MOTION_BNS * (2 if slow else 1), MOTION_T3S)
    state = train.init_state(cfg, engine.build_nets(cfg),
                             torch.Generator().manual_seed(SEED))
    steps = {v: train.make_train_step(cfg, state.nets, v)
             for v in (True, False)}
    use_vis = train.batch_scheduler(cfg)
    batches = clip_batches(torch.Generator(device=dev).manual_seed(SEED + 7),
                           dev, CLIPATT_WARMUP + CLIPATT_STEPS, B, AUD_LEN,
                           224, cfg.clip_len)
    swap = torch.Generator().manual_seed(SEED + 1)
    losses = []
    for i in range(CLIPATT_WARMUP):
        state, m = steps[use_vis(i)](state, batches[i], generator=swap)
        losses.append(float(m["err"]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, per_step, frozen = {True: [], False: []}, [], []
    motion_per_step, motion_want = [], []
    wall = 0.0
    for i in range(CLIPATT_WARMUP, CLIPATT_WARMUP + CLIPATT_STEPS):
        av = use_vis(i)
        snap = frozen_snapshot(state, train.frozen_nets(cfg, av))
        n0 = read_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps[av](state, batches[i], generator=swap)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        wall += dt
        times[av].append(1e3 * dt)
        n1 = read_launches()
        per_step.append(n1["frame_window"] - n0["frame_window"])
        motion_per_step.append([n1[k] - n0[k] for k in MOTION_KERNELS])
        motion_want.append([2 * stems * (av and bf16)] * 2
                           + [2 * norms * (av and bf16)] * 2
                           + [4 * t3s * (av and bf16),
                              2 * t3s * (av and bf16)])
        losses += [float(m["err"]), float(m["match_loss"])]
        frozen.append(unchanged(state, snap))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if per_step != [2] * CLIPATT_STEPS or launches["overlap_add_normalize"]:
        raise AssertionError(f"{phase}: frame_window launches per step "
                             f"{per_step} (expected 2 each), "
                             f"{launches}")
    if motion_per_step != motion_want:
        raise AssertionError(f"{phase}: motion net launches per step "
                             f"({', '.join(MOTION_KERNELS)}) "
                             f"{motion_per_step}, expected {motion_want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{phase}: non-finite loss: {losses}")
    if not all(frozen):
        raise AssertionError(f"{phase}: a step moved a net it does not run "
                             f"(frame in AV, frame and motion in AO): "
                             f"{frozen}")
    if not times[True] or not times[False]:
        raise AssertionError(f"{phase}: no AV or no AO step was timed")
    layouts = slow_stage_layouts(state.nets.motion, batches[0]) if slow \
        else None
    if layouts is not None and not all(layouts.values()):
        raise AssertionError(f"{phase}: a slow stage's input is not "
                             f"channels-last-3d and dense: {layouts}")
    conv_layouts = x3d_layouts(state.nets.motion, batches[0]) if x3d \
        else None
    if conv_layouts is not None and not all(
            i for i, _ in conv_layouts.values()):
        raise AssertionError(
            f"{phase}: a convolution's input is not channels-last-3d and "
            f"dense: {conv_layouts}")
    net = ("SlowFast R50: slow base 64 on every 8th frame, fast base 8, "
           "5x1x1 laterals, fc to 256, [3, 4, 6, 3]" if slow else
           "X3D-M: base 24, inner x2.25, [3, 5, 11, 7], SE in every other "
           "block, swish, conv5 to 432, fc to 256" if x3d else
           "fast pathway base 8, [3, 4, 6, 3]")
    emit(phase, config="scripts/train_MUSIC.sh + --fusion_type "
         f"CoLoc_ClipAtt --load_clips --arch_motion {arch} on one card "
         f"(unet7, {net}, clip_len {cfg.clip_len} at "
         f"224x224, {dtype}, TF32 off, dft matmul)", batch=B, batch_cut=None,
         slow_stage_inputs_channels_last=layouts,
         convolutions=None if conv_layouts is None else len(conv_layouts),
         outputs_not_channels_last=None if conv_layouts is None
         else sorted(k for k, (_, o) in conv_layouts.items() if not o),
         steps=CLIPATT_STEPS, ms_per_av_step=float(np.median(times[True])),
         ms_per_ao_step=float(np.median(times[False])),
         av_step_ms=times[True], ao_step_ms=times[False],
         samples_per_s=B * CLIPATT_STEPS / wall, peak_mem_gib=peak,
         frame_window_launches_per_step=per_step,
         motion_launches_per_step=dict(zip(MOTION_KERNELS,
                                           zip(*motion_per_step))),
         launches=launches,
         losses=losses, frozen_nets_unchanged=frozen)
    av_step = steps[True]
    profile_calls(f"{phase}_profile", lambda i: av_step(
        state, batches[0], generator=swap), 1, conv3d=True, step="AV")
    return launches


def run_clipatt_eval(dev):
    """AV and AO eval steps of the eval_MUSIC.sh recipe with
    ``--fusion_type CoLoc_ClipAtt --load_clips`` (clip_len 32 at 224x224)
    at B = 16: one warm-up step of each branch, then CLIPATT_EVAL_STEPS
    timed steps of each (CUDA events), 3 frame_window and 1
    overlap_add_normalize launches per step, finite metrics."""
    cfg = Config(**{**EVAL, "fusion_type": "CoLoc_ClipAtt",
                    "load_clips": True, "clip_len": 32})
    nets = engine.init_params(cfg, engine.build_nets(cfg),
                              torch.Generator().manual_seed(SEED))
    batches = clip_batches(torch.Generator(device=dev).manual_seed(SEED + 8),
                           dev, 1 + CLIPATT_EVAL_STEPS, B, AUD_LEN, 224,
                           cfg.clip_len)
    swap = torch.Generator().manual_seed(SEED)
    noise = torch.Generator(device=dev).manual_seed(SEED)
    steps = {v: evaluate.make_eval_step(cfg, nets, v) for v in (True, False)}
    for v in (True, False):
        steps[v](batches[0], generator=swap, noise_generator=noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, per_step = {}, []
    for v in (True, False):
        events = []
        for b in batches[1:]:
            n0 = read_launches()
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            s.record()
            metrics, outputs, _ = steps[v](b, generator=swap,
                                           noise_generator=noise)
            e.record()
            events.append((s, e))
            n1 = read_launches()
            per_step.append((n1["frame_window"] - n0["frame_window"],
                             n1["overlap_add_normalize"]
                             - n0["overlap_add_normalize"]))
            vals = torch.stack([metrics[k] for k in ("sdr", "si_sdr")])
            if not torch.isfinite(vals).all():
                raise AssertionError("clipatt_eval: non-finite metrics")
            side = b["clips"].shape[-2] // 32      # the fast pathway's stride
            if v and tuple(outputs["att_maps"].shape[-2:]) != (side, side):
                raise AssertionError("clipatt_eval: att_maps "
                                     f"{tuple(outputs['att_maps'].shape)}")
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in events]
        res["av" if v else "ao"] = {"ms_per_eval_step": float(np.median(ms)),
                                    "eval_step_ms": ms}
    launches = read_launches()
    if per_step != [(3, 1)] * (2 * CLIPATT_EVAL_STEPS):
        raise AssertionError(f"clipatt_eval: (frame_window, "
                             f"overlap_add_normalize) per step {per_step}; "
                             "expected (3, 1)")
    expect_launches("clipatt_eval", launches, 3 * 2 * CLIPATT_EVAL_STEPS,
                    2 * CLIPATT_EVAL_STEPS)
    emit("clipatt_eval", config="scripts/eval_MUSIC.sh + --fusion_type "
         "CoLoc_ClipAtt --load_clips (unet7, fast pathway base 8, clip_len "
         "32 at 224x224, float32, TF32 off, dft fft)", batch=B,
         steps_per_branch=CLIPATT_EVAL_STEPS, launches_per_step=per_step,
         launches=launches,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, **res)
    return launches


def clipatt_card_vs_cpu(dev, gen):
    """One AV and one AO step of the clips branch at a small size (unet5,
    the full-width fast pathway on 4 x 64 x 64 clips, B = 2) from the same
    weights and batches on the card and on the CPU, under
    ``settled_cudnn``, within ``CLIPATT_TOL``."""
    cfg = Config(**{**CLIPATT, **CLIPATT_SMALL})
    batches = clip_batches(gen, torch.device("cpu"), 2, 2, cfg.audLen,
                           cfg.imgSize, cfg.clip_len)
    with settled_cudnn():
        metrics, res = av_ao_card_vs_cpu(cfg, batches, gen)
    emit("clipatt_card_vs_cpu", batch=2, clip_len=cfg.clip_len,
         img=cfg.imgSize, dft=cfg.dft, binary_mask=0, steps=["AV", "AO"],
         cudnn="deterministic, cache emptied", tolerance=CLIPATT_TOL,
         losses_cuda=metrics["cuda"], losses_cpu=metrics["cpu"], **res)
    check_tol("clipatt card vs CPU", res, CLIPATT_TOL)


def mini_videos():
    """data/mini's frame directories, each with its jpgs in order."""
    root = os.path.join(REPO_DIR, "data", "mini", "frames")
    return [sorted(os.path.join(root, c, v, f)
                   for f in os.listdir(os.path.join(root, c, v)))
            for c in sorted(os.listdir(root))
            for v in sorted(os.listdir(os.path.join(root, c)))]


def run_native():
    """The C++ host path: both libraries built from native/ into a fresh
    directory (the time of each), the route ``--frame_decode auto`` takes,
    ``frame_pipeline_batch`` against PIL bit for bit on every data/mini jpg
    (the val clip transform: Resize(-1, 256) and a 224 centre crop), and
    the decode rate of C++ and of PIL over one clip batch (B x 2 x 33
    jpgs), on the host CPU.  The audio library must build; the frames
    library may fail for lack of libjpeg, which is said on a line of its
    own (PIL's rate is still measured).  Returns the ``--frame_decode``
    the CLI phase runs with."""
    import shutil

    from PIL import Image

    from avsep_tpu_torch.data import native
    from avsep_tpu_torch.data.dataset import MusicMixDataset
    from avsep_tpu_torch.data.video_transforms import (
        center_crop, center_crop_box, resize_shorter, resize_shorter_dims,
        to_uint8_array)
    # time a build from scratch: earlier phases' children built the
    # libraries in native.BUILD_DIR already
    fresh = os.path.join(OUT_DIR, "native_build")
    shutil.rmtree(fresh, ignore_errors=True)
    builds, build_dir = {}, native.BUILD_DIR
    native.BUILD_DIR = fresh
    try:
        for name in native.SOURCES:
            t0 = time.perf_counter()
            try:
                native.build(name)
                err = ""
            except RuntimeError as e:
                err = str(e)
            builds[name] = {"seconds": time.perf_counter() - t0,
                            "error": err[-4000:]}
    finally:
        native.BUILD_DIR = build_dir
        shutil.rmtree(fresh, ignore_errors=True)
    if builds["host"]["error"] or not native.native_available():
        raise AssertionError(f"native: the host library did not build:\n"
                             f"{builds['host']['error']}")
    manifest = os.path.join(REPO_DIR, "data", "mini", "train.csv")
    auto = MusicMixDataset(manifest, Config(frame_decode="auto")).frame_route
    res = {"host_cpu": native.host_cpu(), "host_cores": os.cpu_count(),
           "builds": builds, "auto_route": auto,
           "frames_selfcheck_ok": native.frames_selfcheck_ok()}
    videos = mini_videos()
    w, h = Image.open(videos[0][0]).size
    rw, rh = resize_shorter_dims(w, h, 256)
    crop = (*center_crop_box(rw, rh, 224), 224, 224)

    def pil(paths):
        imgs = [Image.open(p).convert("RGB") for p in paths]
        return to_uint8_array(center_crop(resize_shorter(imgs, 256), 224))

    def cpp(paths):
        return native.frame_pipeline_batch(paths, 224, 224, resize=(rw, rh),
                                           crop=crop)

    flat = [p for v in videos for p in v]
    per = NATIVE_CLIP_LEN + 1
    clips = [[flat[(k * per + j) % len(flat)] for j in range(per)]
             for k in range(2 * B)]
    routes = {"pil": pil}
    decode = "pil"
    if builds["frames"]["error"] or not native.frames_available():
        print("native: the frames library did not build; cli_clipatt runs "
              "with --frame_decode pil. The compiler said: "
              + " ".join(builds["frames"]["error"].split()), flush=True)
    else:
        if not all(np.array_equal(cpp(v), pil(v)) for v in videos):
            raise AssertionError("native: frame_pipeline_batch differs "
                                 "from PIL on data/mini")
        res.update(jpgs_compared=len(flat), pixels_equal_pil=True)
        routes["cpp"] = cpp
        decode = "native"
    rates = {}
    for route, fn in routes.items():
        fn(clips[0])
        t0 = time.perf_counter()
        for c in clips:
            fn(c)
        rates[route] = len(clips) * per / (time.perf_counter() - t0)
    emit("native", cli_frame_decode=decode, **res, jpg_size=[w, h],
         clip_batch_jpgs=len(clips) * per, decode_frames_per_s=rates,
         cpp_threads=native.FRAME_THREADS,
         speedup=rates["cpp"] / rates["pil"] if "cpp" in rates else None)
    return decode


def cli_clipatt(decode):
    """``python -m avsep_tpu_torch.main --mode train`` with the flags of
    scripts/train_MUSIC.sh (bf16) plus ``--fusion_type CoLoc_ClipAtt
    --load_clips --frame_decode <decode>`` on data/mini/train.csv.  Cuts:
    the manifests; the batch 2 x 16 -> 1 x CLI_CLIPATT_BATCH; ``--num_iters``
    95001 -> CLI_CLIPATT_ITERS + 1, ``--eval_iter`` 1000 ->
    CLI_CLIPATT_ITERS (one eval and checkpoint), ``--disp_iter`` 20 -> 2,
    ``--val_repeat`` 12 -> 2, ``--num_vis`` 100 -> 0; clip_len stays 32.
    "Training Done!", finite losses, the route printed, one finite
    results.csv row per clip and branch, 2 launches per train step and
    3 + 1 per eval step, the motion stem's forward 2 per AV train or eval
    step and its weight gradient 2 per AV train step, the motion net's
    BatchNorm pair 2 x 53 per AV train step and none in eval, its 3x1x1
    convolution 2 x 16 per AV eval step and 2 x 2 x 16 per AV train step
    (forward and input gradient), their weight gradient 2 x 16 per AV
    train step, TF32 off."""
    manifest = os.path.join("data", "mini", "train.csv")
    argv = ["--mode", "train"] + script_flags("train_MUSIC.sh") + [
        "--fusion_type", "CoLoc_ClipAtt", "--load_clips", "--frame_decode",
        decode, "--av_list_train", manifest, "--ao_list_train", manifest,
        "--list_val", manifest, "--num_gpus", "1", "--batch_size_per_gpu",
        str(CLI_CLIPATT_BATCH), "--num_iters", str(CLI_CLIPATT_ITERS + 1),
        "--eval_iter", str(CLI_CLIPATT_ITERS), "--disp_iter", "2",
        "--val_repeat", "2", "--num_vis", "0",
        "--ckpt", os.path.join(OUT_DIR, "cli_clipatt")]
    cfg = parse_args(argv)
    wall, out, launches, tf32 = run_module("cli_clipatt",
                                           "avsep_tpu_torch.main", argv,
                                           timeout=900)
    losses = [float(m) for m in re.findall(r"loss: ([-+0-9.eE]+|nan|inf),",
                                           out)]
    route = re.findall(r"^Frame decode: (\w+)", out, re.M)
    if "Training Done!" not in out or \
            len(losses) != CLI_CLIPATT_ITERS // 2 or \
            not np.isfinite(losses).all() or route != [decode]:
        raise AssertionError(f"cli_clipatt: no 'Training Done!', losses "
                             f"{losses} or route {route}:\n{out[-3000:]}")
    with open(os.path.join(REPO_DIR, manifest)) as f:
        n = cfg.val_repeat * sum(1 for line in f if line.count(",") >= 1)
    eval_steps = 2 * -(-n // cfg.batch_size)
    run = os.path.join(cfg.ckpt, cfg.id)
    for branch in ("av", "ao"):
        rows = read_results(run, branch)
        vals = [float(r[k]) for r in rows for k in ("sdr", "sir", "si-snr")]
        if len(rows) != n or not np.isfinite(vals).all():
            raise AssertionError(f"cli_clipatt {branch}: {len(rows)} rows "
                                 f"(expected {n}) or non-finite metrics")
    # the CLI's iterations 1 .. CLI_CLIPATT_ITERS, half the eval steps AV
    av_iters = sum(map(train.batch_scheduler(cfg),
                       range(1, CLI_CLIPATT_ITERS + 1)))
    expect_launches("cli_clipatt", launches,
                    2 * CLI_CLIPATT_ITERS + 3 * eval_steps, eval_steps,
                    2 * av_iters + eval_steps, 2 * av_iters,
                    2 * MOTION_BNS * av_iters,
                    4 * MOTION_T3S * av_iters + MOTION_T3S * eval_steps,
                    2 * MOTION_T3S * av_iters)
    emit("cli_clipatt", argv=argv, batch=cfg.batch_size, dtype=cfg.dtype,
         clip_len=cfg.clip_len, frame_decode=route[0],
         iterations=CLI_CLIPATT_ITERS, eval_steps=eval_steps, clips=n,
         wall_s=wall, losses=losses, launches=launches, tf32=tf32,
         cuts={"manifests": "data/mini/train.csv",
               "batch": [32, cfg.batch_size],
               "num_iters": [95001, CLI_CLIPATT_ITERS + 1],
               "eval_iter": [1000, CLI_CLIPATT_ITERS], "disp_iter": [20, 2],
               "val_repeat": [12, 2], "num_vis": [100, 0]},
         eval=[line for line in out.splitlines()
               if line.startswith("[Eval Summary]")])
    return launches, CLI_CLIPATT_ITERS + eval_steps


# ------------------------------------------------------------- slice 8
#
# Data parallelism (avsep_tpu_torch/parallel/), each path in child
# processes of this script (``--dist-child``): ranks of a process group,
# one process each, that count their own kernels' launches and print a
# JSON report as their last line.  NCCL refuses two ranks on one device,
# so the two-rank phases run gloo on CUDA tensors (through the host); the
# NCCL path is a group of one rank.

DIST_DIR = os.path.join(OUT_DIR, "dist")
# dist_train: train_MUSIC.sh's recipe (TRAIN) at B = 16 global, 8 rows per
# rank, from spread_weights (the reference's U-Net init makes the fusion's
# best permutation a coin toss of rounding): 2 AV and 2 AO steps
DIST_SEQ = (True, False, True, False)
# dist_eval: eval_MUSIC.sh's recipe (EVAL) over 16 + 16 + a ragged 8 clips
DIST_EVAL_CLIPS = 40
# two ranks against one process on the same global batches and weights,
# and one NCCL rank against no group: losses, parameters against their
# change, momentum buffers, running statistics (compare_states).  The
# card's backward is not reproducible run to run (the upsample's atomics
# are the suspect), and the momentum readings are bimodal on inputs that
# do not change.  24 runs of tools/dist_train_spread.py on an H100 (NVIDIA
# H100 80GB HBM3, 700.00 W) read: per buffer, 4.65e-3 to 7.13e-3 in 17
# runs and 2.176e-2 to 2.254e-2 in 7 (always frame.fc.weight); over all
# buffers, 8.06e-5 to 1.00e-4, and 3.726e-4 to 3.744e-4 in the same 7;
# losses at most 9.95e-8, parameters within a few ulps (param_err < 0),
# running statistics at most 7.3e-7.  The two momentum limits are 2.0x
# the largest readings, no looser than TRAIN_TOL's card-against-CPU
# limits; the one NCCL rank, whose steps differ from no group's only by
# that backward, read 9.9e-4 per buffer.  Losses and statistics keep 10x
# and 14x, param_err TRAIN_TOL's.
DIST_TOL = {"loss_rel_err": 1e-6, "momentum_global_l2_err": 7.5e-4,
            "momentum_l2_err": 4.5e-2, "param_err": 2e-3, "bn_stats_err": 1e-5}
# two ranks' eval meters (dist_eval) against one process's sweep,
# relative: read 2.1e-5 (8 rows per rank against 16: cuDNN's algorithms
# differ with the batch, and a mask bin within rounding of the threshold
# flips).  The NCCL rank's sweep runs on the same weights as no group's
# and must equal it bit for bit.
DIST_METER_TOL = 1e-4
# cli_dist: the replicate run's loss history and eval meters against one
# process's, relative, after CLI_DIST_ITERS steps at B = 4: read 8.9e-5
# and 3.1e-7 (the deep layers' gradients amplify float32 rounding;
# tests/test_torch_parallel.py measures the same on the CPU)
CLI_DIST_TOL = {"loss_rel_err": 5e-4, "meters_err": 1e-5}
# dist_nccl: the eval sweep, then one AV and one AO step, at B = 16
NCCL_SEQ = (True, False)
NCCL_EVAL_CLIPS = 24
# cli_dist: main.main with train_MUSIC.sh's flags in float32 (its own
# parity recipe, --dtype float32 --dft fft), iterations 1 .. CLI_DIST_ITERS
# with an eval at the last, global batch 2 x 2
CLI_DIST_ITERS = 3
DIST_TIMEOUT = 600


def _join(rank, world, backend, init):
    """Join a group through the ``file://`` store ``init``, on the rank's
    card (made current first, as ``distributed.maybe_initialize`` does)."""
    import datetime

    import torch.distributed as dist
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))


def _all_tensors(state):
    return [t for net in nets_of(state.nets)
            for t in net.state_dict().values()] + [
        b for g in state.opt_state.values() if g for b in g.momentum.values()]


def ranks_identical(state) -> bool:
    """Whether every parameter, buffer and momentum buffer equals rank 0's
    bit for bit, on every rank (a broadcast of rank 0's, then an
    all_reduce of the ranks' mismatches)."""
    import torch.distributed as dist
    bad = torch.zeros(1, device=engine.resolve_device(None))
    for t in _all_tensors(state):
        ref = t.detach().clone()
        dist.broadcast(ref, 0)
        bad += float(not torch.equal(ref, t.detach()))
    dist.all_reduce(bad)
    return bad.item() == 0


def _steps(cfg, state, seq, batches, swap_seed):
    """``seq`` train steps on this rank's rows of the global ``batches``
    (replicate): synchronized ms per step and the losses."""
    steps = {v: train.make_train_step(cfg, state.nets, v)
             for v in (True, False)}
    swap = torch.Generator().manual_seed(swap_seed)
    dev = engine.resolve_device(None)
    times, losses = [], []
    for av, b in zip(seq, batches):
        rows = {k: v.to(dev) for k, v in pdist.device_put_global(b).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = steps[av](state, rows, generator=swap)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        losses.append(float(m["err"]))
    return times, losses


def _dist_state(cfg):
    """train_MUSIC.sh's nets from ``init_state`` at SEED, spread_weights
    from SEED + 8, broadcast from rank 0 (a no-op without a group)."""
    state = train.init_state(cfg, engine.build_nets(cfg),
                             torch.Generator().manual_seed(SEED))
    spread_weights(state.nets, torch.Generator().manual_seed(SEED + 8))
    pdist.broadcast_state(state)
    return state


def _eval_sweeps(cfg, nets, loader):
    history = new_history()
    for use_vis in (True, False):
        evaluate.evaluate(cfg, nets, loader, history, 0, use_vis)
    return history


def meters_of(history):
    return {key: {k: v[-1] for k, v in history[key].items() if k != "iter"}
            for key in ("val_av", "val_ao")}


def meters_err(got, want):
    """Largest relative difference of two ``meters_of``."""
    return max(abs(got[key][k] - v) / max(abs(v), 1e-12)
               for key in want for k, v in want[key].items())


def child_dist_train(rank, world, init):
    """One rank of dist_train and dist_eval (gloo, CUDA tensors): the
    steps, whether the ranks hold the same state bit for bit, the eval
    sweep over a ragged val set; then rank 0 leaves the group and runs the
    same on one process for the comparison."""
    _join(rank, world, "gloo", init)
    cfg = Config(**TRAIN)
    state = _dist_state(cfg)
    p0 = {n: p.detach().cpu().clone()
          for n, p in train.named_parameters(state.nets)}
    batches = train_batches(torch.Generator().manual_seed(SEED + 9),
                            torch.device("cpu"), len(DIST_SEQ), B,
                            aud_len=cfg.audLen, img=cfg.imgSize)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    times, losses = _steps(cfg, state, DIST_SEQ, batches, SEED + 1)
    report = {"rank": rank, "train_launches": read_launches(),
              "step_ms": times, "losses": losses,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "ranks_identical": ranks_identical(state)}
    ecfg = Config(**EVAL, ckpt=os.path.join(DIST_DIR, "eval_ranks"))
    clips = Clips(torch.Generator().manual_seed(SEED + 10), DIST_EVAL_CLIPS,
                  aud_len=ecfg.audLen, img=ecfg.imgSize)
    loader = BatchLoader(clips, B, shuffle=False, num_workers=4)
    reset_launches()
    t0 = time.perf_counter()
    history = _eval_sweeps(ecfg, state.nets, loader)
    torch.cuda.synchronize()
    report.update(eval_launches=read_launches(),
                  eval_wall_s=time.perf_counter() - t0,
                  meters=meters_of(history))
    pdist.shutdown()
    if rank != 0:
        return report
    # one process: the same sweep with the same nets, then the same steps
    # on the global batches from the same weights
    one = ecfg.replace(ckpt=os.path.join(DIST_DIR, "eval_one"))
    single = _eval_sweeps(one, state.nets, loader)
    for branch in ("av", "ao"):
        check_results(read_results(ecfg.ckpt, branch), history,
                      "val_" + branch, DIST_EVAL_CLIPS)
    ref = _dist_state(cfg)
    _, ref_losses = _steps(cfg, ref, DIST_SEQ, batches, SEED + 1)
    report.update(
        single_meters=meters_of(single),
        meters_err=meters_err(meters_of(history), meters_of(single)),
        meters_bit_equal=meters_of(history) == meters_of(single),
        single_losses=ref_losses,
        vs_single=compare_states({"cuda": state, "cpu": ref},
                                 {"cuda": losses, "cpu": ref_losses}, p0))
    return report


def child_dist_nccl(rank, world, init):
    """dist_nccl: the eval sweep and the steps without a group, then the
    same from the same weights in a one-rank NCCL group (its collectives
    run, each the identity on one rank), under settled_cudnn.  The sweep
    comes first, on the initial weights, so it sees the same parameters
    in both runs; the steps' backward is not bit-reproducible on the card
    (the upsample's)."""
    cfg = Config(**TRAIN)
    ecfg = Config(**EVAL, ckpt=os.path.join(DIST_DIR, "nccl_none"))
    batches = train_batches(torch.Generator().manual_seed(SEED + 11),
                            torch.device("cpu"), len(NCCL_SEQ), B,
                            aud_len=cfg.audLen, img=cfg.imgSize)
    clips = Clips(torch.Generator().manual_seed(SEED + 12), NCCL_EVAL_CLIPS,
                  aud_len=ecfg.audLen, img=ecfg.imgSize)
    loader = BatchLoader(clips, B, shuffle=False, num_workers=4)
    runs = {}
    with settled_cudnn():
        for name in ("none", "nccl"):
            if name == "nccl":
                _join(rank, world, "nccl", init)
                ecfg = ecfg.replace(ckpt=os.path.join(DIST_DIR, "nccl_one"))
            state = _dist_state(cfg)
            p0 = {n: p.detach().cpu().clone()
                  for n, p in train.named_parameters(state.nets)}
            reset_launches()
            history = _eval_sweeps(ecfg, state.nets, loader)
            eval_launches = read_launches()
            reset_launches()
            _, losses = _steps(cfg, state, NCCL_SEQ, batches, SEED + 1)
            runs[name] = (state, losses, history, read_launches(),
                          eval_launches)
    import torch.distributed as dist
    backend = dist.get_backend()
    pdist.shutdown()
    (ref, ref_losses, ref_h, _, _), (state, losses, h, tl, el) = \
        runs["none"], runs["nccl"]
    return {"backend": backend, "losses": losses, "single_losses": ref_losses,
            "train_launches": tl, "eval_launches": el,
            "meters": meters_of(h),
            "meters_err": meters_err(meters_of(h), meters_of(ref_h)),
            "meters_bit_equal": meters_of(h) == meters_of(ref_h),
            "state_bit_equal": all(torch.equal(a, b) for a, b in zip(
                _all_tensors(state), _all_tensors(ref))),
            "vs_single": compare_states({"cuda": state, "cpu": ref},
                                        {"cuda": losses, "cpu": ref_losses},
                                        p0)}


@contextlib.contextmanager
def recorded_writes(root):
    """Yields the list of files opened for writing (``open`` in a writing
    mode, ``torch.save``) under ``root`` while the block runs."""
    import builtins
    root = os.path.realpath(root)
    writes = []
    real_open, real_save = builtins.open, torch.save

    def record(file):
        if isinstance(file, (str, os.PathLike)) and \
                os.path.realpath(file).startswith(root):
            writes.append(os.path.realpath(file))

    def traced_open(file, mode="r", *a, **kw):
        if set(mode) & set("wax+"):
            record(file)
        return real_open(file, mode, *a, **kw)

    def traced_save(obj, f, *a, **kw):
        record(f)
        return real_save(obj, f, *a, **kw)

    builtins.open, torch.save = traced_open, traced_save
    try:
        yield writes
    finally:
        builtins.open, torch.save = real_open, real_save


@contextlib.contextmanager
def timed_decode():
    """Yields the list of seconds each ``MusicMixDataset`` item took to
    load (decode, mix) while the block runs, in any loader thread."""
    from avsep_tpu_torch.data.dataset import MusicMixDataset
    getitem = MusicMixDataset.__getitem__
    seconds = []

    def timed(self, index):
        t0 = time.perf_counter()
        item = getitem(self, index)
        seconds.append(time.perf_counter() - t0)
        return item

    MusicMixDataset.__getitem__ = timed
    try:
        yield seconds
    finally:
        MusicMixDataset.__getitem__ = getitem


def child_cli(rank, world, init, *argv):
    """cli_dist: ``main.main`` on this rank of a gloo group the process
    joined first (``maybe_initialize`` is then a no-op), or alone for a
    world of 1; the files it opened for writing under ``--ckpt`` and its
    launches."""
    from avsep_tpu_torch import main as cli_main
    if world > 1:
        _join(rank, world, "gloo", init)
    cfg = parse_args(list(argv))
    reset_launches()
    try:
        with recorded_writes(cfg.ckpt) as writes, timed_decode() as decoded:
            cli_main.main(cfg)
    finally:
        pdist.shutdown()
    return {"rank": rank, "writes": sorted(set(writes)),
            "launches": read_launches(), "decoded": len(decoded),
            "decode_s": sum(decoded)}


CHILD_JOBS = {"dist_train": child_dist_train, "dist_nccl": child_dist_nccl,
              "cli": child_cli}


def child(argv) -> int:
    """``chip_smoke.py --dist-child JOB RANK WORLD INIT ARGS...``: one rank
    of a slice-8 phase; its report is the last line of its output."""
    job, rank, world, init, *rest = argv
    engine.full_float32()
    report = CHILD_JOBS[job](int(rank), int(world), init, *rest)
    print(json.dumps(report), flush=True)
    return 0


def spawn(job, world, *args):
    """``world`` ranks of ``job`` as child processes, started at once, each
    through the ``file://`` store of its own init file."""
    os.makedirs(DIST_DIR, exist_ok=True)
    init = os.path.join(DIST_DIR, f"{job}_{time.monotonic_ns()}.init")
    return [subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--dist-child",
         job, str(r), str(world), init, *map(str, args)], cwd=REPO_DIR,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]


def reports(phase, procs, timeout=DIST_TIMEOUT):
    """The children's reports; a child that fails or outlives ``timeout``
    (in all) fails the phase, and every child still running is killed."""
    deadline = time.perf_counter() + timeout
    outs = [None] * len(procs)
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for i, p in enumerate(procs):
            if outs[i] is None:
                p.kill()
                outs[i] = p.communicate()
    if any(p.returncode != 0 for p in procs):
        raise AssertionError(
            f"{phase}: children exited {[p.returncode for p in procs]}:\n"
            + "\n".join(f"--- child {i}:\n{o[0][-2000:]}\n{o[1][-3000:]}"
                        for i, o in enumerate(outs)))
    return [json.loads(o[0].strip().splitlines()[-1]) for o, p in
            zip(outs, procs)]


def check_compute_mode():
    """Two processes on one card need a compute mode that lets them."""
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    if "exclusive" in mode.lower():
        raise AssertionError(f"dist phases: compute mode {mode!r} lets one "
                             "process use the card")
    return mode


def run_dist_train():
    """dist_train and dist_eval: two gloo ranks on the one card, each a
    child; rank 0 then compares with one process."""
    mode = check_compute_mode()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r0, r1 = reports("dist_train", spawn("dist_train", 2))
    wall = time.perf_counter() - t0
    res = r0["vs_single"]
    emit("dist_train", config="scripts/train_MUSIC.sh (unet7, "
         "resnet18dilated-256, hidsep/sig, bce, binary weighted masks, "
         "float32, TF32 off, dft matmul), spread_weights", ranks=2,
         backend="gloo through the host, two ranks sharing one card",
         compute_mode=mode, batch_global=B, batch_per_rank=B // 2,
         steps=["AV" if v else "AO" for v in DIST_SEQ],
         step_ms_by_rank=[r0["step_ms"], r1["step_ms"]],
         peak_mem_gib_by_rank=[r0["peak_mem_gib"], r1["peak_mem_gib"]],
         losses=r0["losses"], single_losses=r0["single_losses"],
         ranks_identical=[r0["ranks_identical"], r1["ranks_identical"]],
         launches_by_rank=[r0["train_launches"], r1["train_launches"]],
         tolerance=DIST_TOL, wall_s=wall, **res)
    check_tol("dist_train", res, DIST_TOL)
    if not (r0["ranks_identical"] and r1["ranks_identical"]):
        raise AssertionError("dist_train: the ranks' states differ")
    if r0["losses"] != r1["losses"]:
        raise AssertionError(f"dist_train: the ranks report other losses "
                             f"{r0['losses']} {r1['losses']}")
    for r in (r0, r1):
        expect_launches("dist_train", r["train_launches"],
                        2 * len(DIST_SEQ), 0)
    eval_steps = 2 * -(-DIST_EVAL_CLIPS // B)
    emit("dist_eval", ranks=2, backend="gloo through the host, two ranks "
         "sharing one card", clips=DIST_EVAL_CLIPS, batch_global=B,
         eval_steps_per_rank=eval_steps,
         wall_s_by_rank=[r0["eval_wall_s"], r1["eval_wall_s"]],
         meters=r0["meters"], single_meters=r0["single_meters"],
         meters_err=r0["meters_err"], meters_bit_equal=r0["meters_bit_equal"],
         tolerance=DIST_METER_TOL,
         launches_by_rank=[r0["eval_launches"], r1["eval_launches"]])
    if r0["meters"] != r1["meters"] or \
            not r0["meters_err"] <= DIST_METER_TOL:
        raise AssertionError(f"dist_eval: meters {r0['meters']} / "
                             f"{r1['meters']} against one process "
                             f"{r0['single_meters']}")
    for r in (r0, r1):
        expect_launches("dist_eval", r["eval_launches"], 3 * eval_steps,
                        eval_steps)
    total = {p: {k: r0[p][k] + r1[p][k] for k in r0[p]}
             for p in ("train_launches", "eval_launches")}
    return ((total["train_launches"], 2 * len(DIST_SEQ)),
            (total["eval_launches"], 2 * eval_steps))


def run_dist_nccl():
    """dist_nccl: a one-rank NCCL group through the distributed step and
    eval sweep, against the same without a group, in one child."""
    r, = reports("dist_nccl", spawn("dist_nccl", 1))
    res = r["vs_single"]
    eval_steps = 2 * -(-NCCL_EVAL_CLIPS // B)
    emit("dist_nccl", backend=r["backend"], ranks=1, batch=B,
         steps=["AV" if v else "AO" for v in NCCL_SEQ], losses=r["losses"],
         single_losses=r["single_losses"],
         state_bit_equal=r["state_bit_equal"], meters=r["meters"],
         meters_err=r["meters_err"], meters_bit_equal=r["meters_bit_equal"],
         tolerance=DIST_TOL, meter_tolerance="bit for bit",
         train_launches=r["train_launches"],
         eval_launches=r["eval_launches"], **res)
    check_tol("dist_nccl", res, DIST_TOL)
    if r["backend"] != "nccl" or not r["meters_bit_equal"]:
        raise AssertionError(f"dist_nccl: backend {r['backend']}, meters "
                             f"{r['meters_err']} off")
    expect_launches("dist_nccl train", r["train_launches"],
                    2 * len(NCCL_SEQ), 0)
    expect_launches("dist_nccl eval", r["eval_launches"], 3 * eval_steps,
                    eval_steps)
    launches = {k: r["train_launches"][k] + r["eval_launches"][k]
                for k in r["train_launches"]}
    return launches, len(NCCL_SEQ) + eval_steps


def cli_dist():
    """cli_dist: ``main.main`` in two children that joined a gloo group
    first, ``replicate`` and ``shard``, and in one child alone; all five
    at once.  train_MUSIC.sh's flags with its float32 parity recipe
    (``--dtype float32 --dft fft``).  Cuts: the manifests, the batch
    2 x 16 -> 2 x 2, ``--num_iters`` 95001 -> CLI_DIST_ITERS + 1,
    ``--eval_iter`` 1000 -> CLI_DIST_ITERS, ``--disp_iter`` 20 -> 1,
    ``--val_repeat`` 12 -> 1, ``--num_vis`` 100 -> 0, ``--workers`` 4 -> 0,
    ``--frame_decode pil``."""
    manifest = os.path.join("data", "mini", "train.csv")
    base = ["--mode", "train"] + script_flags("train_MUSIC.sh") + [
        "--dtype", "float32", "--dft", "fft", "--av_list_train", manifest,
        "--ao_list_train", manifest, "--list_val", manifest,
        "--num_gpus", "2", "--batch_size_per_gpu", "2",
        "--num_iters", str(CLI_DIST_ITERS + 1), "--eval_iter",
        str(CLI_DIST_ITERS), "--disp_iter", "1", "--val_repeat", "1",
        "--num_vis", "0", "--workers", "0", "--frame_decode", "pil"]
    runs = {"replicate": 2, "shard": 2, "one": 1}
    procs = {}
    for name, world in runs.items():
        ckpt = os.path.join(OUT_DIR, "cli_dist", name)
        shutil.rmtree(ckpt, ignore_errors=True)
        argv = base + ["--ckpt", ckpt] + ([] if world == 1 else [
            "--dist_nprocs", "2", "--dist_data", name])
        procs[name] = spawn("cli", world, *argv)
    t0 = time.perf_counter()
    got = {name: reports(f"cli_dist {name}", ps)
           for name, ps in procs.items()}
    wall = time.perf_counter() - t0
    cfg = parse_args(base)
    with open(os.path.join(REPO_DIR, manifest)) as f:
        n = cfg.val_repeat * sum(1 for line in f if line.count(",") >= 1)
    eval_steps = 2 * -(-n // cfg.batch_size)
    hist = {}
    for name in runs:
        run = os.path.join(OUT_DIR, "cli_dist", name, cfg.id)
        with open(os.path.join(run, "history_latest.json")) as f:
            hist[name] = json.load(f)
        for branch in ("av", "ao"):
            check_results(read_results(run, branch), hist[name],
                          "val_" + branch, n)
        for r in got[name]:
            expect_launches(f"cli_dist {name}", r["launches"],
                            2 * CLI_DIST_ITERS + 3 * eval_steps, eval_steps)
        if name != "one" and got[name][1]["writes"]:
            raise AssertionError(f"cli_dist {name}: rank 1 wrote "
                                 f"{got[name][1]['writes']}")
    losses = {name: h["train"]["err"] for name, h in hist.items()}
    loss_err = max(abs(a / b - 1.0) for a, b in
                   zip(losses["replicate"], losses["one"]))
    meter_err = meters_err(meters_of(hist["replicate"]),
                           meters_of(hist["one"]))
    emit("cli_dist", argv=base, batch_global=cfg.batch_size,
         iterations=CLI_DIST_ITERS, eval_steps_per_rank=eval_steps, clips=n,
         wall_s=wall, losses=losses, loss_rel_err=loss_err,
         meters={k: meters_of(h) for k, h in hist.items()},
         meters_err=meter_err, rank1_writes={k: got[k][1]["writes"]
                                             for k in ("replicate", "shard")},
         rank0_writes={k: len(got[k][0]["writes"]) for k in runs},
         tolerance=CLI_DIST_TOL,
         backend="gloo through the host, two ranks sharing one card",
         launches={k: [r["launches"] for r in v] for k, v in got.items()},
         cuts={"manifests": "data/mini/train.csv", "batch": [32, 4],
               "num_iters": [95001, CLI_DIST_ITERS + 1],
               "eval_iter": [1000, CLI_DIST_ITERS], "disp_iter": [20, 1],
               "val_repeat": [12, 1], "num_vis": [100, 0], "workers": [4, 0],
               "dtype": ["bfloat16", "float32"], "dft": ["matmul", "fft"]})
    if not (len(losses["replicate"]) == CLI_DIST_ITERS
            and np.isfinite(losses["shard"]).all()
            and loss_err <= CLI_DIST_TOL["loss_rel_err"]
            and meter_err <= CLI_DIST_TOL["meters_err"]):
        raise AssertionError(f"cli_dist: losses {losses}, meters off by "
                             f"{meter_err}")
    launches = {k: sum(r["launches"][k] for name in ("replicate", "shard")
                       for r in got[name]) for k in got["one"][0]["launches"]}
    return launches, 2 * 2 * (CLI_DIST_ITERS + eval_steps)


# ------------------------------------------------------------- slice 9
# cli_launch: one command over the cards it names (parallel/launch.py).
# The launched ranks are children of a ``--launch-child`` process of this
# script, which calls ``launch.run`` as the command lines do; each rank
# writes a report (its launches, step times, peak memory, writes, TF32
# flags) to a file.

LAUNCH_DIR = os.path.join(OUT_DIR, "launch")
# (b) and (c) run iterations 1 .. CLI_LAUNCH_ITERS, so each rank times a
# second, warm AV step; their history is held against one process over
# iterations 1 .. CLI_DIST_ITERS, which hold the eval
CLI_LAUNCH_ITERS = 5
# (b)'s failing launch, run beside (a): rank 1 raises once both ranks are
# up, rank 0 sleeps; the launcher must exit non-zero within this of its
# start and leave no rank.  The ranks' start-up (a spawned interpreter
# importing this script) read 14 to 29 s on the H100 machine, the stop
# itself takes at most the grace
LAUNCH_FAIL_DEADLINE_S = launch.STOP_GRACE_S + 80


def launch_entry(out_dir, cfg, device=None):
    """One launched rank of cli_launch: ``main.main`` with its kernels'
    launches counted, each train step timed (synchronized host clock), the
    samples its host loaders decoded and their seconds (summed over the
    loader's threads), its peak memory and the files it opened for writing
    under ``--ckpt``; the report goes to OUT_DIR/rank{r}.json."""
    import torch.distributed as dist

    from avsep_tpu_torch import main as cli_main
    times = []
    make = train.make_train_step

    def timed_make(cfg_, nets, use_vis, *a, **kw):
        step = make(cfg_, nets, use_vis, *a, **kw)

        def timed(*sa, **skw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*sa, **skw)
            torch.cuda.synchronize()
            times.append(["AV" if use_vis else "AO",
                          1e3 * (time.perf_counter() - t0)])
            return out
        return timed

    train.make_train_step = timed_make
    rank, world = pdist.rank(), pdist.world_size()
    backend = dist.get_backend()
    card = torch.cuda.current_device()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with recorded_writes(cfg.ckpt) as writes, timed_decode() as decoded:
        cli_main.main(cfg, device)
    report = {"rank": rank, "world": world, "backend": backend,
              "card": card, "card_name": torch.cuda.get_device_name(card),
              "pid": os.getpid(), "launches": read_launches(),
              "step_ms": times, "writes": sorted(set(writes)),
              "decoded": len(decoded), "decode_s": sum(decoded),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "tf32": [torch.backends.cudnn.allow_tf32,
                       torch.backends.cuda.matmul.allow_tf32]}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def launch_fail_entry(out_dir, cfg, device=None):
    """A launched rank that writes its pid to OUT_DIR/rank{r}.pid and
    waits for the others to have written theirs, then raises on rank 1 and
    sleeps on the others (only the launcher ends them)."""
    rank = pdist.rank()
    with open(os.path.join(out_dir, f"rank{rank}.pid"), "w") as f:
        f.write(str(os.getpid()))
    pdist.barrier()
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(600)


def child_launch(argv) -> int:
    """``chip_smoke.py --launch-child KIND N_LOCAL BACKEND OUT ARGV...``:
    TF32 off (as the command lines' ``__main__``), then ``launch.run`` of
    :func:`launch_entry` (KIND ``run``) or :func:`launch_fail_entry`
    (``fail``), wrapped as ``main.main``, on ``parse_args(ARGV)``; N_LOCAL
    0 and BACKEND ``none`` leave the launcher's defaults (the cards there
    are, NCCL)."""
    import functools

    from avsep_tpu_torch import main as cli_main
    kind, n_local, backend, out_dir, *argv = argv
    engine.full_float32()
    fn = {"run": launch_entry, "fail": launch_fail_entry}[kind]
    entry = functools.update_wrapper(functools.partial(fn, out_dir),
                                     cli_main.main)
    launch.run(entry, parse_args(argv), n_local=int(n_local) or None,
               backend=None if backend == "none" else backend)
    return 0


def launch_child(kind, n_local, backend, name, argv, one_card):
    """Starts a ``--launch-child`` process reporting under LAUNCH_DIR/name;
    ``one_card`` shows it the first card alone (CUDA_VISIBLE_DEVICES)."""
    out = os.path.join(LAUNCH_DIR, name)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    env = dict(os.environ)
    if one_card:
        env["CUDA_VISIBLE_DEVICES"] = env.get(
            "CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return out, subprocess.Popen(
        [sys.executable, "-u", os.path.abspath(__file__), "--launch-child",
         kind, str(n_local), backend, out, *argv], cwd=REPO_DIR, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def launch_line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("[launch]")]
    if len(lines) != 1:
        raise AssertionError(f"cli_launch: {len(lines)} launch lines:\n"
                             f"{out[-3000:]}")
    return lines[0]


def _gone(pid):
    """The process has exited (it is absent, or a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _history_err(got, want, iters):
    """Loss history (first ``iters`` entries) and eval meters of ``got``
    against ``want``, relative."""
    first = list(range(1, iters + 1))
    if got["train"]["iter"][:iters] != first or \
            want["train"]["iter"][:iters] != first:
        raise AssertionError(f"cli_launch: iterations {got['train']['iter']}"
                             f" against {want['train']['iter']}")
    loss = max(abs(a / b - 1.0) for a, b in
               zip(got["train"]["err"][:iters], want["train"]["err"][:iters]))
    return loss, meters_err(meters_of(got), meters_of(want))


def _ranks_of(phase, out_dir, proc, width, timeout=DIST_TIMEOUT):
    """A ``--launch-child run``'s launch line and its ranks' reports."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: the launch exited {proc.returncode}"
                             f":\n{out[-3000:]}\n{err[-3000:]}")
    ranks = []
    for r in range(width):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return launch_line(out), ranks


def _check_ranks(phase, ranks, backend, iters, eval_steps):
    for r in ranks:
        expect_launches(f"{phase} rank {r['rank']}", r["launches"],
                        2 * iters + 3 * eval_steps, eval_steps)
        if r["backend"] != backend or any(r["tf32"]):
            raise AssertionError(f"{phase} rank {r['rank']}: backend "
                                 f"{r['backend']}, TF32 {r['tf32']}")
    if ranks[1]["writes"]:
        raise AssertionError(f"{phase}: rank 1 wrote {ranks[1]['writes']}")


def _step_ms(ranks):
    return [{k: [round(ms, 3) for kind, ms in r["step_ms"] if kind == k]
             for k in ("AV", "AO")} for r in ranks]


def cli_launch():
    """cli_launch, in three parts, with train_MUSIC.sh's flags in float32
    and cli_dist's cuts, ``--num_gpus 2`` (B = 2 x 2):

    (a) the clamp: ``python -m avsep_tpu_torch.main`` shown one card
        starts no child (its own process counts the launches) and prints
        width 1; its history against ``main.main`` alone in a child (the
        reference, which runs iterations 1 .. CLI_LAUNCH_ITERS and counts
        the samples its loaders decode);
    (b) the spawn path on one card: ``launch.run`` with ``n_local=2`` and
        gloo, two ranks sharing the card, iterations 1 .. CLI_LAUNCH_ITERS:
        per-rank step ms, peak memory, launches, samples decoded by each
        rank's loaders against the reference's, the history against the
        reference, rank 1 writing nothing; and, run beside (a), a launch
        whose rank 1 raises must exit non-zero within
        LAUNCH_FAIL_DEADLINE_S and leave no rank;
    (c) distinct cards, where there are two or more: ``--num_gpus 2`` as
        two NCCL ranks on two cards, as (b).

    Returns the launches and calls by path, one path per rank."""
    manifest = os.path.join("data", "mini", "train.csv")
    base = ["--mode", "train"] + script_flags("train_MUSIC.sh") + [
        "--dtype", "float32", "--dft", "fft", "--av_list_train", manifest,
        "--ao_list_train", manifest, "--list_val", manifest,
        "--num_gpus", "2", "--batch_size_per_gpu", "2",
        "--eval_iter", str(CLI_DIST_ITERS), "--disp_iter", "1",
        "--val_repeat", "1", "--num_vis", "0", "--workers", "0",
        "--frame_decode", "pil"]
    short = base + ["--num_iters", str(CLI_DIST_ITERS + 1)]
    long = base + ["--num_iters", str(CLI_LAUNCH_ITERS + 1)]
    ckpt = {k: os.path.join(LAUNCH_DIR, k, "ckpt")
            for k in ("clamp", "one", "gloo", "nccl")}
    cfg = parse_args(short)
    with open(os.path.join(REPO_DIR, manifest)) as f:
        n = cfg.val_repeat * sum(1 for line in f if line.count(",") >= 1)
    eval_steps = 2 * -(-n // cfg.batch_size)
    hist = {}

    def history_of(name):
        run = os.path.join(ckpt[name], cfg.id)
        with open(os.path.join(run, "history_latest.json")) as f:
            hist[name] = json.load(f)
        for branch in ("av", "ao"):
            check_results(read_results(run, branch), hist[name],
                          "val_" + branch, n)
        return hist[name]

    # (a), the one-process reference and the failing launch at once (the
    # failing launch's ranks only sleep or raise)
    for k in ckpt:
        shutil.rmtree(os.path.dirname(ckpt[k]), ignore_errors=True)
    fail_dir, proc = launch_child("fail", 2, "gloo", "fail",
                                  ["--num_gpus", "2"], one_card=True)
    t0 = time.perf_counter()
    failed = {}

    def drain():                    # its output, and when it exited
        failed["out"] = proc.communicate()
        failed["t"] = time.perf_counter()
    waiter = threading.Thread(target=drain, daemon=True)
    waiter.start()
    ref = spawn("cli", 1, *long, "--ckpt", ckpt["one"])
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=os.environ.get(
        "CUDA_VISIBLE_DEVICES", "0").split(",")[0])
    wall, out, clamp_launches, tf32 = run_module(
        "cli_launch (a)", "avsep_tpu_torch.main",
        short + ["--ckpt", ckpt["clamp"]], env=env)
    single, = reports("cli_launch reference", ref)
    line = launch_line(out)
    want = ("[launch] width 1 (main: min(--num_gpus 2, 1 local cards); "
            "fewer cards than --num_gpus 2, so its global batch of 4 rows "
            "runs on 1 card): rank 0 on cuda in this process, no group")
    if line != want:
        raise AssertionError(f"cli_launch (a): {line!r}")
    expect_launches("cli_launch (a)", clamp_launches,
                    2 * CLI_DIST_ITERS + 3 * eval_steps, eval_steps)
    one = history_of("one")
    loss_a, meters_a = _history_err(history_of("clamp"), one, CLI_DIST_ITERS)
    emit("cli_launch_clamp", argv=short, launch_line=line, wall_s=wall,
         launches=clamp_launches, tf32=tf32, loss_rel_err=loss_a,
         meters_err=meters_a, tolerance=CLI_DIST_TOL,
         losses=hist["clamp"]["train"]["err"],
         single_losses=one["train"]["err"][:CLI_DIST_ITERS])
    if not (loss_a <= CLI_DIST_TOL["loss_rel_err"]
            and meters_a <= CLI_DIST_TOL["meters_err"]):
        raise AssertionError(f"cli_launch (a): loss {loss_a}, meters "
                             f"{meters_a}")
    launches = {"cli_launch_clamp": clamp_launches}
    calls = {"cli_launch_clamp": CLI_DIST_ITERS + eval_steps}

    waiter.join(max(0.0, LAUNCH_FAIL_DEADLINE_S - (time.perf_counter() - t0)))
    if waiter.is_alive():
        proc.kill()
        waiter.join()
        raise AssertionError(f"cli_launch fail: the launch outlived "
                             f"{LAUNCH_FAIL_DEADLINE_S} s:\n"
                             f"{failed['out'][1][-3000:]}")
    err = failed["out"][1]
    pids = []
    for r in (0, 1):
        with open(os.path.join(fail_dir, f"rank{r}.pid")) as f:
            pids.append(int(f.read()))
    left = [p for p in pids if not _gone(p)]
    emit("cli_launch_fail", exit_code=proc.returncode,
         wall_s=failed["t"] - t0, deadline_s=LAUNCH_FAIL_DEADLINE_S,
         rank_pids=pids, left=left,
         stderr_tail=err.strip().splitlines()[-1:])
    if proc.returncode == 0 or left or "rank 1 fails on purpose" not in err:
        raise AssertionError(f"cli_launch fail: exit {proc.returncode}, "
                             f"left {left}:\n{err[-3000:]}")

    def ranks_phase(name, n_local, backend, one_card):
        load = os.getloadavg()[0]
        cpu0 = time.process_time()
        out_dir, proc = launch_child("run", n_local, backend, name,
                                     long + ["--ckpt", ckpt[name]], one_card)
        t0 = time.perf_counter()
        line, ranks = _ranks_of(f"cli_launch {name}", out_dir, proc, 2)
        wall = time.perf_counter() - t0
        want_backend = "gloo" if backend == "gloo" else "nccl"
        _check_ranks(f"cli_launch {name}", ranks, want_backend,
                     CLI_LAUNCH_ITERS, eval_steps)
        loss, meters = _history_err(history_of(name), one, CLI_DIST_ITERS)
        if not (loss <= CLI_DIST_TOL["loss_rel_err"]
                and meters <= CLI_DIST_TOL["meters_err"]):
            raise AssertionError(f"cli_launch {name}: loss {loss}, meters "
                                 f"{meters}")
        for r in ranks:
            launches[f"cli_launch_{name}_rank{r['rank']}"] = r["launches"]
            calls[f"cli_launch_{name}_rank{r['rank']}"] = \
                CLI_LAUNCH_ITERS + eval_steps
        # the host's load before the launch, and the CPU seconds this
        # (waiting) process took during it: host contention shows in both
        return dict(launch_line=line, wall_s=wall, host_load_1m=load,
                    parent_cpu_s=time.process_time() - cpu0,
                    cards=[[r["card"], r["card_name"]] for r in ranks],
                    step_ms_by_rank=_step_ms(ranks),
                    peak_mem_gib_by_rank=[r["peak_mem_gib"] for r in ranks],
                    decoded_by_rank=[r["decoded"] for r in ranks],
                    decode_s_by_rank=[r["decode_s"] for r in ranks],
                    single_decoded=single["decoded"],
                    single_decode_s=single["decode_s"],
                    launches_by_rank=[r["launches"] for r in ranks],
                    rank1_writes=ranks[1]["writes"],
                    rank0_writes=len(ranks[0]["writes"]),
                    loss_rel_err=loss, meters_err=meters,
                    losses=hist[name]["train"]["err"],
                    single_losses=one["train"]["err"],
                    tolerance=CLI_DIST_TOL)

    # (b): two gloo ranks sharing the first card
    check_compute_mode()
    res = ranks_phase("gloo", 2, "gloo", one_card=True)
    emit("cli_launch_gloo", argv=long, batch_global=cfg.batch_size,
         iterations=CLI_LAUNCH_ITERS, compared_iterations=CLI_DIST_ITERS,
         backend="gloo through the host, two ranks sharing one card", **res)

    # (c): two NCCL ranks on two cards
    cards = torch.cuda.device_count()
    if cards < 2:
        emit("cli_launch_nccl", ran=False, reason=f"{cards} card visible: "
             "two NCCL ranks on distinct cards need two or more")
    else:
        res = ranks_phase("nccl", 0, "none", one_card=False)
        emit("cli_launch_nccl", ran=True, argv=long, cards_visible=cards,
             batch_global=cfg.batch_size, iterations=CLI_LAUNCH_ITERS,
             compared_iterations=CLI_DIST_ITERS,
             backend="nccl, one rank per card", **res)
    return launches, calls


# ------------------------------------------------------------- slice 10

PROOF_DIR = os.path.join(OUT_DIR, "proof")
# the toy set of scripts/train_toy_av_proof_torch.sh cut to 3 videos per
# class (the recipe's loader mixes two classes per sample and holds one
# video of each class out: 8 train rows, 4 val rows); video 2 is held out
PROOF_SET = ["--classes", "cello", "flute", "violin", "trumpet",
             "--videos_per_class", "3", "--duration", "14", "--fps", "8",
             "--class_tokens"]
PROOF_VAL_VIDEO = "2"
# main.main on the toy AV recipe: iterations 1 .. PROOF_ITERS, an eval and
# the best / latest checkpoints at PROOF_ITERS; sop_main the same at
# train_SoPpp.sh's width
PROOF_ITERS = 4
SOP_PROOF_ITERS = 3
# the keys of the JAX tools' reports (tools/av_probe.py, tools/sop_probe.py)
AV_PROBE_KEYS = {"perm_acc", "perm_n", "pointing_acc", "pointing_mass_acc",
                 "pointing_n", "av_si_sdr", "av_sdr", "ao_si_sdr", "ao_sdr",
                 "mass_confusion", "mean_mass_on_token",
                 "mass_on_token_uniform"}
SOP_PROBE_KEYS = {"assign_acc", "assign_acc_sisdr", "assign_n", "av_si_sdr",
                  "av_sdr", "ao_si_sdr", "ao_sdr", "ckpt_tag"}


def proof_set():
    """The toy set (``tools.make_synthetic_data``), its train and val
    splits; returns (root, train.csv, train split, val split, seconds)."""
    from avsep_tpu_torch.tools import make_synthetic_data
    root = os.path.join(PROOF_DIR, "toy_tok")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_data.main(["--root", root, *PROOF_SET])
    with open(os.path.join(root, "train.csv")) as f:
        rows = [r.strip() for r in f if r.strip()]
    held = [r.split(",")[0].endswith(PROOF_VAL_VIDEO + ".wav") for r in rows]
    splits = []
    for name, keep in (("train_split.csv", False), ("val_split.csv", True)):
        splits.append(os.path.join(root, name))
        with open(splits[-1], "w") as f:
            f.write("\n".join(r for r, h in zip(rows, held) if h == keep)
                    + "\n")
    return (root, os.path.join(root, "train.csv"), *splits,
            time.perf_counter() - t0)


def n_rows(manifest):
    with open(manifest) as f:
        return sum(1 for line in f if line.count(",") >= 1)


def counted(fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counters set to 0 just before;
    returns (its result, the launches, wall seconds)."""
    reset_launches()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, read_launches(), time.perf_counter() - t0


def check_export(cfg, run, out_dir, sop):
    """``tools.export_reference_ckpt`` (on the CPU) on ``run``'s best
    checkpoint; its ``.pth`` files through ``models/torch_import`` into
    fresh nets, each tensor against the checkpoint's, bit for bit."""
    from avsep_tpu_torch import sop_main
    from avsep_tpu_torch.models import torch_import
    from avsep_tpu_torch.tools import export_reference_ckpt
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = (["--tag", "best", "--out", out_dir] + (["--sop"] if sop else [])
            + cfg)
    wrote = export_reference_ckpt.export(argv)
    pcfg = parse_args(cfg)
    saved = torch.load(os.path.join(run, "state_best.pt"),
                       map_location="cpu", weights_only=True)
    nets = (sop_main.build_sop_nets(pcfg, device="cpu") if sop
            else engine.build_nets(pcfg, device="cpu"))
    load = {"sound": lambda sd: torch_import.unet_state_dict_from_torch(
                sd, num_downs=int(pcfg.arch_sound[-1])),
            "frame": torch_import.resnet_state_dict_from_torch,
            "synthesizer": torch_import.synthesizer_state_dict_from_torch}
    tensors = 0
    for path in wrote:
        name = os.path.basename(path).split("_")[0]
        net = getattr(nets, name)
        net.load_state_dict(load[name](torch_import.load_torch_checkpoint(
            path)), strict=True)
        got, want = net.state_dict(), saved[name]
        if set(got) != set(want) or not all(
                torch.equal(got[k], want[k].cpu()) for k in want):
            raise AssertionError(f"proof_tools: {path} does not give back "
                                 f"the checkpoint's {name} net bit for bit")
        tensors += len(want)
    return {"files": [os.path.basename(p) for p in wrote],
            "tensors_bit_for_bit": tensors}


def proof_tools(dev, train_rates=None):
    """proof_tools: the proof and checkpoint tools of
    ``avsep_tpu_torch/tools/`` on the card, on the toy set
    (``tools.make_synthetic_data``, PROOF_SET):

    1. ``main.main``: the toy AV recipe (scripts/train_toy_av_proof_torch.sh
       at full width: unet7, resnet18dilated-256, hidsep/sig, B = 16,
       float32, TF32 off) for PROOF_ITERS iterations and one eval, which
       writes ``best`` and ``latest``;
    2. ``tools.av_probe.run_probe`` on ``best``: every key of the JAX
       report, ``pointing_n == 2 * perm_n``, finite SI-SDRs; 2 + 3 + 3
       frame_window and 2 overlap_add_normalize launches per val batch;
    3. ``tools.export_reference_ckpt`` on ``best`` (on the CPU), its files
       read back through ``models/torch_import``, bit for bit;
    4. ``sop_main.main`` at scripts/train_SoPpp.sh's width for
       SOP_PROOF_ITERS iterations and one eval, then
       ``tools.sop_probe.run_probe --probe_ckpt latest --val_repeat 8``
       (scripts/train_toy_sop_proof_torch.sh's probe) with the same checks
       and the export with ``--sop``;
    5. ``tools.schedule_proof.run_schedule_proof`` at its full compressed
       shape (201 iterations of unet5 / tinyconv, B = 8): every invariant;
    6. ``python -m avsep_tpu_torch.tools.bench_loader`` at B = 16 (the
       process loader, 8 workers, one frame per source at 224 px): its
       clips/s beside the train phase's AV and AO samples/s.

    Cuts: the set (3 videos per class, not 6), the iterations, ``--workers
    0`` (thread loaders: the process loader's workers would import this
    script, and torch with it) and ``--num_vis 0``.  Returns the launches
    and the calls (train, probe and eval steps) by path."""
    from avsep_tpu_torch import main as train_main
    from avsep_tpu_torch import sop_main
    from avsep_tpu_torch.tools import av_probe, schedule_proof, sop_probe
    t_phase = time.perf_counter()
    root, all_rows, train_csv, val_csv, set_s = proof_set()
    lists = ["--av_list_train", train_csv, "--ao_list_train", train_csv,
             "--list_val", val_csv]
    launches, calls, out = {}, {}, {"set": {
        "root": os.path.relpath(root, REPO_DIR), "rows": n_rows(all_rows),
        "train_rows": n_rows(train_csv), "val_rows": n_rows(val_csv),
        "seconds": set_s}}

    # 1-3. the toy AV recipe, its probe and its export
    av = script_flags("train_toy_av_proof_torch.sh") + lists + [
        "--id", "avproof", "--ckpt", os.path.join(PROOF_DIR, "ckpt"),
        "--workers", "0", "--num_iters", str(PROOF_ITERS + 1),
        "--eval_iter", str(PROOF_ITERS), "--disp_iter", "1"]
    cfg = parse_args(["--mode", "train"] + av)
    run = os.path.join(cfg.ckpt, cfg.id)
    shutil.rmtree(run, ignore_errors=True)
    _, got, wall = counted(train_main.main, cfg)
    val_steps = -(-cfg.val_repeat * n_rows(val_csv) // cfg.batch_size)
    expect_launches("proof_tools main", got,
                    2 * PROOF_ITERS + 3 * 2 * val_steps, 2 * val_steps)
    if not all(os.path.exists(os.path.join(run, f"state_{t}.pt"))
               for t in ("best", "latest")):
        raise AssertionError("proof_tools: main.main wrote no best / latest")
    launches["proof_main"], calls["proof_main"] = got, \
        PROOF_ITERS + 2 * val_steps
    out["main"] = {"wall_s": wall, "iterations": PROOF_ITERS,
                   "eval_steps": 2 * val_steps, "launches": got}

    pcfg = parse_args(["--mode", "eval"] + av)
    report, got, wall = counted(av_probe.run_probe, pcfg, os.path.join(
        root, "tokens.json"), tag="best")
    if set(report) != AV_PROBE_KEYS or report["pointing_n"] != \
            2 * report["perm_n"] or report["perm_n"] != \
            pcfg.val_repeat * n_rows(val_csv) or not np.isfinite(
                [report[k] for k in ("av_si_sdr", "av_sdr", "ao_si_sdr",
                                     "ao_sdr")]).all():
        raise AssertionError(f"proof_tools: av_probe report {report}")
    expect_launches("proof_tools av_probe", got, 8 * val_steps,
                    2 * val_steps)
    launches["av_probe"], calls["av_probe"] = got, 3 * val_steps
    out["av_probe"] = {"wall_s": wall, "report": report, "launches": got}
    reset_launches()
    out["export"] = check_export(av, run, os.path.join(PROOF_DIR, "pth"),
                                 sop=False)
    expect_launches("proof_tools export", read_launches(), 0, 0)

    # 4. SoP++ at train_SoPpp.sh's width, its probe and its export
    sop = opts_flags("train_SoPpp.sh") + lists + [
        "--num_gpus", "1", "--id", "sopproof", "--ckpt",
        os.path.join(PROOF_DIR, "ckpt"), "--workers", "0",
        "--num_iters", str(SOP_PROOF_ITERS + 1), "--eval_iter",
        str(SOP_PROOF_ITERS), "--disp_iter", "1", "--num_fsteps", "0",
        "--num_vis", "0"]
    scfg = parse_args(["--mode", "train"] + sop)
    shutil.rmtree(os.path.join(scfg.ckpt, scfg.id), ignore_errors=True)
    _, got, wall = counted(sop_main.main, scfg)
    sop_val = -(-scfg.val_repeat * n_rows(val_csv) // scfg.batch_size)
    expect_launches("proof_tools sop_main", got,
                    2 * SOP_PROOF_ITERS + 3 * 2 * sop_val, 2 * sop_val)
    launches["proof_sop_main"], calls["proof_sop_main"] = got, \
        SOP_PROOF_ITERS + 2 * sop_val
    out["sop_main"] = {"wall_s": wall, "batch": scfg.batch_size,
                       "iterations": SOP_PROOF_ITERS, "launches": got}
    probe_cfg = parse_args(["--mode", "eval"] + sop + ["--val_repeat", "8"])
    report, got, wall = counted(sop_probe.run_probe, probe_cfg, tag="latest")
    n = 8 * n_rows(val_csv)
    probe_steps = 3 * -(-n // probe_cfg.batch_size)
    if set(report) != SOP_PROBE_KEYS or report["assign_n"] != n or \
            not np.isfinite([report[k] for k in (
                "av_si_sdr", "av_sdr", "ao_si_sdr", "ao_sdr")]).all():
        raise AssertionError(f"proof_tools: sop_probe report {report}")
    expect_launches("proof_tools sop_probe", got, 3 * probe_steps,
                    probe_steps)
    launches["sop_probe"], calls["sop_probe"] = got, probe_steps
    out["sop_probe"] = {"wall_s": wall, "report": report, "launches": got}
    out["export_sop"] = check_export(
        sop, os.path.join(scfg.ckpt, scfg.id),
        os.path.join(PROOF_DIR, "pth_sop"), sop=True)

    # 5. the schedule proof at its full compressed shape
    sched_ckpt = os.path.join(PROOF_DIR, "sched")
    report, got, wall = counted(schedule_proof.run_schedule_proof,
                                all_rows, sched_ckpt)
    if not report["ok"]:
        raise AssertionError(f"proof_tools: schedule_proof failed "
                             f"{report['failures']}")
    scfg8 = parse_args(schedule_proof.cli_args(all_rows, sched_ckpt, 201,
                                               True))
    train_steps = (125 - 1) + (201 - 1 - 120)
    eval_steps = 2 * len(report["eval_iters"]) * -(
        -scfg8.val_repeat * n_rows(all_rows) // scfg8.batch_size)
    expect_launches("proof_tools schedule_proof", got,
                    2 * train_steps + 3 * eval_steps, eval_steps)
    launches["schedule_proof"], calls["schedule_proof"] = got, \
        train_steps + eval_steps
    out["schedule_proof"] = {"wall_s": wall, "train_steps": train_steps,
                             "eval_steps": eval_steps, "report": report,
                             "launches": got}

    # 6. the host loader against the train step
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "avsep_tpu_torch.tools.bench_loader", "--csv",
         train_csv, "--bs", str(B), "--one_frame"], cwd=REPO_DIR,
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"proof_tools: bench_loader exited "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    clips = float(re.search(r"= ([0-9.]+) clips/s", line).group(1))
    loader = {"line": line, "clips_per_s": clips, "wall_s":
              time.perf_counter() - t0, "host_cpus": os.cpu_count()}
    if train_rates:
        loader.update({f"train_{k}_samples_per_s": v
                       for k, v in train_rates.items()})
        loader.update({f"loader_over_train_{k}": clips / v
                       for k, v in train_rates.items()})
    else:
        loader["train_samples_per_s"] = "not measured in this run"
    out["bench_loader"] = loader
    emit("proof_tools", seconds=time.perf_counter() - t_phase, **out)
    return launches, calls


# ------------------------------------------------------------- slice 11

MEASURE_DIR = os.path.join(OUT_DIR, "measure")
# measure_tools: the cuts of each tool's run (its own defaults are larger)
MEASURE_ITERS = 4                 # bench, sep_dtype_ab: calls per timed run
MEASURE_SERVE_N = 64
MEASURE_LATENCY = ["--runs", "8", "--sweep_n", "32", "--waits", "0", "5",
                   "25"]
MEASURE_TRAIN_STEPS = 4
MEASURE_MFU_STEPS = 2
MEASURE_MEM_BUDGET_GIB, MEASURE_MEM_START = 8.0, 4
# frame_window / overlap_add_normalize launches per call of each kind the
# tools report in their ``calls``
PER_CALL = {"separate": (1, 1), "train_step": (2, 0), "prepare_stft": (2, 0),
            "forward_av": (2, 0), "frame_features": (0, 0)}
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "dft", "card"}


def expected_launches(calls):
    """The launches of ``calls`` (kind -> number) under ``PER_CALL``."""
    return {"frame_window": sum(n * PER_CALL[k][0] for k, n in calls.items()),
            "overlap_add_normalize": sum(n * PER_CALL[k][1]
                                         for k, n in calls.items())}


def nonfinite(obj, path=""):
    """The paths of every NaN or infinite number in a report."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in nonfinite(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in nonfinite(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not np.isfinite(obj):
        return [path]
    return []


def measure_tools(dev):
    """measure_tools: the seven measurement tools of
    ``avsep_tpu_torch/tools/`` on the card at flagship width (bench.py's
    flagship, seeded weights), each with the launch counters set to 0 just
    before its run:

    1. ``python -m avsep_tpu_torch.tools.bench --iters MEASURE_ITERS`` in a
       child (``run_module``): its last line carries bench.py's keys,
       ``vs_baseline`` null and a finite value;
    2. ``serve_bench`` with ``--n MEASURE_SERVE_N`` at its defaults
       (max_batch 16, 8 clients, 10 ms), audio-only and ``--av
       --frames_wire u8``;
    3. ``latency_report`` with a 3-point knee (``MEASURE_LATENCY``);
    4. ``train_throughput`` at B = 16, MEASURE_TRAIN_STEPS f32 steps, dft
       matmul;
    5. ``mfu_report`` at B = 16 (every piece, ``separate`` and
       ``train_step`` among them), dft matmul, f32: the hand count equal to
       FlopCounterMode on every forward piece, every MFU share at most 1;
    6. ``memory_report.run`` for f32 with remat off from B = 4 under
       MEASURE_MEM_BUDGET_GIB, and the separation at B = 16;
    7. ``sep_dtype_ab`` at B = 16, MEASURE_ITERS calls per run.

    Every number a tool reports must be finite, and its launches must be 1
    / 1 per ``separate`` call and 2 / 0 per train step (``PER_CALL``; an
    out-of-memory step of the memory sweep may have launched up to a
    step's).  Returns the launches and the calls by tool."""
    from avsep_tpu_torch.tools import (
        bench, latency_report, memory_report, mfu_report, sep_dtype_ab,
        serve_bench, train_throughput)
    t_phase = time.perf_counter()
    launches, calls, out = {}, {}, {}

    wall, stdout, got, _ = run_module(
        "measure_tools bench", "avsep_tpu_torch.tools.bench",
        ["--iters", str(MEASURE_ITERS)])
    line = json.loads(stdout.strip().splitlines()[-2])
    n = bench.WARMUP + bench.RUNS * MEASURE_ITERS
    if set(line) != BENCH_KEYS or line["vs_baseline"] is not None or \
            not np.isfinite(line["value"]) or line["value"] <= 0:
        raise AssertionError(f"measure_tools: bench line {line}")
    expect_launches("measure_tools bench", got, n, n)
    launches["measure_bench"], calls["measure_bench"] = got, n
    out["bench"] = {"line": line, "wall_s": wall}

    torch.cuda.empty_cache()
    runs = {
        "serve_bench": lambda: serve_bench.main(
            ["--n", str(MEASURE_SERVE_N)], device=dev),
        "serve_bench_av": lambda: serve_bench.main(
            ["--n", str(MEASURE_SERVE_N), "--av", "--frames_wire", "u8"],
            device=dev),
        "latency_report": lambda: latency_report.main(
            MEASURE_LATENCY + ["--out", os.path.join(
                MEASURE_DIR, "latency_report.json")], device=dev),
        "train_throughput": lambda: train_throughput.main(
            [str(B), str(MEASURE_TRAIN_STEPS), "float32", "matmul"],
            device=dev),
        "mfu_report": lambda: mfu_report.main(
            [str(B), str(MEASURE_MFU_STEPS), "matmul", "float32", "--out",
             os.path.join(MEASURE_DIR, "mfu_report.json")], device=dev),
        "memory_report": lambda: memory_report.run(
            int(MEASURE_MEM_BUDGET_GIB * 2 ** 30), MEASURE_MEM_START,
            variants=("f32",), device=dev, card=nvidia_smi_line()),
        "sep_dtype_ab": lambda: sep_dtype_ab.main(
            [str(B), str(MEASURE_ITERS)], device=dev),
    }
    for name, fn in runs.items():
        report, got, wall = counted(fn)
        bad = nonfinite(report)
        if bad:
            raise AssertionError(f"measure_tools {name}: non-finite {bad}")
        tool_calls = dict(report["calls"])
        oom = tool_calls.pop("train_step_out_of_memory", 0)
        want = expected_launches(tool_calls)
        if oom:  # the step that ran out of memory launched 0 to 2
            if not (want["frame_window"] <= got["frame_window"]
                    <= want["frame_window"] + 2 * oom
                    and got["overlap_add_normalize"]
                    == want["overlap_add_normalize"]
                    and not sum(got[k] for k in MOTION_KERNELS)):
                raise AssertionError(f"measure_tools {name}: launches {got}"
                                     f", expected {want} + up to {oom} "
                                     "steps")
        else:
            expect_launches(f"measure_tools {name}", got,
                            want["frame_window"],
                            want["overlap_add_normalize"])
        launches[f"measure_{name}"] = got
        calls[f"measure_{name}"] = sum(tool_calls.values())
        out[name] = {k: v for k, v in report.items()
                     if k not in ("calls", "card")}
        out[name].update(wall_s=wall, launches=got, calls=tool_calls)
        torch.cuda.empty_cache()

    mfu = out["mfu_report"]
    for piece in mfu_report.FORWARD_PIECES:
        if mfu["flops"][piece] != mfu["flops_hand_forward"][piece]:
            raise AssertionError(f"measure_tools mfu_report: {piece} counted "
                                 f"{mfu['flops'][piece]}, by hand "
                                 f"{mfu['flops_hand_forward'][piece]}")
    shares = [v for k in ("mfu_vs_dtype_peak", "mfu_vs_bf16_peak")
              for v in mfu[k].values()]
    if None in shares or max(shares) > 1.0:
        raise AssertionError(f"measure_tools mfu_report: shares {shares} "
                             f"for {mfu['card_name']}")
    mem = out["memory_report"]["configs"]["f32"]
    if mem["max_batch_fitting"] < MEASURE_MEM_START:
        raise AssertionError(f"measure_tools memory_report: {mem}")
    emit("measure_tools", seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi_line(), **out)
    return launches, calls


# ------------------------------------------------------------- slice 12

TRACE_DIR = os.path.join(OUT_DIR, "trace")
# trace_tools: trace_report's runs (dtype, dft) and steps; insitu_report's
# steps and host loaders; the class-token set it reads (360x640 frames, as
# the JAX tool's instructions write it, 8 s clips to cover 65535 samples)
TRACE_RUNS = (("float32", "fft"), ("bfloat16", "matmul"))
TRACE_STEPS = 2
INSITU_N = 4
INSITU_WORKERS = (0, 4)
INSITU_SET = ["--classes", "cello", "flute", "violin", "trumpet",
              "--videos_per_class", "3", "--duration", "8", "--class_tokens",
              "--img_size", "360", "640"]


def check_port_kernels(phase, port, steps):
    """The profile's frame_window launches equal its wrapper's counter over
    the same steps, 2 per train step; no overlap_add_normalize."""
    fw, ola = port["frame_window"], port["overlap_add_normalize"]
    if not (fw["launches"] == fw["launches_counted"] == 2 * steps
            and ola["launches"] == ola["launches_counted"] == 0):
        raise AssertionError(f"{phase}: port kernels {port}, expected "
                             f"{2 * steps} frame_window launches")


def trace_tools():
    """trace_tools: the two profiling tools of ``avsep_tpu_torch/tools/``
    on the card, each as its command line runs, in a child process
    (``run_module``): in this script's own process, after the earlier
    phases' profiler sessions, a profile was seen to miss kernel events
    (2 of the 4 frame_window launches its counter saw).

    1. ``python -m avsep_tpu_torch.tools.trace_report 16 TRACE_STEPS dtype
       dft`` for each of TRACE_RUNS (flagship width, its warm-up step
       first): the category shares sum to 100 within 1e-6, busy at most
       the wall, and the profile's ``frame_window_kernel`` events equal
       its counter's delta over the profiled steps, 2 per step;
    2. ``python -m avsep_tpu_torch.tools.insitu_report --batch 16 --n
       INSITU_N`` with each of INSITU_WORKERS host loaders, on a
       class-token set that ``tools.make_synthetic_data`` writes under
       build/chip_smoke/trace/: every key of the JAX report and the
       additions, every number finite, arm A a CUDA graph whose first
       replay's loss is within ``TRAIN_TOL["loss_rel_err"]`` of an eager
       step's from the same state, arm C's profile as in 1.

    Each child's launches must be 2 / 0 per train step it reports.
    Returns the launches and the calls by run."""
    from avsep_tpu_torch.tools import insitu_report, make_synthetic_data
    t_phase = time.perf_counter()
    launches, calls, out = {}, {}, {}
    for dtype, dft in TRACE_RUNS:
        name = f"trace_report_{dtype}_{dft}"
        path = os.path.join(TRACE_DIR, f"{name}.json")
        wall, _, got, _ = run_module(
            f"trace_tools {name}", "avsep_tpu_torch.tools.trace_report",
            [str(B), str(TRACE_STEPS), dtype, dft, "--out", path])
        with open(path) as f:
            r = json.load(f)
        bad = nonfinite(r)
        total = sum(r["category_pct"].values())
        if bad or abs(total - 100.0) > 1e-6 or \
                r["device_busy_ms_per_step"] > r["wall_ms_per_step"]:
            raise AssertionError(f"trace_tools {name}: non-finite {bad}, "
                                 f"shares sum to {total}, busy "
                                 f"{r['device_busy_ms_per_step']} ms of "
                                 f"{r['wall_ms_per_step']}")
        check_port_kernels(f"trace_tools {name}", r["port_kernels"],
                           TRACE_STEPS)
        n = r["calls"]["train_step"]
        expect_launches(f"trace_tools {name}", got, 2 * n, 0)
        launches[name], calls[name] = got, n
        out[name] = {k: r[k] for k in (
            "wall_ms_per_step", "device_busy_ms_per_step",
            "device_busy_frac_of_wall", "category_pct", "port_kernels",
            "card")}
        out[name].update(top_ops_pct=r["top_ops_pct"][:6], wall_s=wall)

    root = os.path.join(TRACE_DIR, "insitu_set")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    make_synthetic_data.main(["--root", root, *INSITU_SET])
    out["insitu_set_s"] = time.perf_counter() - t0
    want_keys = set(insitu_report.JAX_KEYS) | set(insitu_report.ADDED_KEYS)
    for workers in INSITU_WORKERS:
        name = f"insitu_report_w{workers}"
        path = os.path.join(TRACE_DIR, f"{name}.json")
        wall, _, got, _ = run_module(
            f"trace_tools {name}", "avsep_tpu_torch.tools.insitu_report",
            ["--batch", str(B), "--n", str(INSITU_N), "--root", root,
             "--workers", str(workers), "--out", path])
        with open(path) as f:
            r = json.load(f)
        numbers = {k: v for k, v in r.items() if k.startswith("clips_per_s")
                   or k.endswith(("_ms", "_ms_per_step", "_insitu_wall"))}
        bad = nonfinite(r) + [k for k, v in numbers.items() if v is None]
        if set(r) != want_keys or bad or \
                not r["arm_a_method"].startswith("cuda_graph"):
            raise AssertionError(f"trace_tools {name}: keys "
                                 f"{sorted(set(r) ^ want_keys)}, not finite "
                                 f"{bad}, arm A {r['arm_a_method']}")
        if not r["arm_a_check"]["rel_err"] <= TRAIN_TOL["loss_rel_err"]:
            raise AssertionError(f"trace_tools {name}: arm A's first replay "
                                 f"against an eager step {r['arm_a_check']}"
                                 f" > {TRAIN_TOL['loss_rel_err']}")
        check_port_kernels(f"trace_tools {name} arm C",
                           r["arm_c_port_kernels"], INSITU_N)
        n = r["calls"]["train_step"]
        expect_launches(f"trace_tools {name}", got, 2 * n, 0)
        launches[name], calls[name] = got, n
        out[name] = {**numbers, "arm_a_check": r["arm_a_check"],
                     "frame_route": r["frame_route"], "wall_s": wall}
    emit("trace_tools", seconds=time.perf_counter() - t_phase,
         nvidia_smi=nvidia_smi_line(), **out)
    return launches, calls


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2

    smi = nvidia_smi_line()
    engine.full_float32()
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
    check_ragged(dev, gen)
    rows += check_motion_stem(dev, flush)
    rows += check_motion_bn(dev, flush)
    check_motion_bn(dev, flush, "slowfast_r50")
    check_motion_bn(dev, flush, "x3d_m")
    rows += check_motion_conv_t3(dev, flush)
    check_slowfast_pathways(dev)
    check_x3d_pathway(dev)
    del flush

    sep_launches, nets, flagship = run_flagship(dev, gen)
    card_vs_cpu(dev, gen, nets)
    # each main path's launches, counted from 0 just before its run, and its
    # calls: separate() calls, train steps, eval steps, serve dispatches,
    # CLI runs, the demos' separate() calls, SoP++ steps (sop_cli: train
    # steps and eval steps; cli_eval: eval steps; cli_train: train steps)
    launches = {"separate": sep_launches,
                "separate_bf16": run_separate_bf16(nets, flagship)}
    del nets, flagship
    # a bfloat16 phase draws what its float32 partner draws, from a copy of
    # the generator, and the remat phase from a generator of its own: they
    # take no draw from ``gen``, so the phases after them keep their inputs
    launches["train_bf16"], _ = run_train(dev, fork(gen), "bfloat16")
    launches["train"], train_rates = run_train(dev, gen)
    launches["remat"] = run_remat(dev, torch.Generator().manual_seed(SEED))
    calls = {"separate": REQUESTS, "separate_bf16": REQUESTS,
             "train": TRAIN_STEPS, "train_bf16": TRAIN_STEPS,
             "remat": 2 * (1 + REMAT_TIMED), "eval": 2 * EVAL_BATCHES}
    train_card_vs_cpu(dev, fork(gen), "bfloat16")
    train_card_vs_cpu(dev, gen)
    launches["eval"] = run_eval(dev, gen)
    eval_card_vs_cpu(dev, gen)
    launches["cli_eval"], calls["cli_eval"] = cli_eval()
    launches["serve"], calls["serve"] = run_serve(dev)
    launches["separate_cli"], calls["separate_cli"] = run_separate_cli()
    duet, solo = write_manifests()
    launches["inference"], calls["inference"] = run_inference(duet, solo)
    launches["vis_t180"], calls["vis_t180"] = run_vis_t180(dev)
    launches["sop_train"], calls["sop_train"] = run_sop_train(dev, gen)
    sop_card_vs_cpu(dev, gen)
    launches["sop_cli"], calls["sop_cli"] = sop_cli()
    launches["pixelwise"], calls["pixelwise"] = run_pixelwise(duet)
    launches["cli_train"], calls["cli_train"] = cli_train()
    # slice 7, each phase from a generator of its own
    launches["clipatt_train"] = run_clipatt_train(dev)
    launches["clipatt_train_bf16"] = run_clipatt_train(dev, "bfloat16")
    launches["slowfast_train_bf16"] = run_clipatt_train(dev, "bfloat16",
                                                        "slowfast_r50")
    launches["x3d_train_bf16"] = run_clipatt_train(dev, "bfloat16", "x3d_m")
    calls.update(clipatt_train=CLIPATT_STEPS,
                 clipatt_train_bf16=CLIPATT_STEPS,
                 slowfast_train_bf16=CLIPATT_STEPS,
                 x3d_train_bf16=CLIPATT_STEPS,
                 clipatt_eval=2 * CLIPATT_EVAL_STEPS)
    launches["clipatt_eval"] = run_clipatt_eval(dev)
    clipatt_card_vs_cpu(dev, torch.Generator().manual_seed(SEED))
    decode = run_native()
    launches["cli_clipatt"], calls["cli_clipatt"] = cli_clipatt(decode)
    # slice 8, in child processes, each from a generator of its own
    (launches["dist_train"], calls["dist_train"]), \
        (launches["dist_eval"], calls["dist_eval"]) = run_dist_train()
    launches["dist_nccl"], calls["dist_nccl"] = run_dist_nccl()
    launches["cli_dist"], calls["cli_dist"] = cli_dist()
    # slice 9: the launcher, one path per rank
    more, more_calls = cli_launch()
    launches.update(more)
    calls.update(more_calls)
    # slice 10: the proof and checkpoint tools, one path per tool run
    more, more_calls = proof_tools(dev, train_rates)
    launches.update(more)
    calls.update(more_calls)
    # slice 11: the measurement tools, one path per tool run
    more, more_calls = measure_tools(dev)
    launches.update(more)
    calls.update(more_calls)
    # slice 12: the profiling tools, one path per tool run
    more, more_calls = trace_tools()
    launches.update(more)
    calls.update(more_calls)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # launches: the sum over the main paths' runs; by path and per call
    # beside
    table = [{**{k: (sum(p[r["name"]] for p in launches.values())
                     if k == "launches" else r[k]) for k in keys},
              "launches_by_path": {path: p[r["name"]]
                                   for path, p in launches.items()},
              "calls_by_path": calls,
              "launches_per_call": {path: p[r["name"]] / calls[path]
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


def kernel_phase_only(check):
    """A kernel phase alone (motion_stem, motion_bn, motion_conv_t3); it
    runs no main path, so it counts no launches."""
    def run():
        dev = torch.device(DEVICE)
        flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
        check(dev, flush)
        return {}, {}
    return run


def slowfast_only():
    """SlowFast R50's phases alone: motion_bn_slowfast, slowfast_pathways
    and slowfast_train_bf16; the last one's launches and its steps."""
    dev = torch.device(DEVICE)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    check_motion_bn(dev, flush, "slowfast_r50")
    del flush
    check_slowfast_pathways(dev)
    launches = run_clipatt_train(dev, "bfloat16", "slowfast_r50")
    return ({"slowfast_train_bf16": launches},
            {"slowfast_train_bf16": CLIPATT_STEPS})


def x3d_train_only():
    """X3D-M's BatchNorm kernels at its shapes (motion_bn_x3d), then its
    train phase: x3d_train_bf16's launches and its steps."""
    dev = torch.device(DEVICE)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    check_motion_bn(dev, flush, "x3d_m")
    del flush
    launches = run_clipatt_train(dev, "bfloat16", "x3d_m")
    return ({"x3d_train_bf16": launches}, {"x3d_train_bf16": CLIPATT_STEPS})


def x3d_pathway_only():
    """X3D-M's float32 net against the reference alone; it runs no main
    path, so it counts no launches."""
    check_x3d_pathway(torch.device(DEVICE))
    return {}, {}


def only(argv) -> int:
    """``python3 chip_smoke.py --only cli_launch``: the card line, the
    kernels' build and the cli_launch phase alone, for a machine with two
    or more cards (its part (c)); ``--only proof_tools`` the same with the
    proof_tools phase (without the train phase's rates), ``--only
    measure_tools`` with the measure_tools phase, ``--only trace_tools``
    with the trace_tools phase, ``--only motion_stem``, ``--only
    motion_bn`` and ``--only motion_conv_t3`` with the motion net's kernel
    phases, ``--only slowfast_train_bf16`` with that train phase, ``--only
    x3d_pathway`` and ``--only x3d_train_bf16`` with X3D-M's phases; then
    the launches by path."""
    phases = {"cli_launch": cli_launch,
              "proof_tools": lambda: proof_tools(torch.device(DEVICE)),
              "measure_tools": lambda: measure_tools(torch.device(DEVICE)),
              "trace_tools": trace_tools,
              "motion_stem": kernel_phase_only(check_motion_stem),
              "motion_bn": kernel_phase_only(check_motion_bn),
              "motion_conv_t3": kernel_phase_only(check_motion_conv_t3),
              "slowfast_train_bf16": slowfast_only,
              "x3d_pathway": x3d_pathway_only,
              "x3d_train_bf16": x3d_train_only}
    if len(argv) != 1 or argv[0] not in phases or \
            not torch.cuda.is_available():
        print("chip_smoke --only: cli_launch, proof_tools, measure_tools, "
              "trace_tools, motion_stem, motion_bn, motion_conv_t3, "
              "slowfast_train_bf16, x3d_pathway or x3d_train_bf16, on a GPU",
              file=sys.stderr)
        return 2
    engine.full_float32()
    emit("card", nvidia_smi=nvidia_smi_line(),
         devices=[torch.cuda.get_device_name(i)
                  for i in range(torch.cuda.device_count())],
         torch=torch.__version__, cuda=torch.version.cuda)
    kernels.build()
    launches, calls = phases[argv[0]]()
    print(json.dumps({"launches_by_path": launches, "calls_by_path": calls}))
    return 0


if __name__ == "__main__":
    sys.exit({"--dist-child": child, "--launch-child": child_launch,
              "--only": only}.get(
        sys.argv[1] if len(sys.argv) > 1 else "", lambda _: main())(
            sys.argv[2:]))
