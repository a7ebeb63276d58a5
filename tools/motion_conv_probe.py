"""Where the clips branch's AV step goes: the motion net alone on the card.

Times one forward and backward of the fast pathway (``models/motion.py``,
base 8, stages ``[3, 4, 6, 3]``) in train mode over the 32 clips of a
B = 16 AV step (2 sources x 16 samples, 32 frames of 224x224), with CUDA
events, in float32 (TF32 off) and in bfloat16, each as the port runs it
and with settings the port does not use: cuDNN's autotuner
(``torch.backends.cudnn.benchmark``), the clips in a contiguous NCDHW
layout (the module's permute of ``[B, T, H, W, 3]`` clips hands cuDNN a
channels-last-3d input beside NCDHW weights), and the weights in the
channels-last-3d layout too.  Prints one JSON line per variant with the
median ms and the peak memory, and the card's name and power limit.
Needs a CUDA GPU; run from the repository's root:

    python3 tools/motion_conv_probe.py

``--macs`` prints instead, on any machine, the multiply-accumulates of the
fast pathway's convolutions per clip forward, counted from their output
shapes on the meta device.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
from avsep_tpu_torch import engine  # noqa: E402
from avsep_tpu_torch.models.layers import Conv3d  # noqa: E402
from avsep_tpu_torch.models.motion import ResNet3dFastOnly  # noqa: E402

CLIPS, FRAMES, SIDE, REPS = 32, 32, 224, 3


def run(dtype, benchmark, layout):
    torch.backends.cudnn.benchmark = benchmark
    net = ResNet3dFastOnly(dtype=dtype)
    net.reset_parameters_(torch.Generator().manual_seed(0))
    net = net.cuda().train()
    if layout == "channels_last_3d":
        net = net.to(memory_format=torch.channels_last_3d)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(CLIPS, FRAMES, SIDE, SIDE, 3, generator=gen,
                    device="cuda")
    if layout == "ncdhw":
        # a [B, T, H, W, 3] view whose permute is contiguous NCDHW
        x = x.permute(0, 4, 1, 2, 3).contiguous().permute(0, 2, 3, 4, 1)

    def step():
        net(x).float().sum().backward()

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(REPS):
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        step()
        e.record()
        torch.cuda.synchronize()
        ms.append(s.elapsed_time(e))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.backends.cudnn.benchmark = False
    return {"dtype": str(dtype).replace("torch.", ""),
            "cudnn_benchmark": benchmark, "layout": layout,
            "ms_fwd_bwd": float(np.median(ms)), "step_ms": ms,
            "peak_gib": peak}


def conv_macs_per_clip():
    """(all convs, the stem) multiply-accumulates of one clip's forward:
    each conv's output elements times its weights per output element."""
    net = ResNet3dFastOnly().to("meta")
    macs = {}

    def count(m, _, out):
        macs[m] = out.numel() * m.weight[0].numel()
    for m in net.modules():
        if isinstance(m, Conv3d):
            m.register_forward_hook(count)
    net(torch.empty(1, FRAMES, SIDE, SIDE, 3, device="meta"))
    return sum(macs.values()), macs[net.conv1]


def main() -> None:
    if "--macs" in sys.argv[1:]:
        macs, stem = conv_macs_per_clip()
        # the backward computes every weight gradient and every input
        # gradient but the stem's (the clips need none)
        flops = 2 * CLIPS * (3 * macs - stem)
        print(json.dumps({"conv_macs_per_clip_forward": macs,
                          "stem_macs_per_clip_forward": stem,
                          "clips_per_av_step": CLIPS,
                          "conv_flops_per_av_step_fwd_bwd": flops}))
        return
    if not torch.cuda.is_available():
        sys.exit("motion_conv_probe: no CUDA device")
    engine.full_float32()
    smi = subprocess.run(["nvidia-smi", "--id=0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for dtype in (torch.float32, torch.bfloat16):
        for benchmark, layout in ((False, "as_run"), (True, "as_run"),
                                  (False, "ncdhw"), (True, "ncdhw"),
                                  (False, "channels_last_3d")):
            print(json.dumps({"phase": "motion_conv_probe", "clips": CLIPS,
                              "frames": FRAMES, "side": SIDE,
                              **run(dtype, benchmark, layout)}), flush=True)
            torch.cuda.empty_cache()
    print(smi)


if __name__ == "__main__":
    main()
