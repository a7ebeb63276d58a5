"""Card-vs-CPU readings of chip_smoke.py's small train steps over seeds.

Runs one of chip_smoke.py's card-vs-CPU phases (``train``: an AV and an AO
step of the train_MUSIC.sh recipe at TRAIN_SMALL's size; ``bf16``: the
same in bfloat16; ``sop``: an AV stage-1, AO, stage-2 and stage-3 SoP++
step) once per seed, each from a generator of its own, and prints each
phase's JSON line with its readings and no limit applied: the spread that
a limit in ``chip_smoke.TRAIN_TOL`` / ``BF16_TOL`` / ``SOP_TOL`` should be
set from.  Needs a CUDA GPU; run from the repository's root:

    python3 tools/card_vs_cpu_spread.py bf16 --seeds 6
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from avsep_tpu_torch import engine  # noqa: E402
from avsep_tpu_torch.ops import kernels  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=("train", "bf16", "sop"))
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("card_vs_cpu_spread: no CUDA device")
    engine.full_float32()
    kernels.build()
    dev = torch.device("cuda")
    cs.check_tol = lambda *a, **k: None       # report, do not bound
    print(cs.nvidia_smi_line(), flush=True)
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        if args.phase == "sop":
            cs.sop_card_vs_cpu(dev, gen)
        else:
            cs.train_card_vs_cpu(dev, gen, "bfloat16" if args.phase == "bf16"
                                 else "float32")


if __name__ == "__main__":
    main()
