"""Card-vs-CPU readings of chip_smoke.py's small train steps over seeds.

Runs one of chip_smoke.py's card-vs-CPU phases (``train``: an AV and an AO
step of the train_MUSIC.sh recipe at TRAIN_SMALL's size; ``bf16``: the
same in bfloat16; ``sop``: an AV stage-1, AO, stage-2 and stage-3 SoP++
step; ``clipatt``: an AV and an AO step of the clips branch at
CLIPATT_SMALL's size) once per seed, each from a generator of its own, and
prints each phase's JSON line with its readings (each parameter's and
momentum buffer's too) and no limit applied: the
spread that a limit in ``chip_smoke.TRAIN_TOL`` / ``BF16_TOL`` /
``SOP_TOL`` / ``CLIPATT_TOL`` should be set from.  Needs a CUDA GPU; run
from the repository's root:

    python3 tools/card_vs_cpu_spread.py bf16 --seeds 6

``--in-run`` reads the seeds in each named phase's place in one whole
``chip_smoke.py`` run instead, after the phases before it (``sop`` and
``clipatt`` only): chip_smoke runs from start to end with every check, its
own draw of each phase included, and the seeds' readings follow that
draw:

    python3 tools/card_vs_cpu_spread.py sop clipatt --seeds 6 --in-run
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from avsep_tpu_torch import engine  # noqa: E402
from avsep_tpu_torch.ops import kernels  # noqa: E402

PHASES = {
    "train": lambda dev, gen: cs.train_card_vs_cpu(dev, gen),
    "bf16": lambda dev, gen: cs.train_card_vs_cpu(dev, gen, "bfloat16"),
    "sop": cs.sop_card_vs_cpu,
    "clipatt": cs.clipatt_card_vs_cpu,
}
IN_RUN = {"sop": "sop_card_vs_cpu", "clipatt": "clipatt_card_vs_cpu"}


def read_seeds(phase, dev, seeds):
    """``phase`` once per seed with the limits lifted, then restored."""
    check = cs.check_tol
    cs.check_tol = lambda *a, **k: None       # report, do not bound
    try:
        for seed in range(seeds):
            print(f"seed {seed}", flush=True)
            PHASES[phase](dev, torch.Generator().manual_seed(seed))
    finally:
        cs.check_tol = check


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=sorted(PHASES))
    ap.add_argument("--seeds", type=int, default=6)
    ap.add_argument("--in-run", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("card_vs_cpu_spread: no CUDA device")
    dev = torch.device("cuda")
    cs.BY_NAME = True
    if args.in_run:
        if not set(args.phases) <= set(IN_RUN):
            sys.exit(f"--in-run reads {sorted(IN_RUN)} only")
        for phase in args.phases:
            own = getattr(cs, IN_RUN[phase])

            def in_place(dev, gen, own=own, phase=phase):
                own(dev, gen)
                read_seeds(phase, dev, args.seeds)
            PHASES[phase] = own
            setattr(cs, IN_RUN[phase], in_place)
        sys.exit(cs.main())
    engine.full_float32()
    kernels.build()
    print(cs.nvidia_smi_line(), flush=True)
    for phase in args.phases:
        read_seeds(phase, dev, args.seeds)


if __name__ == "__main__":
    main()
