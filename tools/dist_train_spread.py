"""Repeat chip_smoke.py's dist_train phase and print each run's readings.

dist_train holds two gloo ranks sharing the card against one process on
the same global batches and weights (``chip_smoke.DIST_TOL``).  Its inputs
are fixed (seeded batches, ``spread_weights``); what moves between runs is
the card's nondeterministic backward.  This runs the phase ``--runs``
times, each in fresh child processes as chip_smoke runs it, and prints
each run's ``dist_train`` line (every reading, the five worst momentum
buffers) with no limit applied, then one summary line: the spread a limit
in ``DIST_TOL`` should be set from.  Needs a CUDA GPU; run from the
repository's root:

    python3 tools/dist_train_spread.py --runs 8
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from avsep_tpu_torch import engine  # noqa: E402
from avsep_tpu_torch.ops import kernels  # noqa: E402

KEYS = ("loss_rel_err", "param_err", "momentum_l2_err",
        "momentum_global_l2_err", "bn_stats_err")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=8)
    args = ap.parse_args()
    engine.full_float32()
    print(cs.nvidia_smi_line(), flush=True)
    kernels.build()
    readings = []
    for _ in range(args.runs):
        r0, _ = cs.reports("dist_train", cs.spawn("dist_train", 2))
        res = r0["vs_single"]
        readings.append({k: res[k] for k in KEYS})
        print(json.dumps({"phase": "dist_train", **res}), flush=True)
    print(json.dumps({k: [r[k] for r in readings] for k in KEYS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
