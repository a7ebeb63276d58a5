"""Whether NCCL takes two ranks on one GPU: the error each rank sees.

    python3 tools/nccl_one_device_probe.py [--timeout SECONDS]

Starts two processes that join one NCCL group (``file://`` store under
build/), both on ``cuda:0``, and run one ``all_reduce``; prints one JSON
line with the card (nvidia-smi's name and power limit), its compute mode,
each rank's exit code and the last lines it wrote.  A rank still waiting
after ``--timeout`` seconds is killed and said to be.  This is why
chip_smoke.py's two-rank phases run gloo on CUDA tensors: a machine with
one card cannot give NCCL two ranks.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RANK = r"""
import datetime, sys
import torch, torch.distributed as dist
rank, init = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"file://{init}", rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
x = torch.ones(4, device="cuda:0")
dist.all_reduce(x)
torch.cuda.synchronize()
print("all_reduce returned", x.tolist(), flush=True)
dist.destroy_process_group()
"""


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    out_dir = os.path.join(REPO, "build", "nccl_probe")
    os.makedirs(out_dir, exist_ok=True)
    init = os.path.join(out_dir, f"init_{time.monotonic_ns()}")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), init],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    deadline = time.monotonic() + args.timeout
    ranks = []
    for r, p in enumerate(procs):
        try:
            out = p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
            killed = False
        except subprocess.TimeoutExpired:
            p.kill()
            out = p.communicate()[0]
            killed = True
        lines = [ln for ln in out.splitlines() if ln.strip()]
        ranks.append({"rank": r, "exit": p.returncode, "killed": killed,
                      "last_lines": lines[-12:]})
    print(json.dumps({"card": smi("name,power.limit"),
                      "compute_mode": smi("compute_mode"),
                      "ranks": ranks}))


if __name__ == "__main__":
    main()
