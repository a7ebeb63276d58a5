"""Run the port's two toy learning proofs on the GPU and record each one's
wall time, peak device memory and probe report.

    python3 tools/toy_proofs_on_card.py [--root build/toy_tok]
        [--ckpt build/toy_ckpt] [--out build/toy_proofs]
        [--av_seeds 1234 4321] [av] [sop]

``av`` runs ``scripts/train_toy_av_proof_torch.sh`` (3000 iterations,
per-video backgrounds, f32) once per ``--av_seeds`` entry (default: the
recipe's own seed, 1234), ``sop`` runs
``scripts/train_toy_sop_proof_torch.sh`` (6000 iterations); both build the
class-token set under ``--root`` when it is missing.  Each script's output
goes to ``<out>/<name>.log``.  Peak memory is the largest ``memory.used``
that ``nvidia-smi`` reports for the card, sampled every 200 ms while the
script runs (the process's allocations, its CUDA context and the
allocator's cache).  The summary, with the card's name and power limit,
goes to ``<out>/summary.json`` and as the last line of the output.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"av": ("scripts/train_toy_av_proof_torch.sh", "avproof",
                  "av_probe.json"),
           "sop": ("scripts/train_toy_sop_proof_torch.sh", "sopproof",
                   "sop_probe_latest.json")}


def smi(query):
    return subprocess.run(
        ["nvidia-smi", "--id=0", f"--query-gpu={query}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def run(name, root, ckpt, out, seed=None):
    script, run_id, report = SCRIPTS[name]
    env = dict(os.environ)
    if seed is not None:
        run_id = f"{run_id}_s{seed}"
        env.update(ID=run_id, EXTRA_ARGS=f"--seed {seed}")
        name = f"{name}_s{seed}"
    peak = [0.0]
    stop = threading.Event()
    sampler = subprocess.Popen(
        ["nvidia-smi", "--id=0", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)

    def read():
        for line in sampler.stdout:
            if line.strip():
                peak[0] = max(peak[0], float(line))
            if stop.is_set():
                break

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    log = os.path.join(out, f"{name}.log")
    t0 = time.perf_counter()
    try:
        with open(log, "w") as f:
            rc = subprocess.run(["bash", script, root, ckpt], cwd=REPO,
                                env=env, stdout=f,
                                stderr=subprocess.STDOUT).returncode
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        sampler.terminate()
        sampler.wait(timeout=30)
        reader.join(timeout=30)
    with open(log) as f:
        text = f.read()
    summary = [line for line in text.splitlines()
               if line.startswith(("[AV probe]", "[SoP probe]"))]
    evals = re.findall(r"^\[(?:Eval Summary|SoP\+\+ Eval)\].*$", text, re.M)
    path = os.path.join(ckpt, run_id, report)
    probe = None
    if rc == 0 and os.path.exists(path):
        with open(path) as f:
            probe = json.load(f)
    return {"script": script, "seed": seed, "exit": rc, "wall_s": wall,
            "peak_memory_used_mib": peak[0], "probe": probe,
            "summary": summary, "last_evals": evals[-4:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", default=["av", "sop"],
                    choices=sorted(SCRIPTS))
    ap.add_argument("--root", default=os.path.join("build", "toy_tok"))
    ap.add_argument("--ckpt", default=os.path.join("build", "toy_ckpt"))
    ap.add_argument("--out", default=os.path.join("build", "toy_proofs"))
    ap.add_argument("--av_seeds", type=int, nargs="+", default=[None])
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    result = {"card": smi("name,power.limit"), "runs": {}}
    for name in args.which:
        for seed in (args.av_seeds if name == "av" else [None]):
            key = name if seed is None else f"{name}_s{seed}"
            result["runs"][key] = run(name, args.root, args.ckpt, args.out,
                                      seed)
            print(json.dumps({key: result["runs"][key]}), flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0 if all(r["exit"] == 0 for r in result["runs"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
