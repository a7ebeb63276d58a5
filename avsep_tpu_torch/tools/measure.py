"""What the measurement tools share: the flagship configuration, seeded
weights, the card's line, synchronized timing, closed-loop clients of the
service, the published peak rates and where reports go.

Every number a tool prints stands beside :func:`card_line`: the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them (``cpu`` when a test runs a tool's
functions on the CPU, where no time is a device's).
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from typing import Callable, List, Optional, Tuple

import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import FLAGSHIP, Config

REPO_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO_DIR, "build", "measure")
# a request or a client thread that takes longer has hung
WAIT_S = 600.0

# Published dense peaks by the name nvidia-smi and torch give the card:
# NVIDIA's H100 SXM data sheet at its 700 W limit (float32 outside the
# tensor cores, TF32 and bfloat16 on them).  A card not named here has no
# peak: the tools print null beside its name.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12,
                              "bfloat16": 989e12},
}


def flagship(**over) -> Config:
    """bench.py's flagship (``config.FLAGSHIP`` with weighted loss: unet7,
    resnet18dilated-256, hidsep/sig, one frame, log-frequency warp, binary
    masks) with the train step's loss fields (bce, match weight 0.1) of the
    JAX package's train_throughput and mfu_report; ``over`` on top."""
    return FLAGSHIP.replace(weighted_loss=1, loss="bce", match_weight=0.1,
                            **over)


def seeded_nets(cfg: Config, device=None, seed: int = 0) -> engine.Nets:
    """``cfg``'s nets on ``device`` with ``engine.init_params`` weights drawn
    from a CPU generator seeded with ``seed``."""
    return engine.init_params(cfg, engine.build_nets(cfg, device=device),
                              torch.Generator().manual_seed(seed),
                              device=device)


def card_line(device: torch.device) -> str:
    """The card's ``name, power limit`` from nvidia-smi, or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def device_name(device: torch.device) -> str:
    """``torch.cuda.get_device_name`` of a card, ``cpu`` for the CPU."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def best_seconds(fn: Callable[[], object], runs: int,
                 device: torch.device) -> float:
    """The least of ``runs`` host timings of ``fn()``, each from a
    synchronized start to a synchronized end."""
    times = []
    for _ in range(runs):
        synchronize(device)
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return min(times)


def percentile(sorted_values: List[float], p: float) -> float:
    """The JAX tools' percentile of a sorted list: element ``int(p * n)``,
    the median as element ``n // 2``."""
    return sorted_values[min(len(sorted_values) - 1,
                             int(p * len(sorted_values)))]


def closed_loop(submit: Callable[[int], object], n: int,
                clients: int) -> Tuple[float, List[float]]:
    """``clients`` threads take request indices 0 .. n - 1 in turn, each
    calling ``submit(i)`` (which returns a Future) and waiting for its
    result before taking the next.  Returns the wall seconds and the
    sorted request latencies in ms; re-raises the first client's error."""
    lats: List[float] = []
    errors: List[BaseException] = []
    lock = threading.Lock()
    indices = iter(range(n))

    def client():
        try:
            while True:
                with lock:
                    i = next(indices, None)
                if i is None:
                    return
                t0 = time.perf_counter()
                submit(i).result(timeout=WAIT_S)
                with lock:
                    lats.append((time.perf_counter() - t0) * 1e3)
        except Exception as e:  # reported by the caller's thread
            with lock:
                errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    if any(t.is_alive() for t in threads) or len(lats) != n:
        raise RuntimeError(f"closed loop: {len(lats)} of {n} requests "
                           f"answered within {WAIT_S} s")
    return wall, sorted(lats)


def report_path(out: Optional[str], name: str) -> str:
    """``out``, or ``build/measure/<name>`` under the checkout."""
    return out or os.path.join(OUT_DIR, name)


def write_json(report: dict, path: str) -> None:
    """``report`` as indented JSON at ``path`` (its directory made),
    written to a temporary file first so a reader never sees half."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)
