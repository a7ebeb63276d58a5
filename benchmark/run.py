"""The benchmark of ``avsep_tpu_torch`` on NVIDIA cards: one cell, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The run finds the cell's configuration,
traffic mix and limits by name (``benchmark/harness.py``), hands them to
the mix's general driver (``benchmark/drivers/<driver>.py``), which makes
the weights and inputs from ``--seed``, sets up and warms the program,
measures for ``--seconds`` seconds and compares what the timed path
produced with the plain reference (``benchmark/reference/``).  With
``--trace 1`` it also profiles a short steady stretch after the window and
prints the per-layer metrics instead of the end-to-end ones.

The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
Without a CUDA card, with fewer cards than the cell asks for, or when JAX
or the JAX package was loaded, the run exits non-zero and prints no result.
"""

import time

T_START = time.time()   # set-up is counted from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cards_missing(chips: int) -> str:
    """Why the run cannot measure on this machine, or ``""``."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA card is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards and "
                f"{torch.cuda.device_count()} are available")
    return ""


def run(args: argparse.Namespace, device=None, cell=None,
        t_start: float = T_START) -> int:
    """One run.  ``device`` and ``cell`` are for the tests, which drive a
    run on the CPU at a small size; a measuring run passes neither."""
    harness.set_cache_env()
    cell = cell or harness.find_cell(args.workload)
    if device is None:
        why = cards_missing(cell.chips)
        if why:
            print(f"benchmark: {why}; no result", file=sys.stderr)
            return 2
    driver = importlib.import_module(
        "benchmark.drivers." + cell.traffic["driver"])
    out = driver.run(cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t_start=t_start)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    line = harness.result_line(cell, out, bool(args.trace))
    for text in harness.check_lines(out.checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run(parse()))
