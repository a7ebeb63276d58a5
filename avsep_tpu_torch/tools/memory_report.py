"""Peak device memory of the flagship AV train step and of the separation,
the port of ``tools/memory_report.py``.

The JAX tool reads XLA's compile-time ``memory_analysis()`` of the train
step (arguments + temporaries - aliased donations).  An eager port has no
compile step, so the port reads the peak from runs: for each of {float32,
bfloat16} x {remat off, on} it builds the train state once (seeded
``train.init_state`` weights), then runs one AV step
(``train.make_eager_train_step``: each batch size once, with no graph's
pool beside it) per batch, doubling the batch from
``--start_batch`` (the JAX tool's ``sweep_max_batch``) until the step no
longer fits the budget.  A point's ``peak_bytes`` is
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()``,
less what was allocated before the state was built: the parameters,
BatchNorm statistics and momentum buffers, the batch (float32 sources,
uint8 frames) and the step's activations and workspaces.

The budget (``--budget_gib``, by default the card's whole memory) is
enforced with ``torch.cuda.set_per_process_memory_fraction``: a step that
runs out of memory there (``torch.cuda.OutOfMemoryError``, then
``empty_cache()``) is the measured answer "does not fit"; so is a step
that an operator refuses for a tensor of 2**31 elements or more.  The
separation pipeline (bench.py's flagship, ``dft="matmul"``) is measured
alike at bench's batch.  A peak holds cuDNN's workspaces, whose size
cuDNN may choose from the memory it finds free: the same call can read
higher under a larger budget.

    python -m avsep_tpu_torch.tools.memory_report [--budget_gib G]
        [--start_batch 32] [--out PATH]

Writes ``build/measure/memory_report.json`` (or ``--out``) and prints a
table.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import gc
from typing import Callable, Dict, Sequence

import torch

from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.tools import measure
from avsep_tpu_torch.tools.bench import B as BENCH_BATCH
from avsep_tpu_torch.tools.bench import draw_inputs, timed_fn

VARIANTS = {
    "f32": dict(dtype="float32", remat=False),
    "f32+remat": dict(dtype="float32", remat=True),
    "bf16": dict(dtype="bfloat16", remat=False),
    "bf16+remat": dict(dtype="bfloat16", remat=True),
}
MAX_BATCH = 4096
# what a CUDA operator says when it refuses a tensor of 2**31 elements or
# more (the U-Net's bilinear upsample at B = 256): a batch the step cannot
# run at, whatever the memory
SIZE_REFUSED = "INT_MAX"


def gib(n: int) -> float:
    return round(n / 1024 ** 3, 3)


def sweep_max_batch(peak_of: Callable[[int], Dict], budget_bytes: int,
                    start_batch: int) -> Dict:
    """Double the batch from ``start_batch`` until ``peak_of(batch)`` (a
    dict with ``peak_bytes``) exceeds ``budget_bytes``, runs out of memory
    or is refused for its size (``SIZE_REFUSED``), or the batch reaches
    ``MAX_BATCH``; record every point.  The JAX tool's search
    (``tools/memory_report.py:116-140``), where XLA's refusal to compile
    stops it."""
    points = {}
    batch, fits_max = start_batch, 0
    while True:
        try:
            m = peak_of(batch)
        except RuntimeError as e:
            if not (isinstance(e, torch.cuda.OutOfMemoryError)
                    or SIZE_REFUSED in str(e)):
                raise
            points[str(batch)] = {"error": type(e).__name__,
                                  "detail": str(e)[:200]}
            break
        m["peak_gib"] = gib(m["peak_bytes"])
        m["fits"] = m["peak_bytes"] <= budget_bytes
        points[str(batch)] = m
        if not m["fits"]:
            break
        fits_max = batch
        if batch >= MAX_BATCH:
            break
        batch *= 2
    return {"max_batch_fitting": fits_max, "points": points}


def release() -> None:
    """Return the cached blocks to the card (after an out-of-memory error
    too, once its traceback is gone)."""
    gc.collect()
    torch.cuda.empty_cache()


def train_step_sweep(cfg: Config, budget_bytes: int, start_batch: int,
                     device: torch.device) -> Dict:
    """:func:`sweep_max_batch` over one AV train step of ``cfg``'s
    flagship state, built once; ``steps`` counts the steps that ran to
    their end, ``steps_out_of_memory`` the one that did not (out of
    memory or refused)."""
    base = torch.cuda.memory_allocated(device)
    state = train.init_state(cfg, engine.build_nets(cfg, device=device),
                             torch.Generator().manual_seed(0), device=device)
    step = train.make_eager_train_step(cfg, state.nets, use_vis=True,
                                       device=device)
    g = torch.Generator(device=device).manual_seed(3)
    steps = []

    def peak_of(batch: int) -> Dict:
        release()
        torch.cuda.reset_peak_memory_stats(device)
        T = 1 if cfg.one_frame else cfg.num_frames
        data = {"audios": 0.1 * torch.randn(
                    batch, cfg.num_mix, cfg.audLen, generator=g,
                    device=device),
                "frames": torch.randint(
                    0, 256, (batch, cfg.num_mix, T, cfg.imgSize,
                             cfg.imgSize, 3), generator=g, device=device,
                    dtype=torch.uint8)}
        err = step(state, data)[1]["err"]
        measure.synchronize(device)
        steps.append(batch)
        if not torch.isfinite(err):
            raise FloatingPointError(f"memory_report: loss {float(err)}")
        return {"peak_bytes": torch.cuda.max_memory_allocated(device)
                - base}

    try:
        res = sweep_max_batch(peak_of, budget_bytes, start_batch)
    finally:
        del state, step
        release()
    res["steps"] = len(steps)
    res["steps_out_of_memory"] = sum("error" in m
                                     for m in res["points"].values())
    return res


def separation_peak(cfg: Config, batch: int, device: torch.device) -> Dict:
    """Peak bytes of one flagship ``separate`` call at ``batch``, the
    seeded nets and the inputs included."""
    release()
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    nets = measure.seeded_nets(cfg, device)
    audio, frames = draw_inputs(cfg, batch, 1, device)
    timed_fn(nets, cfg, device)(audio[0], frames[0])
    measure.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del nets, audio, frames
    release()
    return {"batch": batch, "dft": cfg.dft, "peak_bytes": peak,
            "peak_gib": gib(peak)}


def run(budget_bytes: int, start_batch: int = 32,
        variants: Sequence[str] = tuple(VARIANTS), device=None,
        card: str = "cpu") -> Dict:
    """Every variant's sweep under ``budget_bytes`` (enforced by the
    process's memory fraction on the card, restored afterwards), then the
    separation at bench's batch.  ``calls`` counts the train steps and
    ``separate`` calls made (an out-of-memory step is not one: it may
    have launched part of a step's kernels)."""
    dev = engine.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"memory_report measures a card's memory, not "
                         f"{dev}")
    if dev.index is None:
        # the memory fraction is set per card, by index
        dev = torch.device("cuda", torch.cuda.current_device())
    report = {"card": card, "budget_gib": gib(budget_bytes), "configs": {},
              "separation": {}}
    steps = oom = 0
    total = torch.cuda.get_device_properties(dev).total_memory
    torch.cuda.set_per_process_memory_fraction(
        min(1.0, budget_bytes / total), dev)
    try:
        for name in variants:
            res = train_step_sweep(measure.flagship(**VARIANTS[name]),
                                   budget_bytes, start_batch, dev)
            steps += res.pop("steps")
            oom += res.pop("steps_out_of_memory")
            report["configs"][name] = res
        report["separation"][f"B{BENCH_BATCH}_matmul"] = separation_peak(
            measure.flagship(dft="matmul"), BENCH_BATCH, dev)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
    report["calls"] = {"train_step": steps, "separate": 1,
                       "train_step_out_of_memory": oom}
    return report


def print_table(r: Dict) -> None:
    print(f"# {r['card']}  (budget {r['budget_gib']} GiB)")
    for name, res in r["configs"].items():
        print(f"{name:12s} max batch fitting: {res['max_batch_fitting']}")
        for b, m in res["points"].items():
            if "error" in m:
                why = ("out of memory" if m["error"] == "OutOfMemoryError"
                       else "refused for its size")
                print(f"  B={b:>5}: {why} ({m['detail'][:60]})")
            else:
                print(f"  B={b:>5}: peak {m['peak_gib']:7.3f} GiB"
                      f"{'' if m['fits'] else '  DOES NOT FIT'}")
    for name, s in r["separation"].items():
        print(f"separation {name}: peak {s['peak_gib']} GiB")


def main(argv=None, device=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--budget_gib", type=float, default=None,
                    help="memory budget (default: the card's total)")
    ap.add_argument("--start_batch", type=int, default=32)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    budget = (int(args.budget_gib * 1024 ** 3) if args.budget_gib
              else torch.cuda.get_device_properties(dev).total_memory)
    r = run(budget, args.start_batch, device=dev, card=card)
    print_table(r)
    out = measure.report_path(args.out, "memory_report.json")
    measure.write_json(r, out)
    print(f"wrote {out}")
    return r


if __name__ == "__main__":
    engine.full_float32()
    main()
