"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <cell> --seeds <n>
        --base <seed> [--controls 3] [--out <path>]

A training cell: for each seed, the program's first steps as a run makes
them (``drivers/train.py``'s :class:`Program`), then the reference, then
on the first ``--controls`` seeds the control (the reference one
precision below the configuration's: fp8 under bfloat16, TF32 under
float32) and the fault that leaves half of each batch out (the reference
on the first half of the rows), each held to the reference as the program
is.  Each row also names the worst leaves of the gradient and of the
change, with their sizes and rounding; under a precision below float32 it
holds the reference in float32 to the reference as well, which shows the
precision's own noise leaf by leaf.  A data-parallel cell runs its ranks
as a run does.  A serving cell: for each seed, the reference's answers to
a run's sampled requests against the control's.  Prints one JSON line per
seed and writes them all to ``--out``.  A cell is found in
``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

from benchmark import checks, harness

CONTROL = {"bfloat16": ("fp8", False), "float32": ("float32", True)}


def _leaves(prog, side, ref, top: int = 4):
    """The ``top`` worst leaves of the first gradient and of the change
    of ``side`` against ``ref`` (those the change's gap takes, and every
    moving leaf whatever its rounding), each as ``[name, gap, elements,
    |side|, |ref|, |float32 spacing of p0|, the leaf's first-gradient
    gap]``: what names the cause of a worst leaf."""
    import torch
    p0 = {k: v for k, v in prog.init.items() if k in side[2]}
    first = {k: ref[1].get(k, side[1][k] * 0) for k in side[1]}
    grads = checks.leaf_gaps(side[1], first)
    moving = set(checks.moving_leaves(first))
    resolved = set(checks.resolved_leaves(ref[2], p0))
    out = {}
    for name, keep in (("grad", None), ("change", moving & resolved),
                       ("change_unresolved", moving - resolved)):
        a, b = (side[1], first) if name == "grad" else (side[2], ref[2])
        gaps = checks.leaf_gaps(a, b, keep)
        rows = []
        for k in sorted(gaps, key=gaps.get, reverse=True)[:top]:
            rows.append([k, gaps[k], int(a[k].numel()),
                         float(torch.linalg.vector_norm(a[k].double())),
                         float(torch.linalg.vector_norm(b[k].double())),
                         checks.spacing_norm(p0[k]), grads[k]])
        out[name] = rows
    out["leaves"] = {"all": len(side[2]), "moving": len(moving),
                     "resolved": len(moving & resolved)}
    return out


def train_seed(cell, seed: int, control: bool, device=None):
    from benchmark.drivers.train import Program
    prog = Program(cell, seed, device)
    prog.checked_steps()
    if prog.rank != 0:
        return None
    prog.free()
    dtype = cell.config["flags"]["dtype"]
    ref = prog.reference(dtype)
    mine = (prog.losses, prog.first, prog.change)
    row = {"seed": seed, "program": prog.numbers(ref),
           "program_leaves": _leaves(prog, mine, ref),
           "losses": prog.losses}
    if dtype != "float32":
        # the precision's own noise: the reference in float32 held to
        # the reference in the configuration's precision
        wide = prog.reference("float32")
        row["float32_reference"] = prog.numbers(ref, side=wide)
        row["float32_reference_leaves"] = _leaves(prog, wide, ref)
    if control:
        precision, tf32_on = CONTROL[dtype]
        ctrl = prog.reference(precision, tf32_on)
        row["control"] = prog.numbers(ref, side=ctrl)
        half = prog.reference(dtype, rows=prog.Bg // 2)
        row["half_batch"] = prog.numbers(ref, side=half)
    return row


def _train_ranks(payload, cfg, device):
    rows = [train_seed(payload["cell"], s, c, device)
            for s, c in payload["seeds"]]
    if rows[0] is not None:
        with open(payload["out"], "w") as f:
            json.dump(rows, f)


def serve_seed(cell, seed: int, device=None):
    """The program's answers (``engine.separate`` on padded batches of
    ``max_batch``, as a dispatch runs it) and the control's (the reference
    under TF32) to a run's sampled requests, each against the reference."""
    import torch

    from avsep_tpu_torch import engine
    from benchmark import weights
    from benchmark.drivers.serve import Requests, _port_cfg, serve_flags
    from benchmark.reference import music_hidsep as ref
    from benchmark.reference.nets import Precision, tf32
    engine.full_float32()
    dev = engine.resolve_device(device)
    flags = serve_flags(cell.config)
    cfg = _port_cfg(cell.config)
    nets = engine.build_nets(cfg, device=dev)
    by_name = {"sound": nets.sound, "frame": nets.frame}
    init = weights.make(by_name, torch.Generator(device=dev).manual_seed(
        harness.sub_seed(seed, 0)), dev,
        cell.config.get("serve_weights", "reference"))
    weights.load(by_name, init)
    n = int(round(cell.traffic["rate_per_s"] * 10))
    reqs = Requests(flags, cell.traffic, seed, n)
    P = Precision(flags["dtype"])
    B = int(cell.traffic["max_batch"])
    prog, ctrl = [], []
    for k in reqs.checked.tolist():
        mix = torch.from_numpy(reqs.mix(k))[None].to(dev)
        fr = reqs.frames_of(k)
        fr = None if fr is None else torch.from_numpy(fr)[None].to(dev)
        u = None if fr is not None else torch.tensor([0.25])
        with tf32(False):
            want = ref.separate(init, mix, fr, u, flags, P)[0].cpu()
            got = engine.separate(
                nets, mix.expand(B, -1), None if fr is None else
                engine.imagenet_normalize(fr.expand(B, *fr.shape[1:])), cfg,
                device=dev, swap_uniforms=None if u is None
                else u.expand(B))["wavs"][0].cpu()
        with tf32(True):
            control = ref.separate(init, mix, fr, u, flags, P)[0].cpu()
        prog.append(checks.wav_gap(got, want))
        ctrl.append(checks.wav_gap(control, want))
    return {"seed": seed, "program": checks.serve_numbers(prog),
            "control": checks.serve_numbers(ctrl),
            "program_gaps": sorted(prog)[-5:],
            "control_gaps": sorted(ctrl)[-5:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=7_000_000_000)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    cell = harness.find_cell(args.workload)
    seeds = [args.base + 7919 * s for s in range(args.seeds)]
    out = args.out or os.path.join("chiprun_out",
                                   f"calibrate_{args.workload}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if cell.traffic["driver"] == "serve":
        rows = [serve_seed(cell, s) for s in seeds]
    elif cell.chips > 1:
        from avsep_tpu_torch.parallel import launch
        from benchmark.drivers.train import port_config
        launch.run(functools.partial(_train_ranks, {
            "cell": cell, "out": out,
            "seeds": [(s, i < args.controls) for i, s in enumerate(seeds)]}),
            port_config(cell.config, cell.chips))
        rows = harness.load_json(out)
    else:
        rows = [train_seed(cell, s, i < args.controls)
                for i, s in enumerate(seeds)]
    for r in rows:
        print(json.dumps(r), flush=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
