"""The training driver: the port's training step, fed as its command line
feeds it, on one card or data-parallel over several.

Traffic parameters (``benchmark/traffic/<mix>.json``): ``batch_per_card``
rows per card and step; ``first_iter``, the iteration of the script's
schedule at which the run stands (which steps are audio-visual, and the
SoP++ curriculum stage, follow from it and the configuration's flags);
``pool_clips``, the clips staged on each card; ``trace_steps``, the steps
of the profiled stretch.

Set-up builds the program's nets and state once, loads the benchmark's
seeded weights, stages the pool (with a video clip per entry where the
configuration loads clips; an AV batch carries the visual stream its
forward reads, ``data.visual_stream``), and drives the first three
iterations through the same call the window makes, on batches whose clips
all differ; those steps warm both step kinds, and the reference follows
them after the window (the program's losses, its first gradient as the
optimizer got it, and the parameters' change over the three).  Two more
steps finish the warm-up.
The window then runs steps until ``--seconds`` have passed, each step's
loss read back as ``main.py`` reads it.  Each batch is gathered on the card
from the staged pool, as the command line's prefetcher would have staged
it.  With ``--trace 1`` two profiled stretches of ``trace_steps`` follow
the window: one that traces the card's activity alone and gives its busy
time, then one that traces the host's ops too, for the breakdown, the
kernels' times and NCCL.

Over several cards the ranks come up as ``parallel/launch.py`` brings up
``main.py``'s (one spawned process per card, NCCL), every rank makes the
same global batches and keeps its rows, and a gloo flag ends the window on
the same step everywhere.  Rank 0 runs the reference over the global
batches.
"""

from __future__ import annotations

import functools
import gc
import json
import math
import os
import time
from typing import Dict, List

from benchmark import checks, data, harness, weights
from benchmark.counts import bytes as kbytes
from benchmark.counts import flops as kflops
from benchmark.harness import Cell, Outcome

RANKS_DIR = os.path.join(harness.OUT_DIR, "ranks")
CHECKED = 3
EXTRA_WARM = 2
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense


def port_config(config: Dict, world: int = 1):
    from avsep_tpu_torch.config import Config
    flags = {k: tuple(v) if isinstance(v, list) else v
             for k, v in config["flags"].items()}
    return Config(**flags).replace(num_gpus=world)


def _program(config: Dict, cfg, dev):
    """The program's nets by name, its train state and ``call(i, batch) ->
    metrics``: the step of iteration ``i`` as the command line calls it."""
    from avsep_tpu_torch import engine, train
    model = config["model"]
    if model == "avsep":
        nets = engine.build_nets(cfg, device=dev)
    else:
        from avsep_tpu_torch import sop_main
        nets = sop_main.build_sop_nets(cfg, device=dev)
    use_vis_fn = train.batch_scheduler(cfg)

    def make(state, swap_gen):
        if model == "avsep":
            steps = {v: train.make_train_step(cfg, state.nets, v, device=dev)
                     for v in (True, False)}

            def call(i, batch):
                return steps[use_vis_fn(i)](state, batch,
                                            generator=swap_gen)[1]
            return call
        from avsep_tpu_torch import sop_main
        from avsep_tpu_torch.sop_engine import stage_for_iter
        steps = {}

        def call(i, batch):
            v = use_vis_fn(i)
            stage = stage_for_iter(i, cfg.train_steps) if v else 0
            if (v, stage) not in steps:
                steps[(v, stage)] = sop_main.make_sop_train_step(
                    cfg, state.nets, v, max(stage, 1), device=dev)
            return steps[(v, stage)](state, batch)[1]
        return call

    return nets, use_vis_fn, make


def _stage(config: Dict, cfg, i: int, use_vis: bool) -> int:
    if config["model"] != "sop" or not use_vis:
        return 0
    from avsep_tpu_torch.sop_engine import stage_for_iter
    return stage_for_iter(i, cfg.train_steps)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Program:
    """One rank's program under the benchmark: the port's nets and train
    state built once and loaded with the seeded weights, the pool of clips
    staged on the card, and the step of each iteration as the command line
    calls it.  :meth:`checked_steps` drives the first steps and keeps what
    the reference is held to."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch

        from avsep_tpu_torch import engine, train
        from avsep_tpu_torch.parallel import distributed as pdist
        engine.full_float32()            # the command lines' precision
        self.cell, self.config, traffic = cell, cell.config, cell.traffic
        self.rank, self.world = pdist.rank(), pdist.world_size()
        self.dev = dev = engine.resolve_device(device)
        self.cfg = cfg = port_config(self.config, self.world)
        self.B, self.N = int(traffic["batch_per_card"]), cfg.num_mix
        self.Bg = self.B * self.world
        self.rows = slice(self.rank * self.B, (self.rank + 1) * self.B)
        nets, self.use_vis_fn, make = _program(self.config, cfg, dev)
        by_name = dict(train.modules(nets))
        gen = torch.Generator(device=dev)
        self.init = weights.make(
            by_name, gen.manual_seed(harness.sub_seed(seed, 0)), dev)
        weights.load(by_name, self.init)
        self.state = train.TrainState(0, nets,
                                      train.init_opt_state(cfg, nets))
        pdist.broadcast_state(self.state)
        self.pool = data.make_pool(
            int(traffic["pool_clips"]), cfg.audLen, cfg.audRate, cfg.imgSize,
            gen.manual_seed(harness.sub_seed(seed, 1)), dev,
            clip_len=cfg.clip_len if cfg.load_clips else 0)
        self.stream = data.visual_stream(self.config["flags"])
        self.idx_gen = torch.Generator(device=dev).manual_seed(
            harness.sub_seed(seed, 2))
        self.swap_gen = torch.Generator().manual_seed(
            harness.sub_seed(seed, 3))
        self.call = make(self.state, self.swap_gen)
        self.i = int(traffic["first_iter"])

    def random_indices(self):
        return data.source_indices(self.pool["audio"].shape[0], self.Bg,
                                   self.N, self.idx_gen, self.dev)

    def step(self, idx):
        """The step of the current iteration on the global batch ``idx``'s
        rows of this rank; returns ``(use_vis, loss)``."""
        import torch
        v = self.use_vis_fn(self.i)
        with torch.profiler.record_function("bench.batch"):
            batch = data.train_batch(self.pool, idx[self.rows], v,
                                     self.stream)
        err = float(self.call(self.i, batch)["err"])
        self.i += 1
        return v, err

    def checked_steps(self) -> None:
        """The first :data:`CHECKED` steps, on batches whose clips all
        differ: their losses, the first gradient as the optimizer got it
        (its momentum after one step, less the weight decay, in the groups
        that step advances), and each parameter's change over them."""
        from avsep_tpu_torch import train
        from benchmark.reference import train as rtrain
        self.checked = data.distinct_indices(
            self.pool["audio"].shape[0], self.Bg, self.N, CHECKED,
            self.idx_gen, self.dev)
        self.kinds, self.stages, self.swaps, self.losses = [], [], [], []
        p0 = {k: v for k, v in self.init.items() if rtrain.is_param(k)}
        for c, idx in enumerate(self.checked):
            v = self.use_vis_fn(self.i)
            self.kinds.append(v)
            self.stages.append(_stage(self.config, self.cfg, self.i, v))
            self.swaps.append(None if v else self.swap_gen.get_state())
            self.losses.append(self.step(idx)[1])
            if c == 0:
                # an AV step under CoLoc_ClipAtt leaves group frame as
                # it was
                frozen = rtrain.frozen_nets(self.config["flags"], v)
                moms = {k: b.detach().clone()
                        for g in self.state.opt_state.values()
                        if g is not None for k, b in g.momentum.items()
                        if rtrain.group_of(k) not in frozen}
                self.first = {k: moms[k] - self.cfg.weight_decay * p0[k]
                              for k in moms}
        self.change = {k: p.detach() - p0[k] for k, p in
                       train.named_parameters(self.state.nets)}

    def free(self) -> None:
        """Drop the program's nets and state and return their memory."""
        import torch
        del self.state, self.call
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str, tf32_on: bool = False,
                  rows: int = 0):
        """The reference over the checked steps' global batches (their
        first ``rows`` rows if given): ``(losses, first gradient,
        change)``."""
        import torch

        from benchmark.reference import train as rtrain
        from benchmark.reference.nets import Precision, tf32
        rows = rows or self.Bg
        batches = [data.train_batch(self.pool, idx[:rows], v, self.stream)
                   for idx, v in zip(self.checked, self.kinds)]
        uniforms = []
        for s in self.swaps:
            if s is None:
                uniforms.append(None)
                continue
            g = torch.Generator()
            g.set_state(s)
            uniforms.append(torch.rand(self.Bg, generator=g)[:rows])
        with tf32(tf32_on):
            losses, first, after = rtrain.follow(
                self.config, self.init, batches, self.kinds, uniforms,
                self.stages, Precision(precision))
        p0 = {k: v for k, v in self.init.items() if rtrain.is_param(k)}
        return losses, first, {k: after[k] - p0[k] for k in after}

    def numbers(self, ref, side=None) -> Dict[str, float]:
        """Every number of ``side`` (the program's readings, by default)
        against the reference's ``ref`` (``checks.train_numbers``)."""
        from benchmark.reference import train as rtrain
        losses, first, change = side or (self.losses, self.first,
                                         self.change)
        r_losses, r_first, r_change = ref
        return checks.train_numbers(
            losses, r_losses, first,
            {k: r_first.get(k, first[k] * 0) for k in first}, change,
            r_change, {k: v for k, v in self.init.items()
                       if rtrain.is_param(k)})

    def held(self, ref):
        """The program's numbers that the cell's limits name."""
        n = self.numbers(ref)
        return [harness.Check(k, n[k], float(v))
                for k, v in self.cell.limits.items() if k in n]


def train_rank(cell: Cell, seed: int, seconds: float, trace: bool,
               device, t_start: float) -> Dict:
    """One rank's run; returns what it read, as plain numbers."""
    import torch
    import torch.distributed as dist

    from avsep_tpu_torch.ops import kernels

    prog = Program(cell, seed, device)
    dev, cfg, traffic = prog.dev, prog.cfg, cell.traffic
    B, N, world = prog.B, prog.N, prog.world
    prog.checked_steps()
    for _ in range(EXTRA_WARM):
        prog.step(prog.random_indices())

    # ---- the window
    stop_group = dist.new_group(backend="gloo") if world > 1 else None
    flag = torch.zeros(1)

    def done(t0):
        if stop_group is None:
            return time.perf_counter() - t0 >= seconds
        flag.fill_(float(time.perf_counter() - t0 >= seconds))
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=stop_group)
        return bool(flag.item())

    if stop_group is not None:
        dist.barrier(group=stop_group)
    sync(dev)
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    n_av = n_ao = failed = 0
    while True:
        v, err = prog.step(prog.random_indices())
        n_av, n_ao = n_av + v, n_ao + (not v)
        failed += not math.isfinite(err)
        if done(t0):
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    out = {"rank": prog.rank, "world": world, "setup_s": setup_s,
           "window_s": window_s, "n_av": n_av, "n_ao": n_ao,
           "failed": failed, "rows": B}

    # ---- the profiled stretches: the card's activity alone, for its busy
    # time; then with the host's ops, for the breakdown
    if trace:
        from torch.profiler import ProfilerActivity
        from benchmark.trace import profile as tprof
        k = int(traffic["trace_steps"])

        def stretch():
            for _ in range(k):
                prog.step(prog.random_indices())
        # (a CPU run, in the tests, has no card's activity to trace)
        dev_tr = tprof.traced(stretch, [
            ProfilerActivity.CUDA if dev.type == "cuda"
            else ProfilerActivity.CPU], dev)
        fw0 = kernels.frame_window.launches
        tr = tprof.traced(stretch, [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA], dev)
        fw = tr.kernel(r"frame_window_kernel")
        length, n_fft, hop = cfg.audLen, cfg.stft_frame, cfg.stft_hop
        fw_bound = k * (kbytes.least_seconds(kbytes.frame_window(
            B, length, n_fft, hop)) + kbytes.least_seconds(
            kbytes.frame_window(B * N, length, n_fft, hop)))
        out.update({
            "busy_s": dev_tr.busy_s, "trace_window_s": dev_tr.wall_s,
            "trace_steps": k, "host_traced_step_s": tr.wall_s / k,
            "nccl_s": sum(tr.kernel(r"nccl")),
            "frame_window_s": sum(fw), "frame_window_launches": len(fw),
            "frame_window_counted": kernels.frame_window.launches - fw0,
            "frame_window_bound_s": fw_bound,
            "breakdown": tr.breakdown()})
        del dev_tr, tr
    out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0

    # ---- the reference, on rank 0, once the program's state is freed
    if prog.rank == 0:
        prog.free()
        out["checks"] = [c.__dict__ for c in prog.held(
            prog.reference(cell.config["flags"]["dtype"]))]
        out["losses"] = prog.losses
    return out


def _rank_entry(payload: Dict, cfg, device) -> None:
    """A spawned rank's entry (``launch.run`` calls it with the rank's
    group up): its run, written where the launching process reads it."""
    out = train_rank(**payload, device=device)
    path = os.path.join(RANKS_DIR, f"rank{out['rank']}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)


def _launch(cell: Cell, seed: int, seconds: float, trace: bool,
            t_start: float, device=None) -> List[Dict]:
    from avsep_tpu_torch.parallel import launch
    os.makedirs(RANKS_DIR, exist_ok=True)
    for name in os.listdir(RANKS_DIR):
        os.remove(os.path.join(RANKS_DIR, name))
    payload = {"cell": cell, "seed": seed, "seconds": seconds,
               "trace": trace, "t_start": t_start}
    launch.run(functools.partial(_rank_entry, payload),
               port_config(cell.config, cell.chips), device=device,
               n_local=cell.chips if device is not None else None)
    return [harness.load_json(os.path.join(RANKS_DIR, f"rank{r}.json"))
            for r in range(cell.chips)]


def device_of(dev, count: int, peak: int) -> Dict:
    import torch
    return {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu", "count": count, "memory_peak_bytes": peak}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Outcome:
    import torch

    from avsep_tpu_torch import engine
    if cell.chips > 1:
        ranks = _launch(cell, seed, seconds, trace, t_start, device)
        dev = torch.device("cuda", 0) if device is None \
            else torch.device(device)
    else:
        ranks = [train_rank(cell, seed, seconds, trace, device, t_start)]
        dev = engine.resolve_device(device)
    r0 = ranks[0]
    world, B = r0["world"], r0["rows"]
    steps = r0["n_av"] + r0["n_ao"]
    samples = steps * B * world
    flags = cell.config["flags"]
    per = kflops.per_kind(flags, B * world, cell.config["model"])
    flops = r0["n_av"] * per[True] + r0["n_ao"] * per[False]
    peak = PEAK_FLOPS[flags["dtype"]] * world
    out = Outcome(
        attempted=steps, failed=sum(r["failed"] for r in ranks),
        e2e={**{m["name"]: samples / r0["window_s"]
                for m in cell.end_to_end if m["unit"] == "samples/s"},
             "setup_s": r0["setup_s"]},
        checks=[harness.Check(**c) for c in r0["checks"]],
        device=device_of(dev, world,
                         max(r["memory_peak_bytes"] for r in ranks)),
        reading={"kind": "train", "mfu": 100.0 * flops / r0["window_s"]
                 / peak})
    print(f"window: {steps} steps ({r0['n_av']} AV, {r0['n_ao']} AO) of "
          f"{B} x {world} rows in {r0['window_s']:.3f} s; checked losses "
          f"{r0['losses']}",
          flush=True)
    if trace:
        busy = sum(r["busy_s"] for r in ranks) / len(ranks)
        out.device.update({"busy_s": busy,
                           "window_s": r0["trace_window_s"]})
        out.breakdown = r0["breakdown"]
        out.reading.update({
            "busy_s": busy, "window_s": r0["trace_window_s"],
            "steps": r0["trace_steps"], "step_s": r0["window_s"] / steps,
            "nccl_s": r0["nccl_s"],
            "frame_window_s": r0["frame_window_s"],
            "frame_window_bound_s": r0["frame_window_bound_s"],
            "frame_window_launches": r0["frame_window_launches"],
            "frame_window_counted": r0["frame_window_counted"]})
        unprofiled = out.reading["step_s"]
        traced = r0["trace_window_s"] / r0["trace_steps"]
        print(f"tracing overhead: {traced * 1e3:.3f} ms per step with the "
              f"card's activity traced, {r0['host_traced_step_s'] * 1e3:.3f}"
              f" ms with the host's ops too, against "
              f"{unprofiled * 1e3:.3f} ms unprofiled "
              f"({100 * (traced / unprofiled - 1):.1f} % added); idle "
              f"{100 * (1 - busy / r0['trace_window_s']):.2f} % of the "
              f"traced stretch, "
              f"{100 * (1 - busy / r0['trace_steps'] / unprofiled):.2f} % of "
              f"an unprofiled step; frame_window launches "
              f"{r0['frame_window_launches']} in the trace, "
              f"{r0['frame_window_counted']} counted", flush=True)
    return out
