"""In-situ decomposition of the flagship AV training loop on the card, the
port of ``tools/insitu_report.py``.

Three arms at one configuration (the JAX tool's flagship, ``:81-93``: unet7
+ resnet18dilated-256, hidsep/sig, the same batch, dtype and dft), so the
residual of a training step can be attributed:

  A. **device floor**: one CUDA graph of the whole eager production AV
     step (``train.make_eager_train_step``; ``make_train_step`` replays
     its own graphs), captured once with ``torch.cuda.graph``
     after :data:`CAPTURE_WARMUP` eager steps on a side stream, replayed N
     times on a staged batch: wall per step with no dispatch and no host
     data, where the JAX tool runs one ``lax.scan`` dispatch over N steps.
     What a replay skips happens on the host, so it must have run before
     the capture: the kernels' build and load (``ops/kernels.py``), the
     cached window and warp tensors, cuDNN's algorithm choice.  A replay
     also repeats the captured learning rate and advances neither the SGD
     groups' counts nor the kernels' launch counters (host state); at N
     far below ``lr_steps`` the rate is the one an eager step would use
     (:data:`ARM_A_METHOD`).  The first replay, from a copy of the state,
     is held against one eager step from the same copy (``arm_a_check``).
     A capture that fails raises with its cause; nothing falls back.
  B. **dispatch loop**: N eager calls of the production step on the same
     staged batch: adds the per-step host dispatch, with no host data.
  C. **in situ**: N steps fed by the real pipeline, ``MusicMixDataset`` ->
     ``BatchLoader`` (``ProcessBatchLoader`` when ``--workers`` > 0, as
     ``main.build_loaders`` picks) -> ``DevicePrefetcher`` ->
     ``engine.to_device``; the prefetcher fills before the clock starts
     and each step's wait for data is timed.  Unless ``--no_profile`` it
     runs under ``torch.profiler``, and its device-busy time is the sum of
     its CUDA activity (``trace_report.aggregate``).

``B - A`` is the dispatch cost, ``C - B`` the host data cost that is not
hidden (:func:`derived`).  The report has the JAX report's keys
(``:205-221``) with its formulas, ``device`` being the card's name, plus
:data:`ADDED_KEYS`: ``arm_a_method``, ``arm_a_check``, ``card``
(nvidia-smi's name and power limit), ``frame_route`` (the host decode
route ``--frame_decode`` chose), ``arm_c_port_kernels`` (arm C's
``trace_report`` ``port_kernels``: ms per step and launches of each of the
port's kernels in its profile, beside its wrapper's counter) and ``calls``
(the eager step calls, the capture included, which is what the launch
counters see).

    python -m avsep_tpu_torch.tools.insitu_report [--batch 32] [--n 16]
        [--dtype bfloat16] [--dft matmul] [--root DIR] [--workers 0]
        [--frame_decode auto] [--no_profile] [--out PATH]

``--root`` (default ``insitu_set`` under the temporary directory) must hold
a ``train.csv``: ``python -m avsep_tpu_torch.tools.make_synthetic_data
--root DIR --img_size 360 640`` writes one.  Writes
``build/measure/insitu_report.json`` or ``--out``.  Runs on the GPU only;
on the CPU (``device="cpu"``) :func:`run` measures arms B and C and leaves
arm A and the profile null: a CUDA graph and device events need a card.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.data.dataset import MusicMixDataset
from avsep_tpu_torch.data.loader import (
    BatchLoader, DevicePrefetcher, ProcessBatchLoader, iter_forever)
from avsep_tpu_torch.tools import measure, trace_report

DEFAULT_ROOT = os.path.join(tempfile.gettempdir(), "insitu_set")
CAPTURE_WARMUP = 3
ARM_A_METHOD = (
    "cuda_graph: torch.cuda.graph capture of one production AV step after "
    f"{CAPTURE_WARMUP} eager steps on a side stream, replayed N times on the "
    "staged batch; a replay repeats the captured learning rate and advances "
    "neither the SGD groups' counts nor the launch counters (host state); "
    "at N far below lr_steps the rate equals the eager one")
JAX_KEYS = (
    "batch", "n_steps", "dtype", "dft", "frame_decode", "workers", "device",
    "dataset_root", "arm_a_scan_ms_per_step", "arm_b_dispatch_ms_per_step",
    "arm_c_insitu_ms_per_step", "dispatch_rpc_ms", "unhidden_host_data_ms",
    "mean_data_wait_ms", "device_busy_ms_per_step",
    "device_busy_frac_of_insitu_wall", "clips_per_s_insitu",
    "clips_per_s_scan_floor")
ADDED_KEYS = ("arm_a_method", "arm_a_check", "card", "frame_route",
              "arm_c_port_kernels", "calls")
NO_CARD = ("insitu_report arm A replays a CUDA graph of the train step and "
           "needs a card; {} has none")


def insitu_config(root: str, batch: int = 32, dtype: str = "bfloat16",
                  dft: str = "matmul", workers: int = 0,
                  frame_decode: str = "auto") -> Config:
    """The JAX tool's configuration on ``root/train.csv``; raises, naming
    the command that writes the set, when the manifest is missing."""
    csv = os.path.join(root, "train.csv")
    if not os.path.exists(csv):
        raise FileNotFoundError(
            f"{csv} missing — generate with: python -m avsep_tpu_torch."
            f"tools.make_synthetic_data --root {root} --img_size 360 640")
    return measure.flagship(
        dtype=dtype, dft=dft, av_list_train=(csv,), ao_list_train=(csv,),
        list_val=(csv,), batch_size_per_gpu=batch, num_gpus=1,
        workers=workers, frame_decode=frame_decode, train_repeat=200)


def build_loader(cfg: Config) -> Tuple[MusicMixDataset, BatchLoader]:
    """The train set of ``cfg.av_list_train[0]`` and its loader: a process
    loader when ``cfg.workers`` > 0, else the thread loader."""
    ds = MusicMixDataset(cfg.av_list_train[0], cfg, split="train")
    cls = ProcessBatchLoader if int(cfg.workers) > 0 else BatchLoader
    return ds, cls(ds, cfg.batch_size, shuffle=True,
                   num_workers=cfg.workers, seed=cfg.seed)


def putter(cfg: Config, device: torch.device):
    """A host batch -> the step's tensors on ``device``
    (``engine.to_device`` without the unused visual streams)."""
    drop = engine.unused_visual_streams(cfg)
    return lambda b: engine.to_device(b, device, drop=drop, cfg=cfg)


def _tensors(state: train.TrainState):
    """Every tensor a step writes: parameters, buffers, momentum."""
    out = [t for net in state.nets if net is not None
           for t in list(net.parameters()) + list(net.buffers())]
    out += [b for gs in state.opt_state.values() if gs is not None
            for b in gs.momentum.values()]
    return out


def snapshot(state: train.TrainState):
    return [t.detach().clone() for t in _tensors(state)]


@torch.no_grad()
def restore(state: train.TrainState, snap) -> None:
    """``snapshot``'s values back into the same tensors (in place, so a
    captured graph keeps reading and writing them)."""
    for t, s in zip(_tensors(state), snap):
        t.copy_(s)


def arm_a(step, state: train.TrainState, staged: Dict, n: int,
          device: torch.device) -> Tuple[float, Dict]:
    """Arm A: capture, then the first replay and one eager step, each from
    a copy of the state after the warm-up, then ``n`` timed replays.
    Returns (ms per step, the check)."""
    if device.type != "cuda":
        raise RuntimeError(NO_CARD.format(device))
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(CAPTURE_WARMUP):
            step(state, staged)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    snap = snapshot(state)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, metrics = step(state, staged)
    restore(state, snap)
    graph.replay()
    replay_err = float(metrics["err"])
    restore(state, snap)
    eager_err = float(step(state, staged)[1]["err"])
    del snap
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        graph.replay()
    torch.cuda.synchronize(device)
    ms = (time.perf_counter() - t0) / n * 1e3
    del graph, metrics
    torch.cuda.empty_cache()
    return ms, {"replay_err": replay_err, "eager_err": eager_err,
                "rel_err": abs(replay_err - eager_err)
                / max(abs(eager_err), 1e-30)}


def arm_b(step, state: train.TrainState, staged: Dict, n: int,
          device: torch.device) -> float:
    """Arm B: one warm step, then ``n`` timed eager steps on ``staged``."""
    step(state, staged)
    measure.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        step(state, staged)
    measure.synchronize(device)
    return (time.perf_counter() - t0) / n * 1e3


def arm_c(step, state: train.TrainState, prefetcher: DevicePrefetcher,
          n: int, device: torch.device, profile: bool
          ) -> Tuple[float, float, Optional[float], Optional[Dict]]:
    """Arm C: ``n`` steps on the prefetcher's batches (filled first);
    returns (ms per step, mean data wait ms, and when profiled the
    device-busy ms per step and the port's kernels as the profile and
    their counters saw them, else None, None)."""
    waits = []
    next(prefetcher)  # let the prefetcher fill before the clock starts

    def loop() -> float:
        measure.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(n):
            td = time.perf_counter()
            bd = next(prefetcher)
            waits.append(time.perf_counter() - td)
            step(state, bd)
        measure.synchronize(device)
        return time.perf_counter() - t0

    busy_ms = port = None
    if profile:
        records, wall, counted = trace_report.profile_steps(loop, 1, device)
        agg = trace_report.aggregate(records, n, wall)
        busy_ms, port = agg["device_busy_ms_per_step"], agg["port_kernels"]
        for k, v in port.items():
            v["launches_counted"] = counted[k]
    else:
        wall = loop()
    return wall / n * 1e3, float(np.mean(waits)) * 1e3, busy_ms, port


def derived(batch: int, a_ms: Optional[float], b_ms: float, c_ms: float,
            busy_ms: Optional[float]) -> Dict:
    """The JAX tool's arithmetic (``:205-221``); None where arm A or the
    busy time was not measured."""
    return {
        "dispatch_rpc_ms": None if a_ms is None else b_ms - a_ms,
        "unhidden_host_data_ms": c_ms - b_ms,
        "device_busy_frac_of_insitu_wall": busy_ms / c_ms if busy_ms
        else None,
        "clips_per_s_insitu": batch / (c_ms / 1e3),
        "clips_per_s_scan_floor": None if a_ms is None
        else batch / (a_ms / 1e3),
    }


def run(cfg: Config, state: train.TrainState, n: int, device=None,
        profile: bool = True, card: str = "cpu", root: str = "") -> Dict:
    """The three arms in the JAX tool's order on ``state`` (updated in
    place), arm A and the profile on a card only; returns the report."""
    dev = engine.nets_device(state.nets, device)
    on_card = dev.type == "cuda"
    step = train.make_eager_train_step(cfg, state.nets, use_vis=True,
                                       device=dev)
    ds, loader = build_loader(cfg)
    put = putter(cfg, dev)
    host_iter = iter_forever(loader)
    prefetcher = None
    try:
        # one host batch, staged once: the input of arms A and B
        staged = put(next(host_iter))
        a_ms, check = (arm_a(step, state, staged, n, dev) if on_card
                       else (None, None))
        b_ms = arm_b(step, state, staged, n, dev)
        prefetcher = DevicePrefetcher(host_iter, put)
        c_ms, data_ms, busy_ms, port = arm_c(
            step, state, prefetcher, n, dev, profile and on_card)
    finally:
        if prefetcher is not None:
            prefetcher.close()
        loader.close()
    calls = (CAPTURE_WARMUP + 2 if on_card else 0) + 1 + 2 * n
    return {"batch": cfg.batch_size, "n_steps": n, "dtype": cfg.dtype,
            "dft": cfg.dft, "frame_decode": cfg.frame_decode,
            "workers": cfg.workers, "device": measure.device_name(dev),
            "dataset_root": root,
            "arm_a_scan_ms_per_step": a_ms,
            "arm_b_dispatch_ms_per_step": b_ms,
            "arm_c_insitu_ms_per_step": c_ms,
            "mean_data_wait_ms": data_ms,
            "device_busy_ms_per_step": busy_ms,
            **derived(cfg.batch_size, a_ms, b_ms, c_ms, busy_ms),
            "arm_a_method": ARM_A_METHOD if on_card else None,
            "arm_a_check": check, "card": card,
            "frame_route": ds.frame_route, "arm_c_port_kernels": port,
            "calls": {"train_step": calls}}


def print_report(r: Dict) -> None:
    a, b, c = (r["arm_a_scan_ms_per_step"], r["arm_b_dispatch_ms_per_step"],
               r["arm_c_insitu_ms_per_step"])
    print(f"[{r['card']}] {r['dtype']} dft={r['dft']} B={r['batch']} "
          f"n={r['n_steps']} workers={r['workers']} "
          f"frames by {r['frame_route']}")
    if a is not None:
        print(f"A CUDA graph      : {a:8.1f} ms/step (device floor; first "
              f"replay vs eager err rel {r['arm_a_check']['rel_err']:.2e})")
        print(f"B dispatch loop   : {b:8.1f} ms/step "
              f"(+{r['dispatch_rpc_ms']:.1f} dispatch)")
    else:
        print(f"B dispatch loop   : {b:8.1f} ms/step")
    print(f"C in-situ loop    : {c:8.1f} ms/step "
          f"(+{r['unhidden_host_data_ms']:.1f} un-hidden host data; data "
          f"wait {r['mean_data_wait_ms']:.1f} ms)")
    busy = r["device_busy_ms_per_step"]
    if busy is not None:
        floor = f", {100 * busy / a:.0f}% of the graph's floor" if a else ""
        print(f"  device busy     : {busy:8.1f} ms/step "
              f"({100 * busy / c:.0f}% of in-situ wall{floor})")


def main(argv=None, device=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--dft", default="matmul", choices=["fft", "matmul"])
    ap.add_argument("--root", default=DEFAULT_ROOT,
                    help="synthetic dataset root (tools.make_synthetic_data "
                         "--img_size 360 640); train.csv must exist")
    ap.add_argument("--workers", type=int, default=0)
    ap.add_argument("--frame_decode", default="auto")
    ap.add_argument("--no_profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cfg = insitu_config(args.root, args.batch, args.dtype, args.dft,
                        args.workers, args.frame_decode)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    state = train.init_state(cfg, engine.build_nets(cfg, device=dev),
                             torch.Generator().manual_seed(0), device=dev)
    r = run(cfg, state, args.n, device=dev, profile=not args.no_profile,
            card=card, root=args.root)
    print_report(r)
    out = measure.report_path(args.out, "insitu_report.json")
    measure.write_json(r, out)
    print(f"report written to {out}")
    return r


if __name__ == "__main__":
    engine.full_float32()
    main()
