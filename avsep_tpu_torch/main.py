"""Train / eval command line: ``python -m avsep_tpu_torch.main --mode train``.

Port of ``avsep_tpu/main.py:43-310`` (reference ``main.py:604-801``): the
same flags (``scripts/train_MUSIC.sh`` and ``scripts/eval_MUSIC.sh`` parse
unchanged; see ``config.parse_args`` for the flags that raise), the same
loop: AV / AO batch interleaving, display / eval / checkpoint ticks, the
iteration and data-time meters, the history dict, latest and best
checkpoints.  The step is ``train.make_train_step``; the global batch is
``num_gpus * batch_size_per_gpu``.  The checkpoint carries the optimizer
state (``checkpoint.py``).

Data parallelism (``parallel/``), with the JAX package's widths: the
command line spans ``min(num_gpus, local cards)`` cards, or
``--mesh_shape``'s, one rank per card (``launch.run`` starts them), and
``--dist_coordinator host:port --dist_nprocs P --dist_procid i`` makes it
process i of P, each spanning every local card.  A step over the ranks
computes what one process computes on the global batch (``--dist_data
replicate``: every rank loads it and keeps its rows; ``shard``, with P > 1:
each process's ranks load the process's rows from a disjoint part of the
dataset).

``main(cfg)`` is one rank: it runs on ``cuda`` (the rank's card) and raises
without a GPU; ``main(cfg, device="cpu")`` runs on the CPU.  The command
line has no device flag.

This module imports torch, and the modules that do, inside its functions
only: a process loader's worker starts by importing the parent's main
module (multiprocessing re-imports it by name), and under ``python -m
avsep_tpu_torch.main`` that is this module, so its top level stays numpy
and the standard library and the workers stay light.
"""

from __future__ import annotations

import os
import time

import numpy as np

from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.dataset import MusicMixDataset
from avsep_tpu_torch.data.loader import (
    BatchLoader, ConcatDataset, DevicePrefetcher, ProcessBatchLoader,
    ShardDataset, iter_forever)
from avsep_tpu_torch.utils.media import makedirs
from avsep_tpu_torch.utils.meters import AverageMeter, new_history


def build_loaders(cfg: Config, val_only: bool = False,
                  process_index: int = 0, process_count: int = 1):
    """AV / AO / val loaders (reference main.py:633-657); ``val_only``
    skips the train datasets, so eval mode needs no train manifests.
    ``workers > 0`` gives process loaders for training (the reference's
    DataLoader ``num_workers``), 0 the in-process thread loader; the val
    loader has 4 workers whatever ``workers`` says, as the reference
    (main.py:656).

    Process ``process_index`` of ``process_count`` (the JAX package's,
    ``--dist_procid`` of ``--dist_nprocs``; each of its ranks runs these
    loaders): under ``dist_data=replicate`` every rank runs them alike
    (deterministic datasets, order-preserving loaders) and keeps its own
    rows of each batch (``engine.to_device``); under ``shard``, with more
    than one process, each process's train loaders draw
    ``batch/process_count`` rows from a disjoint ``1/process_count`` of the
    dataset (``ShardDataset``), so a global batch never holds a sample
    twice and every sample comes once per global epoch.  The val loader
    stays replicated, so the eval meters do not depend on the ranks."""
    shard = process_count > 1 and cfg.dist_data == "shard"
    train_bs = cfg.batch_size // process_count if shard else cfg.batch_size

    def maybe_shard(ds):
        if not shard:
            return ds
        sh = ShardDataset(ds, process_index, process_count)
        if len(sh) < train_bs:
            raise ValueError(
                f"dist_data=shard: {len(ds)} samples / {process_count} "
                "processes "
                f"leaves {len(sh)} per process — fewer than the "
                f"per-process batch {train_bs} (raise train_repeat or "
                f"use dist_data=replicate)")
        return sh

    cls = ProcessBatchLoader if int(cfg.workers) > 0 else BatchLoader
    val_ds = ConcatDataset([MusicMixDataset(p, cfg, split="val")
                            for p in cfg.list_val])
    val_loader = cls(val_ds, cfg.batch_size, shuffle=False, num_workers=4,
                     seed=cfg.seed)
    print("Frame decode: {} (--frame_decode {})".format(
        val_ds.datasets[0].frame_route, cfg.frame_decode))
    if val_only:
        return None, None, val_loader
    av_ds = ConcatDataset([MusicMixDataset(p, cfg, split="train")
                           for p in cfg.av_list_train])
    ao_ds = ConcatDataset([MusicMixDataset(p, cfg, split="train", seed=10)
                           for p in cfg.ao_list_train])

    def mk(ds):
        return cls(maybe_shard(ds), train_bs, shuffle=True,
                   num_workers=max(1, int(cfg.workers)), seed=cfg.seed,
                   drop_last=True)
    return mk(av_ds), mk(ao_ds), val_loader


def main(cfg: Config, device=None) -> None:
    """Train or evaluate as ``cfg.mode`` says, as one rank.  With
    ``dist_nprocs > 1`` and no group yet this process joins one first
    (``distributed.maybe_initialize``, before anything touches a card) and
    leaves it at the end, also on an error, so its peers do not wait in a
    collective; a rank of ``launch.run`` is in its group already."""
    from avsep_tpu_torch.parallel import distributed as pdist
    owned = pdist.maybe_initialize(cfg, device=device)
    try:
        _main(cfg, device)
    finally:
        if owned:
            pdist.shutdown()


def _main(cfg: Config, device) -> None:
    import torch
    from avsep_tpu_torch import checkpoint as ckpt_io
    from avsep_tpu_torch.engine import (
        build_nets, resolve_device, to_device, unused_visual_streams)
    from avsep_tpu_torch.evaluate import evaluate
    from avsep_tpu_torch.parallel import distributed as pdist
    from avsep_tpu_torch.parallel.mesh import mesh_from_config
    from avsep_tpu_torch.train import (
        batch_scheduler, init_state, make_train_step)

    dev = resolve_device(device)
    pdist.validate_global_batch(cfg)
    mesh = mesh_from_config(cfg)
    print("Model ID: {}".format(cfg.id))
    if mesh.size > 1:
        print(f"[dist] rank {mesh.rank} of a {mesh.size}-wide "
              f"'{mesh.axis_name}' axis on {dev}, process "
              f"{pdist.process_index(cfg)} of {pdist.process_count(cfg)}, "
              f"dist_data {cfg.dist_data}")
    cfg = cfg.replace(ckpt=os.path.join(cfg.ckpt, cfg.id))
    if pdist.is_primary():
        makedirs(cfg.ckpt, remove=False)

    nets = build_nets(cfg, device=dev)
    state = init_state(cfg, nets, torch.Generator().manual_seed(cfg.seed),
                       device=dev)
    nets = state.nets

    history = new_history()
    start_i = 0
    if cfg.load_ckpt:
        h = ckpt_io.load_history(cfg.ckpt)
        if h is not None:
            history = h
            start_i = history["train"]["iter"][-1] \
                if history["train"]["iter"] else 0
            state = ckpt_io.restore_checkpoint(cfg.ckpt, state, "latest")
            print("Recovered from history.")

    av_loader, ao_loader, val_loader = build_loaders(
        cfg, val_only=cfg.mode == "eval",
        process_index=pdist.process_index(cfg),
        process_count=pdist.process_count(cfg))

    if cfg.mode == "eval":
        if not cfg.load_ckpt:
            best = os.path.join(cfg.ckpt, "state_best.pt")
            if os.path.exists(best):
                state = ckpt_io.restore_checkpoint(cfg.ckpt, state, "best")
            else:
                print("WARNING: no best checkpoint found; evaluating "
                      "current params")
        pdist.broadcast_state(state)
        try:
            for use_vis in (True, False):
                evaluate(cfg, nets, val_loader, history, 0, use_vis,
                         device=dev)
        finally:
            val_loader.close()  # reap the worker processes
        print("Evaluation Done!")
        return

    pdist.broadcast_state(state)
    steps = {v: make_train_step(cfg, nets, v, device=dev)
             for v in (True, False)}
    # the copy of batch i + 1 to the device is issued while step i runs
    av_iter = DevicePrefetcher(
        iter_forever(av_loader),
        lambda b: to_device(b, dev, drop=unused_visual_streams(cfg),
                            cfg=cfg))
    ao_iter = DevicePrefetcher(
        iter_forever(ao_loader),
        lambda b: to_device(b, dev, drop=("frames", "clips"), cfg=cfg))
    # best_err survives a resume through the history json (the reference
    # resets it every run, main.py:797)
    best_holder = {"best_err": float(history.get("best_err", float("inf")))}
    try:
        _train_loop(cfg, state, history, best_holder, start_i, steps,
                    batch_scheduler(cfg), av_iter, ao_iter, val_loader, dev)
    finally:
        # release the prefetch threads and the loaders' worker processes
        # even when the loop raises
        av_iter.close()
        ao_iter.close()
        for ld in (av_loader, ao_loader, val_loader):
            ld.close()
    print("Training Done!")


def _train_loop(cfg, state, history, best_holder, start_i, steps, use_vis_fn,
                av_iter, ao_iter, val_loader, dev):
    import torch
    from avsep_tpu_torch import checkpoint as ckpt_io
    from avsep_tpu_torch.evaluate import evaluate
    from avsep_tpu_torch.parallel import distributed as pdist

    iter_time, data_time, match_meter = (AverageMeter(), AverageMeter(),
                                         AverageMeter())
    swap_gen = torch.Generator().manual_seed(cfg.seed)
    err_total = err_av = err_ao = 0.0
    av_count = ao_count = 0
    prof = None

    def _stop_trace():
        nonlocal prof
        if prof is not None:
            prof.stop()
            path = os.path.join(cfg.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            prof = None
            print(f"profiler trace written to {path}")

    try:
        for i in range(start_i + 1, cfg.num_iters):
            # a torch.profiler trace of iterations [profile_start,
            # profile_start + profile_steps), of the primary rank
            if cfg.profile_dir and i == cfg.profile_start and \
                    pdist.is_primary():
                from torch.profiler import ProfilerActivity, profile
                os.makedirs(cfg.profile_dir, exist_ok=True)
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
            if prof is not None and \
                    i == cfg.profile_start + cfg.profile_steps:
                _stop_trace()

            tic = time.perf_counter()
            use_vis = use_vis_fn(i)
            batch = next(av_iter if use_vis else ao_iter)
            data_time.update(time.perf_counter() - tic)

            state, metrics = steps[use_vis](state, batch, generator=swap_gen)
            err = float(metrics["err"])
            match_loss = float(metrics["match_loss"]) if use_vis else None
            iter_time.update(time.perf_counter() - tic)

            err_total += err
            if use_vis:
                match_meter.update(match_loss)
                err_av += err - match_loss * cfg.match_weight
                av_count += 1
            else:
                err_ao += err
                ao_count += 1

            if i % cfg.disp_iter == 0 and i != 0:
                # the live learning rates: the schedule decays past each
                # lr_steps boundary, first applied at iteration s + 1
                decay = 0.1 ** sum(i > s for s in cfg.lr_steps)
                print("iter: [{}/{}], Time: {:.2f}, Data: {:.2f}, "
                      "lr_sound: {}, lr_frame: {}, loss: {:.3f}, "
                      "loss_ao: {:.3f}, loss_av: {:.3f} loss_match {:.3f}"
                      .format(i, cfg.num_iters, iter_time.average(),
                              data_time.average(), cfg.lr_sound * decay,
                              cfg.lr_frame * decay,
                              err_total / cfg.disp_iter,
                              err_ao / ao_count if ao_count else 0.0,
                              err_av / av_count if av_count else 0.0,
                              match_meter.average() if use_vis else 0))
                history["train"]["iter"].append(i)
                history["train"]["err"].append(err_total / cfg.disp_iter)
                if ao_count:
                    history["train_ao"]["iter"].append(i)
                    history["train_ao"]["err"].append(err_ao / ao_count)
                if av_count:
                    history["train_av"]["iter"].append(i)
                    history["train_av"]["err"].append(err_av / av_count)
                err_total = err_av = err_ao = 0.0
                av_count = ao_count = 0
                match_meter.initialize(0, 0)

            if i % cfg.eval_iter == 0 and i > 1:
                for v in (True, False):
                    evaluate(cfg, state.nets, val_loader, history, i, v,
                             device=dev)
                ckpt_io.checkpoint(cfg.ckpt, state, history, best_holder)
    finally:
        # write a live trace if the loop ends or raises inside the window
        _stop_trace()


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    from avsep_tpu_torch.parallel import launch
    full_float32()
    args = parse_args()
    np.random.seed(args.seed)
    launch.run(main, args)
