"""SoP++ train / eval command line: ``python -m avsep_tpu_torch.sop_main``.

Port of ``avsep_tpu/sop_main.py`` (reference ``SoP++/main.py:723-928``):
the SoP++ nets (the basis U-Net with ``extra_size == num_channels``, the
frame encoder, the synthesizer; the attention module is a function of
``fusion_type``), SGD groups ``sound`` (``sound.*``, ``frame.fc.*``),
``synth`` and ``frame`` (``train.py``; reference ``create_optimizer``
:743-756), the 3-stage curriculum switched on ``--train_steps``
(:670-688), AV / AO batch interleaving, and latest / best checkpoints of
the whole state (``checkpoint.py``).

A step is built per (branch, stage): AO steps run stage 0's AO branch,
built with ``max(stage, 1)`` as the JAX package does.  An AO step leaves
the frame net and the ``frame`` group as they were, while ``frame.fc``'s
momentum in group ``sound`` advances by its decay term
(``train._sgd_update``).  The eval step is ``sop_forward`` at stage 3,
then ``evaluate.score_masks``: 3 ``frame_window`` launches and 1
``overlap_add_normalize`` per step on a CUDA batch; a train step launches
``frame_window`` twice.

Data parallelism as in ``main.py`` (``parallel/``), over every local card
as the JAX package's ``sop_main`` (or ``--mesh_shape``'s), one rank per
card, and under ``--dist_coordinator --dist_nprocs --dist_procid`` over
every card of every process: the step's gradients, metrics and BatchNorm
statistics those of the global batch; the eval sweep is replicated and
gathered, and the primary rank writes.

The entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
and raise without a GPU; the command line has no device flag.  Torch is
imported inside the functions, so a process loader's worker (which
re-imports the main module) stays a numpy + PIL process.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np

from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.loader import DevicePrefetcher, iter_forever
from avsep_tpu_torch.main import build_loaders
from avsep_tpu_torch.utils.media import makedirs
from avsep_tpu_torch.utils.meters import AverageMeter, new_history

_UNET_DOWNS = {"unet5": 5, "unet6": 6, "unet7": 7}


def build_sop_nets(cfg: Config, device=None):
    """The SoP++ nets of ``cfg`` on ``device``, in eval mode (weights as
    PyTorch initializes them; :func:`init_sop_state` draws the reference's)."""
    from avsep_tpu_torch.engine import resolve_device
    from avsep_tpu_torch.models.resnet import FrameEncoder
    from avsep_tpu_torch.models.sop import BasisUnet
    from avsep_tpu_torch.models.synthesizer import Bias, InnerProd
    from avsep_tpu_torch.sop_engine import SopNets
    dev = resolve_device(device)
    sound = BasisUnet(fc_dim=cfg.num_channels,
                      num_downs=_UNET_DOWNS[cfg.arch_sound],
                      extra_size=cfg.num_channels,  # SoP++/main.py:731
                      n_sources=cfg.num_mix)
    frame = FrameEncoder(fc_dim=cfg.vis_channels, pool_type=cfg.img_pool,
                         dilate_scale=16 if "dilated" in cfg.arch_frame
                         else 0)
    synth = (InnerProd(fc_dim=cfg.num_channels)
             if cfg.arch_synthesizer == "linear" else Bias())
    return SopNets(*(net.to(dev).eval() for net in (sound, frame, synth)))


def init_sop_state(cfg: Config, nets, generator, device=None):
    """The reference's initializers drawn on the CPU from ``generator``
    (the sound net, then the frame net; the synthesizer starts at ones and
    zeros), then the reference ``.pth`` files of ``cfg.weights_*`` if given
    (SoP++/main.py:727-748), then the optimizer's initial state.  Returns a
    ``train.TrainState`` on ``device`` (``cuda`` unless ``"cpu"``)."""
    from avsep_tpu_torch import train
    from avsep_tpu_torch.engine import resolve_device
    from avsep_tpu_torch.models.torch_import import (
        load_torch_checkpoint, resnet_state_dict_from_torch,
        synthesizer_state_dict_from_torch, unet_state_dict_from_torch)
    from avsep_tpu_torch.sop_engine import SopNets
    dev = resolve_device(device)
    if generator.device.type != "cpu":
        raise ValueError("init_sop_state draws on the CPU; pass a CPU "
                         "torch.Generator")
    for net in nets:
        net.reset_parameters_(generator)
    nets = SopNets(*(net.to(dev).eval() for net in nets))
    if cfg.weights_sound.endswith(".pth"):
        nets.sound.load_state_dict(unet_state_dict_from_torch(
            load_torch_checkpoint(cfg.weights_sound),
            num_downs=_UNET_DOWNS[cfg.arch_sound]), strict=True)
    if cfg.weights_frame.endswith(".pth"):
        # a torchvision ImageNet dict has no conv fc: the fresh one stays
        sd = resnet_state_dict_from_torch(
            load_torch_checkpoint(cfg.weights_frame))
        nets.frame.load_state_dict({**nets.frame.state_dict(), **sd},
                                   strict=True)
    if cfg.weights_synthesizer.endswith(".pth"):
        nets.synthesizer.load_state_dict(synthesizer_state_dict_from_torch(
            load_torch_checkpoint(cfg.weights_synthesizer)), strict=True)
    return train.TrainState(0, nets, train.init_opt_state(cfg, nets))


def make_sop_train_step(cfg: Config, nets, use_vis: bool, stage: int,
                        device=None):
    """Returns ``step(state, batch) -> (state, metrics)``: one SoP++
    forward in train mode (AV at ``stage``, or AO), one backward and one
    SGD update of the groups that advance, in place; ``metrics`` holds the
    detached ``err`` and ``match_loss``.  The nets must lie on ``device``
    (``cuda`` unless ``device="cpu"``).  The spans are
    ``train.make_train_step``'s."""
    from avsep_tpu_torch import engine, train
    from avsep_tpu_torch.sop_engine import sop_forward
    from avsep_tpu_torch.utils import spans
    engine.nets_device(nets, device)
    kind = "av" if use_vis else "ao"

    def step(state, batch):
        with spans.span("train.step", kind=kind):
            with spans.span("train.forward"):
                err, outputs = sop_forward(state.nets, batch, cfg, use_vis,
                                           train=True, stage=stage)
            train.apply_gradients(cfg, state, err, use_vis)
            with spans.span("train.metrics"):
                metrics = train.step_metrics(err, outputs["match_loss"])
        return state, metrics

    return step


def make_sop_eval_step(cfg: Config, nets, use_vis: bool, device=None):
    """Returns ``step(batch, *, noise_uniforms=None, noise_generator=None)
    -> (metrics, outputs, preds_wav)``: ``sop_forward`` at stage 3 in eval
    mode, then the masks scored as ``evaluate.make_eval_step`` scores them
    (mixture STFT, unwarp, threshold, iSTFT, noise floor, BSS-eval);
    ``metrics`` holds ``[B]`` tensors ``sdr``, ``sir``, ``sar``,
    ``si_sdr`` and ``err_ps``.  The nets must lie on ``device``."""
    import torch

    from avsep_tpu_torch import engine
    from avsep_tpu_torch.evaluate import score_masks
    from avsep_tpu_torch.sop_engine import sop_forward
    dev = engine.nets_device(nets, device)

    @torch.no_grad()
    def step(batch, *, noise_uniforms=None, noise_generator=None):
        batch = {k: engine._to_device(v, dev) for k, v in batch.items()}
        _, outputs = sop_forward(nets, batch, cfg, use_vis, train=False,
                                 stage=3)
        metrics, preds_wav = score_masks(
            cfg, batch, outputs["pred_masks"], noise_uniforms=noise_uniforms,
            noise_generator=noise_generator)
        metrics["err_ps"] = outputs["err_ps"]
        return metrics, outputs, preds_wav

    return step


def sop_evaluate(cfg: Config, nets, loader, history: dict, itera: int, *,
                 device=None, draws: Optional[Iterable[Dict]] = None
                 ) -> None:
    """The val sweep of both branches through the SoP++ forward (the JAX
    package's ``_sop_evaluate``): a ragged final batch padded to the first
    batch's size, rounded up to a multiple of the ranks, by repeating its
    last row, the padded rows left out of the meters and rows;
    ``history[val_av | val_ao]``, and a per-sample ``results.csv`` under
    ``cfg.ckpt/visualization/sop_{av,ao}/``.  Under a process group each
    rank scores its rows of the replicated batch and the per-row metrics
    are gathered (``distributed.fetch``); the primary rank writes.

    ``draws``, if given, holds one dict per batch with ``noise_uniforms``
    (padded size; this rank's rows under a group) and serves both
    branches, as the JAX sweep restarts its key per branch; else the noise
    comes from a generator on the device seeded from ``cfg.seed``, per
    branch.  Runs on ``cuda`` unless ``device="cpu"``."""
    import torch

    from avsep_tpu_torch import engine
    from avsep_tpu_torch.parallel import distributed as pdist
    dev = engine.nets_device(nets, device)
    for use_vis in (True, False):
        meters = {k: AverageMeter() for k in
                  ("err", "sdr", "sir", "sar", "si_sdr")}
        step = make_sop_eval_step(cfg, nets, use_vis, device=dev)
        noise_gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        batch_draws = iter(draws) if draws is not None else None
        skip = engine.unused_visual_streams(cfg) if use_vis \
            else ("frames", "clips")
        csv_ls = []
        pad_to, P = None, pdist.world_size()
        for batch in loader:
            true_bs = len(batch["id"])
            pad_to = pad_to or -(-true_bs // P) * P
            padded = {k: (np.concatenate([v, np.repeat(
                v[-1:], pad_to - v.shape[0], axis=0)])
                if isinstance(v, np.ndarray) and v.shape[0] < pad_to else v)
                for k, v in batch.items()}
            kw = next(batch_draws) if batch_draws is not None else {
                "noise_generator": noise_gen}
            m, _, _ = step(engine.to_device(padded, dev, drop=skip, cfg=cfg,
                                            mode="replicate"), **kw)
            m = {k: v.cpu().numpy()[:true_bs]
                 for k, v in pdist.fetch(m).items()}
            meters["err"].update(float(np.mean(m["err_ps"])),
                                 weight=true_bs)
            for k in ("sdr", "sir", "sar", "si_sdr"):
                meters[k].update(float(np.mean(m[k])), weight=true_bs)
            for n in range(true_bs):
                csv_ls.append({"id": batch["id"][n],
                               "sdr": float(m["sdr"][n]),
                               "sir": float(m["sir"][n]),
                               "si-snr": float(m["si_sdr"][n])})
        key = "val_av" if use_vis else "val_ao"
        history[key]["iter"].append(itera)
        history[key]["err"].append(meters["err"].average())
        for k in ("sdr", "sir", "sar", "si_sdr"):
            history[key][k].append(meters[k].average())
        print("[SoP++ Eval] {} iter {}: SDR {:.3f} SIR {:.3f} SAR {:.3f} "
              "SI-SDR {:.3f}".format(key, itera, meters["sdr"].average(),
                                     meters["sir"].average(),
                                     meters["sar"].average(),
                                     meters["si_sdr"].average()))
        if not pdist.is_primary():
            continue
        save_dir = os.path.join(cfg.ckpt, "visualization",
                                "sop_av" if use_vis else "sop_ao")
        makedirs(save_dir, remove=False)
        with open(os.path.join(save_dir, "results.csv"), "w") as f:
            writer = csv.DictWriter(f, fieldnames=["id", "sdr", "sir",
                                                   "si-snr"])
            writer.writeheader()
            writer.writerows(csv_ls)


def main(cfg: Config, device=None) -> None:
    """Train or evaluate the SoP++ nets as ``cfg.mode`` says, joining and
    leaving the process group as ``main.main`` does."""
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
        resolve_device, to_device, unused_visual_streams)
    from avsep_tpu_torch.parallel import distributed as pdist
    from avsep_tpu_torch.parallel.mesh import mesh_from_config
    from avsep_tpu_torch.sop_engine import stage_for_iter
    from avsep_tpu_torch.train import batch_scheduler
    from avsep_tpu_torch.utils import spans

    dev = resolve_device(device)
    pdist.validate_global_batch(cfg)
    mesh_from_config(cfg)          # --mesh_shape against the ranks
    print("Model ID: {}".format(cfg.id))
    cfg = cfg.replace(ckpt=os.path.join(cfg.ckpt, cfg.id))
    if pdist.is_primary():
        makedirs(cfg.ckpt, remove=False)

    nets = build_sop_nets(cfg, device=dev)
    state = init_sop_state(cfg, nets, torch.Generator().manual_seed(cfg.seed),
                           device=dev)
    nets = state.nets

    history = new_history()
    start_i = 0
    if cfg.load_ckpt or cfg.restart_from_latest:
        h = ckpt_io.load_history(cfg.ckpt)
        if h is not None:
            history = h
            start_i = (history["train"]["iter"][-1]
                       if history["train"]["iter"] else 0)
            state = ckpt_io.restore_checkpoint(cfg.ckpt, state, "latest")
            print("Recovered from history.")

    av_loader, ao_loader, val_loader = build_loaders(
        cfg, val_only=cfg.mode == "eval",
        process_index=pdist.process_index(cfg),
        process_count=pdist.process_count(cfg))

    if cfg.mode == "eval":
        if not cfg.load_ckpt:
            if os.path.exists(os.path.join(cfg.ckpt, "state_best.pt")):
                state = ckpt_io.restore_checkpoint(cfg.ckpt, state, "best")
            else:
                print("WARNING: no best checkpoint found; evaluating "
                      "current params")
        pdist.broadcast_state(state)
        try:
            sop_evaluate(cfg, nets, val_loader, history, 0, device=dev)
        finally:
            val_loader.close()  # reap the worker processes
        print("Evaluation Done!")
        return

    pdist.broadcast_state(state)
    use_vis_fn = batch_scheduler(cfg)
    av_iter = DevicePrefetcher(
        iter_forever(av_loader),
        lambda b: to_device(b, dev, drop=unused_visual_streams(cfg),
                            cfg=cfg))
    ao_iter = DevicePrefetcher(
        iter_forever(ao_loader),
        lambda b: to_device(b, dev, drop=("frames", "clips"), cfg=cfg))
    steps: Dict = {}
    iter_time, data_time = AverageMeter(), AverageMeter()
    # best_err survives a resume through the history json
    best_holder = {"best_err": float(history.get("best_err", float("inf")))}
    try:
        for i in range(start_i + 1, cfg.num_iters):
            spans.correlate(i)
            use_vis = use_vis_fn(i)
            stage = stage_for_iter(i, cfg.train_steps) if use_vis else 0
            with spans.timed("train.data_wait") as wait:
                batch = next(av_iter if use_vis else ao_iter)
            data_time.update(wait.seconds)

            key = (use_vis, stage)
            if key not in steps:
                steps[key] = make_sop_train_step(cfg, nets, use_vis,
                                                 max(stage, 1), device=dev)
            state, metrics = steps[key](state, batch)
            iter_time.update(time.perf_counter() - wait.t0)

            if i % cfg.disp_iter == 0 and i != 0:
                with spans.span("train.loss_read"):
                    err = float(metrics["err"])
                print("iter: [{}/{}], stage: {}, Time: {:.2f}, "
                      "Data: {:.2f}, loss: {:.3f}".format(
                          i, cfg.num_iters, stage, iter_time.average(),
                          data_time.average(), err))
                history["train"]["iter"].append(i)
                history["train"]["err"].append(err)

            if i % cfg.eval_iter == 0 and i > 1:
                with spans.span("train.eval"):
                    sop_evaluate(cfg, nets, val_loader, history, i,
                                 device=dev)
                with spans.span("train.checkpoint"):
                    ckpt_io.checkpoint(cfg.ckpt, state, history, best_holder)
    finally:
        # release the prefetch threads and the loaders' worker processes
        av_iter.close()
        ao_iter.close()
        for ld in (av_loader, ao_loader, val_loader):
            ld.close()
    print("Training Done!")


if __name__ == "__main__":
    from avsep_tpu_torch.engine import full_float32
    from avsep_tpu_torch.parallel import launch
    full_float32()
    args = parse_args()
    if args.fusion_type not in ("Base", "MatchAtt"):
        args = args.replace(fusion_type="Base")
    np.random.seed(args.seed)
    launch.run(main, args)
