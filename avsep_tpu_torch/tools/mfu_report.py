"""FLOPs and MFU of the flagship pipelines on the card, the port of
``tools/mfu_report.py``.

For each piece of the JAX tool -- ``prepare_stft`` (the mixture's and the
sources' STFT, warp, weights, masks), ``frame_features`` (the frame net on
each source's frame), ``forward_av`` (the AV training forward, no grad),
``separate`` (the batched separation) and ``train_step`` (forward,
backward and SGD update, the eager step of ``train.make_eager_train_step``,
whose operations the FLOP counter sees dispatched) -- it gives:

* the FLOPs of one call, counted from shapes by
  ``torch.utils.flop_counter.FlopCounterMode`` (forward and backward);
* beside it, a hand count of the forward: every convolution and linear
  module's ``2 * out.numel() * (in_channels / groups) * prod(kernel)``
  from its weight and output shapes (forward hooks), plus the pipeline's
  own GEMMs from the configuration's shapes (:func:`gemm_flops`: the DFT
  matmuls, the warp and unwarp).  On a forward piece the two agree
  exactly, or the tool raises.  The port's CUDA kernels (``frame_window``,
  ``overlap_add_normalize``) move bytes and do no FLOPs; bound through
  ctypes, the counter does not see them, and they count 0 in both;
* ms per call: ``n_steps`` synchronized calls after two warm-ups, the
  best of two timings;
* the MFU share against the published peak of the card that nvidia-smi
  names (``measure.PEAK_FLOPS``), for the dtype that ran (float32 with
  TF32 off, TF32, or bfloat16 for the nets' convolutions), and against
  the bfloat16 peak as the JAX tool reports it.  A card the tool does not
  know gets null beside its name.  A share above 1 is a fault of the
  count, and the tool raises;
* the train step's time breakdown of the JAX tool (``:217-231``).

    python -m avsep_tpu_torch.tools.mfu_report [batch] [n_steps] [dft]
        [dtype] [--out PATH]

(the JAX tool's argv: defaults 32, 16, fft, float32).  Writes
``build/measure/mfu_report[_<dft>][_<dtype>].json`` (or ``--out``) and
prints a table.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import contextlib
import math
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.ops.prepare import prepare
from avsep_tpu_torch.tools import measure
from avsep_tpu_torch.tools.train_throughput import synthetic_batches

PIECES = ("prepare_stft", "frame_features", "forward_av", "separate",
          "train_step")
FORWARD_PIECES = PIECES[:4]
# prepare()'s log-frequency bins, the U-Net's input height
WARP_BINS = 256
TIMING_REPS = 2
WARMUP = 2


# ------------------------------------------------------------- the counts


def module_flops(module: torch.nn.Module, out: torch.Tensor) -> int:
    """FLOPs of one call of a convolution or linear module, from its
    weight and output shapes (a multiply and an add per MAC)."""
    w = module.weight
    if isinstance(module, torch.nn.Linear):
        return 2 * out.numel() * w.shape[1]
    return 2 * out.numel() * w.shape[1] * math.prod(w.shape[2:])


@contextlib.contextmanager
def hand_count(nets):
    """Counts, in ``box["flops"]``, the FLOPs of every convolution and
    linear module of ``nets`` called inside the block (forward hooks)."""
    box = {"flops": 0}

    def hook(module, _inputs, out):
        box["flops"] += module_flops(module, out)

    handles = [m.register_forward_hook(hook)
               for net in nets if net is not None for m in net.modules()
               if isinstance(m, (torch.nn.modules.conv._ConvNd,
                                 torch.nn.Linear))]
    try:
        yield box
    finally:
        for h in handles:
            h.remove()


def gemm_flops(piece: str, cfg: Config, batch: int) -> int:
    """FLOPs of the pipeline's GEMMs outside the nets in one call of
    ``piece`` at ``batch`` clips, from ``cfg``'s shapes: under a matmul DFT
    the STFT's cos and sin GEMMs and the iSTFT's two; the warp (``Wy @ x
    @ Wx^T``, ``ops/warp.py``) of each spectrogram that ``prepare`` warps,
    and ``separate``'s unwarp of each mask."""
    n_fft, N = cfg.stft_frame, cfg.num_mix
    F = n_fft // 2 + 1
    T = 1 + cfg.audLen // cfg.stft_hop
    fo = WARP_BINS if cfg.log_freq else F
    dft = cfg.dft != "fft"

    def stft(rows):
        return 2 * 2 * rows * T * n_fft * F if dft else 0

    def istft(rows):
        return 2 * 2 * rows * T * F * n_fft if dft else 0

    def warp(rows, h_in, h_out):
        return 2 * rows * h_out * h_in * T + 2 * rows * h_out * T * T

    def prep(rows):
        return warp(rows, F, fo) if cfg.log_freq else 0

    if piece in ("prepare_stft", "forward_av", "train_step"):
        return stft(batch) + stft(N * batch) + prep(batch) + prep(N * batch)
    if piece == "frame_features":
        return 0
    if piece == "separate":
        # prepare() warps the mixture and its one-source copy
        return (stft(batch) + 2 * prep(batch) + warp(N * batch, fo, cfg.HS)
                + istft(N * batch))
    raise ValueError(f"unknown piece {piece!r}; one of {PIECES}")


def count(fn: Callable, nets, piece: str, cfg: Config, batch: int) -> Dict:
    """One call of ``fn`` under ``FlopCounterMode`` and the hand count:
    ``counter`` (forward and backward), ``hand_forward`` and, on a forward
    piece, whether they agree."""
    with hand_count(nets) as box, FlopCounterMode(display=False) as fc:
        fn()
    hand = box["flops"] + gemm_flops(piece, cfg, batch)
    out = {"counter": int(fc.get_total_flops()), "hand_forward": hand}
    if piece in FORWARD_PIECES:
        out["agree"] = out["counter"] == hand
    return out


# ------------------------------------------------------------- the pieces


def piece_fns(cfg: Config, state: train.TrainState, batches,
              device: torch.device) -> Dict[str, Callable[[int], object]]:
    """Each piece as ``fn(i)`` on ``batches[i % len(batches)]``; the
    forward pieces run without grad, ``train_step`` updates ``state``."""
    nets, n = state.nets, len(batches)
    step = train.make_eager_train_step(cfg, nets, use_vis=True,
                                       device=device)

    @torch.no_grad()
    def prepare_stft(i):
        mag_mix, mags = engine.batch_spectrograms(batches[i % n], cfg)
        return prepare(mag_mix, mags, log_freq=bool(cfg.log_freq),
                       weighted_loss=bool(cfg.weighted_loss),
                       binary_mask=bool(cfg.binary_mask))

    @torch.no_grad()
    def frame_features(i):
        nets.frame.eval()
        frames = batches[i % n]["frames"]
        return [nets.frame(frames[:, k], pool=cfg.not_pool_vis)
                for k in range(cfg.num_mix)]

    @torch.no_grad()
    def forward_av(i):
        return engine.forward(nets, batches[i % n], cfg, True, train=True)[0]

    def separate(i):
        b = batches[i % n]
        return engine.separate(nets, b["audio_mix"], b["frames"], cfg,
                               device=device)["wavs"]

    def train_step(i):
        return step(state, batches[i % n])[1]["err"]

    return {"prepare_stft": prepare_stft, "frame_features": frame_features,
            "forward_av": forward_av, "separate": separate,
            "train_step": train_step}


def dtype_ran(cfg: Config, device: torch.device) -> str:
    """The arithmetic the nets' convolutions ran in: ``bfloat16``, or for
    float32 on a card ``tf32`` when cuDNN or cuBLAS may use TF32, else
    ``float32``."""
    if cfg.dtype == "bfloat16":
        return "bfloat16"
    if device.type == "cuda" and (torch.backends.cudnn.allow_tf32 or
                                  torch.backends.cuda.matmul.allow_tf32):
        return "tf32"
    return "float32"


def mfu_shares(flops: Dict[str, int], ms: Dict[str, float], card_name: str,
               dtype: str) -> Dict:
    """``mfu_vs_dtype_peak`` and ``mfu_vs_bf16_peak`` per piece, or null
    for a card without a published peak; raises if a share exceeds 1."""
    peaks = measure.PEAK_FLOPS.get(card_name)
    out = {"card_name": card_name, "dtype_peak": dtype,
           "dtype_peak_flops": peaks[dtype] if peaks else None,
           "bf16_peak_flops": peaks["bfloat16"] if peaks else None,
           "mfu_vs_dtype_peak": {}, "mfu_vs_bf16_peak": {}}
    for k, t in ms.items():
        rate = flops[k] / (t / 1e3)
        out["mfu_vs_dtype_peak"][k] = rate / peaks[dtype] if peaks else None
        out["mfu_vs_bf16_peak"][k] = (rate / peaks["bfloat16"] if peaks
                                      else None)
    over = {k: v for k, v in out["mfu_vs_dtype_peak"].items()
            if v is not None and v > 1.0}
    if over:
        raise ValueError(f"MFU above 100 % ({over}): the FLOP count is "
                         "wrong")
    return out


def breakdown(ms: Dict[str, float]) -> Dict[str, float]:
    """The train step's time by component, in percent (the JAX tool's
    split: the pieces' times, the U-Net double pass as the forward's
    remainder, the backward and update as the step's)."""
    fwd, total = ms["forward_av"], ms["train_step"]
    parts = {
        "prepare_stft": ms["prepare_stft"],
        "frame_features(2xResNet18)": ms["frame_features"],
        "unet_double_pass(residual fwd)": max(
            fwd - ms["prepare_stft"] - ms["frame_features"], 0.0),
        "backward+sgd(update)": max(total - fwd, 0.0)}
    return {k: 100.0 * v / total for k, v in parts.items()}


def run(cfg: Config, state: train.TrainState, batch: int = 32,
        n_steps: int = 16, device=None, card: str = "cpu") -> Dict:
    """The report for every piece of ``cfg`` at ``batch`` clips (``state``
    is trained in place by ``train_step``).  Raises if a forward piece's
    counts disagree or a share exceeds 1.  ``calls`` counts every call of
    each piece (the counted, warm-up and timed ones)."""
    dev = engine.nets_device(state.nets, device)
    fns = piece_fns(cfg, state, synthetic_batches(cfg, batch, 4, dev), dev)
    report = {"card": card, "batch": batch, "n_steps": n_steps,
              "dft": cfg.dft, "dtype": cfg.dtype,
              "note": "FLOPs from shapes (FlopCounterMode); the port's "
                      "CUDA kernels move bytes and count 0",
              "flops": {}, "flops_hand_forward": {}, "ms_per_step": {},
              "calls": {}}
    for name, fn in fns.items():
        c = count(lambda: fn(0), state.nets, name, cfg, batch)
        if c.get("agree") is False:
            raise AssertionError(f"{name}: FlopCounterMode {c['counter']} "
                                 f"!= hand count {c['hand_forward']}")
        report["flops"][name] = c["counter"]
        report["flops_hand_forward"][name] = c["hand_forward"]
        for i in range(WARMUP):
            fn(i)
        best = measure.best_seconds(
            lambda: [fn(i) for i in range(n_steps)], TIMING_REPS, dev)
        report["ms_per_step"][name] = 1e3 * best / n_steps
        report["calls"][name] = 1 + WARMUP + TIMING_REPS * n_steps
    report.update(mfu_shares(report["flops"], report["ms_per_step"],
                             measure.device_name(dev), dtype_ran(cfg, dev)))
    report["train_step_breakdown_pct"] = breakdown(report["ms_per_step"])
    return report


def print_table(r: Dict) -> None:
    peak = r["dtype_peak_flops"]
    print(f"== MFU on {r['card']} ({r['dtype']} nets, {r['dtype_peak']} "
          "peak " + (f"{peak / 1e12:.0f} TFLOP/s" if peak else
                     "unknown for this card: null") + ") ==")
    for k, fl in r["flops"].items():
        share = r["mfu_vs_dtype_peak"][k]
        bf16 = r["mfu_vs_bf16_peak"][k]
        print(f"  {k:16s} {fl / 1e12:8.4f} TFLOP/step (hand fwd "
              f"{r['flops_hand_forward'][k] / 1e12:.4f})  "
              f"{r['ms_per_step'][k]:8.3f} ms  MFU "
              + (f"{share * 100:5.1f}% (bf16 peak {bf16 * 100:5.2f}%)"
                 if share is not None else "null"))
    print("== train-step time breakdown ==")
    for k, v in r["train_step_breakdown_pct"].items():
        print(f"  {k:32s} {v:5.1f}%")


def main(argv=None, device=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=32)
    ap.add_argument("n_steps", type=int, nargs="?", default=16)
    ap.add_argument("dft", nargs="?", default="fft",
                    choices=["fft", "matmul"])
    ap.add_argument("dtype", nargs="?", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship(dft=args.dft, dtype=args.dtype)
    state = train.init_state(cfg, engine.build_nets(cfg, device=dev),
                             torch.Generator().manual_seed(0), device=dev)
    r = run(cfg, state, args.batch, args.n_steps, device=dev, card=card)
    print_table(r)
    tag = ("" if args.dft == "fft" else f"_{args.dft}") + (
        "" if args.dtype == "float32" else f"_{args.dtype}")
    out = measure.report_path(args.out, f"mfu_report{tag}.json")
    measure.write_json(r, out)
    print(f"report written to {out}")
    return r


if __name__ == "__main__":
    engine.full_float32()
    main()
