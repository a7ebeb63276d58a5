"""A/B of the separation pipeline on the card, float32 against bfloat16
compute: throughput and fidelity; the port of ``tools/sep_dtype_ab.py``.

bench.py's flagship (``dft="matmul"``) with seeded ``engine.init_params``
weights in float32, and the same weights in nets that compute in bfloat16
(``--dtype bfloat16``: the convolutions and BatchNorm outputs in bfloat16,
the STFT, masks and iSTFT in float32).  Each leg is timed as ``bench``
times it (synchronized calls after two warm-ups, the best of three runs),
then both separate one fixed batch: the bfloat16 wavs' SNR against the
float32 wavs, and the share of samples that differ by more than 1e-6 (a
binary mask bin that flips moves its samples).

    python -m avsep_tpu_torch.tools.sep_dtype_ab [B] [ITERS]

(the JAX tool's argv; ``ITERS`` is here the synchronized calls per timed
run, by default bench's 16 where the JAX tool scans 64 chunks).  Runs on
the GPU only.
"""

from __future__ import annotations

import math
import sys
from typing import Dict

import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.tools import measure
from avsep_tpu_torch.tools.bench import (
    ITERS, RUNS, draw_inputs, throughput, timed_fn)

FIDELITY_SEED = 99


def bf16_copy(cfg: Config, nets32: engine.Nets, device) -> engine.Nets:
    """``cfg``'s nets computing in bfloat16, holding ``nets32``'s float32
    weights and statistics."""
    nets = engine.build_nets(cfg.replace(dtype="bfloat16"), device=device)
    for n16, n32 in zip(nets, nets32):
        if n32 is not None:
            n16.load_state_dict(n32.state_dict(), strict=True)
    return nets


def fidelity_wavs(cfg: Config, nets: engine.Nets, batch: int,
                  device) -> torch.Tensor:
    """The wavs of the fixed fidelity batch (``draw_inputs`` with
    ``FIDELITY_SEED``), on the host."""
    audio, frames = draw_inputs(cfg, batch, 1, device, seed=FIDELITY_SEED)
    return timed_fn(nets, cfg, device)(audio[0], frames[0]).cpu()


def run(cfg: Config, nets32: engine.Nets, nets16: engine.Nets,
        batch: int = 16, iters: int = ITERS, runs: int = RUNS,
        device=None) -> Dict:
    """Both legs' clips/s, the bfloat16 wav SNR against float32 in dB (the
    JAX tool's, with the error's energy floored at 1e-30: equal wavs read
    about 300 dB), the flip rate and whether the wavs are equal bit for
    bit; ``wavs`` holds each leg's fidelity wavs, ``calls`` every
    ``separate`` call made."""
    dev = engine.nets_device(nets32, device)
    legs = {"float32": (cfg.replace(dtype="float32"), nets32),
            "bfloat16": (cfg.replace(dtype="bfloat16"), nets16)}
    rates, wavs, calls = {}, {}, 0
    for dtype, (c, nets) in legs.items():
        res = throughput(c, nets, batch, iters, runs, dev)
        rates[dtype] = res["clips_per_s"]
        wavs[dtype] = fidelity_wavs(c, nets, batch, dev)
        calls += res["calls"] + 1
    ref, test = wavs["float32"].double(), wavs["bfloat16"].double()
    err = ref - test
    snr = 10 * math.log10(float((ref ** 2).sum())
                          / max(float((err ** 2).sum()), 1e-30))
    f32, bf16 = rates["float32"], rates["bfloat16"]
    return {"batch": batch, "iters": iters, "dft": cfg.dft,
            "f32_clips_per_s": f32, "bf16_clips_per_s": bf16,
            "bf16_gain_pct": (bf16 / f32 - 1) * 100, "bf16_snr_db": snr,
            "flip_rate": float((err.abs() > 1e-6).double().mean()),
            "wavs_bit_equal": bool(torch.equal(wavs["float32"],
                                               wavs["bfloat16"])),
            "wavs": wavs, "calls": {"separate": calls}}


def main(argv=None, device=None) -> Dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    batch = int(argv[0]) if len(argv) > 0 else 16
    iters = int(argv[1]) if len(argv) > 1 else ITERS
    dev = engine.resolve_device(device)
    card = measure.card_line(dev)
    cfg = measure.flagship(dft="matmul")
    nets32 = measure.seeded_nets(cfg, dev)
    r = run(cfg, nets32, bf16_copy(cfg, nets32, dev), batch, iters,
            device=dev)
    print(f"[{card}] B={batch}, {iters} calls per run, best of {RUNS}")
    print(f"f32:  {r['f32_clips_per_s']:.1f} clips/s")
    print(f"bf16: {r['bf16_clips_per_s']:.1f} clips/s  "
          f"({r['bf16_gain_pct']:+.1f}%)")
    print(f"bf16 wav SNR vs f32: {r['bf16_snr_db']:.1f} dB; "
          f"sample flip rate {r['flip_rate'] * 100:.3f}%; wavs bit for bit "
          f"equal: {r['wavs_bit_equal']}", flush=True)
    return {**{k: v for k, v in r.items() if k != "wavs"}, "card": card}


if __name__ == "__main__":
    engine.full_float32()
    main()
