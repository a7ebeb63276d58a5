"""The numbers compared to decide ``correct``.

Training (the program's first steps against the reference's over the same
batches, from the same weights):

* ``loss_gap``: the largest ``|L_prog - L_ref| / |L_ref|`` over the steps;
* ``grad_gap``: the first step's gradient as the optimizer got it, by the
  worst leaf: ``| |g_prog| - |g_ref| |`` over the larger of ``|g_ref|``
  and the median leaf's ``|g_ref|``;
* ``change_gap``: the same for each parameter's change over the steps,
  leaving out the leaves whose first reference gradient is under a
  thousandth of the median leaf's (they move under momentum and weight
  decay by round-off alone), and the leaves whose reference change is
  under :data:`ROUND_FLOOR` times the float32 spacing of their starting
  values (a change that small is mostly the round-off of ``p - lr * buf``
  on both sides);
* ``loss_gap.first``, ``grad_gap.median``, ``change_gap.median``: the
  first step's loss alone, and the median leaf's gaps, which stay steady
  from seed to seed where the worst leaf is one small leaf's noise.

A cell's limits file names the numbers it compares.

Serving: ``wav_gap``, the largest relative L2 distance between a sampled
request's wavs and the reference's, and ``wav_gap.median``, the median
request's.  A served mask is thresholded at 0.5, so a bin whose soft mask
lies within rounding of the threshold flips, and the worst request swings
with the few flips a sample happens to hold; the median request stays
steady.
"""

from __future__ import annotations

import math
from statistics import median
from typing import Dict, List

import torch


GRAD_FLOOR = 1e-3
ROUND_FLOOR = 100.0


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap between the two sides' norms, over the larger of
    the reference leaf's norm and the median leaf's."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return {}
    pn, rn = _norms({k: prog[k] for k in keys}), \
        _norms({k: ref[k] for k in keys})
    floor = median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in keys}


def moving_leaves(first_ref: Dict[str, torch.Tensor]) -> List[str]:
    n = _norms(first_ref)
    floor = GRAD_FLOOR * median(n.values())
    return [k for k, v in n.items() if v >= floor]


def spacing_norm(p0: torch.Tensor) -> float:
    """The norm of the float32 spacing of a leaf's values: the size of
    one rounding of every element."""
    a = p0.detach().float().abs()
    return float(torch.linalg.vector_norm(
        (torch.nextafter(a, torch.full_like(a, math.inf)) - a).double()))


def resolved_leaves(ref_change: Dict[str, torch.Tensor],
                    p0: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference change stands :data:`ROUND_FLOOR` times
    above the rounding of their values."""
    n = _norms(ref_change)
    return [k for k, v in n.items() if v >= ROUND_FLOOR * spacing_norm(p0[k])]


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_first: Dict, ref_first: Dict, prog_change: Dict,
                  ref_change: Dict, p0: Dict) -> Dict[str, float]:
    """Every number a training cell may compare (its limits file picks);
    ``p0`` holds the parameters both sides started from."""
    steps = [abs(p - r) / max(abs(r), 1e-30)
             for p, r in zip(prog_losses, ref_losses)]
    if not all(math.isfinite(x) for x in prog_losses):
        steps = [math.inf] * len(steps)
    grads = leaf_gaps(prog_first, ref_first)
    moving = set(moving_leaves(ref_first)) & \
        set(resolved_leaves(ref_change, p0))
    # no leaf resolved: the reference itself is not finite
    changes = leaf_gaps(prog_change, ref_change, moving) or {"": math.inf}
    return {"loss_gap": max(steps), "loss_gap.first": steps[0],
            "grad_gap": max(grads.values()),
            "grad_gap.median": median(grads.values()),
            "change_gap": max(changes.values()),
            "change_gap.median": median(changes.values())}


def wav_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Relative L2 distance of one request's wavs ``[N, L']``."""
    d = torch.linalg.vector_norm((prog.double() - ref.double()).flatten())
    n = torch.linalg.vector_norm(ref.double().flatten())
    return float(d / n.clamp_min(1e-30))


def serve_numbers(gaps: List[float]) -> Dict[str, float]:
    return {"wav_gap": max(gaps), "wav_gap.median": median(gaps)}
