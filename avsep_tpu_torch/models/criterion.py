"""Losses: weighted L1 / L2 / BCE and permutation-invariant training (PIT).

Port of ``avsep_tpu/models/criterion.py`` (reference ``models/criterion.py``):

* ``weighted_loss`` is the reference ``BaseLoss._forward``: mean of
  ``w * elementwise`` for one source; ``multi_source_loss`` averages the
  per-source scalars (``criterion.py:10-25``).
* BCE is torch's ``F.binary_cross_entropy`` (logs clamped at -100), with the
  JAX package's input clip into ``[1e-7, 1 - 1e-7]``, written out so that
  the gradient at a saturated sigmoid (p exactly 0 or 1) is the JAX
  package's bounded one, not torch's 1e12-scale one.
* ``pit_loss`` scores all S! assignments of predictions to targets per
  sample in one batched expression and keeps the first minimum in
  ``itertools.permutations`` order (the reference's strict ``>``).

Tensors keep the JAX package's convention: sources trailing, ``[B, ..., S]``.
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Tuple

import torch

_LOG_CLAMP = -100.0  # torch F.binary_cross_entropy clamps log() at -100
# The JAX package's gradient-safety clip (avsep_tpu/models/criterion.py:33-
# 40): values equal torch's BCE for p in [eps, 1 - eps]; at p == 0 or 1 the
# gradient is bounded by 1/eps instead of NaN.
_BCE_EPS = 1e-7


def bce_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Unreduced binary cross entropy with torch's log clamp and the
    gradient-safe input clip."""
    pred = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
    logp = torch.clamp(torch.log(pred), min=_LOG_CLAMP)
    log1mp = torch.clamp(torch.log(1.0 - pred), min=_LOG_CLAMP)
    return -(target * logp + (1.0 - target) * log1mp)


def l1_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    # |d| with JAX's gradient at d == 0 (+1; torch.abs gives 0 there), which
    # a saturated prediction on a binary target reaches
    d = pred - target
    return torch.where(d >= 0, d, -d)


def l2_elementwise(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - target)


_ELEMENTWISE = {"bce": bce_elementwise, "l1": l1_elementwise,
                "l2": l2_elementwise}


def weighted_loss(pred: torch.Tensor, target: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  kind: str = "bce") -> torch.Tensor:
    """Scalar weighted loss of one source: mean(w * elementwise)."""
    e = _ELEMENTWISE[kind](pred, target)
    if weight is not None:
        e = e * weight
    return torch.mean(e)


def multi_source_loss(preds: torch.Tensor, targets: torch.Tensor,
                      weight: Optional[torch.Tensor] = None,
                      kind: str = "bce",
                      per_sample: bool = False) -> torch.Tensor:
    """Average of the per-source scalar losses; ``preds``/``targets``
    ``[N, B, ...]``, ``weight [B, ...]`` broadcast over the sources.

    ``per_sample=True`` returns the ``[B]`` per-sample losses, whose mean is
    the scalar loss exactly (every sample has the same element count).
    """
    e = _ELEMENTWISE[kind](preds, targets)
    if weight is not None:
        e = e * weight
    ps = torch.mean(e, dim=(0,) + tuple(range(2, e.dim())))   # [B]
    return ps if per_sample else torch.mean(ps)


@functools.lru_cache(maxsize=None)
def _perm_table(S: int, device) -> torch.Tensor:
    """All S! orderings ``[P, S]`` in ``itertools.permutations`` order, made
    once per ``(S, device)``: a copy from the host inside a step would stop
    a CUDA graph's capture."""
    return torch.tensor(list(itertools.permutations(range(S))),
                        dtype=torch.long, device=device)


def pit_loss(preds: torch.Tensor, targets: torch.Tensor,
             weights: Optional[torch.Tensor] = None, *, kind: str = "bce"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched permutation-invariant loss.

    Args:
      preds, targets: ``[B, ..., S]``, sources trailing.
      weights: the same shape, indexed by the *target* source (reference
        ``criterion.py:167-169``), or None.
    Returns:
      ``(loss [B], perm [B, S])``: ``perm[b]`` maps target slot -> pred slot
      at the least loss, ties going to the first permutation.
    """
    S = preds.shape[-1]
    perms = _perm_table(S, preds.device)                        # [P, S]
    # elem[..., i, j] = loss(pred_j vs target_i)
    e = _ELEMENTWISE[kind](preds[..., None, :], targets[..., :, None])
    if weights is not None:
        e = e * weights[..., :, None]
    mat = torch.mean(e, dim=tuple(range(1, e.dim() - 2)))       # [B, S, S]
    rows = torch.arange(S, device=preds.device)
    perm_losses = torch.mean(mat[:, rows[None, :], perms], dim=-1)  # [B, P]
    # torch.argmin returns the first minimum, as jnp.argmin
    best = torch.argmin(perm_losses, dim=-1)
    loss = torch.gather(perm_losses, 1, best[:, None])[:, 0]
    return loss, perms[best]


def reorder_sources(tensor: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply the per-sample permutation ``perm [B, S]`` on the trailing
    sources axis of ``tensor [B, ..., S]`` (reference
    ``PitWrapper.reorder_tensor``, ``criterion.py:180-200``)."""
    B, S = perm.shape
    idx = perm.reshape((B,) + (1,) * (tensor.dim() - 2) + (S,))
    return torch.gather(tensor, -1, idx.expand(tensor.shape))
