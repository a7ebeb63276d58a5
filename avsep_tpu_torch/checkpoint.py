"""Checkpointing: the whole train state with ``torch.save`` / ``torch.load``.

Port of ``avsep_tpu/checkpoint.py``.  The reference saves per-net
``state_dict`` files plus a history (reference ``main.py:506-533``) and
loses the optimizer's momentum and schedule position on resume; here the
step, both nets' parameters and BatchNorm buffers, and every group's count
and momentum buffers round-trip (``TrainState.state_dict``).  Files, under
``ckpt_dir``: ``state_{tag}.pt`` and ``history_latest.json``.

Under a process group (``parallel/distributed.py``) the ranks hold equal
states, so the primary rank writes and the others wait at a barrier until
the files are there; every rank restores, and the caller broadcasts rank
0's state (``distributed.broadcast_state``).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.train import TrainState


def _state_path(ckpt_dir: str, tag: str) -> str:
    return os.path.join(ckpt_dir, f"state_{tag}.pt")


def save_checkpoint(ckpt_dir: str, state: TrainState, history: dict,
                    tag: str = "latest") -> None:
    """Write the state as ``state_{tag}.pt`` and the history as
    ``history_latest.json``, on the primary rank; then a barrier."""
    if pdist.is_primary():
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(state.state_dict(), _state_path(ckpt_dir, tag))
        with open(os.path.join(ckpt_dir, "history_latest.json"), "w") as f:
            json.dump(history, f)
    pdist.barrier()


def restore_checkpoint(ckpt_dir: str, template: TrainState,
                       tag: str = "latest") -> TrainState:
    """Load ``state_{tag}.pt`` into ``template`` (a state of the same
    config, e.g. from ``train.init_state``), onto its nets' device, and
    return it."""
    sd = torch.load(_state_path(ckpt_dir, tag), map_location="cpu",
                    weights_only=True)
    template.load_state_dict(sd)
    return template


def load_history(ckpt_dir: str) -> Optional[dict]:
    p = os.path.join(ckpt_dir, "history_latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def checkpoint(ckpt_dir: str, state: TrainState, history: dict,
               best_err_holder: dict) -> None:
    """Save ``latest``; also ``best`` when ``-history['val_ao']['si_sdr']
    [-1]`` improves on ``best_err_holder['best_err']`` (reference
    checkpoint(), main.py:506-533).  ``best_err`` is kept in the history,
    so a resumed run does not clobber ``best`` with its first eval."""
    print(f"Saving checkpoints at {state.step} iterations.")
    cur_err = -history["val_ao"]["si_sdr"][-1]
    improved = cur_err < best_err_holder.get("best_err", float("inf"))
    if improved:
        best_err_holder["best_err"] = cur_err
    history["best_err"] = best_err_holder.get("best_err", float("inf"))
    save_checkpoint(ckpt_dir, state, history, "latest")
    if improved:
        save_checkpoint(ckpt_dir, state, history, "best")
