"""Training: the SGD groups, the train state and the train step.

Port of ``avsep_tpu/train.py`` (reference ``main.py:536-601``):

* SGD with momentum ``beta1`` and weight decay in two groups (reference
  ``create_optimizer``, main.py:536-547): group ``sound`` holds ``sound.*``
  and ``frame.fc.*`` at ``lr_sound``; group ``frame`` holds
  ``frame.features.*`` at ``lr_frame``, or gets a zero update and no state
  under ``fix_vis``.
* One step = one forward (AV or AO), one backward, one SGD update
  (reference ``train_step``, main.py:557-569); ``batch_scheduler`` says
  which steps are AV (main.py:572-601).

The update is written out rather than taken from ``torch.optim.SGD``,
because it reproduces the JAX package's optax chain, per group:
``buf = (g + weight_decay * p) + beta1 * buf``, then ``p -= lr * buf``,
where ``lr = base * 0.1 ** #{s in lr_steps : count >= s}`` is read at the
group's update count *before* the update (``optax.piecewise_constant_
schedule``).  In an AO step only group ``sound`` advances: the frame net's
parameters (``frame.features`` and ``frame.fc``) get a zero update and the
``frame`` group's count and buffers stay as they were, so its schedule
counts AV steps only; ``frame.fc`` rides group ``sound``, so its buffer
still becomes ``beta1 * buf + weight_decay * p`` while its value stays
frozen (the JAX package's "residual inexactness", train.py:160-163,
reproduced on purpose).

The state is updated in place: the nets' parameters and BatchNorm buffers,
and the momentum buffers, are the tensors of the state passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.engine import Nets
from avsep_tpu_torch.models.torch_import import (
    load_torch_checkpoint, resnet_state_dict_from_torch,
    unet_state_dict_from_torch)

GROUPS = ("sound", "frame")


@dataclasses.dataclass
class GroupState:
    """One SGD group's state: its update count and one momentum buffer per
    parameter, keyed ``"sound.down0.conv.weight"``, ``"frame.fc.bias"``..."""
    count: int
    momentum: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step``, the nets (parameters and BatchNorm buffers) and the
    optimizer state per group (None for a group with no state: ``frame``
    under ``fix_vis``)."""
    step: int
    nets: Nets
    opt_state: Dict[str, Optional[GroupState]]

    def state_dict(self) -> Dict:
        """Everything a checkpoint holds, as plain dicts of tensors."""
        return {"step": self.step,
                "sound": self.nets.sound.state_dict(),
                "frame": self.nets.frame.state_dict(),
                "opt_state": {g: None if s is None else
                              {"count": s.count, "momentum": s.momentum}
                              for g, s in self.opt_state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        """Copy a :meth:`state_dict` into this state, strictly, onto the
        nets' device."""
        self.nets.sound.load_state_dict(sd["sound"], strict=True)
        self.nets.frame.load_state_dict(sd["frame"], strict=True)
        if set(sd["opt_state"]) != set(self.opt_state):
            raise ValueError(f"optimizer groups {sorted(sd['opt_state'])} do "
                             f"not match {sorted(self.opt_state)}")
        for g, s in sd["opt_state"].items():
            mine = self.opt_state[g]
            if (s is None) != (mine is None):
                raise ValueError(f"group {g!r}: saved and template states "
                                 "differ in fix_vis")
            if s is None:
                continue
            if set(s["momentum"]) != set(mine.momentum):
                raise ValueError(f"group {g!r}: momentum buffers do not "
                                 "match the template's parameters")
            for k, buf in mine.momentum.items():
                buf.copy_(s["momentum"][k])
            mine.count = int(s["count"])
        self.step = int(sd["step"])


def named_parameters(nets: Nets) -> Iterator[Tuple[str, torch.nn.Parameter]]:
    """Both nets' parameters, named ``sound.*`` and ``frame.*``."""
    for net in ("sound", "frame"):
        for name, p in getattr(nets, net).named_parameters():
            yield f"{net}.{name}", p


def param_group(name: str) -> str:
    """``sound.*`` and ``frame.fc.*`` -> ``"sound"``; ``frame.features.*``
    -> ``"frame"`` (reference create_optimizer, main.py:536-547)."""
    if name.startswith("sound.") or name.startswith("frame.fc."):
        return "sound"
    if name.startswith("frame.features."):
        return "frame"
    raise ValueError(f"parameter {name!r} belongs to no optimizer group")


def lr_at(base: float, lr_steps, count: int) -> float:
    """``optax.piecewise_constant_schedule(base, {s: 0.1 for s in
    lr_steps})`` at ``count``, in float32 as optax computes it: one 0.1
    factor for every step ``s`` with ``count >= s``."""
    v = np.float32(base)
    for s in sorted({int(s) for s in lr_steps}):
        if count >= s:
            v = np.float32(np.float32(0.1) * v)
    return float(v)


def _base_lr(cfg: Config, group: str) -> float:
    return cfg.lr_sound if group == "sound" else cfg.lr_frame


def init_opt_state(cfg: Config, nets: Nets) -> Dict[str, Optional[GroupState]]:
    """Count 0 and zero momentum buffers for every group that has state."""
    if cfg.load_clips:
        raise NotImplementedError("the motion group (--load_clips) is not "
                                  f"ported yet ({engine.MOTION_ITEM})")
    state: Dict[str, Optional[GroupState]] = {
        g: GroupState(0, {}) for g in GROUPS}
    if cfg.fix_vis:
        state["frame"] = None
    for name, p in named_parameters(nets):
        gs = state[param_group(name)]
        if gs is not None:
            gs.momentum[name] = torch.zeros_like(p, memory_format=
                                                 torch.contiguous_format)
    return state


def init_state(cfg: Config, nets: Nets, generator: torch.Generator,
               device=None) -> TrainState:
    """:func:`engine.init_params`, then the reference ``.pth`` files of
    ``cfg.weights_sound`` / ``cfg.weights_frame`` if given, then the
    optimizer's initial state.  Runs on ``cuda`` unless ``device="cpu"``.

    A torchvision ImageNet dict has no conv ``fc``: the freshly initialized
    ``fc`` stays, as the reference pretrains only the trunk
    (models/__init__.py:65-78)."""
    nets = engine.init_params(cfg, nets, generator, device=device)
    if cfg.weights_sound.endswith(".pth"):
        nets.sound.load_state_dict(unet_state_dict_from_torch(
            load_torch_checkpoint(cfg.weights_sound),
            num_downs=int(cfg.arch_sound[-1])), strict=True)
    if cfg.weights_frame.endswith(".pth"):
        sd = resnet_state_dict_from_torch(
            load_torch_checkpoint(cfg.weights_frame))
        nets.frame.load_state_dict({**nets.frame.state_dict(), **sd},
                                   strict=True)
    return TrainState(0, nets, init_opt_state(cfg, nets))


def _groups_of(cfg: Config, use_vis: bool) -> List[str]:
    """The groups that advance in a step: both in an AV step (less
    ``frame`` under ``fix_vis``), ``sound`` alone in an AO step."""
    groups = list(GROUPS) if use_vis else ["sound"]
    return [g for g in groups if not (g == "frame" and cfg.fix_vis)]


@torch.no_grad()
def _sgd_update(cfg: Config, state: TrainState, params: Dict, grads: Dict,
                use_vis: bool) -> None:
    """One SGD update of the groups that advance, each operation over a
    whole group at once (``torch._foreach_*``), rounded as optax rounds it:
    ``u = g + wd * p``, ``buf = beta1 * buf + u``, ``p += (-lr) * buf``."""
    wd, beta1 = cfg.weight_decay, cfg.beta1
    for g in _groups_of(cfg, use_vis):
        gs = state.opt_state[g]
        neg_lr = -lr_at(_base_lr(cfg, g), cfg.lr_steps, gs.count)
        names = list(gs.momentum)
        bufs = [gs.momentum[n] for n in names]
        us = torch._foreach_mul([params[n] for n in names], wd)
        with_grad = [i for i, n in enumerate(names)
                     if grads.get(n) is not None]
        if with_grad:
            torch._foreach_add_([us[i] for i in with_grad],
                                [grads[names[i]] for i in with_grad])
        torch._foreach_mul_(bufs, beta1)
        torch._foreach_add_(bufs, us)
        # an AO step leaves the whole frame net where it is
        moving = [i for i, n in enumerate(names)
                  if use_vis or not n.startswith("frame.")]
        torch._foreach_add_([params[names[i]] for i in moving],
                            torch._foreach_mul([bufs[i] for i in moving],
                                               neg_lr))
        gs.count += 1


def make_train_step(cfg: Config, nets: Nets, use_vis: bool,
                    device=None) -> Callable:
    """Returns ``step(state, batch, *, swap_uniforms=None, generator=None)
    -> (state, metrics)``: one forward (AV if ``use_vis``, else AO), one
    backward and one SGD update, in place; ``metrics`` holds the detached
    ``err`` and ``match_loss``.  The AO step's slot swap takes
    ``swap_uniforms [B]`` or ``generator``.  The nets must lie on
    ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = engine.resolve_device(device)
    for name, p in named_parameters(nets):
        if p.device.type != dev.type:
            raise ValueError(f"{name} lies on {p.device}, not {dev}")

    def step(state: TrainState, batch, *, swap_uniforms=None,
             generator=None) -> Tuple[TrainState, Dict]:
        params = dict(named_parameters(state.nets))
        live = [n for n in params
                if param_group(n) in _groups_of(cfg, use_vis)]
        err, outputs = engine.forward(
            state.nets, batch, cfg, use_vis, train=True,
            swap_uniforms=swap_uniforms, generator=generator)
        grads = torch.autograd.grad(err, [params[n] for n in live],
                                    allow_unused=True)
        _sgd_update(cfg, state, params, dict(zip(live, grads)), use_vis)
        state.step += 1
        return state, {"err": err.detach(),
                       "match_loss": outputs["match_loss"].detach()}

    return step


def batch_scheduler(cfg: Config) -> Callable[[int], bool]:
    """``use_vis`` of iteration ``i`` (reference get_av_ao_batch,
    main.py:572-601): AV every ``iter_per_av`` iterations, with the
    ``start_av_first`` / ``num_fsteps`` warm-up gate."""
    def use_vis(i: int) -> bool:
        if cfg.start_av_first:
            return i % cfg.iter_per_av == 0 or i < cfg.num_fsteps
        return i % cfg.iter_per_av == 0 and i > cfg.num_fsteps
    return use_vis
