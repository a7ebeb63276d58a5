"""Training: the SGD groups, the train state and the train step.

Port of ``avsep_tpu/train.py`` (reference ``main.py:536-601``):

* SGD with momentum ``beta1`` and weight decay in groups (reference
  ``create_optimizer``, main.py:536-547): group ``sound`` holds ``sound.*``
  and ``frame.fc.*`` at ``lr_sound``; group ``frame`` holds
  ``frame.features.*`` at ``lr_frame``, or gets a zero update and no state
  under ``fix_vis``; under ``--load_clips`` group ``motion`` holds
  ``motion.*`` at ``lr_motion``.  The SoP++ nets add group ``synth``
  (``synthesizer.*``, at ``lr_synthesizer``; reference SoP++/main.py:743-756).
* One step = one forward (AV or AO), one backward, one SGD update
  (reference ``train_step``, main.py:557-569); ``batch_scheduler`` says
  which steps are AV (main.py:572-601).

The update is written out rather than taken from ``torch.optim.SGD``,
because it reproduces the JAX package's optax chain, per group:
``buf = (g + weight_decay * p) + beta1 * buf``, then ``p -= lr * buf``,
where ``lr = base * 0.1 ** #{s in lr_steps : count >= s}`` is read at the
group's update count *before* the update (``optax.piecewise_constant_
schedule``).  A step leaves the nets its forward does not run where they
are, with the groups of the same names (the JAX package's live nets,
``avsep_tpu/train.py:150-177``): an AO step ``frame`` and ``motion``; an
AV step ``motion``, or ``frame`` under ``fusion_type CoLoc_ClipAtt``,
whose AV step runs the motion net in its place.  A frozen net's
parameters (for the frame net ``frame.features`` and ``frame.fc``) get a
zero update and its group's count and buffers stay as they were, so the
``frame`` group's schedule counts the steps that run the frame net only;
``frame.fc`` rides group ``sound``, so its buffer still becomes ``beta1 *
buf + weight_decay * p`` while its value stays frozen (the JAX package's
"residual inexactness", train.py:160-163, reproduced on purpose).

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
from avsep_tpu_torch.parallel import distributed as pdist


@dataclasses.dataclass
class GroupState:
    """One SGD group's state: its update count and one momentum buffer per
    parameter, keyed ``"sound.down0.conv.weight"``, ``"frame.fc.bias"``..."""
    count: int
    momentum: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step``, the nets (``engine.Nets`` or ``sop_engine.SopNets``: their
    parameters and BatchNorm buffers) and the optimizer state per group
    (None for a group with no state: ``frame`` under ``fix_vis``)."""
    step: int
    nets: Nets
    opt_state: Dict[str, Optional[GroupState]]

    def state_dict(self) -> Dict:
        """Everything a checkpoint holds, as plain dicts of tensors."""
        return {"step": self.step,
                **{name: net.state_dict() for name, net in modules(self.nets)},
                "opt_state": {g: None if s is None else
                              {"count": s.count, "momentum": s.momentum}
                              for g, s in self.opt_state.items()}}

    def load_state_dict(self, sd: Dict) -> None:
        """Copy a :meth:`state_dict` into this state, strictly, onto the
        nets' device."""
        for name, net in modules(self.nets):
            net.load_state_dict(sd[name], strict=True)
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


def modules(nets) -> List[Tuple[str, torch.nn.Module]]:
    """The nets by field name: ``sound``, ``frame``, ``motion`` under
    ``--load_clips``, and ``synthesizer`` for the SoP++ nets."""
    return [(k, v) for k, v in nets._asdict().items() if v is not None]


def named_parameters(nets) -> Iterator[Tuple[str, torch.nn.Parameter]]:
    """The nets' parameters, named ``sound.*``, ``frame.*``, ``motion.*``,
    ``synthesizer.*``."""
    for net, module in modules(nets):
        for name, p in module.named_parameters():
            yield f"{net}.{name}", p


def param_group(name: str) -> str:
    """``sound.*`` and ``frame.fc.*`` -> ``"sound"``; ``synthesizer.*`` ->
    ``"synth"``; ``frame.features.*`` -> ``"frame"``; ``motion.*`` ->
    ``"motion"`` (reference create_optimizer, main.py:536-547;
    SoP++/main.py:743-756)."""
    if name.startswith("sound.") or name.startswith("frame.fc."):
        return "sound"
    if name.startswith("motion."):
        return "motion"
    if name.startswith("synthesizer."):
        return "synth"
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
    return {"sound": cfg.lr_sound, "synth": cfg.lr_synthesizer,
            "frame": cfg.lr_frame, "motion": cfg.lr_motion}[group]


def init_opt_state(cfg: Config, nets) -> Dict[str, Optional[GroupState]]:
    """Count 0 and zero momentum buffers for every group of the nets'
    parameters; None for ``frame`` under ``fix_vis``."""
    state: Dict[str, Optional[GroupState]] = {}
    for name, p in named_parameters(nets):
        g = param_group(name)
        if g == "frame" and cfg.fix_vis:
            state[g] = None
            continue
        state.setdefault(g, GroupState(0, {})).momentum[name] = \
            torch.zeros_like(p, memory_format=torch.contiguous_format)
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


def frozen_nets(cfg: Config, use_vis: bool) -> Tuple[str, ...]:
    """The nets an AV (``use_vis``) or AO step leaves where they are, with
    their groups: those its forward does not run."""
    if not use_vis:
        return ("frame", "motion")
    return ("frame",) if cfg.fusion_type == "CoLoc_ClipAtt" else ("motion",)


def _groups_of(cfg: Config, state: TrainState, use_vis: bool) -> List[str]:
    """The groups that advance in a step: every group with state (``frame``
    has none under ``fix_vis``) but those of :func:`frozen_nets`."""
    frozen = frozen_nets(cfg, use_vis)
    return [g for g, s in state.opt_state.items()
            if s is not None and g not in frozen]


@torch.no_grad()
def _sgd_update(cfg: Config, state: TrainState, params: Dict, grads: Dict,
                use_vis: bool) -> None:
    """One SGD update of the groups that advance, each operation over a
    whole group at once (``torch._foreach_*``), rounded as optax rounds it:
    ``u = g + wd * p``, ``buf = beta1 * buf + u``, ``p += (-lr) * buf``;
    the parameters of the frozen nets stay where they are."""
    wd, beta1 = cfg.weight_decay, cfg.beta1
    frozen = frozen_nets(cfg, use_vis)
    for g in _groups_of(cfg, state, use_vis):
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
        # frame.fc rides group sound but stays with its frozen net
        moving = [i for i, n in enumerate(names)
                  if n.split(".", 1)[0] not in frozen]
        torch._foreach_add_([params[names[i]] for i in moving],
                            torch._foreach_mul([bufs[i] for i in moving],
                                               neg_lr))
        gs.count += 1


def apply_gradients(cfg: Config, state: TrainState, err: torch.Tensor,
                    use_vis: bool) -> None:
    """The gradient of ``err`` for the parameters of the groups that
    advance, averaged across the ranks under a process group (one
    ``all_reduce`` of one buffer: the gradient of the global batch's mean
    loss), then one SGD update of those groups, in place; ``step`` + 1."""
    params = dict(named_parameters(state.nets))
    groups = _groups_of(cfg, state, use_vis)
    live = [n for n in params if param_group(n) in groups]
    grads = torch.autograd.grad(err, [params[n] for n in live],
                                allow_unused=True)
    pdist.mean_([g for g in grads if g is not None])
    _sgd_update(cfg, state, params, dict(zip(live, grads)), use_vis)
    state.step += 1


def step_metrics(err: torch.Tensor, match_loss: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """A train step's detached ``err`` and ``match_loss``, averaged across
    the ranks under a process group (one ``all_reduce``), so every rank
    reports the global batch's numbers."""
    metrics = {"err": err.detach(), "match_loss": match_loss.detach()}
    pdist.mean_(list(metrics.values()))
    return metrics


def make_train_step(cfg: Config, nets: Nets, use_vis: bool,
                    device=None) -> Callable:
    """Returns ``step(state, batch, *, swap_uniforms=None, generator=None)
    -> (state, metrics)``: one forward (AV if ``use_vis``, else AO), one
    backward and one SGD update, in place; ``metrics`` holds the detached
    ``err`` and ``match_loss`` (:func:`step_metrics`).  The AO step's slot
    swap takes ``swap_uniforms [B]`` (this rank's rows) or ``generator``.
    The nets must lie on ``device`` (``cuda`` unless ``device="cpu"``)."""
    dev = engine.nets_device(nets, device)

    def step(state: TrainState, batch, *, swap_uniforms=None,
             generator=None) -> Tuple[TrainState, Dict]:
        err, outputs = engine.forward(
            state.nets, batch, cfg, use_vis, train=True,
            swap_uniforms=swap_uniforms, generator=generator)
        apply_gradients(cfg, state, err, use_vis)
        return state, step_metrics(err, outputs["match_loss"])

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
