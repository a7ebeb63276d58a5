"""The reference's training steps: a configuration's loss, the gradient,
and SGD with momentum and weight decay in the published groups.

Groups (reference ``create_optimizer``): ``sound`` (the sound net and the
frame net's ``fc``) at ``lr_sound``, ``frame`` (the frame net's trunk) at
``lr_frame``, ``motion`` (the motion net, under ``load_clips``) at
``lr_motion``, ``synth`` (the synthesizer) at ``lr_synthesizer``.  A step
moves the groups of the nets its forward runs and freezes the others
(:func:`frozen_nets`): an audio-only step leaves the frame and motion
nets where they are, an audio-visual step the motion net, or under
``fusion_type CoLoc_ClipAtt``, which runs the motion net in its place,
the frame net; a frozen net's groups keep their state as it was.
``frame.fc``'s momentum, in group ``sound``, still decays and takes its
weight decay while its net is frozen.  Per group: ``u = g + wd p``,
``buf = beta1 buf + u``, ``p -= lr buf``, with ``lr = base * 0.1 **
#{s in lr_steps: count >= s}``.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.reference.nets import Precision

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def group_of(name: str) -> str:
    if name.startswith("sound.") or name.startswith("frame.fc."):
        return "sound"
    if name.startswith("synthesizer."):
        return "synth"
    if name.startswith("motion."):
        return "motion"
    return "frame"


def frozen_nets(flags: Dict, use_vis: bool) -> Tuple[str, ...]:
    """The nets, and the groups of the same names, that a step leaves
    where they are: those its forward does not run."""
    if not use_vis:
        return ("frame", "motion")
    return ("frame",) if flags["fusion_type"] == "CoLoc_ClipAtt" \
        else ("motion",)


def is_param(name: str) -> bool:
    return name.rsplit(".", 1)[-1] not in BUFFERS


def lr_at(base: float, steps, count: int) -> float:
    v = torch.tensor(base, dtype=torch.float32)
    for s in sorted(set(int(s) for s in steps)):
        if count >= s:
            v = v * torch.tensor(0.1, dtype=torch.float32)
    return float(v)


class Trainer:
    """The reference's state: weights (a copy of the benchmark's), one
    momentum buffer per parameter and one count per group."""

    def __init__(self, config: Dict, weights: Dict[str, torch.Tensor],
                 precision: Precision):
        self.flags = config["flags"]
        self.model = importlib.import_module(
            "benchmark.reference." + config["reference"])
        self.P = precision
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.params = [k for k in self.w if is_param(k)]
        self.bufs = {k: torch.zeros_like(self.w[k]) for k in self.params}
        self.count = {g: 0 for g in {group_of(k) for k in self.params}}

    def step(self, batch: Dict, use_vis: bool,
             uniforms: Optional[torch.Tensor] = None, stage: int = 3):
        """One step in place; returns ``(loss, {param: gradient})``."""
        f = self.flags
        frozen = frozen_nets(f, use_vis)
        live = [k for k in self.params if group_of(k) not in frozen]
        w = dict(self.w)
        for k in live:
            w[k] = self.w[k].detach().requires_grad_(True)
        loss = self.model.train_loss(w, batch, use_vis, f, self.P,
                                     uniforms=uniforms, stage=stage)
        grads = torch.autograd.grad(loss, [w[k] for k in live],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(self.w[k]) if g is None else g)
                 for k, g in zip(live, grads)}
        with torch.no_grad():
            for k in self.w:               # running statistics moved in w
                if not is_param(k):
                    self.w[k] = w[k]
            base = {"sound": "lr_sound", "frame": "lr_frame",
                    "motion": "lr_motion", "synth": "lr_synthesizer"}
            lrs = {g: lr_at(f[base[g]], f["lr_steps"], self.count[g])
                   for g in self.count}
            for k in live:
                u = self.w[k] * f["weight_decay"] + grads[k]
                self.bufs[k].mul_(f["beta1"]).add_(u)
                if k.split(".", 1)[0] not in frozen:
                    self.w[k] = self.w[k] - lrs[group_of(k)] * self.bufs[k]
            for g in {group_of(k) for k in live}:
                self.count[g] += 1
        return float(loss.detach()), grads


def follow(config: Dict, weights: Dict[str, torch.Tensor],
           batches: List[Dict], kinds: List[bool],
           uniforms: List[Optional[torch.Tensor]], stages: List[int],
           precision: Precision):
    """The reference over the checked steps: ``(losses, first step's
    gradients, parameters after the last step)``."""
    t = Trainer(config, weights, precision)
    losses, first = [], None
    for batch, use_vis, u, stage in zip(batches, kinds, uniforms, stages):
        loss, grads = t.step(batch, use_vis, u, stage)
        losses.append(loss)
        if first is None:
            first = grads
    return losses, first, {k: t.w[k] for k in t.params}
