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
import inspect
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from avsep_tpu_torch import engine
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.engine import Nets
from avsep_tpu_torch.models.fusion import swap_uniforms as swap_uniforms_of
from avsep_tpu_torch.models.torch_import import (
    load_torch_checkpoint, resnet_state_dict_from_torch,
    unet_state_dict_from_torch)
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.utils import spans


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
    loss), then one SGD update of those groups, in place; ``step`` + 1.
    Spans ``train.backward``, ``train.grad_mean`` and ``train.update``
    (``utils/spans.py``)."""
    params = dict(named_parameters(state.nets))
    groups = _groups_of(cfg, state, use_vis)
    live = [n for n in params if param_group(n) in groups]
    with spans.span("train.backward"):
        grads = torch.autograd.grad(err, [params[n] for n in live],
                                    allow_unused=True)
    with spans.span("train.grad_mean"):
        pdist.mean_([g for g in grads if g is not None])
    with spans.span("train.update"):
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


def _step(cfg: Config, use_vis: bool, forward: Callable, state: TrainState,
          batch, swap_uniforms, generator) -> Tuple[TrainState, Dict]:
    """One ``forward`` in train mode, backward and SGD update in place,
    under the spans ``train.forward``, :func:`apply_gradients`' and
    ``train.metrics``.  ``forward`` gets the slot swap's draw only where
    one is given: a forward that takes none raises on it."""
    draw = {k: v for k, v in (("swap_uniforms", swap_uniforms),
                              ("generator", generator)) if v is not None}
    with spans.span("train.forward"):
        err, outputs = forward(state.nets, batch, cfg, use_vis, train=True,
                               **draw)
    apply_gradients(cfg, state, err, use_vis)
    with spans.span("train.metrics"):
        metrics = step_metrics(err, outputs["match_loss"])
    return state, metrics


def make_eager_train_step(cfg: Config, nets: Nets, use_vis: bool,
                          device=None, forward: Callable = engine.forward
                          ) -> Callable:
    """Returns ``step(state, batch, *, swap_uniforms=None, generator=None)
    -> (state, metrics)``: one ``forward`` (AV if ``use_vis``, else AO),
    one backward and one SGD update, in place, each operation dispatched
    from the host as it comes; ``metrics`` holds the detached ``err`` and
    ``match_loss`` (:func:`step_metrics`).  ``forward(nets, batch, cfg,
    use_vis, *, train, ...) -> (err, outputs)`` is the family's:
    :func:`engine.forward`, whose AO slot swap takes ``swap_uniforms [B]``
    (this rank's rows) or ``generator``, or SoP++'s ``sop_forward`` at a
    stage, which takes no draw.  The nets must lie on ``device`` (``cuda``
    unless ``device="cpu"``).  A step is the span ``train.step`` (``kind``
    ``av`` or ``ao``) over ``train.forward``, :func:`apply_gradients`'
    spans and ``train.metrics``."""
    engine.nets_device(nets, device)
    kind = "av" if use_vis else "ao"

    def step(state: TrainState, batch, *, swap_uniforms=None,
             generator=None) -> Tuple[TrainState, Dict]:
        with spans.span("train.step", kind=kind):
            return _step(cfg, use_vis, forward, state, batch, swap_uniforms,
                         generator)

    return step


def make_train_step(cfg: Config, nets: Nets, use_vis: bool,
                    device=None, forward: Callable = engine.forward
                    ) -> Callable:
    """The step of :func:`make_eager_train_step`, which on a CUDA device
    outside a process group runs as one replay of a CUDA graph per call
    (:class:`GraphedStep`); on the CPU it is the eager step itself."""
    dev = engine.nets_device(nets, device)
    eager = make_eager_train_step(cfg, nets, use_vis, dev, forward)
    if dev.type != "cuda":
        return eager
    return GraphedStep(cfg, use_vis, eager,
                       next(nets.sound.parameters()).device, forward)


def learning_rates(cfg: Config, state: TrainState, use_vis: bool
                   ) -> Tuple[Tuple[str, float], ...]:
    """``(group, lr)`` of each group that advances in a step, at the
    group's count, as :func:`_sgd_update` reads them."""
    return tuple((g, lr_at(_base_lr(cfg, g), cfg.lr_steps,
                           state.opt_state[g].count))
                 for g in _groups_of(cfg, state, use_vis))


def graphable(device: torch.device) -> bool:
    """Whether a step on ``device`` may run as a CUDA graph: a CUDA device
    and no process group (a group's collectives stay eager)."""
    return device.type == "cuda" and not pdist.active()


def _addresses(state: TrainState, mods: List[torch.nn.Module]) -> tuple:
    """The address of every tensor a step reads and writes in place: the
    parameters and buffers of ``mods`` (every module of the state's nets)
    and the momentum buffers.  It reads each module's own dicts: walking
    ``net.parameters()`` on every call costs the host several times more."""
    out = [t.data_ptr() for m in mods
           for d in (m._parameters, m._buffers) for t in d.values()
           if t is not None]
    out += [b.data_ptr() for gs in state.opt_state.values() if gs is not None
            for b in gs.momentum.values()]
    return tuple(out)


@dataclasses.dataclass
class _Graph:
    """One captured step: its key, the graph, its static inputs (the batch
    and, for an AO step, the slot swap's uniforms), its static metrics, the
    groups it advances, the kernel launches it holds and what it counts
    in the span recorder (``motion.clips``, ``motion.slow_frames``)."""
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    batch: Dict[str, torch.Tensor]
    uniforms: Optional[torch.Tensor]
    metrics: Dict[str, torch.Tensor]
    groups: List[str]
    launches: Dict[str, int]
    counts: Dict[str, int]


class GraphedStep:
    """:func:`make_eager_train_step`'s step of ``forward``, replayed as one
    CUDA graph.

    A call runs eager unless :func:`graphable` holds and every value of
    the batch is a tensor on the nets' device.  Otherwise it is keyed by
    the batch's shapes, dtypes and strides, :func:`learning_rates` and the
    addresses of the state's tensors (:func:`_addresses`): the first
    call with a key runs eager (and warms cuDNN, cuBLAS, the caching
    allocator and the cached constants the capture must find); the second
    captures the step into a graph with a private memory pool, then
    replays it once as that step; later calls copy the batch into the
    graph's static inputs (device to device, on the current stream) and
    replay.  A new key drops the old graph when it is captured: a new
    batch shape, a learning rate past an ``lr_steps`` boundary, a state
    whose tensors were rebuilt (a state loaded in place keeps its
    addresses, and its graphs).

    The replay is the eager step's kernels in its order; the host keeps
    what the graph cannot: the AO slot swap's uniforms (where ``forward``
    takes a draw) are drawn from the same generator as the eager step
    draws them and reach the static input through pinned memory without
    blocking (the caching host allocator reuses a pinned block only once
    its copy has landed); each advancing group's count and ``step`` go up
    by one; the kernels' launch counters (:func:`kernels.launch_counts`)
    go up by the launches the capture counted; the nets are put back in
    train mode.  ``metrics`` are fresh copies of the graph's static
    outputs.  A step is the span ``train.step`` with the counter
    ``train.graph_capture`` or ``train.graph_replay``; the inner spans are
    recorded at the capture only, and a replay counts again inside its
    ``train.step`` the clips the captured step ran through the motion net
    and the slow pathway's frames (``motion.clips``,
    ``motion.slow_frames``: :func:`engine.motion_counts` of its static
    batch, for the recorder may be off at the capture).  The graphs and
    their pools are this object's: dropping it frees them."""

    def __init__(self, cfg: Config, use_vis: bool, eager: Callable,
                 device: torch.device, forward: Callable = engine.forward):
        self.cfg, self.use_vis, self.eager, self.device = (
            cfg, use_vis, eager, device)
        self.forward = forward
        self.kind = "av" if use_vis else "ao"
        self.draws = not use_vis and (
            "swap_uniforms" in inspect.signature(forward).parameters)
        self.graph: Optional[_Graph] = None
        self.seen: Optional[tuple] = None   # the last key that ran eager
        self.nets, self.mods = None, []     # the state's nets, their modules

    def __call__(self, state: TrainState, batch, *, swap_uniforms=None,
                 generator=None) -> Tuple[TrainState, Dict]:
        if not (graphable(self.device) and batch and all(
                isinstance(v, torch.Tensor) and v.device == self.device
                for v in batch.values())):
            return self.eager(state, batch, swap_uniforms=swap_uniforms,
                              generator=generator)
        if state.nets is not self.nets:
            self.nets = state.nets
            self.mods = [m for _, net in modules(state.nets)
                         for m in net.modules()]
        key = (tuple((k, tuple(v.shape), v.dtype, v.stride())
                     for k, v in sorted(batch.items())),
               learning_rates(self.cfg, state, self.use_vis),
               _addresses(state, self.mods))
        if self.graph is not None and self.graph.key == key:
            return self._replay(state, batch, swap_uniforms, generator)
        if key != self.seen:
            self.seen = key
            return self.eager(state, batch, swap_uniforms=swap_uniforms,
                              generator=generator)
        self.graph = None           # its pool goes before the next fills
        return self._capture(key, state, batch, swap_uniforms, generator)

    def _uniforms(self, batch, swap_uniforms, generator):
        """The AO slot swap's ``[B]`` draw, made as the eager step makes
        it; None for an AV step or a forward that draws none."""
        if not self.draws:
            return None
        rows = next(iter(batch.values())).shape[0]
        return swap_uniforms_of(rows, swap_uniforms, generator)

    def _put_uniforms(self, static: torch.Tensor, u: torch.Tensor) -> None:
        if u.device.type == "cpu":
            u = u.pin_memory()
        static.copy_(u, non_blocking=True)

    def _capture(self, key, state: TrainState, batch, swap_uniforms,
                 generator) -> Tuple[TrainState, Dict]:
        u = self._uniforms(batch, swap_uniforms, generator)
        static = {k: v.clone() for k, v in batch.items()}
        static_u = None
        if u is not None:
            static_u = torch.empty(u.shape, dtype=torch.float32,
                                   device=self.device)
            self._put_uniforms(static_u, u)
        groups = _groups_of(self.cfg, state, self.use_vis)
        counts = {g: state.opt_state[g].count for g in groups}
        step0 = state.step
        launches0 = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with spans.span("train.step", kind=self.kind):
            spans.count("train.graph_capture")
            try:
                # thread_local: the loader's prefetch thread may go on
                # pinning and copying batches during the capture, which
                # the global mode forbids in every thread
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    _, metrics = _step(self.cfg, self.use_vis,
                                       self.forward, state, static,
                                       static_u, None)
            except BaseException:
                # the capture ran no kernel: the host state stays too
                for g, c in counts.items():
                    state.opt_state[g].count = c
                state.step = step0
                raise
            graph.replay()
        self.graph = _Graph(
            key, graph, static, static_u, metrics, groups,
            {k: n - launches0[k] for k, n in kernels.launch_counts().items()},
            engine.motion_counts(self.cfg, self.use_vis, static,
                                 getattr(state.nets, "motion", None)))
        return state, {k: v.clone() for k, v in metrics.items()}

    def _replay(self, state: TrainState, batch, swap_uniforms,
                generator) -> Tuple[TrainState, Dict]:
        gr = self.graph
        with spans.span("train.step", kind=self.kind):
            spans.count("train.graph_replay")
            for k, t in gr.batch.items():
                t.copy_(batch[k], non_blocking=True)
            if gr.uniforms is not None:
                self._put_uniforms(gr.uniforms, self._uniforms(
                    batch, swap_uniforms, generator))
            gr.graph.replay()
            for g in gr.groups:
                state.opt_state[g].count += 1
            state.step += 1
            for k, n in gr.launches.items():
                getattr(kernels, k).launches += n
            for k, n in gr.counts.items():
                spans.count(k, n)
            for _, net in modules(state.nets):
                if not net.training:
                    net.train(True)
            metrics = {k: v.clone() for k, v in gr.metrics.items()}
        return state, metrics


def batch_scheduler(cfg: Config) -> Callable[[int], bool]:
    """``use_vis`` of iteration ``i`` (reference get_av_ao_batch,
    main.py:572-601): AV every ``iter_per_av`` iterations, with the
    ``start_av_first`` / ``num_fsteps`` warm-up gate."""
    def use_vis(i: int) -> bool:
        if cfg.start_av_first:
            return i % cfg.iter_per_av == 0 or i < cfg.num_fsteps
        return i % cfg.iter_per_av == 0 and i > cfg.num_fsteps
    return use_vis
