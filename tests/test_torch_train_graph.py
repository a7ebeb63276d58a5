"""The train step as one CUDA graph per step kind (``train.GraphedStep``).

On the CPU: the cached constants that let the AO step be captured (the PIT
table, the slot swap's pair orderings) are made once per device and hold
today's values; the graphed path is not taken on the CPU nor under a
process group; the learning-rate part of the graph's key changes exactly
at each ``lr_steps`` boundary; and the graphed step's control flow, with
an emulated graph, follows the eager sequence of states.

On a card (the ``cuda`` marker; each test skips without one): AV and AO
steps graphed against eager from one state, also across an ``lr_steps``
boundary; no synchronizing call in either kind; the kernels' launch
counters; a new batch shape, a state loaded in place and a new state; and
the pools returned when the steps are dropped.  The file imports torch and
the port only, so the card's machine, which has no JAX, runs it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_train_graph.py -q -s
"""

import contextlib
import functools
import gc
import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, sop_main, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import criterion, fusion
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from avsep_tpu_torch.ops import kernels
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.sop_engine import sop_forward
from avsep_tpu_torch.utils import spans
from tests.test_torch_spans import SOP

SMALL = dict(arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
             vis_channels=32, fusion_type="hidsep", att_type="sig",
             loss="bce", not_pool_vis=False, binary_mask=1, weighted_loss=1,
             num_mix=2, audLen=16383, imgSize=64, one_frame=True,
             match_weight=0.1, lr_sound=1e-2, lr_frame=1e-3,
             lr_steps=(100,))
CPU = torch.device("cpu")
KINDS = [True, False] * 3             # AV, AO, AV, AO, AV, AO
EAGER_READINGS = 12                   # eager-against-eager runs for a limit


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.drain()
    yield
    spans.disable()
    spans.drain()


def small_nets(cfg, device=CPU):
    torch.manual_seed(0)
    return engine.Nets(AudioUnet(fc_dim=2, num_downs=5, ngf=8,
                                 fusion_type=cfg.fusion_type,
                                 att_type=cfg.att_type).to(device),
                       TinyConvEncoder(32, "maxpool").to(device))


def batches(cfg, n, B=2, device=CPU, seed=0):
    rs = np.random.RandomState(seed)
    return [{"audios": torch.from_numpy(
                 (rs.randn(B, 2, cfg.audLen) * 0.05).astype(np.float32)
             ).to(device),
             "frames": torch.from_numpy(rs.randint(
                 0, 256, (B, 2, 1, 64, 64, 3)).astype(np.uint8)).to(device)}
            for _ in range(n)]


def state_tensors(state):
    """Every tensor of a train state, named."""
    out = {f"{n}.{k}": v for n, net in train.modules(state.nets)
           for k, v in net.state_dict().items()}
    out.update({f"m.{g}.{k}": v for g, gs in state.opt_state.items()
                if gs is not None for k, v in gs.momentum.items()})
    return out


def run(cfg, make, kinds, data, device=CPU, state=None, draws=True):
    """``kinds`` steps of ``make(cfg, nets, use_vis, device)`` on ``data``
    from the small nets: each step's loss, the state's tensors after each
    step (the first step's momentum is the gradient the optimizer got,
    with the weight decay) on the CPU, the recorder's counts, the swap
    generator's state and the final train state.  The steps get the
    generator if ``draws`` (SoP++'s forward takes none)."""
    if state is None:
        nets = small_nets(cfg, device)
        state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    steps = {v: make(cfg, state.nets, v, device) for v in (True, False)}
    gen = torch.Generator().manual_seed(5)
    draw = {"generator": gen} if draws else {}
    losses, after = [], []
    spans.drain()
    with spans.recording():
        for v, b in zip(kinds, data):
            state, m = steps[v](state, b, **draw)
            losses.append(m["err"])
            after.append({k: t.detach().cpu().clone()
                          for k, t in state_tensors(state).items()})
    rec = spans.drain()
    return {"losses": [float(x) for x in losses], "after": after,
            "counts": rec.totals(), "gen": gen.get_state(), "state": state,
            "steps": steps}


def largest_difference(a, b) -> float:
    """The largest absolute difference of two runs' losses and tensors."""
    d = max(abs(x - y) for x, y in zip(a["losses"], b["losses"]))
    for ta, tb in zip(a["after"], b["after"]):
        assert ta.keys() == tb.keys()
        for k in ta:
            d = max(d, float((ta[k].double() - tb[k].double()).abs().max()))
    return d


# ------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("S", [2, 3])
def test_pit_table_is_made_once_per_device(S):
    a = criterion._perm_table(S, CPU)
    assert criterion._perm_table(S, CPU) is a
    assert a.tolist() == [list(p) for p in itertools.permutations(range(S))]
    assert a.dtype == torch.long


def test_pair_orders_are_made_once_per_device_and_swap_as_before():
    swapped, kept = fusion._pair_orders(CPU)
    assert fusion._pair_orders(CPU) == (swapped, kept)
    assert fusion._pair_orders(CPU)[0] is swapped
    assert swapped.tolist() == [[1, 0]] and kept.tolist() == [[0, 1]]
    assert swapped.dtype == kept.dtype == torch.long
    # the coin of the reference: slots swap where u <= 0.5
    blocks = torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
    u = torch.tensor([0.1, 0.5, 0.51, 0.9])
    got = fusion._random_slot_swap(blocks, u)
    want = torch.stack([b.flip(0) if x <= 0.5 else b
                        for b, x in zip(blocks, u)])
    assert torch.equal(got, want)


def test_the_graph_is_not_taken_on_the_cpu():
    """On the CPU ``make_train_step`` is the eager step: AV, AO, AV, AO and
    more through it equal ``make_eager_train_step``'s bit for bit, and no
    graph is captured or replayed."""
    cfg = Config(**SMALL)
    data = batches(cfg, len(KINDS))
    got = run(cfg, train.make_train_step, KINDS, data)
    want = run(cfg, train.make_eager_train_step, KINDS, data)
    assert not any(isinstance(s, train.GraphedStep)
                   for s in got["steps"].values())
    assert largest_difference(got, want) == 0.0
    assert torch.equal(got["gen"], want["gen"])
    assert not {"train.graph_capture", "train.graph_replay"} & set(
        got["counts"])


@pytest.mark.parametrize("case", ["cuda", "cpu", "group_of_two",
                                  "group_of_one"])
def test_graphable_only_on_a_card_outside_a_process_group(case, monkeypatch,
                                                          tmp_path):
    """The graphed path needs a CUDA device and no process group: a group's
    collectives stay eager (a group of one rank still runs them)."""
    dev = torch.device("cpu" if case == "cpu" else "cuda", 0)
    if case == "group_of_two":
        monkeypatch.setattr(pdist, "active", lambda: True)
        monkeypatch.setattr(pdist, "world_size", lambda: 2)
    ctx = contextlib.nullcontext()
    if case == "group_of_one":
        ctx = _gloo_group_of_one(tmp_path)
    with ctx:
        assert train.graphable(dev) == (case == "cuda")


@contextlib.contextmanager
def _gloo_group_of_one(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_learning_rates_change_exactly_at_each_boundary():
    """The learning-rate part of a graph's key is each advancing group's
    rate at its count: it changes exactly where a group's count reaches an
    ``lr_steps`` boundary, and an AO step leaves the frame group out."""
    cfg = Config(**dict(SMALL, lr_steps=(3, 7)))
    nets = small_nets(cfg)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    prev = None
    for count in range(10):
        for gs in state.opt_state.values():
            gs.count = count
        key = train.learning_rates(cfg, state, True)
        assert [g for g, _ in key] == ["sound", "frame"]
        assert [lr for _, lr in key] == [
            train.lr_at(cfg.lr_sound, cfg.lr_steps, count),
            train.lr_at(cfg.lr_frame, cfg.lr_steps, count)]
        if prev is not None:
            assert (key != prev) == (count in (3, 7)), count
        prev = key
        assert [g for g, _ in train.learning_rates(cfg, state, False)] \
            == ["sound"]
    # one group past a boundary changes the key alone
    state.opt_state["frame"].count = 0
    state.opt_state["sound"].count = 2
    k0 = train.learning_rates(cfg, state, True)
    state.opt_state["sound"].count = 3
    assert train.learning_rates(cfg, state, True)[1] == k0[1]
    assert train.learning_rates(cfg, state, True)[0] != k0[0]


class _EmulatedGraph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs
    the step and takes its effect on the state's tensors back, as a capture
    runs no kernel; a replay runs it again on the captured inputs at the
    captured counts (which the host has already moved on) and writes the
    captured metrics in place."""
    capturing = None

    def replay(self):
        state, counts, args = self.state, self.counts, self.args
        now = {g: state.opt_state[g].count for g in counts}
        step = state.step
        for g, c in counts.items():
            state.opt_state[g].count = c
        _, m = _EmulatedGraph.real_step(*args)
        for g, c in now.items():
            state.opt_state[g].count = c
        state.step = step
        with torch.no_grad():
            for k, v in m.items():
                self.metrics[k].copy_(v)


@contextlib.contextmanager
def _emulated_capture(graph, capture_error_mode="global"):
    _EmulatedGraph.capturing = graph
    try:
        yield
    finally:
        _EmulatedGraph.capturing = None


def _emulated_step(cfg, use_vis, forward, state, batch, u, gen):
    args = (cfg, use_vis, forward, state, batch, u, gen)
    graph = _EmulatedGraph.capturing
    if graph is None:
        return _EmulatedGraph.real_step(*args)
    before = {k: t.detach().clone() for k, t in state_tensors(state).items()}
    graph.state, graph.args = state, args
    graph.counts = {g: s.count for g, s in state.opt_state.items()
                    if s is not None}
    # a card's capture counts the launches it records: kernel i, i + 1
    for i, k in enumerate(kernels.SOURCES):
        getattr(kernels, k).launches += i + 1
    out = _EmulatedGraph.real_step(*args)
    with torch.no_grad():
        for k, t in state_tensors(state).items():
            t.copy_(before[k])
    graph.metrics = out[1]
    return out


@pytest.mark.parametrize("family", ["avsep", "sop"])
def test_graphed_step_follows_the_eager_sequence_with_an_emulated_graph(
        monkeypatch, family):
    """``GraphedStep``'s keys, captures, replays and host bookkeeping with
    an emulated graph on the CPU, across two ``lr_steps`` boundaries, for
    the step of ``engine.forward`` and for SoP++'s (whose forward takes no
    draw): the losses, every tensor after every step, the counts, ``step``
    and the slot swap's generator follow the eager sequence bit for bit;
    each kind captures on its second call with a key and recaptures past a
    boundary; the metrics handed out are fresh tensors (the losses read
    after the last step are each step's own); every replay advances the
    launch counter of every kernel of ``kernels.SOURCES`` by what its
    capture counted."""
    monkeypatch.setattr(_EmulatedGraph, "real_step", train._step,
                        raising=False)
    monkeypatch.setattr(train, "_step", _emulated_step)
    monkeypatch.setattr(train, "graphable", lambda d: True)
    monkeypatch.setattr(train.GraphedStep, "_put_uniforms",
                        lambda self, static, u: static.copy_(u))
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _EmulatedGraph)
    monkeypatch.setattr(torch.cuda, "graph", _emulated_capture)
    launches0 = kernels.launch_counts()
    for k, n in launches0.items():
        monkeypatch.setattr(getattr(kernels, k), "launches", n)
    sop = family == "sop"
    cfg = Config(**dict(SOP if sop else SMALL, lr_steps=(3, 5)))
    forward = (functools.partial(sop_forward, stage=3) if sop
               else engine.forward)
    kinds = [True, False] * 8
    data = batches(cfg, len(kinds))

    def graphed(cfg_, nets, use_vis, device):
        return train.GraphedStep(cfg_, use_vis, eager(
            cfg_, nets, use_vis, device), CPU, forward)

    def eager(cfg_, nets, use_vis, device):
        return train.make_eager_train_step(cfg_, nets, use_vis, device,
                                           forward)

    def state():
        if not sop:
            return None
        return sop_main.init_sop_state(cfg, sop_main.build_sop_nets(
            cfg, "cpu"), torch.Generator().manual_seed(0), "cpu")

    got = run(cfg, graphed, kinds, data, state=state(), draws=not sop)
    want = run(cfg, eager, kinds, data, state=state(), draws=not sop)
    assert largest_difference(got, want) == 0.0
    assert torch.equal(got["gen"], want["gen"])
    assert got["state"].step == want["state"].step == len(kinds)
    assert {g: s.count for g, s in got["state"].opt_state.items()} == \
        {g: s.count for g, s in want["state"].opt_state.items()}
    # sound's count reaches 3 and 5 at steps 3 and 5, frame's (AV steps
    # only) at steps 6 and 10: a kind runs eager where its key is new and
    # captures on the next call with that key, AV at steps 2, 8 and 12, AO
    # at 7; steps 9, 11, 13, 14 and 15 replay
    assert got["counts"]["train.graph_capture"] == 4
    assert got["counts"]["train.graph_replay"] == 5
    # the emulated capture counts i + 1 launches of kernel i
    assert {k: n - launches0[k] for k, n in kernels.launch_counts().items()
            } == {k: 9 * (i + 1) for i, k in enumerate(kernels.SOURCES)}


# ------------------------------------------------------------ on a card


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off and cuDNN deterministic inside the
    test; skips the test where there is none (a CUDA graph and the CUDA
    kernels run only on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and kernels run only "
                    "on the card")
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    engine.full_float32()
    try:
        yield torch.device("cuda", torch.cuda.current_device())
    finally:
        torch.backends.cudnn.deterministic = before


def _limit(cfg, kinds, data, dev) -> float:
    """Twice the largest of :data:`EAGER_READINGS` eager-against-eager
    differences of the sequence; 0 where eager repeats itself bit for
    bit."""
    ref = run(cfg, train.make_eager_train_step, kinds, data, dev)
    readings = [largest_difference(ref, run(
        cfg, train.make_eager_train_step, kinds, data, dev))
        for _ in range(EAGER_READINGS)]
    print(f"eager against eager: {readings}")
    return 2 * max(readings)


@pytest.mark.cuda
@pytest.mark.parametrize("lr_steps", [(100,), (3, 5)],
                         ids=["steady", "lr_boundaries"])
def test_graphed_steps_match_eager_on_cuda(cuda_device, lr_steps):
    """AV, AO, AV, AO, ... from one state, graphed against eager: the
    losses, the gradient as the optimizer got it (the momentum after the
    first step) and every tensor after every step, bit for bit where
    eager repeats itself, else within twice its own spread; the swap
    generator's draws alike.  Past each boundary the kind that crosses it
    runs eager once, then captures again."""
    cfg = Config(**dict(SMALL, lr_steps=lr_steps))
    kinds = [True, False] * (3 if lr_steps == (100,) else 6)
    data = batches(cfg, len(kinds), device=cuda_device)
    limit = _limit(cfg, kinds, data, cuda_device)
    got = run(cfg, train.make_train_step, kinds, data, cuda_device)
    want = run(cfg, train.make_eager_train_step, kinds, data, cuda_device)
    diff = largest_difference(got, want)
    print(f"graphed against eager ({lr_steps}): {diff} (limit {limit})")
    assert diff <= limit
    assert torch.equal(got["gen"], want["gen"])
    captures = 2 if lr_steps == (100,) else 3
    assert got["counts"]["train.graph_capture"] == captures
    assert got["counts"]["train.graph_replay"] >= 2


@pytest.mark.cuda
def test_graphed_steps_count_no_sync_and_their_launches_on_cuda(
        cuda_device):
    """With the recorder counting synchronizing calls, a replayed step of
    either kind counts none; each replayed step adds its two
    ``frame_window`` launches (the mixture's and the sources' STFT) to the
    kernel's counter, and no ``overlap_add_normalize``."""
    cfg = Config(**SMALL)
    kinds = [True, False] * 4
    data = batches(cfg, len(kinds), device=cuda_device)
    nets = small_nets(cfg, cuda_device)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    steps = {v: train.make_train_step(cfg, nets, v) for v in (True, False)}
    gen = torch.Generator().manual_seed(5)
    for v, b in zip(kinds[:4], data[:4]):       # eager, then captures
        state, _ = steps[v](state, b, generator=gen)
    torch.cuda.synchronize()
    spans.drain()
    per_step = []
    with spans.recording():
        assert spans.counting_syncs()
        for v, b in zip(kinds[4:], data[4:]):
            fw = kernels.frame_window.launches
            ola = kernels.overlap_add_normalize.launches
            state, m = steps[v](state, b, generator=gen)
            per_step.append((kernels.frame_window.launches - fw,
                             kernels.overlap_add_normalize.launches - ola))
            float(m["err"])
    rec = spans.drain()
    kids = spans.descendants(rec.records)
    by_kind = {}
    for r in rec.records:
        if r.name == "train.step":
            c = spans.inclusive_counts(r, kids)
            by_kind.setdefault(r.attrs["kind"], []).append(
                (c.get(spans.SYNC, 0), c.get("train.graph_replay", 0)))
    assert by_kind == {"av": [(0, 1), (0, 1)], "ao": [(0, 1), (0, 1)]}
    assert per_step == [(2, 0)] * 4


@pytest.mark.cuda
def test_graphs_follow_shapes_and_states_on_cuda(cuda_device):
    """A new batch shape runs eager once and then captures; a state loaded
    in place (``TrainState.load_state_dict``) keeps the graphs; a new state
    whose tensors lie elsewhere never replays into the old memory: it runs
    eager, then captures.  Each step's loss equals the eager step's on a
    copy of the same state."""
    cfg = Config(**SMALL)
    nets = small_nets(cfg, cuda_device)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    step = train.make_train_step(cfg, nets, True)
    eager = train.make_eager_train_step(cfg, nets, True)
    small, large = (batches(cfg, 3, B=B, device=cuda_device, seed=B)
                    for B in (2, 4))

    def counted(st, b):
        """One graphed step and the eager step on a copy of ``st``:
        (graph counters, loss, eager loss)."""
        twin = train.TrainState(st.step, small_nets(cfg, cuda_device),
                                train.init_opt_state(cfg, st.nets))
        twin.load_state_dict(st.state_dict())
        spans.drain()
        with spans.recording():
            st, m = step(st, b)
        c = spans.drain().totals()
        _, want = eager(twin, b)
        return ({k[len("train.graph_"):]: v for k, v in c.items()
                 if k.startswith("train.graph_")},
                float(m["err"]), float(want["err"]))

    seen = [counted(state, b) for b in (small[0], small[1], small[2],
                                        large[0], large[1], large[2])]
    assert [c for c, _, _ in seen] == [{}, {"capture": 1}, {"replay": 1},
                                       {}, {"capture": 1}, {"replay": 1}]
    assert all(a == b for _, a, b in seen), seen
    state.load_state_dict(state.state_dict())
    assert counted(state, large[0])[0] == {"replay": 1}
    fresh = train.TrainState(state.step, small_nets(cfg, cuda_device),
                             train.init_opt_state(cfg, state.nets))
    fresh.load_state_dict(state.state_dict())
    got = [counted(fresh, large[i]) for i in range(3)]
    assert [c for c, _, _ in got] == [{}, {"capture": 1}, {"replay": 1}]
    assert all(a == b for _, a, b in got), got


@pytest.mark.cuda
def test_dropping_the_steps_returns_their_pools_on_cuda(cuda_device):
    """The graphs and their private pools live in the steps: once the
    steps are dropped and the cache emptied, the card holds what it held
    before the captures, up to one library workspace."""
    cfg = Config(**SMALL)
    nets = small_nets(cfg, cuda_device)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    data = batches(cfg, 4, device=cuda_device)
    gen = torch.Generator().manual_seed(5)
    steps = {v: train.make_train_step(cfg, nets, v) for v in (True, False)}
    for v, b in zip([True, False], data[:2]):
        state, m = steps[v](state, b, generator=gen)
    del m
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda_device)
    for v, b in zip([True, False], data[2:]):
        state, m = steps[v](state, b, generator=gen)
    del m
    torch.cuda.synchronize()
    held = torch.cuda.memory_reserved(cuda_device)
    assert all(isinstance(s.graph, train._Graph) for s in steps.values())
    del steps
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_reserved(cuda_device)
    print(f"reserved: {before} before the captures, {held} with the "
          f"graphs, {after} after dropping the steps")
    assert held > after
    # what may stay is a cuBLAS workspace kept for the capture's stream
    assert after <= before + 32 * 2 ** 20
