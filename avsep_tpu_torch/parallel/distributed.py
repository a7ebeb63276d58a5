"""Data parallelism over ranks, one card each, with ``torch.distributed``.

Port of ``avsep_tpu/parallel/distributed.py``.  The JAX package puts one
data axis over every device of every process and shards the batch on dim 0;
under ``jax.jit`` that is the program of the global batch, with the
gradient ``psum`` and the global BatchNorm statistics inserted by XLA.  The
port runs one rank per card and makes a step over W ranks compute what
one process computes on the whole global batch, up to float32 summation
order.  A *process* is the JAX package's: ``--dist_procid`` of
``--dist_nprocs`` P (one per host).  A process that spans L cards runs L
ranks (``parallel/launch.py``), so the group has W = P * L ranks, and
process ``procid``'s ranks are ``procid * L .. procid * L + L - 1``, the
JAX device order ``(process_index, id)``:

* **initialization**: :func:`join` pins the rank's card before anything is
  allocated and joins the group (NCCL for CUDA, gloo for the CPU);
  :func:`maybe_initialize` does so from the ``--dist_*`` flags for a
  process that is one rank (one process per card), the launcher for each
  of its ranks.  ``engine.resolve_device`` then returns that card.
* **batch formation**: :func:`device_put_global` returns the rank's rows.
  ``replicate``: every rank runs the same deterministic loader, holds the
  full global batch and keeps rows ``[r*B/W, (r+1)*B/W)``.  ``shard`` (only
  when P > 1, as in JAX): each process's ranks load the process's ``B/P``
  rows from a disjoint ``data.loader.ShardDataset`` and each keeps its
  block of them; the global batch is the processes' rows in process order.
* **randomness**: :func:`rank_rand` draws for the global batch from a
  generator seeded alike on every rank and keeps the rank's rows, so the
  draws of a replicate run are the one-process run's.
* **collectives**: only ``all_reduce``, ``broadcast`` and ``barrier``,
  which gloo also supports on CUDA tensors, so the same code runs over
  gloo on the CPU, over gloo with two ranks on one card, and over NCCL on
  several.  :func:`mean_` averages the gradients (one buffer per step) and
  the step's metrics, :func:`all_reduce_sum` is the differentiable sum
  behind the global-batch BatchNorm (``models/layers.py``), :func:`fetch`
  gathers per-row tensors to every rank (an ``all_reduce`` of a
  zero-padded buffer that each rank fills with its rows), and
  :func:`broadcast_` makes every rank start from rank 0's state.  Each
  collective is issued in one place (``_issue``): the span
  ``dp.all_reduce`` or ``dp.broadcast`` and the counters
  ``dp.collectives`` and ``dp.bytes`` while the span recorder is on
  (``utils/spans.py``).
* **files**: history, ``results.csv``, plots, media and checkpoints are
  written by the primary rank (:func:`is_primary`, global rank 0); a
  checkpoint save is followed by :func:`barrier`, and every rank restores.

Without a group every function here is the single-process identity, so
the one-card path runs no collective.  A group of one rank (possible only
when the caller starts it) runs the collectives, each an identity on one
rank; the BatchNorm's global path needs more than one rank.
"""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from avsep_tpu_torch.utils import spans

# a collective that waits longer than this raises (gloo) or aborts the
# communicator (NCCL), so a rank that died cannot hang its peers for ever
TIMEOUT = datetime.timedelta(minutes=10)
DIST_DATA = ("replicate", "shard")


def active() -> bool:
    """Whether a process group exists."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_primary() -> bool:
    """Global rank 0, the one that writes."""
    return rank() == 0


def process_count(cfg) -> int:
    """The JAX package's ``process_count``: ``--dist_nprocs`` (P)."""
    return max(1, int(cfg.dist_nprocs))


def process_index(cfg) -> int:
    """The JAX package's ``process_index`` of this rank: ``rank // L``,
    with L = W / P ranks per process."""
    return rank() // max(1, world_size() // process_count(cfg))


def is_multihost(cfg) -> bool:
    """More than one process (P > 1), as in the JAX package, whatever the
    ranks per process."""
    return process_count(cfg) > 1


def local_device_index() -> int:
    """The card of this rank: ``rank % torch.cuda.device_count()``."""
    return rank() % torch.cuda.device_count()


def join(init: str, rank: int, world: int, card: int = 0, device=None,
         backend: Optional[str] = None,
         timeout: datetime.timedelta = TIMEOUT) -> None:
    """Join the group at ``init`` (a ``tcp://`` or ``file://`` address) as
    ``rank`` of ``world``.  On a GPU ``cuda:{card % device_count}`` is made
    current first, before the group allocates anything; ``backend``
    defaults to gloo when ``device`` is the CPU, else NCCL."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(card) % torch.cuda.device_count())
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=init, world_size=int(world),
                            rank=int(rank), timeout=timeout)
    print(f"[dist] rank {rank}/{world} up on "
          f"{'cpu' if cpu else torch.cuda.current_device()}: backend "
          f"{dist.get_backend()}", flush=True)


def maybe_initialize(cfg, device=None, backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Start the process group from ``--dist_coordinator host:port``,
    ``--dist_nprocs`` and ``--dist_procid`` when ``dist_nprocs > 1``, this
    process being one rank on card ``procid % device_count``.  Returns
    whether it started one: it does nothing for one process or when a
    group exists already (the launcher's ranks, or a caller that starts
    the group itself and pins its card itself)."""
    if int(cfg.dist_nprocs) <= 1 or active():
        return False
    if not cfg.dist_coordinator:
        raise ValueError("--dist_nprocs > 1 requires --dist_coordinator "
                         "host:port (the address of process 0)")
    join(f"tcp://{cfg.dist_coordinator}", int(cfg.dist_procid),
         int(cfg.dist_nprocs), card=int(cfg.dist_procid), device=device,
         backend=backend, timeout=timeout)
    return True


def shutdown() -> None:
    """Destroy the process group, if there is one.  Called when a rank
    leaves, on success or on an error: its peers' next collective then
    fails at once instead of waiting out :data:`TIMEOUT`."""
    if active():
        dist.destroy_process_group()


def validate_global_batch(cfg) -> None:
    """Fail fast on a batch the ranks cannot divide (the per-rank batch
    would be floored silently) and on an unknown ``dist_data``: the JAX
    package's two checks, the global batch across the W ranks and, under
    ``shard``, across the P processes.  No-op for one rank.  Shared by
    ``main.main`` and ``sop_main.main``."""
    W = world_size()
    if W <= 1:
        return
    if cfg.dist_data not in DIST_DATA:
        raise ValueError(f"--dist_data {cfg.dist_data!r}: one of "
                         f"{DIST_DATA}")
    if cfg.batch_size % W:
        raise ValueError(f"global batch {cfg.batch_size} must divide "
                         f"across {W} devices")
    if cfg.dist_data == "shard" and cfg.batch_size % process_count(cfg):
        raise ValueError("dist_data=shard needs batch_size divisible "
                         "by the process count")


def rank_slice(n_local: int) -> slice:
    """This rank's rows of a global batch of ``n_local * world_size()``."""
    r = rank()
    return slice(r * n_local, (r + 1) * n_local)


def device_put_global(batch: Dict, mode: str = "replicate",
                      procs: int = 1) -> Dict:
    """The rows of a batch (numpy arrays or tensors) this rank computes.
    ``replicate``: the batch is the global one, and the rank keeps its
    block of it.  ``shard`` over ``procs`` processes: the batch is this
    process's ``1/procs`` of the global one, and the rank keeps its block
    of that among the process's ranks (all of it for one rank per
    process); with one process ``shard`` is ``replicate``."""
    W = world_size()
    parts = W // procs if mode == "shard" else W
    if parts == 1:
        return batch
    r = rank() % parts
    out = {}
    for k, v in batch.items():
        if v.shape[0] % parts:
            raise ValueError(f"{k}: {v.shape[0]} rows do not divide "
                             f"across {parts} ranks")
        n = v.shape[0] // parts
        out[k] = v[r * n:(r + 1) * n]
    return out


def rank_rand(shape, generator: torch.Generator, device=None
              ) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's ``shape[0]`` rows: the draw of
    the global batch's ``shape[0] * world_size()`` rows, the rank's block
    kept.  Every rank draws the same numbers from a generator seeded
    alike; with one process it is ``torch.rand(shape)``."""
    n = shape[0]
    u = torch.rand((n * world_size(),) + tuple(shape[1:]),
                   generator=generator, device=device)
    return u[rank_slice(n)]


def _issue(name: str, t: torch.Tensor, collective) -> None:
    """``collective(t)``: the one place a collective is issued, the span
    ``dp.<name>`` with the counters ``dp.collectives`` and ``dp.bytes``
    (``utils/spans.py``)."""
    if spans.enabled():
        spans.count("dp.collectives")
        spans.count("dp.bytes", t.numel() * t.element_size())
    with spans.span("dp." + name):
        collective(t)


def _all_reduce(t: torch.Tensor) -> None:
    _issue("all_reduce", t, dist.all_reduce)


def _flat_apply(tensors: List[torch.Tensor], collective) -> None:
    """``collective`` on the tensors concatenated into one buffer, the
    result copied back into them (any layout)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    collective(flat)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view(t.shape))


def mean_(tensors: List[torch.Tensor]) -> None:
    """Average ``tensors`` across the ranks in place, with one
    ``all_reduce`` of one buffer."""
    if not active() or not tensors:
        return
    P = world_size()

    def reduce(flat):
        _all_reduce(flat)
        flat.div_(P)
    _flat_apply(tensors, reduce)


def broadcast_(tensors: List[torch.Tensor]) -> None:
    """Overwrite ``tensors`` with rank 0's, one ``broadcast`` per dtype."""
    if not active():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        _flat_apply(group, lambda flat: _issue(
            "broadcast", flat, lambda t: dist.broadcast(t, src=0)))


def broadcast_state(state) -> None:
    """Every parameter, BatchNorm buffer and momentum buffer of a
    ``train.TrainState`` from rank 0, so the ranks start equal after an
    init or a restore."""
    tensors = [t for net in state.nets if net is not None
               for t in net.state_dict().values()]
    tensors += [b for g in state.opt_state.values() if g is not None
                for b in g.momentum.values()]
    broadcast_(tensors)


def barrier() -> None:
    if active():
        dist.barrier()


def fetch(x):
    """Per-row tensors of this rank -> the global batch's, on every rank:
    a tensor ``[n, ...]`` becomes ``[n * world_size(), ...]`` (an
    ``all_reduce`` of a zero buffer holding the rank's rows at its block;
    adding zeros is exact).  Dicts, tuples and lists are fetched per
    value; scalars and None pass through.  Collective: every rank calls it
    on the same tree."""
    if isinstance(x, dict):
        return {k: fetch(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(fetch(v) for v in x)
    if not active() or x is None or x.dim() == 0:
        return x
    n = x.shape[0]
    buf = x.new_zeros((n * world_size(),) + tuple(x.shape[1:]))
    buf[rank_slice(n)] = x
    _all_reduce(buf)
    return buf


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks; its backward is the sum of the ranks'
    gradients, which is the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_reduce`` (sum) of ``x``."""
    return _AllReduceSum.apply(x)
