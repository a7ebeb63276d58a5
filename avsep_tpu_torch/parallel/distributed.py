"""Data parallelism over processes, one card each, with ``torch.distributed``.

Port of ``avsep_tpu/parallel/distributed.py``.  The JAX package puts one
data axis over every device of every process and shards the batch on dim 0;
under ``jax.jit`` that is the program of the global batch, with the
gradient ``psum`` and the global BatchNorm statistics inserted by XLA.  The
port runs one process per card and makes a step over P ranks compute what
one process computes on the whole global batch, up to float32 summation
order:

* **initialization**: :func:`maybe_initialize` starts the group from the
  ``--dist_*`` flags (NCCL for CUDA, gloo for the CPU) and pins the rank to
  ``cuda:{rank % device_count}`` before anything is allocated;
  ``engine.resolve_device`` then returns that card.
* **batch formation**: :func:`device_put_global` returns the rank's rows.
  ``replicate``: every rank runs the same deterministic loader, holds the
  full global batch and keeps rows ``[r*B/P, (r+1)*B/P)``.  ``shard``: each
  rank loads its own ``B/P`` rows from a disjoint ``data.loader.
  ShardDataset``; the global batch is the ranks' rows in rank order.
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
  :func:`broadcast_` makes every rank start from rank 0's state.
* **files**: history, ``results.csv``, plots, media and checkpoints are
  written by the primary rank (:func:`is_primary`); a checkpoint save is
  followed by :func:`barrier`, and every rank restores.

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
    return rank() == 0


def is_multihost() -> bool:
    """More than one process: the JAX package's name, kept."""
    return world_size() > 1


def local_device_index() -> int:
    """The card of this rank: ``rank % torch.cuda.device_count()``."""
    return rank() % torch.cuda.device_count()


def maybe_initialize(cfg, device=None, backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Start the process group from ``--dist_coordinator host:port``,
    ``--dist_nprocs`` and ``--dist_procid`` when ``dist_nprocs > 1``.
    Returns whether it started one: it does nothing for one process or
    when a group exists already (a caller that starts the group itself
    pins its card itself).  ``backend`` defaults to ``gloo`` when
    ``device`` is the CPU, else NCCL; on a GPU the rank's card is made
    current before the group allocates anything."""
    if int(cfg.dist_nprocs) <= 1 or active():
        return False
    if not cfg.dist_coordinator:
        raise ValueError("--dist_nprocs > 1 requires --dist_coordinator "
                         "host:port (the address of process 0)")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(int(cfg.dist_procid)
                              % torch.cuda.device_count())
    dist.init_process_group(backend or ("gloo" if cpu else "nccl"),
                            init_method=f"tcp://{cfg.dist_coordinator}",
                            world_size=int(cfg.dist_nprocs),
                            rank=int(cfg.dist_procid), timeout=timeout)
    print(f"[dist] process {rank()}/{world_size()} up: backend "
          f"{dist.get_backend()}")
    return True


def shutdown() -> None:
    """Destroy the process group, if there is one.  Called when a rank
    leaves, on success or on an error: its peers' next collective then
    fails at once instead of waiting out :data:`TIMEOUT`."""
    if active():
        dist.destroy_process_group()


def validate_global_batch(cfg) -> None:
    """Fail fast on a batch the ranks cannot divide (the per-rank batch
    would be floored silently) and on an unknown ``dist_data``.  No-op for
    one process.  Shared by ``main.main`` and ``sop_main.main``."""
    P = world_size()
    if P <= 1:
        return
    if cfg.dist_data not in DIST_DATA:
        raise ValueError(f"--dist_data {cfg.dist_data!r}: one of "
                         f"{DIST_DATA}")
    if cfg.batch_size % P:
        raise ValueError(f"global batch {cfg.batch_size} must divide "
                         f"across {P} devices")


def rank_slice(n_local: int) -> slice:
    """This rank's rows of a global batch of ``n_local * world_size()``."""
    r = rank()
    return slice(r * n_local, (r + 1) * n_local)


def device_put_global(batch: Dict, mode: str = "replicate") -> Dict:
    """The rows of a batch (numpy arrays or tensors) this rank computes: in
    ``replicate`` the rank's block of the global batch every rank holds,
    in ``shard`` the rank's own batch, whole."""
    P = world_size()
    if P == 1 or mode == "shard":
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % P:
            raise ValueError(f"{k}: {v.shape[0]} rows do not divide "
                             f"across {P} ranks")
        out[k] = v[rank_slice(v.shape[0] // P)]
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
        dist.all_reduce(flat)
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
        _flat_apply(group, lambda flat: dist.broadcast(flat, src=0))


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
    dist.all_reduce(buf)
    return buf


class _AllReduceSum(torch.autograd.Function):
    """Sum across the ranks; its backward is the sum of the ranks'
    gradients, which is the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``all_reduce`` (sum) of ``x``."""
    return _AllReduceSum.apply(x)
