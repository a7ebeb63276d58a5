"""One command over the cards it names: the JAX package's width rules, one
rank launched per local card.

A JAX process drives every device of its mesh from one program: the width
is ``min(num_gpus, local devices)`` for ``main`` (``avsep_tpu/main.py:
128-140``), every local device for ``sop_main`` (``avsep_tpu/sop_main.py:
174``), ``--mesh_shape W`` where given (``avsep_tpu/parallel/mesh.py:
31-52``), and every device of every process under ``--dist_nprocs P > 1``.
``torch.distributed`` runs one rank per card, so a port process that spans
L cards starts L ranks, as ``torchrun`` would: :func:`run` picks L by
:func:`local_width` and

* for L = 1 calls ``entry(cfg, device)`` in this process (with ``--dist_*``
  that process is one rank of P, ``distributed.maybe_initialize``);
* for L > 1 starts L children (the ``spawn`` start method: CUDA cannot be
  forked, and this process never initializes it).  Child ``l`` of process
  ``procid`` is rank ``procid * L + l`` of ``P * L``: it pins ``cuda:l``
  before it allocates anything, joins the group (NCCL on distinct cards,
  or the caller's ``backend``) through a loopback port this process picked
  or, under ``--dist_*``, the ``--dist_coordinator`` store of process 0,
  takes this process's TF32 flags, runs ``entry(cfg, device)`` and leaves
  the group.

A child that exits non-zero ends the launch: the others get SIGTERM, then
SIGKILL after :data:`STOP_GRACE_S` seconds, and this process exits with
the failed child's code.  SIGINT or SIGTERM to this process ends every
child the same way, and a child dies with this process (Linux's parent
death signal), so none outlives it.  ``entry`` and ``cfg`` must pickle:
a module-level function of an importable module (or of the main script,
which ``spawn`` re-imports in each child).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import socket
import sys
import threading
import time
from multiprocessing.connection import wait
from typing import Callable, Optional, Tuple

import torch

from avsep_tpu_torch.parallel import distributed as pdist

# seconds the other ranks get to exit on SIGTERM after one failed, before
# SIGKILL: the launch ends within this (and a join) of the first failure
STOP_GRACE_S = 10.0
PR_SET_PDEATHSIG = 1                    # <linux/prctl.h>


def entry_name(entry) -> str:
    """``main`` or ``sop_main``: the command line ``entry`` (a name or a
    function) belongs to; a ``python -m`` run's ``__main__`` is named by
    its module spec."""
    if isinstance(entry, str):
        return entry
    module = getattr(entry, "__module__", "") or ""
    if module == "__main__":
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        module = spec.name if spec is not None else module
    return module.rsplit(".", 1)[-1]


def local_width(cfg, entry, n_local: int) -> Tuple[int, str]:
    """``(L, rule)``: the cards this process spans, by the JAX package's
    rules, with ``n_local`` cards in the process, and the rule that set
    it.  The ``--mesh_shape`` errors are the JAX package's, "available
    devices" being those of all ``--dist_nprocs`` processes."""
    procs = pdist.process_count(cfg)
    avail = procs * n_local
    if cfg.mesh_shape:
        if len(cfg.mesh_shape) != 1:
            raise ValueError(
                "only 1-axis (data-parallel) meshes are supported; got "
                f"mesh_shape={tuple(cfg.mesh_shape)}")
        w = int(cfg.mesh_shape[0])
        if w > avail:
            raise ValueError(f"mesh_shape={w} exceeds the {avail} "
                             "available devices")
        if procs > 1 and w != avail:
            raise ValueError("multi-host jobs must span every device "
                             f"(mesh_shape={w}, devices={avail}): all "
                             "processes participate in every SPMD program")
        return w // procs, f"--mesh_shape {w}"
    if procs > 1:
        return n_local, (f"--dist_nprocs {procs}: every local card of "
                         "each process")
    if entry_name(entry) == "sop_main":
        return max(1, n_local), "sop_main: every local card"
    return max(1, min(int(cfg.num_gpus), n_local)), (
        f"main: min(--num_gpus {cfg.num_gpus}, {n_local} local cards)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with(parent: int) -> None:
    """Have the kernel kill this process when ``parent`` dies (Linux)."""
    if sys.platform.startswith("linux"):
        import ctypes
        ctypes.CDLL(None).prctl(PR_SET_PDEATHSIG, int(signal.SIGKILL))
    if os.getppid() != parent:          # it died before the prctl
        os._exit(1)


def _tf32() -> Tuple[bool, bool]:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _rank_main(entry, cfg, device, local: int, width: int, init: str,
               backend: Optional[str], parent: int,
               tf32: Tuple[bool, bool]) -> None:
    """Child ``local`` of ``width``: join the group as rank ``procid *
    width + local``, run ``entry`` with the launching process's TF32 flags
    (a command line turns them off before it launches), leave the group
    (also on an error, so the peers' next collective fails at once)."""
    _die_with(parent)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    procs = pdist.process_count(cfg)
    procid = int(cfg.dist_procid) if procs > 1 else 0
    pdist.join(init, procid * width + local, procs * width, card=local,
               device=device, backend=backend)
    try:
        entry(cfg, device)
    finally:
        pdist.shutdown()


class _Signalled(Exception):
    def __init__(self, signum: int):
        super().__init__(signum)
        self.signum = signum


def _raise_signalled(signum, _frame):
    raise _Signalled(signum)


def _first_failure(children) -> int:
    """Wait until every child exited 0 (returns 0) or one failed (returns
    its code as a shell reports it: 128 + N for signal N)."""
    pending = list(children)
    while pending:
        ready = wait([p.sentinel for p in pending])
        for p in [p for p in pending if p.sentinel in ready]:
            p.join()
            pending.remove(p)
            if p.exitcode:
                return p.exitcode if p.exitcode > 0 else 128 - p.exitcode
    return 0


def _stop(children, grace: float = STOP_GRACE_S) -> None:
    """SIGTERM every child still running, SIGKILL what is left after
    ``grace`` seconds, and reap them all."""
    for p in children:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + grace
    for p in children:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in children:
        if p.is_alive():
            p.kill()
        p.join()


def _cards(cpu: bool, width: int):
    if cpu:
        return ["cpu"] * width
    n = torch.cuda.device_count()   # no CUDA context: the parent stays clean
    return [f"cuda:{l % n}" if n else "cuda" for l in range(width)]


def run(entry: Callable, cfg, *, device=None, n_local: Optional[int] = None,
        backend: Optional[str] = None) -> None:
    """Run ``entry(cfg, device)`` (``main.main`` or ``sop_main.main``) over
    the cards :func:`local_width` gives this process; ``n_local`` defaults
    to the cards there are (1 on the CPU), ``backend`` to NCCL on cards
    and gloo on the CPU.  Exits with a failed rank's code."""
    cpu = device is not None and torch.device(device).type == "cpu"
    if n_local is None:
        n_local = 1 if cpu else max(1, torch.cuda.device_count())
    width, rule = local_width(cfg, entry, n_local)
    procs = pdist.process_count(cfg)
    procid = int(cfg.dist_procid) if procs > 1 else 0
    if procs == 1 and not cfg.mesh_shape and \
            entry_name(entry) != "sop_main" and cfg.num_gpus > width:
        rule += (f"; fewer cards than --num_gpus {cfg.num_gpus}, so its "
                 f"global batch of {cfg.batch_size} rows runs on {width} "
                 f"card{'s' * (width > 1)}")
    head = f"[launch] width {procs * width} ({rule})"
    if width == 1:
        who = f"rank {procid} of {procs}" if procs > 1 else "rank 0"
        group = "its group from --dist_*" if procs > 1 else "no group"
        print(f"{head}: {who} on {'cpu' if cpu else 'cuda'} in this "
              f"process, {group}", flush=True)
        entry(cfg, device)
        return

    backend = backend or ("gloo" if cpu else "nccl")
    cards = _cards(cpu, width)
    if backend == "nccl" and len(set(cards)) < width:
        raise ValueError(f"{width} ranks on {len(set(cards))} card(s): NCCL "
                         "needs a card per rank (a caller may force gloo)")
    if procs > 1:
        if not cfg.dist_coordinator:
            raise ValueError("--dist_nprocs > 1 requires --dist_coordinator "
                             "host:port (the address of process 0)")
        init = f"tcp://{cfg.dist_coordinator}"
    else:
        init = f"tcp://127.0.0.1:{_free_port()}"
    ranks = ", ".join(f"rank {procid * width + l} on {cards[l]}"
                      for l in range(width))
    print(f"{head}: {ranks} (process {procid} of {procs}); backend "
          f"{backend}; rendezvous {init}", flush=True)

    ctx = mp.get_context("spawn")
    children = [ctx.Process(
        target=_rank_main, name=f"rank{procid * width + l}",
        args=(entry, cfg, device, l, width, init, backend, os.getpid(),
              _tf32()))
        for l in range(width)]
    main_thread = threading.current_thread() is threading.main_thread()
    handlers = {}
    if main_thread:
        for s in (signal.SIGINT, signal.SIGTERM):
            handlers[s] = signal.signal(s, _raise_signalled)
    why = "a rank failed"
    try:
        for p in children:
            p.start()
        code = _first_failure(children)
    except _Signalled as e:
        code, why = 128 + e.signum, f"signal {e.signum}"
    finally:
        _stop(children)
        for s, h in handlers.items():
            signal.signal(s, h)
    if code:
        print(f"[launch] {why}: every rank stopped, exit {code}",
              file=sys.stderr, flush=True)
        raise SystemExit(code)
