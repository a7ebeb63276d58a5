"""One cap on torch's CPU threads for the port's tests under pytest-xdist.

The tier-1 run puts six pytest workers on the machine's cores, and torch's
default of one intra-op thread per core then makes the workers' small steps
wait on each other: on an 8-core CPU one graph test took 423 s in the suite
and 8 s alone at one thread.  Imported in an xdist worker
(``PYTEST_XDIST_WORKER_COUNT`` set), this module gives torch the worker's
share of the cores this process may run on, at least one, and sets
``OMP_NUM_THREADS`` to the same share, unless it is set, for the processes
the tests start.  Outside xdist it does nothing, so a file run alone keeps
every core.  Every port test module imports it: a worker collects every
module, so the cap holds in each worker from collection on.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    THREADS = max(1, len(os.sched_getaffinity(0)) // int(_WORKERS))
    torch.set_num_threads(THREADS)
    os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
