"""Ranks of a gloo group on the CPU, for tests/test_torch_parallel*.py.

``python -m tests.torch_dist_worker jobs SPEC RANK WORLD INIT OUT`` joins a
gloo group through the ``file://`` store INIT, runs each job of SPEC (a
``torch.save``d dict written by the test) and saves this rank's results to
OUT.  ``python -m tests.torch_dist_worker cli MODULE CKPT_ROOT ARGV...``
runs ``MODULE.main(parse_args(ARGV), device="cpu")`` (``avsep_tpu_torch.
main`` or ``sop_main``), which joins the group through the real
``--dist_*`` flags, and prints as its last line a JSON object with the
files it opened for writing under CKPT_ROOT and the global indices its
``ShardDataset``s served.  ``python -m tests.torch_dist_worker launch KIND
N_LOCAL OUT WEIGHTS ARGV...`` runs ``parallel.launch.run`` of an entry
below (:func:`run_launch`), whose ranks report to files under OUT.  A
process imports torch and the port only, never JAX, and runs one thread,
so a pair of ranks stays light beside the suite's other workers.
:func:`launch` and :func:`wait_all` are the test side: every wait has a
deadline, and a failure kills every child.

Jobs:

* ``bn``: the global-batch BatchNorm in train mode on this rank's rows of a
  global input, then the backward of ``sum(y * dy)``: ``y``, the input's
  gradient (gathered to the global batch) and the weight and bias
  gradients summed across the ranks, the running statistics.
* ``train``: train steps from the spec's weights (:func:`small_nets`) on
  this rank's rows of each
  global batch (``replicate``); the AO swap from the injected global
  uniforms (this rank's rows) or from a generator seeded alike on every
  rank.  The state after each step and the step's metrics.
"""

import builtins
import contextlib
import copy
import datetime
import functools
import importlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from avsep_tpu_torch import train
from avsep_tpu_torch.parallel import distributed as pdist


def run_bn(job):
    bn = job["bn"]
    x = job["x"][pdist.rank_slice(job["x"].shape[0] // pdist.world_size())]
    dy = job["dy"][pdist.rank_slice(x.shape[0])]
    x = x.clone().requires_grad_(True)
    bn.train()
    y = bn(x)
    (y * dy).sum().backward()
    grads = [bn.weight.grad.clone(), bn.bias.grad.clone()]
    for g in grads:
        dist.all_reduce(g)
    return {"y": pdist.fetch(y.detach()), "dx": pdist.fetch(x.grad),
            "dweight": grads[0], "dbias": grads[1],
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone()}


def small_nets(cfg):
    """The port nets of tests/test_torch_forward.py's ``make_nets``: unet5
    at ngf 8 and the tiny conv encoder at 32 channels."""
    from avsep_tpu_torch.engine import Nets
    from avsep_tpu_torch.models.resnet import TinyConvEncoder
    from avsep_tpu_torch.models.unet import AudioUnet
    return Nets(AudioUnet(fc_dim=2, num_downs=5, ngf=8,
                          fusion_type=cfg.fusion_type, att_type=cfg.att_type),
                TinyConvEncoder(32, "maxpool"))


def run_train(job):
    cfg = job["cfg"]
    nets = small_nets(cfg)
    for name, sd in job["weights"].items():
        getattr(nets, name).load_state_dict(sd, strict=True)
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    pdist.broadcast_state(state)
    steps = {v: train.make_train_step(cfg, nets, v, device="cpu")
             for v in (True, False)}
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    out = []
    for use_vis, batch, u in zip(job["seq"], job["batches"],
                                 job["uniforms"]):
        rows = pdist.device_put_global(batch, "replicate")
        n = len(batch["audios"]) // pdist.world_size()
        kw = {"generator": gen} if u is None else \
            {"swap_uniforms": u[pdist.rank_slice(n)]}
        state, m = steps[use_vis](state, rows, **kw)
        out.append({"metrics": {k: v.clone() for k, v in m.items()},
                    "state": copy.deepcopy(state.state_dict())})
    return out


def run_jobs(spec_path, rank, world, init, out_path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=int(rank), world_size=int(world),
                            timeout=datetime.timedelta(seconds=300))
    try:
        spec = torch.load(spec_path, weights_only=False)
        results = {name: {"bn": run_bn, "train": run_train}[job["kind"]](job)
                   for name, job in spec.items()}
        # a group that exists is left alone: no coordinator is asked for
        from avsep_tpu_torch.config import Config
        results["maybe_initialize"] = pdist.maybe_initialize(
            Config(dist_nprocs=2), device="cpu")
        torch.save(results, out_path)
    finally:
        pdist.shutdown()


@contextlib.contextmanager
def traced(ckpt_root):
    """Records the files opened for writing under ``ckpt_root`` and the
    global indices each ``ShardDataset`` serves (tagged in the order they
    were built) while the block runs; yields ``(writes, served)``."""
    from avsep_tpu_torch.data import loader

    root = os.path.realpath(ckpt_root)
    writes, served = [], {}
    real_open = builtins.open

    def record(file):
        if isinstance(file, (str, os.PathLike)):
            path = os.path.realpath(file)
            if path.startswith(root):
                writes.append(path)

    def traced_open(file, mode="r", *a, **kw):
        if set(mode) & set("wax+"):
            record(file)
        return real_open(file, mode, *a, **kw)

    def traced_save(obj, f, *a, **kw):
        record(f)           # torch.save writes a path from C++, not open()
        return real_save(obj, f, *a, **kw)

    real_init, real_getitem = (loader.ShardDataset.__init__,
                               loader.ShardDataset.__getitem__)

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        self.tag = len(served)
        served[self.tag] = []

    def getitem(self, i):
        served[self.tag].append(self.index + i * self.count)
        return real_getitem(self, i)

    real_save = torch.save
    builtins.open, torch.save = traced_open, traced_save
    loader.ShardDataset.__init__ = init
    loader.ShardDataset.__getitem__ = getitem
    try:
        yield writes, served
    finally:
        builtins.open, torch.save = real_open, real_save
        loader.ShardDataset.__init__ = real_init
        loader.ShardDataset.__getitem__ = real_getitem


def _report(writes, served, **extra):
    return {"writes": sorted(set(writes)),
            "served": {str(k): sorted(v) for k, v in served.items()},
            **extra}


def run_cli(module, ckpt_root, *argv):
    from avsep_tpu_torch.config import parse_args

    torch.set_num_threads(1)
    with traced(ckpt_root) as (writes, served):
        importlib.import_module(module).main(parse_args(list(argv)),
                                             device="cpu")
    print(json.dumps(_report(writes, served)), flush=True)


# ------------------------------------------- entries for parallel.launch


def _rank_file(out_dir):
    return os.path.join(out_dir, f"rank{pdist.rank()}.json")


def traced_entry(module, out_dir, weights, cfg, device):
    """One rank of ``launch.run``: ``MODULE.main(cfg, device)``, traced as
    ``run_cli`` traces it, from the JAX package's initial weights when
    ``weights`` names a ``torch.save``d ``(params, batch_stats)`` pair of
    numpy trees; the report goes to OUT_DIR/rank{r}.json."""
    torch.set_num_threads(1)
    if weights != "-":
        from avsep_tpu_torch.models.from_jax import load_from_jax
        params, stats = torch.load(weights, weights_only=False)
        init_state = train.init_state

        def from_jax(*a, **kw):
            state = init_state(*a, **kw)
            load_from_jax(state.nets, params, stats)
            return state
        train.init_state = from_jax
    with traced(cfg.ckpt) as (writes, served):
        importlib.import_module(module).main(cfg, device)
    with open(_rank_file(out_dir), "w") as f:
        json.dump(_report(writes, served, rank=pdist.rank(),
                          world=pdist.world_size(),
                          process=pdist.process_index(cfg),
                          pid=os.getpid(),
                          tf32=[torch.backends.cudnn.allow_tf32,
                                torch.backends.cuda.matmul.allow_tf32]), f)


class IndexClips:
    """A dataset of ``n`` items whose ``audios`` hold their index, in
    place of ``MusicMixDataset(path, cfg, split, seed)``: the rows a batch
    carries, with no audio read and no model."""
    frame_route = "none"

    def __init__(self, path, cfg, split="train", seed=None, n=24):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"audios": np.full((2, 4), i, np.float32), "id": f"c{i}"}


def rows_entry(out_dir, n_batches, cfg, device):
    """One rank of ``launch.run``: the row indices its first ``n_batches``
    AV train batches give it, through ``main.build_loaders`` and
    ``engine.to_device`` over :class:`IndexClips`; to OUT_DIR/rank{r}.json."""
    from avsep_tpu_torch import engine
    from avsep_tpu_torch import main as cli_main

    cli_main.MusicMixDataset = IndexClips
    pdist.validate_global_batch(cfg)
    av, ao, val = cli_main.build_loaders(
        cfg, process_index=pdist.process_index(cfg),
        process_count=pdist.process_count(cfg))
    rows = []
    try:
        it = iter(av)
        for _ in range(int(n_batches)):
            b = engine.to_device(next(it), torch.device("cpu"), cfg=cfg)
            rows.append(b["audios"][:, 0, 0].long().tolist())
    finally:
        for ld in (av, ao, val):
            ld.close()
    with open(_rank_file(out_dir), "w") as f:
        json.dump({"rank": pdist.rank(), "process": pdist.process_index(cfg),
                   "rows": rows}, f)


def pid_entry(out_dir, failing_rank, cfg, device):
    """One rank of ``launch.run`` that writes its pid to OUT_DIR/rank{r}.pid
    and waits for the others to have written theirs, then raises if it is
    ``failing_rank`` and otherwise sleeps for five minutes: only the
    launcher can end it sooner."""
    path = os.path.join(out_dir, f"rank{pdist.rank()}.pid")
    with open(path + ".tmp", "w") as f:
        f.write(str(os.getpid()))
    os.replace(path + ".tmp", path)
    pdist.barrier()
    if pdist.rank() == int(failing_rank):
        raise RuntimeError(f"rank {failing_rank} fails on purpose")
    time.sleep(300)


def run_launch(kind, n_local, out_dir, weights, *argv):
    """``launch.run`` of the entry KIND (``main`` or ``sop_main``:
    :func:`traced_entry`; ``rows``: :func:`rows_entry` over 3 batches;
    ``raise``: :func:`pid_entry` with rank 1 failing; ``sleep``: with none)
    on ``parse_args(ARGV)``, on the CPU, as if the process had N_LOCAL
    cards, with TF32 off first as the command lines' ``__main__`` blocks
    turn it off."""
    from avsep_tpu_torch.config import parse_args
    from avsep_tpu_torch.engine import full_float32
    from avsep_tpu_torch.parallel import launch

    torch.set_num_threads(1)
    full_float32()
    if kind in ("main", "sop_main"):
        module = importlib.import_module(f"avsep_tpu_torch.{kind}")
        # the wrapper names the entry it wraps: launch reads the width rule
        # from the entry's module
        entry = functools.update_wrapper(functools.partial(
            traced_entry, module.__name__, out_dir, weights), module.main)
    elif kind == "rows":
        entry = functools.partial(rows_entry, out_dir, 3)
    else:
        entry = functools.partial(pid_entry, out_dir,
                                  1 if kind == "raise" else -1)
    launch.run(entry, parse_args(list(argv)), device="cpu",
               n_local=int(n_local))


# ------------------------------------------------------------ test side


def launch(args, n, env_extra=None):
    """``n`` processes of ``python -m tests.torch_dist_worker`` with
    ``args(i)`` for process ``i``, from the repository's root, one thread
    each."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **(env_extra or {}))
    return [subprocess.Popen(
        [sys.executable, "-u", "-m", "tests.torch_dist_worker",
         *map(str, args(i))], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(n)]


def wait_all(procs, timeout):
    """The outputs of ``procs``, which must all exit 0 within ``timeout``
    seconds in all; on a timeout or a failure every child still running is
    killed and the test fails with the children's output."""
    deadline = time.monotonic() + timeout
    outs = [None] * len(procs)
    late = False
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0]
    except subprocess.TimeoutExpired:
        late = True
    finally:
        for i, p in enumerate(procs):
            if outs[i] is None:
                p.kill()
                outs[i] = p.communicate()[0]
    if late or any(p.returncode != 0 for p in procs):
        raise AssertionError(
            f"{'timed out after ' + str(timeout) + ' s; ' if late else ''}"
            f"exit codes {[p.returncode for p in procs]}:\n"
            + "\n".join(f"--- process {i}:\n{o[-3000:]}"
                        for i, o in enumerate(outs)))
    return outs


if __name__ == "__main__":
    {"jobs": run_jobs, "cli": run_cli,
     "launch": run_launch}[sys.argv[1]](*sys.argv[2:])
