"""One command over the cards it names (``parallel/launch.py``), on the CPU.

* **Widths**: ``launch.local_width`` against the JAX package's mesh width
  for ``main`` and ``sop_main``, ``--num_gpus`` 1, 2, 4, ``--mesh_shape``
  unset, equal to the devices, larger, 1 and two axes, ``--dist_nprocs`` 1
  and 2, 1, 2 or 4 devices per process; the JAX side runs
  ``avsep_tpu/main.py:128-140``'s and ``sop_main.py:174``'s
  ``mesh_from_config`` calls in subprocesses with that many virtual CPU
  devices (two processes joined by ``jax.distributed`` for
  ``--dist_nprocs 2``), and the ``ValueError`` texts must be JAX's.
* **Two launched ranks through ``main.main``** (``launch.run`` with
  ``n_local=2``, gloo) at toy size (tests/test_torch_parallel_cli.py's
  flags, a global batch of 2 x 2, iterations 1 to 3 and an eval at 3, soft
  masks, every step AV) from the JAX package's initial weights: against
  one port process on the global batch, the loss history at 1e-4 and the
  eval loss and meters at 1e-5 (test_torch_parallel_cli.py's tolerances;
  read: 3.5e-6, 5.2e-8 and 3.6e-6); against ``avsep_tpu.main`` in one
  process on a 2-device CPU mesh, the AV loss history at 1e-4 and the
  eval loss and meters at 1e-5 (read: 5.1e-6, 5.7e-7 and 7.5e-6).  A dB
  meter is held relative to the larger of itself and 1 dB: these toy
  meters lie near 0 dB (an SDR of 0.108 dB), where a relative error has no
  meaning.  The ``train`` series adds ``match_weight`` times the match
  loss, which reads 2.5e-4 apart between the two packages' float32
  backends after two updates (0.7 % of the match term; ROADMAP's known
  divergences): it is held against the port's one process only.  Only
  rank 0 writes, and the ranks run with the launcher's TF32 flags (off).
  Two processes of one rank each (``--dist_nprocs 2``, each launched with
  one card) run the one-process-per-card path and match too.
* **Shard rows**: ``--dist_data shard`` over 2 processes of 2 ranks each:
  the row indices each rank's first three AV batches give it, through
  ``main.build_loaders`` and ``engine.to_device``, against the rows that
  the JAX package's device ``(process, id)`` holds after its
  ``build_loaders`` and ``to_device``, over a dataset whose items carry
  their index (no model).
* **The clamp**: one device and ``--num_gpus 2``: the entry runs in this
  process, no child is started, and the launch line says so.
* **Failure**: a rank that raises ends the launch with its exit code
  within the stop deadline, and no rank is left; SIGTERM or SIGKILL to the
  launcher ends every rank.
* **SoP++**: ``sop_main`` over two launched ranks against one process.

Every subprocess has a deadline (``wait_all``) and a failure kills them
all; the runs of the module-scoped fixture start at once.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import parse_args as jparse_args
from avsep_tpu.engine import build_nets as jbuild_nets
from avsep_tpu.train import init_state as jinit_state
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.parallel import launch
from tests.test_torch_parallel_cli import (
    METER_RTOL, SOP, TOY, _free_port, assert_histories_match, history)
from tests.torch_dist_worker import launch as start
from tests.torch_dist_worker import wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
LOSS_RTOL = 1e-4
# the launch's flags: a global batch of 2 x 2, every step AV (no AO swap,
# whose draws are JAX's PRNG in one package and torch's in the other),
# soft masks (no all-zero prediction, so no noise floor is drawn)
LAUNCH = TOY + ["--num_gpus", "2", "--batch_size_per_gpu", "2",
                "--num_iters", "4", "--num_fsteps", "100",
                "--binary_mask", "0", "--loss", "l1", "--weighted_loss",
                "0"]
# the shard-rows job: 24 index items, 2 processes of 2 devices, B = 8
ROWS = ["--num_gpus", "4", "--batch_size_per_gpu", "2", "--workers", "0",
        "--dist_data", "shard", "--dist_nprocs", "2", "--seed", "3",
        "--av_list_train", "x", "--ao_list_train", "x", "--list_val", "x"]

_JAX_MAIN = r"""
import sys
repo, *argv = sys.argv[1:]
sys.path.insert(0, repo)
import jax
jax.config.update("jax_platforms", "cpu")
from avsep_tpu.config import parse_args
from avsep_tpu.main import main
main(parse_args(argv))
"""

# avsep_tpu/main.py:128-140 (main) and sop_main.py:174 (sop_main) in the
# width they give mesh_from_config, for each case of a JSON list
_JAX_WIDTHS = r"""
import json, sys
repo, procs, pid, port, cases = sys.argv[1:]
procs, pid = int(procs), int(pid)
sys.path.insert(0, repo)
import jax
jax.config.update("jax_platforms", "cpu")
if procs > 1:
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=procs, process_id=pid)
from avsep_tpu.config import Config
from avsep_tpu.parallel.mesh import mesh_from_config
out = []
for entry, num_gpus, shape in json.loads(cases):
    cfg = Config(num_gpus=num_gpus, mesh_shape=tuple(shape))
    if entry == "sop_main":
        n = None
    elif jax.process_count() > 1:
        n = len(jax.devices())
    else:
        n = max(1, min(cfg.num_gpus, len(jax.devices())))
    try:
        out.append(["width", int(mesh_from_config(cfg, n).devices.size)])
    except ValueError as e:
        out.append(["error", str(e)])
print(json.dumps(out))
"""

# the rows JAX's devices hold: avsep_tpu.main.build_loaders and to_device
# over IndexClips, two processes of two virtual devices
_JAX_ROWS = r"""
import json, sys
repo, pid, port, *argv = sys.argv[1:]
sys.path.insert(0, repo)
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=int(pid))
import numpy as np
from avsep_tpu import main as jmain
from avsep_tpu.config import parse_args
from avsep_tpu.parallel.mesh import make_mesh
from tests.torch_dist_worker import IndexClips
jmain.MusicMixDataset = IndexClips
cfg = parse_args(argv)
av, ao, val = jmain.build_loaders(cfg)
mesh = make_mesh()
it = iter(av)
rows = {}
for _ in range(3):
    b = jmain.to_device(next(it), mesh, cfg=cfg)
    for s in b["audios"].addressable_shards:
        d = s.device
        rows.setdefault(f"{d.process_index},{d.id}", []).append(
            np.asarray(s.data)[:, 0, 0].astype(int).tolist())
print(json.dumps(rows))
"""


def width_cases(procs, n_local):
    avail = procs * n_local
    shapes = [[], [avail], [avail + 1], [1], [2, 2]]
    return [[e, g, s] for e in ("main", "sop_main") for g in (1, 2, 4)
            for s in shapes]


def _jax_env(n_devices):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{n_devices}")
    return env


def _jax(script, args, n_devices):
    return subprocess.Popen(
        [sys.executable, "-c", script, REPO, *map(str, args)], cwd=REPO,
        env=_jax_env(n_devices), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def _read(out_dir, n):
    ranks = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return ranks


GROUPS = [(p, n) for p in (1, 2) for n in (1, 2, 4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module's comparisons, started at once: the
    JAX widths, the launched and the one-process main runs with JAX's
    initial weights, JAX's main on a 2-device mesh, two one-rank processes,
    the shard rows of both packages, SoP++ launched and alone."""
    d = tmp_path_factory.mktemp("launch")
    cfg = jparse_args(LAUNCH)
    rng = jax.random.split(jax.random.PRNGKey(cfg.seed))[1]
    jstate = jinit_state(cfg, jbuild_nets(cfg), rng)
    weights = d / "jax_init.pt"
    torch.save(jax.device_get((jstate.params, jstate.batch_stats)),
               weights)

    procs, names = [], []

    def add(name, ps):
        procs.extend(ps)
        names.extend([name] * len(ps))

    for p, n in GROUPS:
        port = _free_port()
        cases = json.dumps(width_cases(p, n))
        add(("widths", p, n), [_jax(_JAX_WIDTHS, [p, pid, port, cases], n)
                               for pid in range(p)])

    def port_launch(kind, n_local, name, weights, argv):
        out = d / name
        out.mkdir()
        return start(lambda i: ["launch", kind, n_local, out, weights,
                                *argv, "--ckpt", out / "ckpt"], 1)

    add("launch", port_launch("main", 2, "launch", weights, LAUNCH))
    add("one", port_launch("main", 1, "one", weights, LAUNCH))
    add("jax", [_jax(_JAX_MAIN, LAUNCH + ["--ckpt", d / "jax"], 2)])
    coord = ["--dist_coordinator", f"127.0.0.1:{_free_port()}",
             "--dist_nprocs", "2"]
    for pid in (0, 1):
        add("pair", port_launch("main", 1, f"pair{pid}", weights, LAUNCH +
                                coord + ["--dist_procid", str(pid)]))
    rows_port = [_free_port(), _free_port()]
    for pid in (0, 1):
        add("rows", port_launch("rows", 2, f"rows{pid}", "-", ROWS + [
            "--dist_coordinator", f"127.0.0.1:{rows_port[0]}",
            "--dist_procid", str(pid)]))
    add("jax_rows", [_jax(_JAX_ROWS, [pid, rows_port[1], *ROWS], 2)
                     for pid in (0, 1)])
    sop = SOP + ["--num_gpus", "2", "--batch_size_per_gpu", "2"]
    add("sop_launch", port_launch("sop_main", 2, "sop_launch", "-",
                                  TOY + sop))
    add("sop_one", port_launch("sop_main", 1, "sop_one", "-", TOY + sop))

    outs = wait_all(procs, TIMEOUT)
    res = {}
    for name, out in zip(names, outs):
        res.setdefault(name, []).append(out)
    return d, res


def _port_width(procs, n_local, case):
    entry, num_gpus, shape = case
    cfg = Config(num_gpus=num_gpus, mesh_shape=tuple(shape),
                 dist_nprocs=procs)
    try:
        width, rule = launch.local_width(cfg, entry, n_local)
    except ValueError as e:
        return ["error", str(e)]
    assert rule
    return ["width", procs * width]


@pytest.mark.parametrize("procs,n_local", GROUPS)
def test_width_rules_match_jax(runs, procs, n_local):
    """Every case's width, or its error text, as the JAX package's."""
    _, res = runs
    want = _last_json(res[("widths", procs, n_local)][0])
    cases = width_cases(procs, n_local)
    got = [_port_width(procs, n_local, c) for c in cases]
    for case, g, w in zip(cases, got, want):
        assert g == w, (case, g, w)
    kinds = {g[0] for g in got}
    assert kinds == {"width", "error"}


def test_width_rule_examples():
    """The rules by name: the clamp, sop_main's every card, a launch's
    ``--mesh_shape``, every card under ``--dist_nprocs``."""
    w = launch.local_width
    assert w(Config(num_gpus=2), "main", 1) == (
        1, "main: min(--num_gpus 2, 1 local cards)")
    assert w(Config(num_gpus=2), "main", 4)[0] == 2
    assert w(Config(num_gpus=1), "sop_main", 4)[0] == 4
    assert w(Config(mesh_shape=(3,)), "main", 4) == (3, "--mesh_shape 3")
    assert w(Config(num_gpus=1, dist_nprocs=2), "main", 4)[0] == 4
    with pytest.raises(ValueError, match=re.escape(
            "mesh_shape=9 exceeds the 8 available devices")):
        w(Config(mesh_shape=(9,), dist_nprocs=2), "main", 4)
    # a launch entry is named by its module, a wrapper by what it wraps
    from avsep_tpu_torch import main, sop_main
    assert launch.entry_name(main.main) == "main"
    assert launch.entry_name(sop_main.main) == "sop_main"


DB_METERS = ("sdr", "sir", "sar", "si_sdr")


def readings(got, want, series):
    """The largest differences of two histories: ``series``' losses
    (relative), the eval losses (relative) and the dB meters (relative to
    the larger of the meter and 1 dB: a meter near 0 dB has no relative
    precision)."""
    out = {"history": 0.0, "val_err": 0.0, "meters": 0.0}
    for key in series:
        assert got[key]["iter"] == want[key]["iter"], key
        out["history"] = max(out["history"], *(
            abs(g - w) / abs(w) for g, w in zip(got[key]["err"],
                                                want[key]["err"])))
    for branch in ("val_av", "val_ao"):
        assert got[branch]["iter"] == want[branch]["iter"] == [3]
        g, w = got[branch]["err"][0], want[branch]["err"][0]
        out["val_err"] = max(out["val_err"], abs(g - w) / abs(w))
        for k in DB_METERS:
            g, w = got[branch][k][0], want[branch][k][0]
            out["meters"] = max(out["meters"],
                                abs(g - w) / max(abs(w), 1.0))
    assert got["val_av"]["perm_acc"] == want["val_av"]["perm_acc"]
    return out


def assert_match(got, want, series=("train", "train_av")):
    r = readings(got, want, series)
    assert r["history"] <= LOSS_RTOL, r
    assert r["val_err"] <= METER_RTOL and r["meters"] <= METER_RTOL, r


def _launched(res, name, width):
    out = res[name][0]
    line = [ln for ln in out.splitlines() if ln.startswith("[launch]")]
    assert len(line) == 1, out[-2000:]
    assert line[0].startswith(f"[launch] width {width} "), line
    return line[0]


def test_two_ranks_match_one_process(runs):
    d, res = runs
    line = _launched(res, "launch", 2)
    assert "rank 0 on cpu, rank 1 on cpu" in line and "backend gloo" in line
    got, want = history(d / "launch" / "ckpt"), history(d / "one" / "ckpt")
    assert got["train"]["iter"] == [1, 2, 3]
    assert got["train_av"]["iter"] == [1, 2, 3]      # every step AV
    assert_match(got, want)
    r0, r1 = _read(d / "launch", 2)
    assert (r0["rank"], r0["world"], r1["rank"], r1["world"]) == (0, 2, 1, 2)
    assert r0["pid"] != r1["pid"]
    assert r1["writes"] == [] and r0["writes"]
    # the launcher turned TF32 off; its ranks run with its flags
    assert r0["tf32"] == r1["tf32"] == [False, False]


def test_two_ranks_match_jax_on_a_two_device_mesh(runs):
    d, res = runs
    assert "Training Done!" in res["jax"][0]
    got, want = history(d / "launch" / "ckpt"), history(d / "jax")
    assert got["train_av"]["iter"] == want["train_av"]["iter"] == [1, 2, 3]
    assert_match(got, want, series=("train_av",))


def test_one_card_ranks_run_the_per_process_path(runs):
    """``--dist_nprocs 2`` with one card per process: each launch runs
    its rank in the process (one process per card) and the pair matches one
    process."""
    d, res = runs
    for out in res["pair"]:
        line = [ln for ln in out.splitlines() if ln.startswith("[launch]")]
        assert len(line) == 1 and "in this process" in line[0], line
        assert line[0].startswith("[launch] width 2 "), line
    assert_match(history(d / "pair0" / "ckpt"), history(d / "one" / "ckpt"))
    assert not os.path.exists(d / "pair1" / "ckpt" / "toy" /
                              "history_latest.json")


def test_shard_rows_match_jax_devices(runs):
    """Rank ``procid * 2 + l`` holds the rows of JAX's device ``l`` of
    process ``procid``, batch by batch."""
    d, res = runs
    jrows = {}
    for out in res["jax_rows"]:
        jrows.update(_last_json(out))
    for pid, out in enumerate(res["rows"]):
        assert f"[launch] width 4 (--dist_nprocs 2: every local card of " \
            f"each process): rank {2 * pid} on cpu, rank {2 * pid + 1} on " \
            f"cpu (process {pid} of 2); backend gloo" in out
        devs = sorted((k for k in jrows if k.startswith(f"{pid},")),
                      key=lambda k: int(k.split(",")[1]))
        assert len(devs) == 2
        for l, dev in enumerate(devs):
            rank = pid * 2 + l
            with open(d / f"rows{pid}" / f"rank{rank}.json") as f:
                got = json.load(f)
            assert got["process"] == pid
            assert got["rows"] == jrows[dev], (rank, dev)
    every = [r for k in jrows for b in jrows[k] for r in b]
    assert len(every) == 3 * 8
    for b in range(3):      # a global batch never holds a row twice
        rows = [r for k in jrows for r in jrows[k][b]]
        assert len(set(rows)) == 8


def test_sop_main_two_ranks_match_one_process(runs):
    d, res = runs
    _launched(res, "sop_launch", 2)
    assert "in this process" in _launched(res, "sop_one", 1)
    got = history(d / "sop_launch" / "ckpt")
    want = history(d / "sop_one" / "ckpt")
    assert got["train"]["iter"] == [1, 2, 3]
    assert_histories_match(got, want)
    r0, r1 = _read(d / "sop_launch", 2)
    assert r1["writes"] == [] and r0["writes"]


def test_the_clamp_starts_no_child(monkeypatch, capsys):
    """One device and ``--num_gpus 2``: width 1, the entry called here,
    the launch line says so; ``sop_main`` with one device alike."""
    def no_spawn(*a, **kw):
        raise AssertionError("a child was started")
    monkeypatch.setattr(launch.mp, "get_context", no_spawn)
    seen = []
    cfg = Config(num_gpus=2, batch_size_per_gpu=3)
    launch.run(lambda c, dev: seen.append((os.getpid(), c, dev)), cfg,
               device="cpu", n_local=1)
    assert seen == [(os.getpid(), cfg, "cpu")]
    line = capsys.readouterr().out.strip()
    assert line == ("[launch] width 1 (main: min(--num_gpus 2, 1 local "
                    "cards); fewer cards than --num_gpus 2, so its global "
                    "batch of 6 rows runs on 1 card): rank 0 on cpu in "
                    "this process, no group")

    def sop(c, dev):
        seen.append(dev)
    sop.__module__ = "avsep_tpu_torch.sop_main"
    launch.run(sop, Config(num_gpus=4), device="cpu", n_local=1)
    assert seen[-1] == "cpu"
    assert "(sop_main: every local card)" in capsys.readouterr().out


def _gone(pid):
    """The process has exited (it is absent, or a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _pids(out_dir, n, deadline):
    while time.monotonic() < deadline:
        files = [out_dir / f"rank{r}.pid" for r in range(n)]
        if all(f.exists() for f in files):
            return [int(f.read_text()) for f in files]
        time.sleep(0.2)
    raise AssertionError("the ranks did not start")


def _launcher(kind, out_dir):
    out_dir.mkdir()
    return start(lambda i: ["launch", kind, 2, out_dir, "-", "--num_gpus",
                            "2"], 1)[0]


def test_a_failing_rank_ends_the_launch(tmp_path):
    """Rank 1 raises while rank 0 sleeps: the launcher ends rank 0 and
    exits with rank 1's code (1) within the stop deadline of the failure;
    no rank is left."""
    p = _launcher("raise", tmp_path / "r")
    pids = _pids(tmp_path / "r", 2, time.monotonic() + 120)
    t0 = time.monotonic()
    out, _ = p.communicate(timeout=120)
    assert p.returncode == 1, out[-3000:]
    assert time.monotonic() - t0 < launch.STOP_GRACE_S + 5
    assert "rank 1 fails on purpose" in out
    assert "[launch] a rank failed: every rank stopped, exit 1" in out
    assert all(_gone(pid) for pid in pids)


@pytest.mark.parametrize("sig", [signal.SIGTERM, signal.SIGKILL])
def test_a_signal_to_the_launcher_ends_every_rank(tmp_path, sig):
    """SIGTERM: the launcher ends its ranks and exits 128 + 15.  SIGKILL:
    the kernel's parent death signal ends them."""
    p = _launcher("sleep", tmp_path / "s")
    pids = _pids(tmp_path / "s", 2, time.monotonic() + 120)
    p.send_signal(sig)
    out, _ = p.communicate(timeout=60)
    assert p.returncode == (143 if sig == signal.SIGTERM else -9), \
        out[-3000:]
    if sig == signal.SIGTERM:
        assert "[launch] signal 15: every rank stopped, exit 143" in out
    deadline = time.monotonic() + 30
    while not all(_gone(pid) for pid in pids):
        assert time.monotonic() < deadline, pids
        time.sleep(0.2)


@pytest.mark.parametrize("procs,rank,mode,want", [
    (1, 3, "replicate", [6, 7]), (1, 3, "shard", [6, 7]),
    (2, 0, "shard", [0, 1]), (2, 1, "shard", [2, 3]),
    (2, 2, "shard", [0, 1]), (2, 3, "shard", [2, 3]),
    (4, 2, "shard", [0, 1])])
def test_device_put_global_rows(monkeypatch, procs, rank, mode, want):
    """Four ranks: ``replicate`` keeps the rank's block of the global 8
    rows; ``shard`` its block of its process's 4 (2 processes) or all of
    its process's 2 (4 processes of one rank); one process's ``shard`` is
    ``replicate``.  ``process_index`` is the rank's process."""
    monkeypatch.setattr(pdist, "world_size", lambda: 4)
    monkeypatch.setattr(pdist, "rank", lambda: rank)
    rows = np.arange(8 if mode == "replicate" else 8 // procs)
    got = pdist.device_put_global({"a": rows}, mode, procs=procs)["a"]
    assert got.tolist() == want
    cfg = Config(dist_nprocs=procs)
    assert pdist.process_index(cfg) == rank // (4 // procs)
    assert pdist.is_multihost(cfg) == (procs > 1)
