"""Readings behind the data-parallel tolerances, on the CPU (needs JAX).

    JAX_PLATFORMS=cpu python3 tools/dist_spread.py readings
    JAX_PLATFORMS=cpu python3 tools/dist_spread.py count

``readings``: tests/test_torch_parallel.py's two gloo ranks against one
port process (the same run as its ``ranks`` fixture), with no limit: the
largest relative difference of the losses, parameters, running statistics
and momentum buffers (each against the tensor's largest value), the worst
buffer, and the global-batch BatchNorm's readings.  Then two readings that
say why the momentum differs: one process running the global-batch
BatchNorm's own arithmetic (its collectives made the identity) against
the ranks, and one process against itself with the input audio perturbed
by 1e-7 relative.

``count``: the all-reduces and their bytes in one AV and one AO step of
train_MUSIC.sh's widths (unet7, resnet18dilated-256; B = 2 over two gloo
ranks at 64x64 frames), counted by wrapping ``torch.distributed.
all_reduce`` in each rank.  Prints one JSON line per mode.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_COUNT = r"""
import datetime, json, sys
import torch, torch.distributed as dist
torch.set_num_threads(2)
rank, init = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=900))
import chip_smoke as cs
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.parallel import distributed as pdist
sizes, real = [], dist.all_reduce
def counted(t, *a, **k):
    sizes.append(t.numel() * t.element_size())
    return real(t, *a, **k)
dist.all_reduce = counted
cfg = Config(**dict(cs.TRAIN, imgSize=64, batch_size_per_gpu=2))
state = train.init_state(cfg, engine.build_nets(cfg, device="cpu"),
                         torch.Generator().manual_seed(0), device="cpu")
batch = cs.train_batches(torch.Generator().manual_seed(1),
                         torch.device("cpu"), 1, 2, aud_len=cfg.audLen,
                         img=cfg.imgSize)[0]
out = {}
for av in (True, False):
    sizes.clear()
    step = train.make_train_step(cfg, state.nets, av, device="cpu")
    state, _ = step(state, pdist.device_put_global(batch),
                    generator=torch.Generator().manual_seed(2))
    out["AV" if av else "AO"] = {"all_reduces": len(sizes),
                                 "largest_bytes": max(sizes),
                                 "bytes": sum(sizes)}
if rank == 0:
    print(json.dumps(out))
dist.destroy_process_group()
"""


def worst(got, want, prefix):
    """The largest relative difference over the tensors whose path starts
    with ``prefix`` (or not, for ``!opt_state``), and its path."""
    import tests.test_torch_parallel as T
    ref = dict(T._tensors(want))
    neg = prefix.startswith("!")
    return max((T.rel(t, ref[n]), n) for n, t in T._tensors(got)
               if t.is_floating_point()
               and n.startswith(prefix.lstrip("!")) != neg)


def readings():
    import numpy as np

    import tests.conftest  # noqa: F401 (JAX on the CPU's 8 devices)
    import tests.test_torch_parallel as T
    from avsep_tpu_torch.models import layers
    from tests.test_torch_forward import make_batch

    with tempfile.TemporaryDirectory() as d:
        got, refs, cfg, pnets = T.run_ranks(Path(d))
    res = {"bn": {job: max(T.rel(got[r][job][k], w) for r in (0, 1)
                           for k, w in refs[job].items())
                  for job in ("bn2d", "bn3d")}}
    steps = list(zip(got[0]["port"], refs["port"]))
    res["loss"] = max(abs(float(m["metrics"][k] - w["metrics"][k]))
                      / abs(float(w["metrics"][k]))
                      for m, w in steps for k in ("err",))
    res["momentum"] = max(worst(m["state"], w["state"], "opt_state")
                          for m, w in steps)
    res["params_and_statistics"] = max(
        worst(m["state"], w["state"], "!opt_state") for m, w in steps)
    batches = [make_batch(20 + i, B=T.B) for i in range(len(T.PORT_SEQ))]
    # the global-batch BatchNorm's arithmetic in one process
    real = layers.world_size, layers.all_reduce_sum
    layers.world_size, layers.all_reduce_sum = (lambda: 2), (lambda x: x)
    try:
        emulated = T.single_port(cfg, copy.deepcopy(pnets), batches)
    finally:
        layers.world_size, layers.all_reduce_sum = real
    res["ranks_vs_emulated_first_step_momentum"] = worst(
        got[0]["port"][0]["state"], emulated[0]["state"], "opt_state")
    rs = np.random.RandomState(0)
    nudged = [{k: (v * (1 + 1e-7 * rs.randn(*v.shape)).astype(np.float32)
                   if k == "audios" else v) for k, v in b.items()}
              for b in batches]
    moved = T.single_port(cfg, copy.deepcopy(pnets), nudged)
    res["one_process_input_1e-7_first_step_momentum"] = worst(
        moved[0]["state"], refs["port"][0]["state"], "opt_state")
    print(json.dumps(res))


def count():
    with tempfile.TemporaryDirectory() as d:
        init = os.path.join(d, "init")
        env = {**os.environ, "OMP_NUM_THREADS": "2"}
        procs = [subprocess.Popen([sys.executable, "-c", _COUNT, str(r), init],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=1200)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        if any(p.returncode for p in procs):
            raise SystemExit("\n".join(o[-3000:] for o in outs))
        print(outs[0].strip().splitlines()[-1])


if __name__ == "__main__":
    {"readings": readings, "count": count}[sys.argv[1]]()
