"""The port's data parallelism (avsep_tpu_torch/parallel/) on the CPU.

Two gloo ranks (``tests/torch_dist_worker.py``, one process each) against
two oracles, on the small nets of tests/test_torch_forward.py (unet5 at
ngf 8, the tiny conv encoder, 64x64 frames, 16383 samples) at a global
batch of 4, 2 rows per rank, ``dist_data=replicate``:

* the JAX package's ``make_train_step`` on a 2-device mesh (``make_mesh(2)``
  over the virtual CPU devices of tests/conftest.py, batch sharded on dim
  0), from the same weights and batches with the JAX swap draws injected:
  an AV and an AO step, held to the port-vs-JAX tolerances of
  tests/test_torch_train.py (``check_step``);
* one port process on the global batch: AV, AO, AV, AO, the AO swap drawn
  from a generator seeded alike (each rank keeps its rows of the global
  draw).  The ranks hold every tensor bit for bit alike.  Against the one
  process: ``err`` at 1e-6 relative (read: at most 1.1e-7), the match
  loss, a difference of scores of order one, at 1e-6 absolute (read: bit
  for bit with the reference at 8 threads, 1.19e-7 at one); each
  parameter and running statistic at 1e-5 of the tensor's largest value
  (read: at most 1.1e-6 and 8.6e-7); each momentum buffer at 2e-3 (read:
  at most 6.6e-4, the U-Net's up2 conv after the first AV step; 7.0e-4
  with the reference at one thread).  That
  buffer is ill-conditioned, not mis-summed: in one process a relative
  perturbation of 1e-7 of the input audio moves it by the same 6.56e-4,
  and one process running the global-batch BatchNorm's own arithmetic
  (its collectives made the identity) meets the two ranks at 9.7e-7 after
  that step; the global path sums in float32 where the CPU's
  ``F.batch_norm`` accumulates in float64.

And the global-batch BatchNorm alone (NCHW and the motion net's NCDHW)
against ``BatchNorm`` on the concatenated batch: the output, the input's
gradient and the weight and bias gradients of ``sum(y * dy)``, the running
statistics, at 1e-5 relative (read: at most 6.1e-7), so a factor of the
rank count in the backward would show as a ratio of 2.  Plus the flags,
``mesh_from_config``'s and ``validate_global_batch``'s errors,
``ShardDataset`` against the JAX package's, and ``build_loaders``' shard
split.  The CLI path is tests/test_torch_parallel_cli.py.
"""

import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.config import parse_args as jparse_args
from avsep_tpu.data.loader import ShardDataset as JShardDataset
from avsep_tpu.parallel.mesh import make_mesh as jmake_mesh
from avsep_tpu.parallel.mesh import shard_batch, shard_tree
from avsep_tpu.train import TrainState as JTrainState
from avsep_tpu.train import make_optimizer, make_train_step as jmake_step
from avsep_tpu_torch import train
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.data.loader import ShardDataset
from avsep_tpu_torch.main import build_loaders
from avsep_tpu_torch.models.layers import BatchNorm, reset_batchnorm_
from avsep_tpu_torch.parallel import distributed as pdist
from avsep_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_forward import configs, make_batch, make_nets
from tests.test_torch_train import WD, check_step
from tests.torch_dist_worker import launch, wait_all

B = 4                                     # the global batch, 2 rows per rank
JAX_SEQ = (True, False)
PORT_SEQ = (True, False, True, False)
SWAP_SEED = 3
LOSS_REL = 1e-6
STATE_REL = 1e-5
MOMENTUM_REL = 2e-3
BN_REL = 1e-5
MANIFEST = "data/mini/train.csv"


# --------------------------------------------------------------- the ranks


def bn_job(shape, seed):
    rs = np.random.RandomState(seed)
    bn = BatchNorm(shape[1])
    reset_batchnorm_(bn, torch.Generator().manual_seed(seed))
    x = torch.from_numpy((rs.randn(*shape) * 2 + 1).astype(np.float32))
    dy = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    return {"kind": "bn", "bn": bn, "x": x, "dy": dy}


def single_bn(job):
    """The job on the concatenated batch, in one process."""
    bn = copy.deepcopy(job["bn"]).train()
    x = job["x"].clone().requires_grad_(True)
    y = bn(x)
    (y * job["dy"]).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


def jax_steps(jcfg, jnets, params, stats, batches):
    """The JAX train steps on a 2-device mesh; (state, metrics) per step."""
    mesh = jmake_mesh(2)
    jstate = shard_tree(JTrainState(jnp.zeros((), jnp.int32), params, stats,
                                    make_optimizer(jcfg, params).init(params)),
                        mesh)
    steps = {v: jmake_step(jcfg, jnets, v) for v in (True, False)}
    out = []
    for i, (use_vis, batch) in enumerate(zip(JAX_SEQ, batches)):
        jb = shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        jstate, jm = steps[use_vis](jstate, jb, jax.random.PRNGKey(100 + i))
        out.append((jax.device_get(jstate), jax.device_get(jm)))
    return out


def single_port(cfg, nets, batches):
    """The port's steps on the global batches in one process."""
    state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
    steps = {v: train.make_train_step(cfg, nets, v, device="cpu")
             for v in (True, False)}
    gen = torch.Generator().manual_seed(SWAP_SEED)
    out = []
    for use_vis, batch in zip(PORT_SEQ, batches):
        state, m = steps[use_vis](state, batch, generator=gen)
        out.append({"metrics": m, "state": copy.deepcopy(state.state_dict())})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("ranks"))


def run_ranks(d):
    """Runs every job on two gloo ranks (their files under the directory
    ``d``) while the references are computed here; returns (the ranks'
    results, the references, the config, the port nets)."""
    jcfg, cfg = configs(weight_decay=WD)
    jnets, params, stats, pnets = make_nets(cfg)
    jax_batches = [make_batch(10 + i, B=B) for i in range(len(JAX_SEQ))]
    port_batches = [make_batch(20 + i, B=B) for i in range(len(PORT_SEQ))]
    weights = {name: net.state_dict() for name, net in pnets._asdict().items()
               if net is not None}
    spec = {
        "bn2d": bn_job((B, 3, 5, 6), 1),
        "bn3d": bn_job((B, 3, 2, 5, 6), 2),
        "jax": {"kind": "train", "cfg": cfg, "weights": weights,
                "seq": JAX_SEQ, "batches": jax_batches,
                "uniforms": [torch.from_numpy(np.array(jax.random.uniform(
                    jax.random.PRNGKey(100 + i), (B,))))
                    for i in range(len(JAX_SEQ))]},
        "port": {"kind": "train", "cfg": cfg, "weights": weights,
                 "seq": PORT_SEQ, "batches": port_batches,
                 "uniforms": [None] * len(PORT_SEQ), "seed": SWAP_SEED}}
    torch.save(spec, d / "spec.pt")
    procs = launch(lambda r: ["jobs", d / "spec.pt", r, 2, d / "init",
                              d / f"rank{r}.pt"], 2)
    try:
        refs = {"bn2d": single_bn(spec["bn2d"]),
                "bn3d": single_bn(spec["bn3d"]),
                "jax": jax_steps(jcfg, jnets, params, stats, jax_batches),
                "jax_params0": params,
                "port": single_port(cfg, copy.deepcopy(pnets),
                                    port_batches)}
    finally:
        wait_all(procs, timeout=600)
    got = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    return got, refs, cfg, pnets


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(
        1e-30))


@pytest.mark.parametrize("job", ["bn2d", "bn3d"])
def test_global_batchnorm_is_batchnorm_of_the_whole_batch(ranks, job):
    """Forward, input gradient, weight and bias gradients and the running
    statistics of two ranks' global-batch BatchNorm against one BatchNorm
    on the concatenated batch."""
    got, refs, _, _ = ranks
    for k, want in refs[job].items():
        for r in (0, 1):
            assert rel(got[r][job][k], want) <= BN_REL, (job, k, r)


def test_two_ranks_match_jax_mesh_train_step(ranks):
    """An AV and an AO step of two gloo ranks against the JAX package's
    train step on a 2-device mesh (port-vs-JAX tolerances)."""
    got, refs, cfg, pnets = ranks
    params0 = refs["jax_params0"]
    for (jstate, jm), step in zip(refs["jax"], got[0]["jax"]):
        nets = copy.deepcopy(pnets)
        pstate = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
        pstate.load_state_dict(step["state"])
        check_step(pstate, step["metrics"], jstate, jm, params0)


def _tensors(sd, prefix=""):
    """Every tensor of a nested state dict, by path."""
    for k, v in sd.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}{k}.")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def test_two_ranks_hold_the_same_state_bit_for_bit(ranks):
    got, _, _, _ = ranks
    for job in ("jax", "port"):
        for s0, s1 in zip(got[0][job], got[1][job]):
            t1 = dict(_tensors(s1["state"]))
            for name, t in _tensors(s0["state"]):
                assert torch.equal(t, t1[name]), (job, name)
            for k, v in s0["metrics"].items():
                assert torch.equal(v, s1["metrics"][k]), (job, k)


def test_two_ranks_match_one_process_on_the_global_batch(ranks):
    """Two AV and two AO steps, the swap drawn for the global batch: the
    losses to float32 rounding, every parameter and running statistic
    within ``STATE_REL`` of its largest value, every momentum buffer
    within ``MOMENTUM_REL``; the step and the groups' counts exactly."""
    got, refs, _, _ = ranks
    for mine, want in zip(got[0]["port"], refs["port"]):
        # the match loss is a difference of per-row scores of order one
        # (fusion._score_and_sort), so its float32 rounding is absolute
        scale = {"err": abs(float(want["metrics"]["err"])), "match_loss": 1.0}
        for k in ("err", "match_loss"):
            assert abs(float(mine["metrics"][k] - want["metrics"][k])) <= \
                LOSS_REL * scale[k], k
        assert mine["state"]["step"] == want["state"]["step"]
        for g, s in want["state"]["opt_state"].items():
            assert mine["state"]["opt_state"][g]["count"] == s["count"], g
        ref = dict(_tensors(want["state"]))
        for name, t in _tensors(mine["state"]):
            if t.is_floating_point():
                tol = MOMENTUM_REL if name.startswith("opt_state") \
                    else STATE_REL
                assert rel(t, ref[name]) <= tol, name
            else:
                assert torch.equal(t, ref[name]), name


# -------------------------------------------------------------- in-process


@pytest.mark.parametrize("argv", [
    ["--mesh_shape", "2"], ["--data_axis", "batch"],
    ["--dist_coordinator", "localhost:1234"], ["--dist_nprocs", "2"],
    ["--dist_procid", "1"], ["--dist_data", "shard"]])
def test_dist_and_mesh_flags_parse_as_the_jax_package(argv):
    got, want = parse_args(argv), jparse_args(argv)
    name = argv[0][2:]
    assert getattr(got, name) == getattr(want, name) != \
        getattr(Config(), name)


@pytest.mark.parametrize("shape,world,message", [
    ((2, 2), 1, "only 1-axis"),
    ((2,), 1, "exceeds the 1 available devices"),
    ((1,), 2, "multi-host jobs must span every device")])
def test_mesh_from_config_errors(monkeypatch, shape, world, message):
    monkeypatch.setattr(pmesh, "world_size", lambda: world)
    with pytest.raises(ValueError, match=re.escape(message)):
        pmesh.mesh_from_config(Config(mesh_shape=shape))


def test_mesh_from_config_widths(monkeypatch):
    assert pmesh.mesh_from_config(Config()) == ("data", 1, 0)
    assert pmesh.mesh_from_config(Config(mesh_shape=(1,),
                                         data_axis="b")) == ("b", 1, 0)
    monkeypatch.setattr(pmesh, "world_size", lambda: 4)
    monkeypatch.setattr(pmesh, "rank", lambda: 3)
    assert pmesh.mesh_from_config(Config(mesh_shape=(4,))) == ("data", 4, 3)


@pytest.mark.parametrize("kw,message", [
    (dict(batch_size_per_gpu=3), "global batch 3 must divide across 2"),
    (dict(dist_data="rows"), "--dist_data 'rows'")])
def test_validate_global_batch_errors(monkeypatch, kw, message):
    pdist.validate_global_batch(Config(**kw))       # one process: no check
    monkeypatch.setattr(pdist, "world_size", lambda: 2)
    pdist.validate_global_batch(Config(batch_size_per_gpu=4))
    with pytest.raises(ValueError, match=re.escape(message)):
        pdist.validate_global_batch(Config(**kw))


def test_maybe_initialize_leaves_an_existing_group_alone(ranks):
    got, _, _, _ = ranks
    assert got[0]["maybe_initialize"] is False
    assert got[1]["maybe_initialize"] is False


def test_maybe_initialize_needs_a_coordinator():
    assert not pdist.maybe_initialize(Config())
    with pytest.raises(ValueError, match="--dist_coordinator"):
        pdist.maybe_initialize(Config(dist_nprocs=2), device="cpu")
    assert not pdist.active()


@pytest.mark.parametrize("n,count", [(10, 2), (11, 3), (7, 4), (3, 1)])
def test_shard_dataset_equals_jax(n, count):
    data = [f"s{i}" for i in range(n)]
    seen = []
    for index in range(count):
        mine, want = ShardDataset(data, index, count), \
            JShardDataset(data, index, count)
        assert len(mine) == len(want) == n // count
        assert [mine[i] for i in range(len(mine))] == \
            [want[i] for i in range(len(want))]
        seen += [mine[i] for i in range(len(mine))]
    assert len(seen) == len(set(seen))              # disjoint
    with pytest.raises(ValueError):
        ShardDataset(data, count, count)


def test_one_process_helpers_are_the_identity():
    batch = {"audios": np.arange(12.0).reshape(4, 3)}
    assert pdist.device_put_global(batch, "replicate") is batch
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(pdist.rank_rand((4, 3), g1), torch.rand(4, 3,
                                                                generator=g2))
    t = torch.ones(3)
    pdist.mean_([t])
    pdist.broadcast_([t])
    assert torch.equal(t, torch.ones(3)) and pdist.fetch(t) is t


def shard_cfg(**kw):
    base = dict(num_mix=2, audLen=16383, imgSize=64, one_frame=True,
                frame_decode="pil", train_repeat=2, val_repeat=1,
                batch_size_per_gpu=4, workers=0, dist_data="shard",
                av_list_train=(MANIFEST,), ao_list_train=(MANIFEST,),
                list_val=(MANIFEST,))
    return Config(**{**base, **kw})


def test_build_loaders_shard_split():
    """``dist_data=shard``: each of two processes' train loaders serve
    half the global batch from a disjoint half of the dataset; the val
    loader stays the whole, replicated."""
    parts = []
    for r in (0, 1):
        av, ao, val = build_loaders(shard_cfg(), process_index=r,
                                     process_count=2)
        try:
            assert av.batch_size == ao.batch_size == 2
            assert val.batch_size == 4 and len(val.dataset) == 6
            parts.append({av.dataset.index + i * av.dataset.count
                          for i in range(len(av.dataset))})
        finally:
            for ld in (av, ao, val):
                ld.close()
    assert parts[0].isdisjoint(parts[1])
    assert parts[0] | parts[1] == set(range(12))


def test_build_loaders_shard_too_small_raises():
    """Six samples over two processes leave three each, fewer than a
    per-process batch of four: the JAX package's error."""
    with pytest.raises(ValueError, match="fewer than the per-process batch"):
        build_loaders(shard_cfg(train_repeat=1, batch_size_per_gpu=8),
                      process_index=1, process_count=2)
