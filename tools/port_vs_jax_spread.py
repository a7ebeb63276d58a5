"""The port on the CPU against the JAX package on the CPU, on the draws of
chip_smoke.py's ``sop_card_vs_cpu`` or ``clipatt_card_vs_cpu`` phase, seed
by seed.

``tools/card_vs_cpu_spread.py sop|clipatt`` reads, per seed, how far the
port's train steps on the card lie from the same steps on the CPU.  This
tool takes the same seeds, the same weights (``chip_smoke.spread_weights``)
and the same batches, runs the port's steps on the CPU (``sop``: AV stage
1, AO, AV stage 2, AV stage 3; ``clipatt``: an AV and an AO step of the
clips branch) and the JAX package's jitted train steps on the CPU from the
same state, and prints ``chip_smoke.compare_states``' readings of the port
against JAX, each parameter's and buffer's included: the distance between
two float32 implementations on one device, to hold a card-vs-CPU reading
against.  JAX's BatchNorm runs with Flax's two-pass batch variance, the
port's (tests/test_torch_forward.py says why).  The clips branch's AO step
takes JAX's slot-swap draw on both sides (a JAX PRNG stream cannot be
drawn in torch), where the card phase draws its own.  Needs JAX and runs
on the CPU, from the repository's root:

    JAX_PLATFORMS=cpu python3 tools/port_vs_jax_spread.py sop --seeds 6
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from avsep_tpu import engine as jengine  # noqa: E402
from avsep_tpu import sop_main as jsop  # noqa: E402
from avsep_tpu import train as jtrain  # noqa: E402
from avsep_tpu.config import Config as JConfig  # noqa: E402
from avsep_tpu.config import parse_args as jparse_args  # noqa: E402
from avsep_tpu.train import TrainState as JTrainState  # noqa: E402
from avsep_tpu_torch import engine, sop_main, train  # noqa: E402
from avsep_tpu_torch.config import Config  # noqa: E402
from avsep_tpu_torch.models.from_jax import (  # noqa: E402
    load_from_jax, load_sop_from_jax)
from tests.test_torch_sop_train import jax_groups  # noqa: E402

SOP_KINDS = ((True, 1), (False, 1), (True, 2), (True, 3))


def to_jax(net_sd, bn_prefixes):
    """A port ``state_dict`` -> the JAX (params, batch_stats) trees."""
    params, stats = {}, {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = jnp.asarray(value.numpy())

    for key, v in net_sd.items():
        path = key.split(".")
        mod, name = tuple(path[:-1]), path[-1]
        if name == "num_batches_tracked":
            continue
        if name == "running_mean":
            put(stats, mod + ("mean",), v)
        elif name == "running_var":
            put(stats, mod + ("var",), v)
        elif name == "weight" and v.dim() >= 4:
            n = v.dim()
            put(params, mod + ("kernel",),
                v.permute(*range(2, n), 1, 0).contiguous())
        elif name == "weight" and ".".join(mod) in bn_prefixes:
            put(params, mod + ("scale",), v)
        else:
            put(params, mod + (name,), v)
    return params, stats


def jax_state(st):
    params, stats = {}, {}
    for name, net in train.modules(st.nets):
        sd = net.state_dict()
        bn = {k.rsplit(".", 1)[0] for k in sd if k.endswith("running_mean")}
        if name == "synthesizer":
            params[name] = {k: jnp.asarray(v.numpy()) for k, v in sd.items()}
        else:
            params[name], stats[name] = to_jax(sd, bn)
    return params, stats


class Sop:
    """chip_smoke's sop_card_vs_cpu: its config, state and steps."""

    def __init__(self):
        self.cfg = cs.sop_config().replace(**cs.SOP_SMALL)
        self.jcfg = jparse_args(cs.opts_flags("train_SoPpp.sh") + [
            "--num_gpus", "1"]).replace(**cs.SOP_SMALL)
        jnets = jsop.build_sop_nets(self.jcfg)
        self.kinds = SOP_KINDS
        self.jsteps = {k: jsop.make_sop_train_step(self.jcfg, jnets, *k)
                       for k in self.kinds}

    def batches(self, gen):
        return cs.train_batches(gen, torch.device("cpu"), len(self.kinds), 2,
                                aud_len=self.cfg.audLen, img=self.cfg.imgSize)

    def state(self):
        return sop_main.init_sop_state(
            self.cfg, sop_main.build_sop_nets(self.cfg, device="cpu"),
            torch.Generator().manual_seed(cs.SEED), device="cpu")

    def optimizer(self, params):
        return jsop.make_sop_optimizer(self.jcfg, params)

    def port_step(self, st, k, b, swap):
        return sop_main.make_sop_train_step(self.cfg, st.nets, *k,
                                            device="cpu")(st, b)

    load = staticmethod(load_sop_from_jax)


class ClipAtt:
    """chip_smoke's clipatt_card_vs_cpu: its config, state and steps."""

    def __init__(self):
        self.cfg = Config(**{**cs.CLIPATT, **cs.CLIPATT_SMALL})
        fields = {f.name for f in dataclasses.fields(JConfig)}
        self.jcfg = JConfig(**{k: v for k, v in
                               dataclasses.asdict(self.cfg).items()
                               if k in fields})
        jnets = jengine.build_nets(self.jcfg)
        self.kinds = (True, False)
        self.jsteps = {k: jtrain.make_train_step(self.jcfg, jnets, k)
                       for k in self.kinds}

    def batches(self, gen):
        b = cs.clip_batches(gen, torch.device("cpu"), 2, 2, self.cfg.audLen,
                            self.cfg.imgSize, self.cfg.clip_len)
        torch.rand(2, generator=gen)            # the card phase's swap draw
        return b

    def state(self):
        return train.init_state(self.cfg,
                                engine.build_nets(self.cfg, device="cpu"),
                                torch.Generator().manual_seed(cs.SEED),
                                device="cpu")

    def optimizer(self, params):
        return jtrain.make_optimizer(self.jcfg, params)

    def port_step(self, st, k, b, swap):
        return train.make_train_step(self.cfg, st.nets, k, device="cpu")(
            st, b, swap_uniforms=swap)

    load = staticmethod(load_from_jax)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("phase", choices=("sop", "clipatt"))
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    import flax.linen.normalization as fnorm
    orig = fnorm._compute_stats
    fnorm._compute_stats = lambda *a, **kw: orig(
        *a, **{**kw, "use_fast_variance": False})
    cs.BY_NAME = True
    ph = Sop() if args.phase == "sop" else ClipAtt()
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)
        batches = ph.batches(gen)
        st = ph.state()
        cs.spread_weights(st.nets, gen)
        p0 = {n: p.detach().clone()
              for n, p in train.named_parameters(st.nets)}
        params, stats = jax_state(st)
        js = JTrainState(jnp.zeros((), jnp.int32), params, stats,
                         ph.optimizer(params).init(params))
        ms = {"cuda": [], "cpu": []}
        for i, (b, k) in enumerate(zip(batches, ph.kinds)):
            rng = jax.random.PRNGKey(i)
            js, jm = ph.jsteps[k](js, {n: jnp.asarray(v.numpy())
                                       for n, v in b.items()}, rng)
            swap = torch.from_numpy(np.array(jax.random.uniform(rng, (2,))))
            st, m = ph.port_step(st, k, b, swap)
            ms["cuda"].append(float(m["err"]))
            ms["cpu"].append(float(jm["err"]))
        js = jax.device_get(js)
        ref = ph.state()
        ph.load(ref.nets, js.params, js.batch_stats)
        for g, (count, bufs) in jax_groups(js.opt_state).items():
            ref.opt_state[g].count = count
            for n, v in bufs.items():
                ref.opt_state[g].momentum[n].copy_(torch.from_numpy(v))
        ref.step = int(js.step)
        res = cs.compare_states({"cuda": st, "cpu": ref}, ms, p0)
        print(json.dumps({"phase": f"{args.phase}_port_vs_jax",
                          "seed": seed,
                          "compared": "port (CPU) against JAX (CPU)",
                          "losses_port": ms["cuda"], "losses_jax": ms["cpu"],
                          **res}), flush=True)


if __name__ == "__main__":
    main()
