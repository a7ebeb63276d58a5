"""``cfg.remat`` in the port: the frame and sound nets' forwards of a train
step under ``torch.utils.checkpoint`` (``avsep_tpu/engine.py:126-130``
wraps the same two in ``jax.checkpoint``).

The recompute repeats the forward's arithmetic on the same inputs with the
same algorithms, so on the CPU a rematerialized step equals the plain one
bit for bit: losses, every gradient, the parameters and momentum buffers
after the update, the running statistics and their update counts.  The
recompute must not update the BatchNorm running statistics a second time,
and the audio-only slot swap, drawn from an explicit ``torch.Generator``
that ``preserve_rng_state`` does not cover, must be drawn once, before the
region.  ``tests/test_torch_forward.py`` holds the rematerialized forward
against JAX's.  Size: unet5 at ngf 8 and the tiny encoder at 32 channels
on 64x64 frames, 16383 samples, B = 3, under both compute dtypes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch import engine, train
from avsep_tpu_torch.models.from_jax import load_from_jax
from tests.test_torch_bf16 import nets_of, variables
from tests.test_torch_forward import configs, make_batch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_nets(dtype):
    j32, _ = nets_of("tinyconv", jnp.float32, torch.float32)
    _, pnets = nets_of("tinyconv", jnp.float32, DTYPES[dtype])
    load_from_jax(pnets, *variables(j32, "tinyconv"))
    return pnets


def count_calls(nets):
    """Forward calls per net, counted by forward hooks."""
    calls = {"sound": 0, "frame": 0}
    for name in calls:
        def hook(module, args, name=name):
            calls[name] += 1
        getattr(nets, name).register_forward_pre_hook(hook)
    return calls


def forward_and_grads(remat, dtype, use_vis, seed=7):
    _, cfg = configs(remat=remat, dtype=dtype)
    nets = port_nets(dtype)
    calls = count_calls(nets)
    gen = torch.Generator().manual_seed(seed)
    err, out = engine.forward(nets, make_batch(2), cfg, use_vis, train=True,
                              generator=gen)
    named = dict(train.named_parameters(nets))
    grads = torch.autograd.grad(err, list(named.values()), allow_unused=True)
    buffers = {f"{n}.{k}": v.clone() for n, net in (("sound", nets.sound),
                                                    ("frame", nets.frame))
               for k, v in net.state_dict().items()
               if "running" in k or "num_batches" in k}
    return (err, out, dict(zip(named, grads)), buffers, dict(calls),
            torch.rand(4, generator=gen))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_vis", [True, False])
def test_remat_forward_equals_the_plain_path(dtype, use_vis):
    """Loss, per-sample losses, masks and every gradient bit for bit; the
    running statistics and ``num_batches_tracked`` as after one plain
    forward (updated once, not again in the recompute); the AO step's slot
    swap drawn once from the generator; and the nets really recomputed."""
    err0, out0, g0, b0, calls0, next0 = forward_and_grads(False, dtype,
                                                          use_vis)
    err1, out1, g1, b1, calls1, next1 = forward_and_grads(True, dtype,
                                                          use_vis)
    assert torch.equal(err0, err1)
    assert torch.equal(out0["err_ps"], out1["err_ps"])
    assert torch.equal(out0["pred_masks"], out1["pred_masks"])
    assert set(g0) == set(g1)
    for name, g in g0.items():
        if g is None:
            assert g1[name] is None and name.startswith("frame.")
            continue
        assert g1[name].dtype == torch.float32
        assert torch.equal(g, g1[name]), name
    for k, v in b0.items():
        assert torch.equal(v, b1[k]), k
    tracked = b1["sound.down_bn1.bn.num_batches_tracked"].item()
    assert tracked == (2 if use_vis else 1)
    if use_vis:
        assert b1["frame.features.BatchNorm_0.num_batches_tracked"] == 2
    # the same draws taken from the generator, and no more
    assert torch.equal(next0, next1)
    # the plain path runs each net's forward once per call; remat runs it
    # again in the backward pass
    assert calls1 == {k: 2 * v for k, v in calls0.items()}
    assert calls0["sound"] == (2 if use_vis else 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_train_steps_equal_the_plain_steps(dtype):
    """An AV step then an AO step through ``make_train_step``, with and
    without remat, from the same weights: parameters, momentum buffers,
    running statistics and group counts bit for bit."""
    states = []
    for remat in (False, True):
        _, cfg = configs(remat=remat, dtype=dtype)
        nets = port_nets(dtype)
        state = train.TrainState(0, nets, train.init_opt_state(cfg, nets))
        gen = torch.Generator().manual_seed(11)
        for i, use_vis in enumerate((True, False)):
            step = train.make_train_step(cfg, nets, use_vis, device="cpu")
            state, m = step(state, make_batch(5 + i), generator=gen)
            assert np.isfinite(m["err"].item())
        states.append(state.state_dict())
    plain, remat = states
    for net in ("sound", "frame"):
        for k, v in plain[net].items():
            assert torch.equal(v, remat[net][k]), (net, k)
    for g, s in plain["opt_state"].items():
        assert s["count"] == remat["opt_state"][g]["count"]
        for k, v in s["momentum"].items():
            assert torch.equal(v, remat["opt_state"][g]["momentum"][k]), k
