"""The port's train step (avsep_tpu_torch/train.py) against
``jax.jit(avsep_tpu.train.make_train_step)``, step by step, on the CPU:
the loss, every parameter, every momentum buffer, each group's count and
every BatchNorm running statistic after each step.  Also the learning-rate
schedule, the AV/AO scheduler, ``.pth`` loading, checkpoints, and what
raises.

Size and weights as in tests/test_torch_forward.py (unet5 at ngf 8, the
tiny conv encoder on 64x64 frames, 16383 samples, B = 3, random weights in
the JAX shapes).  The steps run AV, AO, AV, AO, AV with ``lr_steps=(2,)``,
so the ``sound`` group crosses the boundary at its third update and the
``frame`` group, which counts AV steps only, at the third AV step.  Larger
learning rates than the reference's (1e-2 and 1e-3) make each step move
the parameters well above float noise, and a weight decay of 0.05 makes
the decay term as large as the gradients.

Tolerances: the loss at 1e-5 relative.  Each momentum buffer at 1e-2 of
its largest entry, floored at 1e-4 of the largest buffer of the step: a
decoder activation within rounding of 0 takes the other side of its ReLU
in one package and sends its cotangent elsewhere, which at this size moves
a gradient by up to 0.9 % (measured: the JAX and the port's AO gradients
at identical parameters after one step, with the JAX oracle's BatchNorm
variance made two-pass, which changed nothing).  Each parameter at 2e-3 of
its largest change since the start (the same floor on the largest change),
plus 1e-6 of its largest value (a few float32 ulps: each step rounds
``p + update``, and the frame net's updates are about 1e-7); the largest
seen was 5e-5.  Running statistics at 1e-4 of each buffer's largest value.
What must be exact is exact: the counts; the frame net's parameters,
statistics and ``frame`` group across an AO step; and the SGD update
itself against optax on given gradients (``test_sgd_update_is_optax``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.train import TrainState as JTrainState
from avsep_tpu.train import batch_scheduler as jbatch_scheduler
from avsep_tpu.train import make_optimizer, make_train_step as jmake_step
from avsep_tpu_torch import checkpoint, engine, train
from avsep_tpu_torch.models.from_jax import state_dict_from_jax
from tests.test_torch_forward import B, configs, make_batch, make_nets
from tests.test_torch_sop import rel

SEQ = (True, False, True, False, True)
# large enough that the decay term is of the gradients' size
WD = 0.05


def _drop_masked(tree):
    """A trace tree of one optax group without its ``MaskedNode`` leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            sub = _drop_masked(v)
            if sub:
                out[k] = sub
        elif not isinstance(v, optax.MaskedNode):
            out[k] = v
    return out


def flat(tree):
    """A JAX tree of nets -> {port name: array}."""
    return {f"{net}.{k}": v.numpy() for net, sub in tree.items()
            for k, v in state_dict_from_jax(sub, {}).items()}


def jax_groups(opt_state, flat=flat):
    """The JAX optax state -> {group: (count, {port name: buffer})}, None
    for a group without state (``fix_vis``); ``flat`` names a tree's
    leaves as the port does."""
    out = {}
    for g, masked in opt_state.inner_states.items():
        inner = masked.inner_state
        if not (isinstance(inner, tuple) and len(inner) == 2):
            out[g] = None
            continue
        trace, sched = inner[1]
        out[g] = (int(sched.count), flat(_drop_masked(trace.trace)))
    return out


def _close(got, ref, scale, tol=2e-3):
    return np.abs(got - ref).max() <= tol * scale


def run_steps(cfg_kw, seq=SEQ):
    """Runs ``seq`` through both packages from the same state; yields after
    each step (use_vis, port state, port metrics, JAX state, JAX metrics,
    the port's frame state before the step)."""
    jcfg, cfg = configs(**{"weight_decay": WD, **cfg_kw})
    jnets, params, stats, pnets = make_nets(cfg)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, stats,
                         make_optimizer(jcfg, params).init(params))
    pstate = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    jsteps = {v: jmake_step(jcfg, jnets, v) for v in (True, False)}
    psteps = {v: train.make_train_step(cfg, pnets, v, device="cpu")
              for v in (True, False)}
    for i, use_vis in enumerate(seq):
        batch = make_batch(10 + i)
        rng = jax.random.PRNGKey(100 + i)
        before = {k: v.clone() for k, v in pnets.frame.state_dict().items()}
        jstate, jm = jsteps[use_vis](
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        u = torch.from_numpy(np.array(jax.random.uniform(rng, (B,))))
        pstate, pm = psteps[use_vis](pstate, batch, swap_uniforms=u)
        yield use_vis, pstate, pm, jax.device_get(jstate), jm, before, params


def check_step(pstate, pm, jstate, jm, params0, flat=flat,
               nets=("sound", "frame")):
    """A port step against the JAX package's from the same state, for
    every family: ``err``, ``step``, each group's count and momentum
    buffers, the parameters by their change since ``params0`` and the
    running statistics of ``nets``; ``flat`` names a JAX tree's leaves as
    the port does."""
    assert rel(pm["err"].item(), float(jm["err"])) < 1e-5
    assert pstate.step == int(jstate.step)
    # momentum buffers and counts, per group
    jg = jax_groups(jstate.opt_state, flat)
    assert set(jg) == set(pstate.opt_state)
    tops = [np.abs(b).max() for g in jg.values() if g for b in g[1].values()]
    for g, want in jg.items():
        mine = pstate.opt_state[g]
        if want is None:
            assert mine is None
            continue
        assert mine.count == want[0], g
        assert set(mine.momentum) == set(want[1]), g
        for name, buf in mine.momentum.items():
            ref = want[1][name]
            assert _close(buf.numpy(), ref,
                          max(np.abs(ref).max(), 1e-4 * max(tops)),
                          tol=1e-2), name
    # parameters, by their change since the start
    p0, pj = flat(params0), flat(jstate.params)
    moves = {n: np.abs(pj[n] - p0[n]).max() for n in pj}
    for name, p in train.named_parameters(pstate.nets):
        scale = max(moves[name], 1e-4 * max(moves.values()))
        assert np.abs(p.detach().numpy() - pj[name]).max() <= \
            2e-3 * scale + 1e-6 * np.abs(pj[name]).max(), name
    # running statistics
    for net in nets:
        want = state_dict_from_jax(jstate.params[net],
                                   jstate.batch_stats[net])
        sd = getattr(pstate.nets, net).state_dict()
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var")):
                assert rel(sd[k].numpy(), v.numpy()) <= 1e-4, (net, k)


def test_interleaved_steps_match_jax_train_step():
    """AV and AO steps interleaved across an lr_steps boundary.  In the AO
    steps the frame net, ``frame.fc`` included, stays bit for bit, and the
    ``frame`` group's count stays, while ``frame.fc``'s buffer (group
    ``sound``) advances by its decay term alone."""
    _, cfg = configs()
    counts = []
    for use_vis, pstate, pm, jstate, jm, before, params0 in run_steps({}):
        check_step(pstate, pm, jstate, jm, params0)
        counts.append((pstate.opt_state["sound"].count,
                       pstate.opt_state["frame"].count))
        if not use_vis:
            for k, v in pstate.nets.frame.state_dict().items():
                assert torch.equal(v, before[k]), k
            assert pm["match_loss"].item() == 0.0
    assert counts == [(1, 1), (2, 1), (3, 2), (4, 2), (5, 3)]


def test_fix_vis_matches_jax_train_step():
    """fix_vis: the ``frame`` group has no state and its parameters never
    move; ``frame.fc`` (group ``sound``) learns in AV steps."""
    fc0 = None
    for use_vis, pstate, pm, jstate, jm, before, params0 in run_steps(
            {"fix_vis": True}, seq=(True, False, True)):
        check_step(pstate, pm, jstate, jm, params0)
        assert pstate.opt_state["frame"] is None
        feats0 = state_dict_from_jax(params0["frame"], {})
        for k, v in pstate.nets.frame.features.state_dict().items():
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")):
                assert torch.equal(v, feats0["features." + k]), k
        fc = pstate.nets.frame.fc.weight.detach().clone()
        if fc0 is not None and use_vis:
            assert not torch.equal(fc, fc0)
        fc0 = fc


def test_mixvis_steps_match_jax_train_step():
    for _, pstate, pm, jstate, jm, _, params0 in run_steps(
            {"fusion_type": "MixVis"}, seq=(True, False)):
        check_step(pstate, pm, jstate, jm, params0)


def test_sgd_update_is_optax():
    """The update alone, on the same given gradients, three AV updates
    across an lr_steps boundary: the port's against the JAX package's
    optax chain (``make_optimizer``), to float32 rounding."""
    jcfg, cfg = configs(weight_decay=WD, lr_steps=(1,))
    _, params, stats, pnets = make_nets(cfg)
    state = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    opt = make_optimizer(jcfg, params)
    jopt = opt.init(params)
    jparams = params
    rs = np.random.RandomState(5)
    for _ in range(3):
        shapes = jax.tree_util.tree_map(lambda a: a.shape, params)
        jgrads = jax.tree_util.tree_map(
            lambda sh: jnp.asarray(rs.randn(*sh).astype(np.float32) * 1e-2),
            shapes, is_leaf=lambda x: isinstance(x, tuple))
        upd, jopt = opt.update(jgrads, jopt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        grads = {k: torch.from_numpy(v) for k, v in flat(jgrads).items()}
        train._sgd_update(cfg, state, dict(train.named_parameters(pnets)),
                          grads, True)
    want, got = flat(jparams), dict(train.named_parameters(pnets))
    for n, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=1e-6,
                                   atol=1e-8, err_msg=n)
    for g, (count, bufs) in jax_groups(jax.device_get(jopt)).items():
        assert state.opt_state[g].count == count == 3
        for n, b in state.opt_state[g].momentum.items():
            np.testing.assert_allclose(b.numpy(), bufs[n], rtol=1e-6,
                                       atol=1e-9, err_msg=n)


@pytest.mark.parametrize("lr_steps", [(2,), (1, 3), ()])
def test_lr_schedule_is_optax_piecewise_constant(lr_steps):
    jcfg, _ = configs(lr_steps=lr_steps)
    from avsep_tpu.train import _lr_schedule
    sched = _lr_schedule(1e-3, lr_steps)
    for k in range(6):
        assert train.lr_at(1e-3, lr_steps, k) == float(np.float32(sched(k)))
    assert [train.lr_at(1.0, (2,), k) for k in range(4)] == [
        1.0, 1.0, float(np.float32(0.1)), float(np.float32(0.1))]


@pytest.mark.parametrize("start_av_first,num_fsteps,iter_per_av",
                         [(True, 3, 2), (False, 3, 2), (True, 0, 2),
                          (False, 0, 3)])
def test_batch_scheduler_matches_jax(start_av_first, num_fsteps, iter_per_av):
    kw = dict(start_av_first=start_av_first, num_fsteps=num_fsteps,
              iter_per_av=iter_per_av)
    jcfg, cfg = configs(**kw)
    ours, ref = train.batch_scheduler(cfg), jbatch_scheduler(jcfg)
    assert [ours(i) for i in range(12)] == [ref(i) for i in range(12)]


def test_param_groups_follow_the_reference():
    _, cfg = configs()
    _, _, _, pnets = make_nets(cfg)
    groups = {n: train.param_group(n)
              for n, _ in train.named_parameters(pnets)}
    assert groups["frame.fc.weight"] == groups["frame.fc.bias"] == "sound"
    assert groups["frame.features.Conv_0.weight"] == "frame"
    assert all(g == "sound" for n, g in groups.items()
               if n.startswith("sound."))
    assert train.param_group("motion.layer1_0.conv1.weight") == "motion"
    with pytest.raises(ValueError):
        train.param_group("depth.conv.weight")


def test_pth_round_trip_equals_from_jax(tmp_path):
    """JAX params -> the JAX package's reference-layout export -> ``.pth``
    -> the port's loader: the same state_dicts as ``from_jax``; through
    ``init_state`` too, where a torchvision-style dict without a conv fc
    keeps the freshly initialized fc."""
    from avsep_tpu.models.torch_export import (
        resnet_to_torch, save_torch_checkpoint, unet_to_torch)
    from avsep_tpu_torch.models import torch_import
    jcfg, cfg = configs(arch_frame="resnet18dilated")
    _, params, stats, _ = make_nets(cfg)
    su, sr = tmp_path / "sound.pth", tmp_path / "frame.pth"
    save_torch_checkpoint(unet_to_torch(params["sound"], stats["sound"],
                                        num_downs=5), str(su))
    rsd = resnet_to_torch(params["frame"], stats["frame"])
    save_torch_checkpoint(rsd, str(sr))
    got_u = torch_import.unet_state_dict_from_torch(
        torch_import.load_torch_checkpoint(str(su)), num_downs=5)
    got_r = torch_import.resnet_state_dict_from_torch(
        torch_import.load_torch_checkpoint(str(sr)))
    for got, net in ((got_u, "sound"), (got_r, "frame")):
        want = state_dict_from_jax(params[net], stats[net])
        assert set(got) == set(want), net
        for k, v in want.items():
            assert torch.equal(got[k], v), k

    ckpt_cfg = cfg.replace(arch_sound="unet5", weights_sound=str(su),
                           weights_frame=str(sr))
    fresh = make_nets(cfg)[3]
    state = train.init_state(ckpt_cfg, fresh, torch.Generator().manual_seed(0),
                             device="cpu")
    for net, want in (("sound", got_u), ("frame", got_r)):
        sd = getattr(state.nets, net).state_dict()
        for k, v in want.items():
            assert torch.equal(sd[k], v), k
    # a torchvision-style dict: no conv fc
    tv = tmp_path / "tv.pth"
    save_torch_checkpoint({k: v for k, v in rsd.items()
                           if not k.startswith("fc.")}, str(tv))
    gen = torch.Generator().manual_seed(0)
    plain = train.init_state(cfg, make_nets(cfg)[3], gen, device="cpu")
    gen = torch.Generator().manual_seed(0)
    loaded = train.init_state(cfg.replace(weights_frame=str(tv)),
                              make_nets(cfg)[3], gen, device="cpu")
    assert torch.equal(loaded.nets.frame.fc.weight,
                       plain.nets.frame.fc.weight)
    assert torch.equal(loaded.nets.frame.features.conv1.weight,
                       got_r["features.conv1.weight"])


def test_checkpoint_round_trip_and_next_step_identical(tmp_path):
    _, cfg = configs()
    step = None

    def fresh(seed):
        return train.init_state(cfg, make_nets(cfg)[3],
                                torch.Generator().manual_seed(seed),
                                device="cpu")

    a = fresh(0)
    av = train.make_train_step(cfg, a.nets, True, device="cpu")
    a, _ = av(a, make_batch(20))
    checkpoint.save_checkpoint(str(tmp_path), a, {"it": [1]}, "latest")
    b = checkpoint.restore_checkpoint(str(tmp_path), fresh(1), "latest")
    assert b.step == a.step == 1
    assert checkpoint.load_history(str(tmp_path)) == {"it": [1]}
    for use_vis in (False, True):
        step = train.make_train_step(cfg, a.nets, use_vis, device="cpu")
        a, ma = step(a, make_batch(21), swap_uniforms=torch.zeros(B) + 0.3)
        step = train.make_train_step(cfg, b.nets, use_vis, device="cpu")
        b, mb = step(b, make_batch(21), swap_uniforms=torch.zeros(B) + 0.3)
        assert torch.equal(ma["err"], mb["err"])
    sa, sb = a.state_dict(), b.state_dict()
    for net in ("sound", "frame"):
        for k, v in sa[net].items():
            assert torch.equal(v, sb[net][k]), k
    for g, s in sa["opt_state"].items():
        assert s["count"] == sb["opt_state"][g]["count"]
        for k, v in s["momentum"].items():
            assert torch.equal(v, sb["opt_state"][g]["momentum"][k]), k
    with pytest.raises(ValueError, match="fix_vis"):
        fix = train.init_state(cfg.replace(fix_vis=True), make_nets(cfg)[3],
                               torch.Generator().manual_seed(0),
                               device="cpu")
        checkpoint.restore_checkpoint(str(tmp_path), fix, "latest")


def test_checkpoint_keeps_latest_and_best_by_val_si_sdr(tmp_path):
    _, cfg = configs()
    state = train.TrainState(0, make_nets(cfg)[3],
                             train.init_opt_state(cfg, make_nets(cfg)[3]))
    holder = {}
    for i, sdr in enumerate((3.0, 2.0, 5.0)):
        state.step = i
        hist = {"val_ao": {"si_sdr": [sdr]}}
        checkpoint.checkpoint(str(tmp_path), state, hist, holder)
        assert hist["best_err"] == holder["best_err"]
        best = torch.load(tmp_path / "state_best.pt", weights_only=True)
        latest = torch.load(tmp_path / "state_latest.pt", weights_only=True)
        assert latest["step"] == i
        assert best["step"] == (0 if i < 2 else 2)
    assert holder["best_err"] == -5.0


def test_what_this_slice_leaves_out_raises(monkeypatch):
    _, cfg = configs()
    nets = make_nets(cfg)[3]
    # remat is ported (tests/test_torch_remat.py): a remat step runs
    remat = cfg.replace(remat=True)
    state = train.TrainState(0, nets, train.init_opt_state(remat, nets))
    _, m = train.make_train_step(remat, nets, True, device="cpu")(
        state, make_batch(30))
    assert np.isfinite(m["err"].item())
    # the motion group is ported (tests/test_torch_clipatt.py): a motion
    # net gets its group at lr_motion
    clip_nets = nets._replace(motion=engine.build_nets(
        cfg.replace(load_clips=True), device="cpu").motion)
    groups = train.init_opt_state(cfg.replace(load_clips=True), clip_nets)
    assert set(groups) == {"sound", "frame", "motion"}
    assert set(groups["motion"].momentum) == {
        f"motion.{k}" for k, _ in clip_nets.motion.named_parameters()}
    assert train._base_lr(cfg, "motion") == cfg.lr_motion
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.init_state(cfg, nets, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.make_train_step(cfg, nets, True)


def test_frame_window_refuses_to_detach_silently():
    """The STFT kernel has no backward: an input that requires grad raises
    while grad mode is on, on every device (the CUDA launch is checked on
    the card by chip_smoke.py); under no_grad it runs."""
    from avsep_tpu_torch.ops import kernels
    padded = torch.rand(2, 1022 + 3 * 256, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.frame_window(padded, 4, 1022, 256)
    with torch.no_grad():
        assert kernels.frame_window(padded, 4, 1022, 256).shape == (2, 4,
                                                                    1022)
    assert kernels.frame_window(padded.detach(), 4, 1022, 256).shape == (
        2, 4, 1022)
