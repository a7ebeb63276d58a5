"""The live motion branch in the port (``fusion_type CoLoc_ClipAtt
--load_clips``) against the JAX package's, on the CPU: the counterpart of
tests/test_clipatt.py on its tiny nets (unet5 at ngf 8, the fast pathway
at base 1 with one block per stage, 64x64 clips of ``clip_len`` 4, B = 4;
the tiny conv encoder as the frame net, which this fusion never runs).

* AV, AO, AV steps against ``jax.jit(avsep_tpu.train.make_train_step)``
  from the same random weights (``from_jax``), the AO slot swap injected
  from the JAX draw: the loss, every parameter, every momentum buffer,
  each group's count and every running statistic.  An AV step trains
  ``sound`` and ``motion`` and leaves the frame net, the ``frame`` group's
  count and its buffers bit for bit (``frame.fc``'s buffer in group
  ``sound`` advances by its decay term alone); an AO step leaves the frame
  and motion nets and their groups bit for bit.
* The eval forward and eval step: ``att_maps`` over the motion maps'
  2 x 2 grid; the eval step reads clips, not frames.
* ``CoLoc_ClipAtt`` without ``load_clips`` raises ``ValueError``.
* remat equals the plain step bit for bit.
* The bfloat16 motion features against JAX's run op by op.
* A checkpoint round trip reproduces the next step bit for bit.
* ``main.main`` trains and scores the branch through the host pipeline.

Tolerances as tests/test_torch_train.py states them: the loss at 1e-5
relative; each momentum buffer at 1e-2 of its largest entry, floored at
1e-4 of the largest buffer; each parameter at 2e-3 of its largest change
plus 1e-6 of its value; running statistics at 1e-4 of each buffer's
largest value.  Flax runs unpatched: its E[x^2] - E[x]^2 batch variance
meets the port's two-pass one at these tolerances here, though the motion
net's last BatchNorms see 16 values per channel (B x T x 2 x 2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.engine import Nets as JNets
from avsep_tpu.models.motion import ResNet3dFastOnly as JFast
from avsep_tpu.models.resnet import TinyConvEncoder as JTinyConvEncoder
from avsep_tpu.models.unet import AudioUnet as JAudioUnet
from avsep_tpu.train import TrainState as JTrainState
from avsep_tpu.train import make_optimizer, make_train_step as jmake_step
from avsep_tpu_torch import checkpoint, engine, evaluate, train
from avsep_tpu_torch.models.from_jax import load_from_jax
from avsep_tpu_torch.models.motion import ResNet3dFastOnly
from avsep_tpu_torch.models.resnet import TinyConvEncoder
from avsep_tpu_torch.models.unet import AudioUnet
from tests.test_dataset import manifest  # noqa: F401 (fixture)
from tests.test_torch_forward import configs, make_batch
from tests.test_torch_models import random_variables
from tests.test_torch_train import check_step

B = 4
NETS = ("sound", "frame", "motion")
CLIP = dict(fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=4,
            lr_motion=1e-2, weight_decay=0.05)


def clip_configs(**kw):
    return configs(**{**CLIP, **kw})


def nets_of(cfg, jdtype=jnp.float32, pdtype=torch.float32):
    fusion = dict(fc_dim=2, num_downs=5, ngf=8, fusion_type=cfg.fusion_type,
                  att_type=cfg.att_type)
    jnets = JNets(JAudioUnet(**fusion, dtype=jdtype),
                  JTinyConvEncoder(fc_dim=32, pool_type="maxpool"),
                  JFast(base_channels=1, stage_blocks=(1, 1, 1, 1),
                        dtype=jdtype))
    pnets = engine.Nets(AudioUnet(**fusion, dtype=pdtype),
                        TinyConvEncoder(32, "maxpool"),
                        ResNet3dFastOnly(base_channels=1,
                                         stage_blocks=(1, 1, 1, 1),
                                         dtype=pdtype))
    return jnets, pnets


def variables(jnets, seed=0):
    rs = np.random.RandomState(seed)
    sv = random_variables(jnets.sound, rs, jnp.zeros((1, 256, 64, 1)),
                          jnp.zeros((2, 1, 2, 2, 32)), train=False)
    fv = random_variables(jnets.frame, rs, jnp.zeros((1, 64, 64, 3)),
                          pool=False, train=False)
    mv = random_variables(jnets.motion, rs, jnp.zeros((1, 4, 64, 64, 3)),
                          train=False)
    return ({"sound": sv["params"], "frame": fv["params"],
             "motion": mv["params"]},
            {"sound": sv["batch_stats"], "frame": fv["batch_stats"],
             "motion": mv["batch_stats"]})


def clip_batch(seed):
    batch = make_batch(seed, B=B)
    rs = np.random.RandomState(100 + seed)
    batch["clips"] = rs.randint(0, 256, (B, 2, 4, 64, 64, 3)).astype(
        np.uint8)
    return batch


def _snapshot(pstate, net):
    return ({k: v.clone() for k, v in
             getattr(pstate.nets, net).state_dict().items()},
            pstate.opt_state[net].count,
            {k: v.clone() for k, v in pstate.opt_state[net].momentum.items()})


def _unchanged(pstate, net, snap):
    sd, count, bufs = snap
    now = getattr(pstate.nets, net).state_dict()
    return (all(torch.equal(v, now[k]) for k, v in sd.items())
            and pstate.opt_state[net].count == count
            and all(torch.equal(v, pstate.opt_state[net].momentum[k])
                    for k, v in bufs.items()))


def test_steps_match_jax_train_step():
    """AV, AO, AV against the JAX train step; the frozen nets bit for
    bit."""
    jcfg, cfg = clip_configs()
    jnets, pnets = nets_of(cfg)
    params, stats = variables(jnets)
    load_from_jax(pnets, params, stats)
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, stats,
                         make_optimizer(jcfg, params).init(params))
    pstate = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    jsteps = {v: jmake_step(jcfg, jnets, v) for v in (True, False)}
    psteps = {v: train.make_train_step(cfg, pnets, v, device="cpu")
              for v in (True, False)}
    for i, use_vis in enumerate((True, False, True)):
        batch = clip_batch(i)
        rng = jax.random.PRNGKey(10 + i)
        frame = _snapshot(pstate, "frame")
        motion = _snapshot(pstate, "motion")
        fc_buf = {k: v.clone() for k, v in
                  pstate.opt_state["sound"].momentum.items()
                  if k.startswith("frame.fc.")}
        jstate, jm = jsteps[use_vis](
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        jstate = jax.device_get(jstate)
        u = torch.from_numpy(np.array(jax.random.uniform(rng, (B,))))
        pstate, pm = psteps[use_vis](pstate, batch, swap_uniforms=u)
        check_step(pstate, pm, jstate, jm, params, nets=NETS)
        assert np.isfinite(pm["err"].item())
        assert _unchanged(pstate, "frame", frame)
        assert _unchanged(pstate, "motion", motion) == (not use_vis)
        fc = dict(pnets.frame.fc.named_parameters())
        for k, buf in fc_buf.items():
            want = buf * cfg.beta1 + fc[k[len("frame.fc."):]].detach() * \
                cfg.weight_decay
            torch.testing.assert_close(
                pstate.opt_state["sound"].momentum[k], want, rtol=1e-6,
                atol=1e-9)
    assert {g: s.count for g, s in pstate.opt_state.items()} == \
        {"sound": 3, "frame": 0, "motion": 2}


def test_eval_forward_and_step_att_maps():
    _, cfg = clip_configs()
    jnets, pnets = nets_of(cfg)
    load_from_jax(pnets, *variables(jnets))
    batch = clip_batch(3)
    err, out = engine.forward(pnets, batch, cfg, True, train=False)
    assert np.isfinite(err.item())
    assert out["att_maps"] is not None and \
        tuple(out["att_maps"].shape[-2:]) == (2, 2)
    # the eval step reads the clips and never the frames
    dev_batch = engine.to_device(batch, torch.device("cpu"),
                                 drop=engine.unused_visual_streams(cfg))
    assert "frames" not in dev_batch and "clips" in dev_batch
    L = cfg.stft_hop * (cfg.WS - 1)
    metrics, outputs, wavs = evaluate.make_eval_step(
        cfg, pnets, True, device="cpu")(
        dev_batch, noise_uniforms=torch.rand(B, 2, L,
                                             generator=torch.Generator()))
    assert tuple(outputs["att_maps"].shape[-2:]) == (2, 2)
    assert all(np.isfinite(metrics[k].numpy()).all()
               for k in ("sdr", "si_sdr", "perm_correct"))


def test_clipatt_requires_load_clips():
    _, cfg = clip_configs(load_clips=False)
    with pytest.raises(ValueError, match="load_clips"):
        engine.build_nets(cfg, device="cpu")
    _, cfg = clip_configs()
    nets = engine.build_nets(cfg.replace(arch_frame="tinyconv"),
                             device="cpu")
    assert isinstance(nets.motion, ResNet3dFastOnly)
    assert nets.motion.out_features == 256
    assert engine.build_nets(cfg.replace(load_clips=False,
                                         fusion_type="hidsep"),
                             device="cpu").motion is None


def _av_step(cfg, seed=0):
    jnets, pnets = nets_of(cfg)
    load_from_jax(pnets, *variables(jnets))
    state = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    step = train.make_train_step(cfg, pnets, True, device="cpu")
    state, m = step(state, clip_batch(seed))
    return state, m


def test_remat_equals_plain_step():
    _, cfg = clip_configs()
    plain, m0 = _av_step(cfg)
    remat, m1 = _av_step(cfg.replace(remat=True))
    assert torch.equal(m0["err"], m1["err"])
    a, b = plain.state_dict(), remat.state_dict()
    for net in NETS:
        for k, v in a[net].items():
            assert torch.equal(v, b[net][k]), (net, k)
    for g, s in a["opt_state"].items():
        for k, v in s["momentum"].items():
            assert torch.equal(v, b["opt_state"][g]["momentum"][k]), k


def test_bf16_motion_features_match_jax_bf16():
    """The port's bfloat16 motion features (the motion net in train mode,
    the mean over time, the ReLU: ``engine._motion_features``) against
    JAX's run op by op (see tests/test_torch_bf16.py for why not under
    jit), on the same weights and clip: as close to JAX-bf16 as JAX-bf16 is
    to JAX-f32 (mean |Δ| over the maps' largest value), the parameters
    float32.  The rest of the bfloat16 AV step is the U-Net's, held in
    tests/test_torch_bf16.py."""
    _, cfg = clip_configs()
    j32, _ = nets_of(cfg)
    j16, pnets = nets_of(cfg, jnp.bfloat16, torch.bfloat16)
    params, stats = variables(j32)
    load_from_jax(pnets, params, stats)
    clips = clip_batch(5)["clips"][:, 0]
    x = jnp.asarray(engine.normalize_frames(torch.from_numpy(clips)).numpy())

    def jax_maps(net):
        feats, _ = net.apply({"params": params["motion"],
                              "batch_stats": stats["motion"]}, x,
                             train=True, mutable=["batch_stats"])
        return np.asarray(jax.nn.relu(jnp.mean(feats, axis=1)), np.float32)

    m32 = jax_maps(j32.motion)
    with jax.disable_jit():
        m16 = jax_maps(j16.motion)
    pnets.motion.train()
    got = engine._motion_features(pnets, torch.from_numpy(clips),
                                  cfg.replace(dtype="bfloat16"))
    assert got.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in pnets.motion.parameters())
    got = got.float().detach().numpy()
    scale = np.abs(m32).max()
    d_port = np.abs(got - m16).mean() / scale
    d_jax = np.abs(m16 - m32).mean() / scale
    assert 0 < d_jax < 2e-2
    assert d_port <= d_jax, (d_port, d_jax)


def test_checkpoint_round_trip(tmp_path):
    """The motion net, its statistics and the ``motion`` group survive a
    save and a restore; the next step from the restored state equals the
    next step from the live one bit for bit."""
    _, cfg = clip_configs()
    state, _ = _av_step(cfg)
    checkpoint.save_checkpoint(str(tmp_path), state, {"x": 1})
    template, _ = _av_step(cfg, seed=7)
    restored = checkpoint.restore_checkpoint(str(tmp_path), template)
    assert restored.opt_state["motion"].count == 1
    batch = clip_batch(9)
    outs = []
    for st in (state, restored):
        st, m = train.make_train_step(cfg, st.nets, True, device="cpu")(
            st, batch)
        outs.append((m["err"], st.state_dict()))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1]["motion"].items():
        assert torch.equal(v, outs[1][1]["motion"][k]), k
    for k, v in outs[0][1]["opt_state"]["motion"]["momentum"].items():
        assert torch.equal(
            v, outs[1][1]["opt_state"]["motion"]["momentum"][k]), k


def test_main_trains_and_scores_the_clips_branch(manifest, tmp_path,  # noqa: F811
                                                  capsys):
    """``main.main`` in train mode with ``--fusion_type CoLoc_ClipAtt
    --load_clips --frame_decode native`` on the CPU, through the host
    pipeline (clips decoded by the C++ route): iterations 1 (AV) and 2
    (AO), an eval tick at 2 with a finite results.csv row per clip in each
    branch, and a checkpoint holding the motion net and its group."""
    from avsep_tpu_torch import main as pmain
    from tests.test_torch_cli import results_rows, toy_cfg, two_row_manifest
    cfg = toy_cfg(manifest, tmp_path / "ckpt", num_iters=3, workers=0,
                  list_val=(two_row_manifest(manifest, tmp_path),),
                  fusion_type="CoLoc_ClipAtt", load_clips=True, clip_len=4,
                  frame_decode="native")
    pmain.main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "Frame decode: native (--frame_decode native)" in out
    assert "Training Done!" in out
    run = tmp_path / "ckpt" / "toy"
    for branch in ("av", "ao"):
        rows = results_rows(run, branch)
        assert len(rows) == 3 and "nan" not in "".join(rows)
    sd = torch.load(run / "state_latest.pt", weights_only=True)
    assert sd["opt_state"]["motion"]["count"] == 1
    assert "layer4_2.bn3.running_var" in sd["motion"]
