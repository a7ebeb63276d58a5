"""The port's SoP++ training (avsep_tpu_torch/sop_main.py, the SGD groups
of train.py) against the JAX package's, on the CPU, with the same weights
(``from_jax.load_sop_from_jax``): train steps through the 3-stage
curriculum against ``jax.jit(make_sop_train_step)``, the groups, the
``.pth`` loaders, what raises, and ``sop_main.main`` train then eval.

Size, weights and tolerances as tests/test_torch_sop.py states them.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.sop_main import make_sop_optimizer, make_sop_train_step
from avsep_tpu.train import TrainState as JTrainState
from avsep_tpu_torch import checkpoint, sop_main, train
from avsep_tpu_torch.config import Config
from avsep_tpu_torch.models import sop as psop
from avsep_tpu_torch.models.from_jax import state_dict_from_jax
from tests.test_dataset import manifest  # noqa: F401 (fixture)
from tests.test_torch_sop import (
    C, SMALL, WD, configs, flat, make_batch, make_nets, rel)
from tests.test_torch_train import check_step


# ------------------------------------------------------------ train steps


def test_train_steps_match_jax_through_the_curriculum():
    """AV stage 1, AO, AV stage 2, AV stage 3 from one state, against
    ``jax.jit(make_sop_train_step)``, across an lr_steps boundary of groups
    ``sound`` and ``synth``.  An AO step leaves the frame net (``frame.fc`` too) and the
    ``frame`` group bit for bit, while ``frame.fc``'s buffer in group
    ``sound`` becomes ``beta1 * buf + wd * p`` exactly.  Stage 2 and 3 run
    the frame net on the sources in eval mode: only the duet image's
    statistics update, and the net is back in train mode after."""
    jcfg, cfg = configs()
    jnets, params, stats, pnets = make_nets()
    jstate = JTrainState(jnp.zeros((), jnp.int32), params, stats,
                         make_sop_optimizer(jcfg, params).init(params))
    pstate = train.TrainState(0, pnets, train.init_opt_state(cfg, pnets))
    seq = ((True, 1), (False, 1), (True, 2), (True, 3))
    jsteps, psteps = {}, {}
    for i, key in enumerate(seq):
        if key not in jsteps:
            jsteps[key] = make_sop_train_step(jcfg, jnets, *key)
            psteps[key] = sop_main.make_sop_train_step(cfg, pnets, *key,
                                                       device="cpu")
        batch = make_batch(10 + i)
        frame_before = {k: v.clone()
                        for k, v in pnets.frame.state_dict().items()}
        fc_buf = {k: v.clone() for k, v in
                  pstate.opt_state["sound"].momentum.items()
                  if k.startswith("frame.fc.")}
        frame_group = pstate.opt_state["frame"]
        frame_bufs = {k: v.clone() for k, v in frame_group.momentum.items()}
        frame_count = frame_group.count
        jstate, jm = jsteps[key](jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 jax.random.PRNGKey(i))
        jstate = jax.device_get(jstate)
        pstate, pm = psteps[key](pstate, batch)
        check_step(pstate, pm, jstate, jm, params, flat=flat)
        assert rel(pm["match_loss"].item(), float(jm["match_loss"])) < 1e-5 \
            or abs(float(jm["match_loss"])) < 1e-12
        assert pnets.frame.training
        if not key[0]:
            for k, v in pnets.frame.state_dict().items():
                assert torch.equal(v, frame_before[k]), k
            assert frame_group.count == frame_count
            for k, v in frame_group.momentum.items():
                assert torch.equal(v, frame_bufs[k]), k
            fc = dict(pnets.frame.fc.named_parameters())
            for k, buf in fc_buf.items():
                p = fc[k[len("frame.fc."):]].detach()
                want = buf * cfg.beta1 + p * WD
                torch.testing.assert_close(
                    pstate.opt_state["sound"].momentum[k], want,
                    rtol=1e-6, atol=1e-9)
                assert not torch.equal(pstate.opt_state["sound"].momentum[k],
                                       buf), k
    counts = {g: s.count for g, s in pstate.opt_state.items()}
    assert counts == {"sound": 4, "synth": 4, "frame": 3}


def test_sop_groups_and_fix_vis():
    _, cfg = configs()
    _, _, _, pnets = make_nets()
    groups = {n: train.param_group(n)
              for n, _ in train.named_parameters(pnets)}
    assert groups["frame.fc.weight"] == "sound"
    assert groups["synthesizer.scale"] == groups["synthesizer.bias"] == \
        "synth"
    assert groups["frame.features.Conv_0.weight"] == "frame"
    st = train.init_opt_state(cfg.replace(fix_vis=True), pnets)
    assert st["frame"] is None and set(st) == {"sound", "synth", "frame"}
    assert train._base_lr(cfg, "synth") == cfg.lr_synthesizer


def test_synthesizer_pth_round_trip_and_init_sop_state(tmp_path):
    from avsep_tpu.models.torch_export import (
        save_torch_checkpoint, synthesizer_to_torch, unet_to_torch)
    _, cfg = configs(arch_frame="resnet18dilated")
    _, params, stats, _ = make_nets()
    su, ss = tmp_path / "sound.pth", tmp_path / "synth.pth"
    save_torch_checkpoint(unet_to_torch(params["sound"], stats["sound"],
                                        num_downs=5), str(su))
    save_torch_checkpoint(synthesizer_to_torch(params["synthesizer"]),
                          str(ss))
    big = cfg.replace(num_channels=C, vis_channels=C)
    nets = sop_main.build_sop_nets(big, device="cpu")
    nets = nets._replace(sound=psop.BasisUnet(fc_dim=C, num_downs=5, ngf=8,
                                              extra_size=C))
    state = sop_main.init_sop_state(
        big.replace(weights_sound=str(su), weights_synthesizer=str(ss)),
        nets, torch.Generator().manual_seed(0), device="cpu")
    want = state_dict_from_jax(params["sound"], stats["sound"])
    for k, v in state.nets.sound.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in state.nets.synthesizer.state_dict().items():
        assert np.array_equal(v.numpy(), params["synthesizer"][k]), k
    # seeded: the same generator seed gives the same frame net
    again = sop_main.init_sop_state(
        big, sop_main.build_sop_nets(big, device="cpu")._replace(
            sound=psop.BasisUnet(fc_dim=C, num_downs=5, ngf=8,
                                 extra_size=C)),
        torch.Generator().manual_seed(0), device="cpu")
    for k, v in again.nets.frame.state_dict().items():
        assert torch.equal(v, state.nets.frame.state_dict()[k]), k
    assert not state.nets.sound.training


def test_sop_entry_points_raise_without_a_gpu(monkeypatch):
    _, cfg = configs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sop_main.build_sop_nets(cfg)
    nets = make_nets()[3]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sop_main.init_sop_state(cfg, nets, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sop_main.make_sop_train_step(cfg, nets, True, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sop_main.main(cfg)


# ---------------------------------------------------------------- the CLI


def test_sop_main_trains_then_evaluates(manifest, tmp_path,  # noqa: F811
                                        capsys):
    """``sop_main.main(cfg, device="cpu")``: iterations 1 to 4, AV at
    stages 1, 2 and 3 and one AO step (``batch_scheduler``,
    ``stage_for_iter``), an eval and a checkpoint at 4; then eval mode,
    restoring ``best``."""
    cfg = Config(**{**SMALL, "arch_frame": "resnet18dilated",
                    "num_channels": 4, "vis_channels": 4, "imgSize": 48,
                    "audLen": 8191},
                 id="sop", ckpt=str(tmp_path), mode="train",
                 av_list_train=(manifest,), ao_list_train=(manifest,),
                 list_val=(manifest,), batch_size_per_gpu=2, workers=0,
                 num_iters=5, eval_iter=4, disp_iter=1, train_repeat=1,
                 val_repeat=1, num_vis=0, margin=1.0, train_steps=(2, 4, 5),
                 start_av_first=True, num_fsteps=2, iter_per_av=2)
    sop_main.main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "Training Done!" in out
    for stage in (0, 1, 2, 3):
        assert f"stage: {stage}," in out, stage
    run = os.path.join(str(tmp_path), "sop")
    for f in ("state_latest.pt", "state_best.pt", "history_latest.json"):
        assert os.path.exists(os.path.join(run, f)), f
    hist = checkpoint.load_history(run)
    assert hist["val_av"]["iter"] == hist["val_ao"]["iter"] == [4]
    for branch in ("sop_av", "sop_ao"):
        with open(os.path.join(run, "visualization", branch,
                               "results.csv")) as f:
            rows = f.read().strip().splitlines()
        assert len(rows) == 1 + 6                  # header + 6 val clips
    saved = torch.load(os.path.join(run, "state_best.pt"), weights_only=True)
    assert set(saved) == {"step", "sound", "frame", "synthesizer",
                          "opt_state"}
    assert saved["step"] == 4

    sop_main.main(cfg.replace(mode="eval"), device="cpu")
    out = capsys.readouterr().out
    assert "Evaluation Done!" in out and "WARNING" not in out
    assert "[SoP++ Eval] val_av iter 0" in out
