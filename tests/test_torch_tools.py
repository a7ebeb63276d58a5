"""The port's proof and checkpoint tools (``avsep_tpu_torch/tools/``)
against the JAX package's, on the CPU.

Sizes: the toy AV recipe of scripts/train_toy_av_proof.sh cut to unet5 and
the tiny conv encoder (the export: the dilated ResNet18), both at the
recipe's 256 visual channels, SoP++ at unet5 with the dilated ResNet18 at
32 channels, 16383 samples, 64x64 frames, B = 2, on a class-token set of
4 classes x 2 videos of 4 s built by ``tools.make_synthetic_data``; the val split is the
4 videos numbered 1.  Both packages start from one JAX ``init_state``
(``init_sop_state``), its values drawn in their shapes so that the
attention is not flat: the JAX side saved with
``avsep_tpu.checkpoint.save_checkpoint``, the port's through
``models/from_jax.py`` and the port's ``save_checkpoint``.

Tolerances, each stated where it is used:

* The set: every wav and jpg equal byte for byte; ``train.csv`` and
  ``tokens.json`` equal, both sets built at the same root one after the
  other.
* The probes: the JAX tools draw the AO slot swap and the noise floor from
  a JAX key; the port's tools take those draws injected (``draws=``), so
  both score the same randomness (with binary masks, the toy recipe's, the
  noise floor may fire on a random network).  The inputs of every
  decision are compared first: the per-sample losses at 1e-5 relative
  (tests/test_torch_forward.py), the attention maps at 1e-5 absolute
  (sigmoids of O(1)), the quadrant means at 1e-5, the SI-SDR at 1e-3 dB
  (tests/test_torch_evaluate.py).  A decision whose margin (the gap
  between the two losses, the two largest cells, the two largest
  quadrants, the two SI-SDRs) exceeds twice its tolerance must come out
  the same in both packages; the counts of the reports are held exactly
  when every margin does, and otherwise within the number of decisions
  whose margin does not.  At these sizes every margin of the AV probe's 20
  decisions exceeds its tolerance (asserted); of the SoP++ probe's 8, the
  4 loss comparisons do and one of the 4 SI-SDR comparisons does not (the
  swap moves that sample's SI-SDR by less than 2e-3 dB), so
  ``assign_acc_sisdr`` is held within one sample.  ``mass_confusion`` is
  held exactly under the same rule, ``mean_mass_on_token`` at 1e-5, every
  SI-SDR / SDR of the reports within 1e-3 dB.
* The JAX tools build their template state with ``init_state``, which on
  the CPU runs the U-Net's init op by op (20 s); the tests hand them the
  state they restore into instead (the same tree).
* The export: the ``.pth`` files of both tools equal key for key and bit
  for bit (the export renames; it computes nothing), but for the shape of
  ``num_batches_tracked``: ``[1]`` in the JAX tool's files (its
  ``np.ascontiguousarray`` of a scalar), ``[]`` in the port's (BatchNorm's
  own; torch's strict ``load_state_dict`` takes either).
* The schedule proof: every invariant at a compressed shape; the
  resume-after-decay case bit for bit against the unbroken trajectory.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu import sop_main as jsop_main
from avsep_tpu import train as jtrain
from avsep_tpu.checkpoint import save_checkpoint as jsave_checkpoint
from avsep_tpu.config import parse_args as jparse_args
from avsep_tpu.engine import build_nets as jbuild_nets
from avsep_tpu.engine import forward as jforward
from avsep_tpu.models import criterion as jcrit
from avsep_tpu.sop_main import build_sop_nets as jbuild_sop_nets
from avsep_tpu.sop_main import init_sop_state as jinit_sop_state
from avsep_tpu.sop_main import make_sop_eval_step as jmake_sop_eval_step
from avsep_tpu.train import init_state as jinit_state
from avsep_tpu.utils.meters import new_history as jnew_history
from avsep_tpu_torch import checkpoint, engine, sop_main
from avsep_tpu_torch import train as ptrain
from avsep_tpu_torch.config import parse_args
from avsep_tpu_torch.data.dataset import MusicMixDataset
from avsep_tpu_torch.data.loader import BatchLoader
from avsep_tpu_torch.models.from_jax import load_from_jax, load_sop_from_jax
from avsep_tpu_torch.tools import (
    av_probe, export_reference_ckpt, make_synthetic_data, schedule_proof,
    sop_probe)
from avsep_tpu_torch.utils.meters import new_history
from tests.test_torch_evaluate import jax_draws
from tests.test_torch_forward import configs, make_batch, make_nets

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, L = 2, 16383
WAV = L - L % 256                       # the iSTFT's length
LOSS_RTOL, ATT_TOL, DB_TOL = 1e-5, 1e-5, 1e-3

SET_FLAGS = ["--classes", "cello", "flute", "violin", "trumpet",
             "--videos_per_class", "2", "--duration", "4", "--fps", "8"]
SMALL = ["--audLen", str(L), "--imgSize", "64", "--batch_size_per_gpu",
         str(B), "--num_gpus", "1", "--workers", "0", "--val_repeat", "1",
         "--num_vis", "0", "--mode", "eval"]
# the toy AV recipe's flags (scripts/train_toy_av_proof.sh), cut to size
AV = ["--arch_sound", "unet5", "--arch_frame", "tinyconv",
      "--arch_synthesizer", "linear", "--num_channels", "2",
      "--vis_channels", "256", "--fusion_type", "hidsep", "--att_type",
      "sig", "--not_pool_vis", "--img_pool", "maxpool", "--img_activation",
      "relu", "--output_activation", "sigmoid", "--loss", "bce",
      "--binary_mask", "1", "--weighted_loss", "1", "--mask_thres", "0.5",
      "--num_mix", "2", "--log_freq", "1", "--match_weight", "0.1",
      "--one_frame", "--margin", "1", "--rate_dc", "1"] + SMALL
# the toy SoP++ recipe's (scripts/train_toy_sop_proof.sh), cut to size
SOP = ["--arch_sound", "unet5", "--arch_frame", "resnet18dilated",
       "--arch_synthesizer", "linear", "--num_channels", "32",
       "--vis_channels", "32", "--fusion_type", "Base", "--att_type", "cos",
       "--not_pool_vis", "--img_pool", "maxpool", "--img_activation",
       "relu", "--sound_activation", "no", "--output_activation", "sigmoid",
       "--loss", "bce", "--binary_mask", "1", "--weighted_loss", "1",
       "--mask_thres", "0.5", "--num_mix", "2", "--log_freq", "1",
       "--match_weight", "0.1", "--one_frame", "--margin", "1",
       "--rate_dc", "1", "--lr_synthesizer", "1e-3"] + SMALL


def build_set(root, *flags):
    make_synthetic_data.main(["--root", str(root), *SET_FLAGS, *flags])


def files_of(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("flags", [
    ["--class_tokens", "--shared_background"],
    ["--layout", "reference", "--duets", "1", "--class_tokens"]],
    ids=["flat-shared-bg", "reference-duets"])
def test_make_synthetic_data_matches_the_example(tmp_path, monkeypatch,
                                                 flags):
    """The example and the port's generator, with the same flags, at the
    same root one after the other: the same files, byte for byte."""
    from examples import make_synthetic_data as jexample
    root = tmp_path / "set"
    monkeypatch.setattr(sys, "argv", ["make_synthetic_data.py", "--root",
                                      str(root), *SET_FLAGS, *flags])
    jexample.main()
    root.rename(tmp_path / "jax")
    build_set(root, *flags)
    names = files_of(root)
    assert names == files_of(tmp_path / "jax")
    assert any(n.endswith(".wav") for n in names)
    assert any(n.endswith(".jpg") for n in names)
    assert "tokens.json" in names and "train.csv" in names
    for name in names:
        with open(root / name, "rb") as f, \
                open(tmp_path / "jax" / name, "rb") as g:
            assert f.read() == g.read(), name
    with open(root / "tokens.json") as f:
        assert all(k.startswith(str(root)) for k in json.load(f))


@pytest.fixture(scope="module")
def toy_set(tmp_path_factory):
    """A class-token set and its val split (the videos numbered 1)."""
    root = tmp_path_factory.mktemp("toy")
    build_set(root, "--class_tokens")
    rows = [r for r in (root / "train.csv").read_text().splitlines() if r]
    val = [r for r in rows if r.split(",")[0].endswith("1.wav")]
    (root / "val.csv").write_text("\n".join(val) + "\n")
    return root


FC_SCALE = 0.03


def jax_state(init, seed=0):
    """A JAX train state in the tree of ``init()`` (``init_state`` or
    ``init_sop_state``, traced with ``jax.eval_shape``, not run): the step,
    the group counts and the momentum at 0, as ``init`` leaves them, and
    every parameter and statistic drawn in its shape (He-scaled kernels,
    BN scales near 1, statistics away from (0, 1), as
    tests/test_torch_models.py draws them), the frame net's last projection
    at ``FC_SCALE`` of that.  At these sizes an ``init_state``'s own
    attention logits are all 0 and He-scaled ones saturate the sigmoid:
    either way every pointing decision is a tie.  At 0.03 the maps lie in
    0.55 to 0.85 and every top-two gap exceeds 1e-3."""
    rs = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rs.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * rs.randn(*s.shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, s.shape)
        else:                      # bias, mean
            v = 0.1 * rs.randn(*s.shape)
        return jax.numpy.asarray(v.astype(np.float32))

    shapes = jax.eval_shape(init)
    params = jax.tree_util.tree_map_with_path(fill, shapes.params)
    params["frame"]["fc"] = {k: v * FC_SCALE
                             for k, v in params["frame"]["fc"].items()}
    return jax.tree_util.tree_map(
        lambda s: jax.numpy.zeros(s.shape, s.dtype), shapes)._replace(
            params=params, batch_stats=jax.tree_util.tree_map_with_path(
                fill, shapes.batch_stats))


def two_checkpoints(tmp, argv, sop=False):
    """One JAX state (:func:`jax_state`), saved by each package: returns
    (JAX cfg, JAX nets, JAX state, port cfg)."""
    jcfg = jparse_args(argv + ["--ckpt", str(tmp / "jax")])
    cfg = parse_args(argv + ["--ckpt", str(tmp / "port")])
    rng = jax.random.PRNGKey(cfg.seed)
    if sop:
        jnets = jbuild_sop_nets(jcfg)
        jstate = jax_state(lambda: jinit_sop_state(jcfg, jnets, rng))
        state = sop_main.init_sop_state(
            cfg, sop_main.build_sop_nets(cfg, device="cpu"),
            torch.Generator().manual_seed(0), device="cpu")
        load_sop_from_jax(state.nets, jstate.params, jstate.batch_stats)
    else:
        jnets = jbuild_nets(jcfg)
        jstate = jax_state(lambda: jinit_state(jcfg, jnets, rng))
        state = ptrain.init_state(cfg, engine.build_nets(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        load_from_jax(state.nets, jstate.params, jstate.batch_stats)
    for c in (jcfg, cfg):
        os.makedirs(os.path.join(c.ckpt, c.id))
    jsave_checkpoint(os.path.join(jcfg.ckpt, jcfg.id), jstate,
                     jnew_history(), "best")
    checkpoint.save_checkpoint(os.path.join(cfg.ckpt, cfg.id), state,
                               new_history(), "best")
    return jcfg, jnets, jstate, cfg


def val_batches(cfg):
    """The probes' val batches (the datasets of both packages give them
    bit for bit, tests/test_torch_data.py)."""
    return list(BatchLoader(MusicMixDataset(cfg.list_val[0], cfg,
                                            split="val"),
                            cfg.batch_size, shuffle=False, num_workers=2))


def host(batch):
    return {k: v for k, v in batch.items()
            if isinstance(v, np.ndarray) and v.dtype != object
            and k != "audio_mix"}


def margin_ok(a, b, tol):
    return np.abs(np.asarray(a) - np.asarray(b)) > 2 * tol


def top2_gap(x, axis=-1):
    s = np.sort(x, axis=axis)
    return np.take(s, -1, axis=axis) - np.take(s, -2, axis=axis)


def close_count(got, want, unsure):
    assert abs(got - want) <= unsure, (got, want, unsure)
    if unsure == 0:
        assert got == want


@pytest.fixture(scope="module")
def av_reports(toy_set, tmp_path_factory):
    from tools.av_probe import run_probe as jrun_probe
    tmp = tmp_path_factory.mktemp("av_probe")
    argv = AV + ["--id", "probe", "--list_val", str(toy_set / "val.csv")]
    jcfg, jnets, jstate, cfg = two_checkpoints(tmp, argv)
    tokens = str(toy_set / "tokens.json")
    batches = val_batches(cfg)
    draws = jax_draws(cfg.seed, len(batches), B, (B, 2, WAV))
    with pytest.MonkeyPatch.context() as mp:
        # the tool's template: the same tree, without init's run
        mp.setattr(jtrain, "init_state", lambda *a, **k: jstate)
        jreport = jrun_probe(jcfg, tokens, tag="best")
    return dict(jax=jreport,
                port=av_probe.run_probe(cfg, tokens, tag="best",
                                        device="cpu", draws=draws),
                jcfg=jcfg, jnets=jnets, jstate=jstate, cfg=cfg,
                batches=batches, tokens=tokens)


def test_av_probe_matches_jax(av_reports):
    """The decisions' inputs batch by batch, then the two reports."""
    r = av_reports
    cfg, jstate = r["cfg"], r["jstate"]
    with open(r["tokens"]) as f:
        tokens = json.load(f)
    nets = checkpoint.restore_checkpoint(
        os.path.join(cfg.ckpt, cfg.id),
        ptrain.init_state(cfg, engine.build_nets(cfg, device="cpu"),
                          torch.Generator(), device="cpu"), "best").nets
    jcfg, jnets = r["jcfg"], r["jnets"]

    @jax.jit
    def jax_outputs(params, stats, dev):
        _, (_, out) = jforward(jnets, params, stats, dev, jcfg, None,
                               use_vis=True, train=False)
        ps = jax.numpy.moveaxis(out["pred_masks"], 1, 0)
        gts = jax.numpy.moveaxis(out["gt_masks"], 1, 0)
        return (jcrit.multi_source_loss(ps, gts, out["weight"],
                                        kind=jcfg.loss, per_sample=True),
                jcrit.multi_source_loss(ps, gts[::-1], out["weight"],
                                        kind=jcfg.loss, per_sample=True),
                out["att_maps"])

    unsure_perm = unsure_point = unsure_mass = 0
    for batch in r["batches"]:
        want = [np.asarray(x) for x in jax_outputs(
            jstate.params, jstate.batch_stats,
            {k: jax.numpy.asarray(v) for k, v in host(batch).items()})]
        got = av_probe.probe_outputs(
            nets, engine.to_device(batch, torch.device("cpu"), cfg=cfg),
            cfg)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)
        np.testing.assert_allclose(got[2], want[2], atol=ATT_TOL)
        d_got, d_want = av_probe.decisions(*got), av_probe.decisions(*want)
        np.testing.assert_allclose(d_got[2], d_want[2], atol=ATT_TOL)
        sure = margin_ok(want[0], want[1], LOSS_RTOL * np.abs(want[0]))
        assert (d_got[0] == d_want[0])[sure].all()
        unsure_perm += int((~sure).sum())
        Bn, C, h, w = want[2].shape
        sure = top2_gap(want[2].reshape(Bn, C, h * w)) > 2 * ATT_TOL
        assert (d_got[1] == d_want[1])[sure].all()
        unsure_point += int((~sure).sum())
        sure = top2_gap(d_want[2]) > 2 * ATT_TOL
        assert (d_got[2].argmax(-1) == d_want[2].argmax(-1))[sure].all()
        unsure_mass += int((~sure).sum())
        assert all(tokens[os.path.abspath(info[1])]["quadrant"] in range(4)
                   for infos in batch["infos"] for info in infos)

    jrep, prep = r["jax"], r["port"]
    assert set(prep) == set(jrep)
    assert prep["perm_n"] == jrep["perm_n"] == 4
    assert prep["pointing_n"] == jrep["pointing_n"] == 2 * prep["perm_n"]
    close_count(prep["perm_acc"] * 4, jrep["perm_acc"] * 4, unsure_perm)
    close_count(prep["pointing_acc"] * 8, jrep["pointing_acc"] * 8,
                unsure_point)
    close_count(prep["pointing_mass_acc"] * 8,
                jrep["pointing_mass_acc"] * 8, unsure_mass)
    if unsure_mass == 0:
        assert prep["mass_confusion"] == jrep["mass_confusion"]
    assert abs(prep["mean_mass_on_token"] - jrep["mean_mass_on_token"]) \
        <= 1e-5
    assert prep["mass_on_token_uniform"] == 0.25
    for k in ("av_si_sdr", "av_sdr", "ao_si_sdr", "ao_sdr"):
        assert np.isfinite(prep[k]) and abs(prep[k] - jrep[k]) <= DB_TOL, k
    # at this size every margin exceeded its tolerance
    assert unsure_perm == unsure_point == unsure_mass == 0
    with open(os.path.join(cfg.ckpt, cfg.id, "av_probe.json")) as f:
        assert json.load(f) == prep


@pytest.fixture(scope="module")
def sop_reports(toy_set, tmp_path_factory):
    from tools.sop_probe import run_probe as jrun_probe
    tmp = tmp_path_factory.mktemp("sop_probe")
    argv = SOP + ["--id", "sop", "--list_val", str(toy_set / "val.csv")]
    jcfg, jnets, jstate, cfg = two_checkpoints(tmp, argv, sop=True)
    batches = val_batches(cfg)
    draws = jax_draws(cfg.seed, len(batches), B, (B, 2, WAV))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsop_main, "init_sop_state", lambda *a, **k: jstate)
        jreport = jrun_probe(jcfg, tag="best")
    return dict(jax=jreport,
                port=sop_probe.run_probe(cfg, tag="best", device="cpu",
                                         draws=draws),
                jcfg=jcfg, jnets=jnets, jstate=jstate, cfg=cfg,
                batches=batches, draws=draws)


def test_sop_probe_matches_jax(sop_reports):
    """The per-sample loss and SI-SDR, as-is and with the visual streams
    swapped, batch by batch, then the two reports."""
    r = sop_reports
    cfg, jstate = r["cfg"], r["jstate"]
    nets = checkpoint.restore_checkpoint(
        os.path.join(cfg.ckpt, cfg.id),
        sop_main.init_sop_state(cfg, sop_main.build_sop_nets(
            cfg, device="cpu"), torch.Generator(), device="cpu"),
        "best").nets
    jstep = jmake_sop_eval_step(r["jcfg"], r["jnets"], True)
    pstep = sop_main.make_sop_eval_step(cfg, nets, True, device="cpu")
    rng = jax.random.PRNGKey(cfg.seed)
    unsure = {"err": 0, "sisdr": 0}
    for batch, draw in zip(r["batches"], r["draws"]):
        rng, sub = jax.random.split(rng)
        dev = {k: jax.numpy.asarray(v) for k, v in host(batch).items()}
        pdev = engine.to_device(batch, torch.device("cpu"), cfg=cfg)
        res = {}
        for swap in (False, True):
            jd, pd = dict(dev), dict(pdev)
            if swap:
                jd["frames"] = dev["frames"][:, ::-1]
                pd["frames"] = pdev["frames"].flip(1)
            jm = jax.device_get(jstep(jstate.params, jstate.batch_stats, jd,
                                      sub))
            pm, _, _ = pstep(pd, noise_uniforms=draw["noise_uniforms"])
            np.testing.assert_allclose(pm["err_ps"].numpy(), jm["err_ps"],
                                       rtol=LOSS_RTOL)
            assert np.abs(pm["si_sdr"].numpy() - jm["si_sdr"]).max() \
                <= DB_TOL
            res[swap] = jm
        unsure["err"] += int((~margin_ok(
            res[False]["err_ps"], res[True]["err_ps"],
            LOSS_RTOL * np.abs(res[False]["err_ps"]))).sum())
        unsure["sisdr"] += int((~margin_ok(
            res[False]["si_sdr"], res[True]["si_sdr"], DB_TOL)).sum())

    jrep, prep = r["jax"], r["port"]
    assert set(prep) == set(jrep) and prep["ckpt_tag"] == "best"
    assert prep["assign_n"] == jrep["assign_n"] == 4
    close_count(prep["assign_acc"] * 4, jrep["assign_acc"] * 4,
                unsure["err"])
    close_count(prep["assign_acc_sisdr"] * 4, jrep["assign_acc_sisdr"] * 4,
                unsure["sisdr"])
    for k in ("av_si_sdr", "av_sdr", "ao_si_sdr", "ao_sdr"):
        assert np.isfinite(prep[k]) and abs(prep[k] - jrep[k]) <= DB_TOL, k
    with open(os.path.join(cfg.ckpt, cfg.id, "sop_probe_best.json")) as f:
        assert json.load(f) == prep


@pytest.mark.parametrize("sop", [False, True], ids=["av", "sop"])
def test_export_matches_the_jax_tool(toy_set, tmp_path, monkeypatch, sop):
    """Both tools on one state: ``.pth`` files equal key for key, bit for
    bit, dtypes and shapes included."""
    from tools import export_reference_ckpt as jexport
    argv = (SOP if sop else
            [a if a != "tinyconv" else "resnet18dilated" for a in AV]) + [
        "--id", "exp", "--list_val", str(toy_set / "val.csv")]
    jcfg, _, jstate, cfg = two_checkpoints(tmp_path, argv, sop=sop)
    extra = ["--sop"] if sop else []
    monkeypatch.setattr(jsop_main if sop else jtrain,
                        "init_sop_state" if sop else "init_state",
                        lambda *a, **k: jstate)
    monkeypatch.setattr(sys, "argv", ["export_reference_ckpt.py", "--tag",
                                      "best", "--out", str(tmp_path / "jo"),
                                      *extra, *argv, "--ckpt", jcfg.ckpt])
    jexport.main()
    wrote = export_reference_ckpt.export(
        ["--tag", "best", "--out", str(tmp_path / "po"), *extra, *argv,
         "--ckpt", cfg.ckpt])
    names = ["sound", "frame"] + (["synthesizer"] if sop else [])
    assert [os.path.basename(p) for p in wrote] == \
        [f"{n}_best.pth" for n in names]
    assert sorted(os.listdir(tmp_path / "po")) == \
        sorted(os.listdir(tmp_path / "jo"))
    for name in os.listdir(tmp_path / "jo"):
        got = torch.load(tmp_path / "po" / name, weights_only=True)
        want = torch.load(tmp_path / "jo" / name, weights_only=True)
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            if k.endswith("num_batches_tracked"):
                # the JAX tool's np.ascontiguousarray makes the scalar
                # [1]; the port keeps BatchNorm's own shape, []
                assert v.shape == (1,) and got[k].shape == ()
                v = v.reshape(())
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert torch.equal(got[k], v), (name, k)


def test_schedule_proof_passes_at_a_compressed_shape(toy_set, tmp_path):
    """Boundaries 10 / 14 / 16, phase 1 to iteration 12, the resume to 20,
    an eval every 4 (of the 8 rows once, B = 2): every invariant holds."""
    report = schedule_proof.run_schedule_proof(
        str(toy_set / "train.csv"), str(tmp_path), lr_steps=(10, 14, 16),
        iters=(13, 21), eval_iter=4, disp_iter=2, batch_size=B,
        val_repeat=1, device="cpu")
    assert report["failures"] == [] and report["ok"], report
    assert report["final_step"] == report["schedule_count"] == 20
    assert report["group_counts"] == {"sound": 20, "frame": 10}
    assert report["eval_iters"] == [4, 8, 12, 16, 20]
    assert report["lr_final"] == ptrain.lr_at(report["lr_base"],
                                              (10, 14, 16), 20)


def test_resume_after_decay_boundary_keeps_decayed_lr(tmp_path):
    """The port's counterpart of tests/test_resume.py's case: save after
    the ``lr_steps`` boundary, restore, continue: the restored group counts
    give the decayed rate, and the step after the resume equals the
    unbroken trajectory's bit for bit."""
    _, cfg = configs(lr_steps=(3,))
    batch = engine.to_device(make_batch(5, B=4), torch.device("cpu"))
    swaps = [torch.from_numpy(np.random.RandomState(i).uniform(size=4)
                              .astype(np.float32)) for i in range(5)]

    def fresh():
        nets = make_nets(cfg)[3]
        state = ptrain.TrainState(0, nets, ptrain.init_opt_state(cfg, nets))
        return state, ptrain.make_train_step(cfg, state.nets, False,
                                             device="cpu")

    s, step = fresh()
    for u in swaps:
        s, _ = step(s, batch, swap_uniforms=u)
    direct = {k: v.clone() for k, v in ptrain.named_parameters(s.nets)}

    s, step = fresh()
    for u in swaps[:4]:
        s, _ = step(s, batch, swap_uniforms=u)
    checkpoint.save_checkpoint(str(tmp_path), s, new_history(), "latest")
    restored, step = fresh()
    restored = checkpoint.restore_checkpoint(str(tmp_path), restored,
                                             "latest")
    assert restored.step == 4
    counts = {g: st.count for g, st in restored.opt_state.items()}
    assert counts == {"sound": 4, "frame": 0}
    np.testing.assert_allclose(
        ptrain.lr_at(cfg.lr_sound, cfg.lr_steps, max(counts.values())),
        0.1 * cfg.lr_sound, rtol=1e-6)
    restored, _ = step(restored, batch, swap_uniforms=swaps[4])
    for k, v in ptrain.named_parameters(restored.nets):
        assert torch.equal(v, direct[k]), k


def test_bench_loader_prints_its_line(toy_set):
    out = subprocess.run(
        [sys.executable, "-m", "avsep_tpu_torch.tools.bench_loader",
         "--csv", str(toy_set / "train.csv"), "--n", "2", "--bs", "2",
         "--workers", "2", "--one_frame"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("process loader [auto]: ") and "clips/s" in line
    assert "at B=2, 2 workers, real jpg+wav IO" in line


@pytest.mark.parametrize("tool,argv", [
    ("av_probe", ["--tokens_json", "t.json"]),
    ("sop_probe", ["--probe_ckpt", "latest"]),
    ("schedule_proof", ["--csv", "x.csv"])])
def test_gpu_tools_refuse_to_run_without_a_gpu(tool, argv, tmp_path,
                                               monkeypatch):
    """The command lines (their ``__main__``, run as ``python -m`` runs it)
    have no device flag: without a card they fail before touching a file;
    the CPU runs go through the functions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(engine, "full_float32", lambda: None)
    monkeypatch.setattr(sys, "argv", [tool, *argv, "--ckpt",
                                      str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        runpy.run_module(f"avsep_tpu_torch.tools.{tool}",
                         run_name="__main__")
    assert os.listdir(tmp_path) == []
