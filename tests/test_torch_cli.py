"""The port's command line: ``config.parse_args`` against the JAX
package's on the flag strings of ``scripts/train_MUSIC.sh`` and
``scripts/eval_MUSIC.sh``, ``main.main`` in eval and
train mode on the CPU at toy size on the synthetic manifest of
tests/test_dataset.py, ``check_exp`` against the JAX package's, and the
command line itself, which runs on a GPU only.  ``--use_pallas`` is
accepted and changes nothing."""

import dataclasses
import json
import os
import re
import shlex
import subprocess
import sys

import pytest
import torch

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu import check_exp as jcheck_exp
from avsep_tpu.config import parse_args as jparse_args
from avsep_tpu_torch import check_exp
from avsep_tpu_torch.config import Config, parse_args
from avsep_tpu_torch.main import main
from avsep_tpu_torch.utils import spans
from tests.test_dataset import AUDLEN, manifest  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_args(name, **subst):
    """The flag strings of ``scripts/<name>``'s ``args=( ... )`` array,
    comments dropped, with ``subst`` replacing a flag's value."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        text = f.read()
    body = re.search(r"^args=\((.*?)^\)", text, re.S | re.M).group(1)
    argv = shlex.split("\n".join(line.split("#")[0]
                                 for line in body.splitlines()))
    for flag, value in subst.items():
        argv[argv.index("--" + flag) + 1] = value
    return argv


# the port's fields that the JAX package's Config has not, with their
# defaults: the motion net's architecture (the JAX package builds the fast
# pathway alone)
PORT_ONLY = {"arch_motion": "slowfast_fast"}


@pytest.mark.parametrize("script,subst", [
    ("train_MUSIC.sh", {}),
    ("eval_MUSIC.sh", {})])
def test_script_flags_parse_as_the_jax_package(script, subst):
    argv = script_args(script, **subst)
    got, want = parse_args(argv), jparse_args(argv)
    shared = [f.name for f in dataclasses.fields(Config)
              if f.name not in PORT_ONLY]
    assert len(shared) > 60
    for name in shared:
        assert getattr(got, name) == getattr(want, name), name
    # use_pallas, which the port's Config has no field for, holds its
    # default; the port's own fields, which the JAX package's Config has
    # not, hold theirs
    assert not hasattr(got, "use_pallas") and want.use_pallas is False
    for name, default in PORT_ONLY.items():
        assert not hasattr(want, name) and getattr(got, name) == default
    assert got.batch_size == want.batch_size


@pytest.mark.parametrize("argv", [
    ["--dtype", "bfloat16"],
    ["--dtype", "bfloat16", "--dft", "matmul", "--remat", "1"]])
def test_dtype_and_remat_parse_as_the_jax_package(argv):
    got, want = parse_args(argv), jparse_args(argv)
    assert (got.dtype, got.dft, got.remat) == (want.dtype, want.dft,
                                               want.remat)
    assert got.dtype == "bfloat16"


@pytest.mark.parametrize("value", ["0", "1"])
def test_use_pallas_is_accepted_and_changes_nothing(value):
    """Both packages parse ``--use_pallas 0|1``; the port's ``Config`` is
    the one parsed without the flag (the port runs its kernels on every
    CUDA tensor whatever the flag says), and nothing raises."""
    argv = script_args("train_MUSIC.sh") + ["--use_pallas", value]
    assert jparse_args(argv).use_pallas is (value == "1")
    assert parse_args(argv) == parse_args(script_args("train_MUSIC.sh"))


@pytest.mark.parametrize("decode", ["native", "fast"])
def test_frame_decode_parses_as_the_jax_package(decode):
    """``--frame_decode native`` and ``fast`` are ported (data/native.py):
    they parse to what the JAX package parses, and raise nothing."""
    argv = ["--frame_decode", decode]
    assert parse_args(argv).frame_decode == jparse_args(argv).frame_decode \
        == decode


def test_ported_flags_at_non_defaults():
    cfg = parse_args(["--frame_decode", "pil", "--audio_wire", "int16",
                      "--use_pallas", "0", "--dtype", "float32",
                      "--profile_dir", "p", "--profile_start", "3",
                      "--lr_steps", "5", "7", "--not_pool_vis"])
    assert (cfg.frame_decode, cfg.audio_wire, cfg.profile_dir,
            cfg.profile_start, cfg.lr_steps, cfg.not_pool_vis) == (
        "pil", "int16", "p", 3, (5, 7), False)


def toy_cfg(manifest, ckpt, **kw):  # noqa: F811
    base = dict(
        id="toy", arch_sound="unet5", arch_frame="tinyconv", num_channels=2,
        vis_channels=256, fusion_type="hidsep", att_type="sig",
        not_pool_vis=False, img_activation="relu",
        output_activation="sigmoid", loss="bce", binary_mask=1,
        weighted_loss=1, log_freq=1, num_mix=2, audLen=AUDLEN, imgSize=64,
        one_frame=True, margin=1.0, num_gpus=1, batch_size_per_gpu=2,
        workers=2, train_repeat=1, val_repeat=1, num_iters=4, eval_iter=2,
        disp_iter=2, num_vis=0, iter_per_av=2, start_av_first=True,
        num_fsteps=0, lr_steps=(100,), ckpt=str(ckpt),
        av_list_train=(manifest,), ao_list_train=(manifest,),
        list_val=(manifest,), max_silent=0.95, rate_dc=1.0)
    return Config(**{**base, **kw})


def results_rows(run, branch):
    with open(os.path.join(run, "visualization", branch,
                           "results.csv")) as f:
        return f.read().splitlines()


def two_row_manifest(manifest, tmp_path):  # noqa: F811
    """The first rows of two classes of the synthetic manifest: a val set
    of two clips, one batch."""
    with open(manifest) as f:
        rows = f.read().splitlines()
    path = tmp_path / "two.csv"
    path.write_text("\n".join([rows[0], rows[-1]]) + "\n")
    return str(path)


def test_main_train_then_eval_on_the_cpu(manifest, tmp_path, capsys):  # noqa: F811
    """Train mode with process loaders: 2 iterations (AO, AV) with an eval
    tick at iteration 2 and a torch.profiler trace of iteration 1; writes
    both results.csv, the history and the latest and best checkpoints (at
    the eval tick).  Then eval mode restores the best checkpoint and
    writes the media of one sample."""
    cfg = toy_cfg(manifest, tmp_path / "ckpt", num_iters=3,
                  list_val=(two_row_manifest(manifest, tmp_path),),
                  profile_dir=str(tmp_path / "prof"), profile_start=1,
                  profile_steps=1)
    main(cfg, device="cpu")
    run = str(tmp_path / "ckpt" / "toy")
    for branch in ("av", "ao"):
        rows = results_rows(run, branch)
        assert rows[0] == "id,sdr,sir,si-snr" and len(rows) == 3
    with open(os.path.join(run, "history_latest.json")) as f:
        h = json.load(f)
    assert h["train"]["iter"] == [2]
    assert h["val_av"]["iter"] == h["val_ao"]["iter"] == [2]
    assert len(h["val_av"]["perm_acc"]) == 1
    assert h["best_err"] == -h["val_ao"]["si_sdr"][0]
    saved = torch.load(os.path.join(run, "state_latest.pt"),
                       weights_only=True)
    # saved at the eval tick, after an AO and an AV step
    assert saved["step"] == 2
    assert saved["opt_state"]["sound"]["count"] == 2
    assert saved["opt_state"]["frame"]["count"] == 1
    assert os.path.exists(os.path.join(run, "state_best.pt"))
    assert os.path.exists(os.path.join(run, "loss.png"))
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    # the profiled iteration's trace shows the program's spans, and the
    # recorder the window turned on is off again
    with open(tmp_path / "prof" / "trace.json") as f:
        assert '"train.step"' in f.read()
    assert not spans.enabled() and spans.drain().records == []
    out = capsys.readouterr().out
    assert "Training Done!" in out

    main(cfg.replace(mode="eval", num_vis=1, profile_dir=""), device="cpu")
    out = capsys.readouterr().out
    assert "Evaluation Done!" in out and "no best checkpoint" not in out
    vis = os.path.join(run, "visualization", "av")
    sample = [d for d in os.listdir(vis) if d != "results.csv"]
    assert len(sample) == 1
    for f in ("mix.jpg", "weight.jpg", "mix.wav", "predmask1.jpg",
              "gtmask2.jpg", "pred1.wav", "gt2.wav"):
        assert os.path.exists(os.path.join(vis, sample[0], f)), f
    assert len(results_rows(run, "ao")) == 3


def test_main_eval_without_a_checkpoint(manifest, tmp_path, capsys):  # noqa: F811
    """Eval mode with thread loaders (workers 0), no checkpoint and no
    train manifests: warns, evaluates the initial weights, writes both
    results.csv."""
    cfg = toy_cfg(manifest, tmp_path, mode="eval", workers=0,
                  list_val=(two_row_manifest(manifest, tmp_path),),
                  av_list_train=("absent.csv",), ao_list_train=())
    main(cfg, device="cpu")
    assert "no best checkpoint" in capsys.readouterr().out
    for branch in ("av", "ao"):
        assert len(results_rows(str(tmp_path / "toy"), branch)) == 3


@pytest.mark.parametrize("wire", ["f32", "int16"])
def test_to_device_ships_what_the_step_reads(wire):
    """``engine.to_device`` (the JAX package's ``main.to_device``): the
    arrays a step reads, less ``audio_mix`` (rebuilt from the sources),
    ``class``, the ids and the dropped streams; int16 audio on that
    wire."""
    import numpy as np
    from avsep_tpu_torch import engine
    rs = np.random.RandomState(0)
    audios = (rs.randn(2, 2, 64) * 0.1).astype(np.float32)
    batch = {"audios": audios, "audio_mix": audios.sum(1),
             "frames": np.zeros((2, 2, 1, 4, 4, 3), np.uint8),
             "clips": np.zeros((2, 2, 3, 4, 4, 3), np.uint8),
             "class": np.zeros((2, 2), np.int32), "id": ["a", "b"]}
    cfg = Config(audio_wire=wire)
    dev = engine.to_device(batch, torch.device("cpu"),
                           drop=engine.unused_visual_streams(cfg), cfg=cfg)
    audio_keys = {"audios"} if wire == "f32" else {"audios_i16", "audio_gain"}
    assert set(dev) == audio_keys | {"frames"}
    assert dev["frames"].dtype == torch.uint8
    got = engine.audios_of(dev)
    torch.testing.assert_close(got, torch.from_numpy(audios),
                               rtol=0, atol=0 if wire == "f32" else 1e-5)
    ao = engine.to_device(batch, torch.device("cpu"),
                          drop=("frames", "clips"))
    assert set(ao) == {"audios"}


def test_check_exp_prints_as_the_jax_package(tmp_path, capsys):
    hist = {
        "val_ao": {"iter": [100, 200, 300], "sdr": [1.0, 2.513, 2.0],
                   "sir": [3.0, 4.518, 4.0], "si_sdr": [0.5, 1.5, 1.2]},
        "val_av": {"iter": [100, 200], "sdr": [0.9, 3.2],
                   "sir": [2.0, 5.25], "si_sdr": [0.4, 2.8]},
    }
    (tmp_path / "history_latest.json").write_text(json.dumps(hist))
    check_exp.main(str(tmp_path))
    got = capsys.readouterr().out
    jcheck_exp.main(str(tmp_path))
    assert got == capsys.readouterr().out
    assert "Best AO model (epoch 200):" in got
    assert "AO: sir: 4.52, SDR: 2.51, SI-SNR: 1.5" in got
    assert "Best AV model (epoch 200):" in got


def test_command_line_needs_a_gpu(manifest, tmp_path):  # noqa: F811
    """``python -m avsep_tpu_torch.main`` has no device flag: without a
    GPU it stops with the entry points' error instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command line would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "avsep_tpu_torch.main", "--mode", "eval",
         "--list_val", manifest, "--ckpt", str(tmp_path),
         "--arch_sound", "unet5", "--arch_frame", "tinyconv"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_plots_are_skipped_without_matplotlib(tmp_path, monkeypatch,
                                              capsys):
    """An eval tick's plots need matplotlib; without it they are skipped
    with one line instead of stopping the train loop."""
    from avsep_tpu_torch.utils.meters import new_history
    from avsep_tpu_torch.utils.viz import plot_loss_metrics
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    history = new_history()
    history["train"]["iter"].append(1)
    history["train"]["err"].append(0.5)
    plot_loss_metrics(str(tmp_path), history)
    assert "matplotlib not found" in capsys.readouterr().out
    assert not os.listdir(tmp_path)
