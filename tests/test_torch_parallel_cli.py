"""The port's command lines over two gloo ranks on the CPU.

``avsep_tpu_torch.main.main`` and ``sop_main.main`` run in two processes
through the real ``--dist_coordinator``, ``--dist_nprocs`` and
``--dist_procid`` flags (``parse_args``; each process joins the group
itself, as ``python -m avsep_tpu_torch.main`` does) and in one process
without them, at toy size (unet5, the tiny conv encoder, 64x64 frames,
16383 samples, a global batch of 4) on data/mini, iterations 1 to 4 with
an eval and a checkpoint at 3.  This is the JAX package's
tests/test_multihost.py on the port.

* ``replicate``: the loss history at 1e-4 relative to the one-process run
  (read: at most 1.3e-5, from the deep layers' ill-conditioned gradients
  that tests/test_torch_parallel.py describes; the step-by-step bounds are
  there), the eval meters at 1e-5 relative (read: at most 3.8e-8), the
  same visuals (3 clips, across both ranks' rows) with the predicted wavs
  within 1e-3 (read: equal).  Only rank 0 opens a file for writing under
  the checkpoint directory.
* resume: the 2-rank checkpoint resumed onto 2 ranks and onto 1 process
  for iterations 4 to 6, with an eval at 6: the same history, at the same
  tolerances (read: 4.7e-7 and 3.8e-8).
* ``--mode eval`` on the 2-rank checkpoint, by 2 ranks: the rows of the
  training run's eval of the same weights, from rank 0.
* ``shard``: it trains and evaluates; the two ranks' train loaders serve
  disjoint samples.
* SoP++ (``sop_main``), ``replicate``: the loss history and meters against
  one process, as above (read: 1.8e-6 and 8.9e-8).  Its per-sample eval
  loss carries the batch's scalar match loss, which the ranks average
  (``sop_engine.sop_forward``); before they did, a ragged batch's rows
  read 1.4 % off.

Every process has a deadline (``wait_all``) and the group a timeout; a
failure kills every child.  The tests of each phase share one run.
"""

import json
import os
import shutil
import socket

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu_torch.data.audio_io import read_wav
from tests.torch_dist_worker import launch, wait_all

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = "data/mini/train.csv"
TIMEOUT = 600
LOSS_RTOL = 1e-4
METER_RTOL = 1e-5
WAV_ATOL = 1e-3
TOY = ["--id", "toy", "--arch_sound", "unet5", "--arch_frame", "tinyconv",
       "--num_channels", "2", "--vis_channels", "256",
       "--fusion_type", "hidsep", "--att_type", "sig", "--not_pool_vis",
       "--img_activation", "relu", "--output_activation", "sigmoid",
       "--loss", "bce", "--binary_mask", "1", "--weighted_loss", "1",
       "--log_freq", "1", "--num_mix", "2", "--audLen", "16383",
       "--imgSize", "64", "--one_frame", "--margin", "1.0",
       "--num_gpus", "1", "--batch_size_per_gpu", "4", "--workers", "0",
       "--train_repeat", "2", "--val_repeat", "1", "--num_iters", "5",
       "--eval_iter", "3", "--disp_iter", "1", "--num_vis", "0",
       "--iter_per_av", "2", "--start_av_first", "--num_fsteps", "0",
       "--lr_steps", "100", "--frame_decode", "pil", "--max_silent", "0.95",
       "--rate_dc", "1.0", "--av_list_train", MANIFEST,
       "--ao_list_train", MANIFEST, "--list_val", MANIFEST]
SOP = ["--fusion_type", "Base", "--att_type", "cos", "--num_channels", "4",
       "--vis_channels", "4", "--binary_mask", "1", "--train_steps", "2",
       "4", "5", "--num_fsteps", "2", "--lr_synthesizer", "1e-2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli(module, ckpt, extra=(), nprocs=1, mode="replicate", also=()):
    """Runs ``module`` in ``nprocs`` processes on ``ckpt`` (as one group
    when ``nprocs > 1``), and the argument lists of ``also`` (each a
    ``(module, ckpt, extra)``) as one process each, all at once; returns
    each run's per-process reports."""
    runs = [(module, ckpt, extra, nprocs)] + [(m, c, e, 1) for m, c, e in also]
    groups = []
    for m, c, e, n in runs:
        argv = TOY + ["--ckpt", str(c), *e]
        if n > 1:
            argv += ["--dist_coordinator", f"127.0.0.1:{_free_port()}",
                     "--dist_nprocs", str(n), "--dist_data", mode]
        groups.append(launch(
            lambda i, m=m, c=c, a=argv, n=n: ["cli", m, c, *a] + (
                ["--dist_procid", i] if n > 1 else []), n))
    procs = [p for g in groups for p in g]
    outs = wait_all(procs, TIMEOUT)
    reports, k = [], 0
    for g in groups:
        reports.append([json.loads(o.strip().splitlines()[-1])
                        for o in outs[k:k + len(g)]])
        k += len(g)
    return reports


def history(ckpt):
    with open(os.path.join(ckpt, "toy", "history_latest.json")) as f:
        return json.load(f)


def assert_histories_match(got, want):
    assert got["train"]["iter"] == want["train"]["iter"]
    np.testing.assert_allclose(got["train"]["err"], want["train"]["err"],
                               rtol=LOSS_RTOL)
    for branch in ("val_av", "val_ao"):
        assert got[branch]["iter"] == want[branch]["iter"]
        for k in ("err", "sdr", "sir", "sar", "si_sdr"):
            np.testing.assert_allclose(got[branch][k], want[branch][k],
                                       rtol=METER_RTOL, err_msg=branch + k)


@pytest.fixture(scope="module")
def replicate(tmp_path_factory):
    d = tmp_path_factory.mktemp("replicate")
    vis = ["--num_vis", "3"]
    pair, single = cli("avsep_tpu_torch.main", d / "pair", vis, nprocs=2,
                       also=[("avsep_tpu_torch.main", d / "one", vis)])
    return d, pair, single


def test_replicate_matches_one_process(replicate):
    d, _, _ = replicate
    got, want = history(d / "pair"), history(d / "one")
    assert got["train"]["iter"] == [1, 2, 3]
    assert got["val_ao"]["iter"] == [3]
    assert_histories_match(got, want)


def test_replicate_visuals_gather_both_ranks_rows(replicate):
    """num_vis 3 takes rank 0's two rows and one of rank 1's: the primary
    writes all three clips' media as the one process does."""
    d, _, _ = replicate
    for branch in ("av", "ao"):
        roots = [d / run / "toy" / "visualization" / branch
                 for run in ("pair", "one")]
        clips = [sorted(p for p in os.listdir(r) if os.path.isdir(r / p))
                 for r in roots]
        assert len(clips[0]) == 3 and clips[0] == clips[1]
        for clip in clips[0]:
            files = [sorted(os.listdir(r / clip)) for r in roots]
            assert files[0] == files[1] and "pred2.wav" in files[0]
            for n in (1, 2):
                got, want = (read_wav(str(r / clip / f"pred{n}.wav"))[0]
                             for r in roots)
                np.testing.assert_allclose(got, want, atol=WAV_ATOL)


def test_only_rank_zero_writes(replicate):
    d, pair, _ = replicate
    assert pair[1]["writes"] == []
    run = os.path.realpath(d / "pair" / "toy")
    for f in ("history_latest.json", "state_latest.pt",
              "visualization/av/results.csv",
              "visualization/ao/results.csv"):
        assert os.path.join(run, f) in pair[0]["writes"], f


def test_resume_onto_two_ranks_and_onto_one(replicate, tmp_path):
    """The 2-rank checkpoint at iteration 3, resumed for iterations 4 to 6
    (an eval at 6) by 2 ranks and by 1 process: the same history."""
    d, _, _ = replicate
    for run in ("two", "one"):
        shutil.copytree(d / "pair", tmp_path / run)
    more = ["--num_iters", "7", "--load_ckpt", "latest"]
    cli("avsep_tpu_torch.main", tmp_path / "two", more, nprocs=2,
        also=[("avsep_tpu_torch.main", tmp_path / "one", more)])
    got, want = history(tmp_path / "two"), history(tmp_path / "one")
    assert got["train"]["iter"] == [1, 2, 3, 4, 5, 6]
    assert got["val_ao"]["iter"] == [3, 6]
    assert_histories_match(got, want)


def test_eval_mode_on_two_ranks(replicate, tmp_path):
    """``--mode eval`` on two ranks restores ``best`` (iteration 3) on every
    rank and sweeps: the rows of the training run's eval at 3 (which
    test_replicate_matches_one_process holds against one process), written
    by rank 0 alone."""
    d, _, _ = replicate
    shutil.copytree(d / "pair", tmp_path / "two")
    (r0, r1), = cli("avsep_tpu_torch.main", tmp_path / "two",
                    ["--mode", "eval"], nprocs=2)
    assert r1["writes"] == [] and r0["writes"]
    for branch in ("av", "ao"):
        rows = []
        for root in (tmp_path / "two", d / "pair"):
            with open(root / "toy" / "visualization" / branch /
                      "results.csv") as f:
                rows.append([line.split(",") for line in f.read().split()])
        assert [r[0] for r in rows[0]] == [r[0] for r in rows[1]]
        np.testing.assert_allclose(
            np.array([r[1:] for r in rows[0][1:]], float),
            np.array([r[1:] for r in rows[1][1:]], float), rtol=METER_RTOL)


def test_shard_trains_on_disjoint_samples(tmp_path):
    (r0, r1), = cli("avsep_tpu_torch.main", tmp_path, nprocs=2,
                    mode="shard")
    h = history(tmp_path)
    assert h["train"]["iter"] == [1, 2, 3]
    assert np.isfinite(h["train"]["err"]).all()
    assert np.isfinite(h["val_ao"]["si_sdr"]).all()
    assert r1["writes"] == []
    # the AV and the AO train loaders, in the order they were built
    assert set(r0["served"]) == set(r1["served"]) == {"0", "1"}
    for tag in ("0", "1"):
        assert r0["served"][tag] and r1["served"][tag]
        assert set(r0["served"][tag]).isdisjoint(r1["served"][tag])


def test_sop_main_replicate_matches_one_process(tmp_path):
    (r0, r1), _ = cli("avsep_tpu_torch.sop_main", tmp_path / "pair", SOP,
                      nprocs=2, also=[("avsep_tpu_torch.sop_main",
                                       tmp_path / "one", SOP)])
    got, want = history(tmp_path / "pair"), history(tmp_path / "one")
    assert got["train"]["iter"] == [1, 2, 3]
    assert_histories_match(got, want)
    assert r1["writes"] == []
    assert os.path.exists(tmp_path / "pair" / "toy" / "visualization" /
                          "sop_ao" / "results.csv")
