"""The port's evaluation (avsep_tpu_torch/evaluate.py) against
``avsep_tpu.evaluate`` on the CPU: the same in-memory val set, the same
weights (``models/from_jax.py``) and the JAX package's own draws injected,
so that both give the same ``results.csv`` rows and ``history`` entries.

Size as tests/test_torch_forward.py: unet5 at ngf 8 and the tiny conv
encoder on 64x64 frames, 16383 samples, 5 clips in batches of 3 (the last
one ragged, padded to 3).  The JAX sweep splits ``PRNGKey(cfg.seed)`` once
per batch; its sub-key gives the audio-only slot swap
(``uniform(sub, (B,))``) and the noise floor (``uniform(sub, wav
shape)``), which the port gets through ``evaluate(draws=...)``.

Tolerances: every metric of every row and of the history within 1e-3
dB, the loss at 1e-6 relative, the perm accuracy exactly.  Read: at most
7.6e-6 dB and 1.1e-7 (float32 networks, iSTFT and BSS-eval in another
summation order).  Three mask settings: the eval script's binary masks at
``mask_thres 0.5``; soft masks (``binary_mask 0``), free of the threshold;
and ``mask_thres 1``, where every prediction is all-zero and both
packages score the same injected noise floor.  With binary masks a value
within rounding of the threshold could land on the other side in one
package and move its row by whole dB; none did at this size.
"""

import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.data.loader import BatchLoader as JBatchLoader
from avsep_tpu.evaluate import evaluate as jevaluate
from avsep_tpu.evaluate import perm_correct as jperm_correct
from avsep_tpu.utils.meters import new_history as jnew_history
from avsep_tpu_torch import evaluate as pev
from avsep_tpu_torch.data.loader import BatchLoader
from avsep_tpu_torch.utils.meters import new_history
from tests.test_torch_forward import configs, make_nets

N_CLIPS, BS, L = 5, 3, 16383
DB_TOL, LOSS_RTOL = 1e-3, 1e-6


class Clips:
    """An in-memory val set: the dataset's sample dict, seeded."""

    def __init__(self, n=N_CLIPS, seed=0):
        rs = np.random.RandomState(seed)
        self.items = []
        for i in range(n):
            audios = (rs.randn(2, L) * 0.05).astype(np.float32)
            self.items.append({
                "audios": audios, "audio_mix": audios.sum(0),
                "frames": rs.randint(0, 256, (2, 1, 64, 64, 3)
                                     ).astype(np.uint8),
                "id": f"clip{i}", "class": np.array([0, 1], np.int32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def jax_draws(seed, n_batches, B, wav_shape):
    """The draws of the JAX sweep, batch by batch."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_batches):
        rng, sub = jax.random.split(rng)
        out.append({
            "swap_uniforms": torch.from_numpy(
                np.array(jax.random.uniform(sub, (B,)))),
            "noise_uniforms": torch.from_numpy(
                np.array(jax.random.uniform(sub, wav_shape)))})
    return out


def read_rows(ckpt, branch):
    with open(os.path.join(ckpt, "visualization", branch,
                           "results.csv")) as f:
        return list(csv.DictReader(f))


def run_both(tmp_path, use_vis, **kw):
    jcfg, cfg = configs(**kw)
    jnets, params, stats, pnets = make_nets(cfg)
    jcfg = jcfg.replace(ckpt=str(tmp_path / "jax"), num_vis=0)
    cfg = cfg.replace(ckpt=str(tmp_path / "port"), num_vis=0)
    data = Clips()
    jh, ph = jnew_history(), new_history()
    jevaluate(jcfg, jnets, params, stats,
              JBatchLoader(data, BS, shuffle=False, num_workers=2), jh, 0,
              use_vis_eval=use_vis, write_visuals=False)
    n_batches = -(-N_CLIPS // BS)
    draws = jax_draws(cfg.seed, n_batches, BS, (BS, 2, 256 * 63))
    pev.evaluate(cfg, pnets, BatchLoader(data, BS, shuffle=False,
                                         num_workers=2), ph, 0,
                 use_vis_eval=use_vis, write_visuals=False, device="cpu",
                 draws=draws)
    branch = "av" if use_vis else "ao"
    return (jh, read_rows(jcfg.ckpt, branch)), (ph, read_rows(cfg.ckpt,
                                                              branch))


def check(jax_out, port_out, use_vis, loss_rtol=LOSS_RTOL, db_tol=DB_TOL):
    (jh, jrows), (ph, prows) = jax_out, port_out
    key = "val_av" if use_vis else "val_ao"
    assert [r["id"] for r in prows] == [r["id"] for r in jrows] == \
        [f"clip{i}" for i in range(N_CLIPS)]
    for pr, jr in zip(prows, jrows):
        for k in ("sdr", "sir", "si-snr"):
            assert np.isfinite(float(pr[k])), (pr, k)
            assert abs(float(pr[k]) - float(jr[k])) <= db_tol, (pr, jr, k)
    assert set(ph[key]) == set(jh[key])
    assert ph[key]["iter"] == jh[key]["iter"] == [0]
    for k in ("sdr", "sir", "sar", "si_sdr"):
        assert abs(ph[key][k][0] - jh[key][k][0]) <= db_tol, k
    assert abs(ph[key]["err"][0] - jh[key]["err"][0]) <= \
        loss_rtol * abs(jh[key]["err"][0])
    if use_vis:
        assert ph[key]["perm_acc"] == jh[key]["perm_acc"]
    # the meters are the means of the rows (padded rows left out)
    for k, col in (("sdr", "sdr"), ("si_sdr", "si-snr")):
        np.testing.assert_allclose(
            ph[key][k][0], np.mean([float(r[col]) for r in prows]),
            rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_vis,masks", [
    (True, dict(binary_mask=1)), (False, dict(binary_mask=0)),
    (True, dict(binary_mask=1, mask_thres=1.0))],
    ids=["av-binary", "ao-soft", "av-noise-floor"])
def test_evaluate_matches_jax(tmp_path, use_vis, masks):
    jax_out, port_out = run_both(tmp_path, use_vis, **masks)
    check(jax_out, port_out, use_vis)


def test_eval_step_binary_masks_and_counts():
    """One AV step with binary masks through ``make_eval_step``: the
    ``[B]`` metrics, perm_correct in {0, 1}, predictions in [-1, 1]; the
    noise floor needs its draws or a generator."""
    _, cfg = configs(binary_mask=1)
    _, _, _, pnets = make_nets(cfg)
    batch = {k: np.stack([c[k] for c in Clips(3).items])
             for k in ("audios", "frames")}
    step = pev.make_eval_step(cfg, pnets, True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    metrics, outputs, wavs = step(batch, noise_generator=gen)
    assert wavs.shape == (3, 2, 256 * 63)
    assert float(wavs.abs().max()) <= 1.0
    for k in ("sdr", "sir", "sar", "si_sdr", "err_ps", "match_ps",
              "perm_correct"):
        assert metrics[k].shape == (3,), k
        assert torch.isfinite(metrics[k]).all(), k
    assert set(metrics["perm_correct"].tolist()) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="noise"):
        step(batch)


def test_perm_correct_catches_three_cycles():
    """Identity against all N! assignments: a 3-cycle (pred n carries
    source n + 1) scores 0 although the full reversal is worse than the
    identity; the port equals the JAX package's ``perm_correct``."""
    rs = np.random.RandomState(0)
    B, N, F, T = 2, 3, 6, 5
    gts = rs.rand(B, N, F, T).astype(np.float32)
    preds = gts.copy()
    preds[0] = gts[0, [1, 2, 0]]  # sample 0: a 3-cycle; sample 1: identity
    w = np.ones((B, F, T), np.float32)
    out = pev.perm_correct(torch.from_numpy(preds), torch.from_numpy(gts),
                           torch.from_numpy(w), kind="l2")
    np.testing.assert_array_equal(out.numpy(), [0.0, 1.0])
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jperm_correct(
            jnp.asarray(preds), jnp.asarray(gts), jnp.asarray(w), "l2")))
    gts2 = rs.rand(B, 2, F, T).astype(np.float32)
    preds2 = gts2.copy()
    preds2[0] = gts2[0, ::-1]
    out2 = pev.perm_correct(torch.from_numpy(preds2), torch.from_numpy(gts2),
                            torch.ones(B, F, T), kind="bce")
    np.testing.assert_array_equal(out2.numpy(), [0.0, 1.0])


def test_evaluate_raises_without_a_gpu(monkeypatch, tmp_path):
    _, cfg = configs()
    _, _, _, pnets = make_nets(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pev.evaluate(cfg.replace(ckpt=str(tmp_path)), pnets, [], {}, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pev.make_eval_step(cfg, pnets, True)
