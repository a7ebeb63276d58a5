"""The port's BSS-eval and SI-SDR (avsep_tpu_torch/ops/metrics.py) against
``avsep_tpu.ops.metrics`` and against the numpy oracle of
tests/test_metrics.py (mir_eval's algorithm with scipy's Toeplitz solve),
on the same float32 signals, with ``flen`` at its 512 taps.

Tolerances.  Against the numpy oracle (float64, no diagonal loading):
0.15 dB, the JAX package's own bound for its loading of 1e-7 * trace.
Against the JAX package (the same float32 algorithm, the same loading):
SDR / SIR / SAR within 2e-3 dB, SI-SDR within 1e-4 dB.  Read on the
twenty signals of ``_mix_signals`` (seeds 0 to 9, both orders, 4096
samples): at most 2.4e-4 dB (SAR) and 9.5e-7 dB (SI-SDR), from float32
Cholesky factors of a Gram of condition number up to 1e7 built in another
summation order (pocketfft and LAPACK against XLA's FFT and Cholesky).
The narrowband (two-sine) references read 1.1e-3 dB and are held at
1e-2 dB.  The chosen permutation must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avsep_tpu.ops import metrics as jm
from avsep_tpu_torch.ops import metrics as pm
from tests.test_metrics import _mix_signals, np_bss_eval

DB_TOL = 2e-3       # port vs JAX, SDR / SIR / SAR
SI_SDR_TOL = 1e-4   # port vs JAX, SI-SDR
SINE_TOL = 1e-2     # port vs JAX, narrowband references
ORACLE_TOL = 0.15   # port vs the float64 numpy oracle


def both(refs, ests):
    """(port, JAX) bss_eval_sources of the same float32 arrays, as numpy."""
    r32, e32 = refs.astype(np.float32), ests.astype(np.float32)
    got = pm.bss_eval_sources(torch.from_numpy(r32), torch.from_numpy(e32))
    want = jm.bss_eval_sources(jnp.asarray(r32), jnp.asarray(e32))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("swap", [False, True])
def test_bss_eval_matches_jax_and_numpy_oracle(swap):
    refs, ests = _mix_signals(0, swap=swap)
    got, want = both(refs[None], ests[None])
    np.testing.assert_array_equal(got[3], want[3])
    for g, w, name in zip(got[:3], want[:3], ("sdr", "sir", "sar")):
        np.testing.assert_allclose(g, w, atol=DB_TOL, rtol=0, err_msg=name)
    ref = np_bss_eval(refs, ests)
    np.testing.assert_array_equal(got[3][0], ref[3])
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g[0], r, atol=ORACLE_TOL, rtol=0)


def test_bss_eval_batched_matches_per_sample_and_jax():
    """Four samples at once, two of them swapped: each row equals the same
    sample scored alone (1e-3 dB, the JAX test's bound) and the JAX batch."""
    pairs = [_mix_signals(s, swap=s % 2 == 1) for s in range(1, 5)]
    refs = np.stack([p[0] for p in pairs])
    ests = np.stack([p[1] for p in pairs])
    got, want = both(refs, ests)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, atol=DB_TOL, rtol=0)
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[3][0], [1, 0])
    for b in range(len(pairs)):
        one = pm.bss_eval_sources(
            torch.from_numpy(refs[b:b + 1].astype(np.float32)),
            torch.from_numpy(ests[b:b + 1].astype(np.float32)))
        for g1, gb in zip(one[:3], got[:3]):
            np.testing.assert_allclose(g1[0].numpy(), gb[b], atol=1e-3,
                                       rtol=0)


def test_degenerate_references_stay_finite_and_match_jax():
    """Duplicated, gain-scaled and narrowband (sine) references make the
    Gram singular: the diagonal loading must keep every metric finite, on
    the port as on the JAX package.  The permutation of duplicated sources
    is a tie of rounding, so only the two distinct sines are compared with
    the JAX package, at ``SINE_TOL``."""
    rs = np.random.RandomState(3)
    L = 8191
    t = np.arange(L) / 11025.0
    a = rs.randn(L).astype(np.float32)
    cases = {
        "dup": np.stack([a, a]),
        "scaled": np.stack([a, 0.25 * a]),
        "sines": np.stack([0.4 * np.sin(2 * np.pi * 220 * t),
                           0.4 * np.sin(2 * np.pi * 330 * t)]),
        "same-sine": np.stack([0.4 * np.sin(2 * np.pi * 220 * t)] * 2),
    }
    refs = np.stack([c for c in cases.values()]).astype(np.float32)
    ests = refs + 0.05 * rs.randn(*refs.shape).astype(np.float32)
    got, want = both(refs, ests)
    for g, w in zip(got[:3], want[:3]):
        assert np.isfinite(g).all() and np.isfinite(w).all(), g
    i = list(cases).index("sines")
    np.testing.assert_array_equal(got[3][i], want[3][i])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[i], w[i], atol=SINE_TOL, rtol=0)


def test_failed_factorization_gives_nan_not_an_error():
    """A sample whose Gram cannot be factorized (here: a NaN in its
    references) scores NaN, as on the JAX package, without raising and
    without a host sync (``cholesky_ex``), and its neighbour in the batch
    is unharmed."""
    refs, ests = _mix_signals(5)
    bad = refs.copy()
    bad[0, 100] = np.nan
    batch_r = np.stack([refs, bad]).astype(np.float32)
    batch_e = np.stack([ests, ests]).astype(np.float32)
    got, want = both(batch_r, batch_e)
    assert np.isnan(got[0][1]).all() and np.isnan(want[0][1]).all()
    assert np.isfinite(got[0][0]).all()
    alone, _ = both(batch_r[:1], batch_e[:1])
    np.testing.assert_allclose(got[0][0], alone[0][0], atol=1e-3)


def test_si_sdr_matches_jax():
    rs = np.random.RandomState(3)
    ref = rs.randn(3, 2, 2048).astype(np.float32)
    for noise in (0.1, 0.5, 2.0):
        est = (ref + noise * rs.randn(*ref.shape)).astype(np.float32)
        got = pm.si_sdr(torch.from_numpy(est), torch.from_numpy(ref))
        want = jm.si_sdr(jnp.asarray(est), jnp.asarray(ref))
        assert got.shape == (3,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SI_SDR_TOL, rtol=0)
    # scale invariance
    a = pm.si_sdr(torch.from_numpy(est), torch.from_numpy(ref))
    b = pm.si_sdr(torch.from_numpy(3.7 * est), torch.from_numpy(ref))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-2)


def test_eval_metrics_dict_matches_jax():
    pairs = [_mix_signals(s, swap=s == 7) for s in (6, 7)]
    refs = np.stack([p[0] for p in pairs]).astype(np.float32)
    ests = np.stack([p[1] for p in pairs]).astype(np.float32)
    got = pm.eval_metrics(torch.from_numpy(refs), torch.from_numpy(ests))
    want = jm.eval_metrics(jnp.asarray(refs), jnp.asarray(ests))
    assert set(got) == set(want) == {"sdr", "sir", "sar", "si_sdr"}
    for k in got:
        assert got[k].shape == (2,)
        np.testing.assert_allclose(
            got[k].numpy(), np.asarray(want[k]),
            atol=SI_SDR_TOL if k == "si_sdr" else DB_TOL, rtol=0, err_msg=k)
    assert (got["sir"] > got["sdr"]).all()
