"""Batched separation metrics: SI-SDR and BSS-eval SDR / SIR / SAR.

Port of ``avsep_tpu/ops/metrics.py:40-222``.  The reference scores each
eval sample on the host with asteroid's ``get_metrics`` (reference
``main.py:260-261``), a per-sample loop over mir_eval's
``bss_eval_sources``.  Here the BSS-eval decomposition runs batched over
``B`` by broadcasting, on the references' device:

* 512-tap least-squares projection filters, built from rfft
  cross-correlations: one ``[S·flen, S·flen]`` Toeplitz-block Gram per
  sample, factorized once (Cholesky) and solved with the ``S`` estimates
  stacked as right-hand sides;
* the s_target / e_interf / e_artif decomposition and the dB ratios;
* the permutation of the best mean SIR over the S! orders (mir_eval's
  convention, ties to the first);
* SI-SDR with the sources in their given order (asteroid's convention).

The work is cuFFT and cuSOLVER calls on the card (pocketfft and LAPACK on
the CPU), in float32: TF32 plays no part in them.  Shapes: ``refs`` and
``ests`` ``[B, S, L]``.
"""

from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

FLEN = 512  # mir_eval bss_eval_sources filter length


def _db(num: torch.Tensor, den: torch.Tensor, eps: float = 1e-30
        ) -> torch.Tensor:
    return 10.0 * torch.log10((num + eps) / (den + eps))


def si_sdr(est: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SDR, fixed pairing, mean over sources.

    est/ref: ``[..., S, L]``.  Zero-mean both, project est onto ref.
    """
    est = est - torch.mean(est, dim=-1, keepdim=True)
    ref = ref - torch.mean(ref, dim=-1, keepdim=True)
    alpha = (torch.sum(est * ref, -1, keepdim=True)
             / (torch.sum(ref * ref, -1, keepdim=True) + 1e-12))
    target = alpha * ref
    noise = est - target
    val = _db(torch.sum(target ** 2, -1), torch.sum(noise ** 2, -1))
    return torch.mean(val, dim=-1)


# --------------------------------------------------------------- bss_eval


def _toeplitz_from_corr(ssf: torch.Tensor, flen: int) -> torch.Tensor:
    """T[a, b] = ssf[(b - a) mod n_fft], the correlation Toeplitz block."""
    n_fft = ssf.shape[-1]
    a = torch.arange(flen, device=ssf.device)
    idx = (a[None, :] - a[:, None]) % n_fft
    return ssf[..., idx]


def _corr(fa: torch.Tensor, fb: torch.Tensor, n_fft: int) -> torch.Tensor:
    """irfft(fa * conj(fb)): the circular cross-correlation of two real
    signals from their rfft spectra."""
    return torch.fft.irfft(fa * torch.conj(fb), n=n_fft, dim=-1)


def _fftconvolve(c: torch.Tensor, x_f: torch.Tensor, n_fft: int,
                 out_len: int) -> torch.Tensor:
    cf = torch.fft.rfft(c, n=n_fft, dim=-1)
    return torch.fft.irfft(cf * x_f, n=n_fft, dim=-1)[..., :out_len]


def _psolve(G: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``G x = rhs`` for symmetric positive-semidefinite ``G [..., n,
    n]`` by Cholesky, batched over the leading dims.

    As in the JAX package (``_psolve``, metrics.py:79-110): relative
    diagonal loading ``1e-7 · trace + 1e-12`` keeps a singular Gram
    (duplicated or gain-scaled sources, narrowband references) positive
    definite in float32, with a condition number of at most 1e7.  A
    factorization that fails all the same gives NaN for that sample, as
    JAX's does: ``cholesky_ex`` reports the failure in ``info`` instead of
    raising, so no host sync is added.
    """
    n = G.shape[-1]
    scale = G.diagonal(dim1=-2, dim2=-1).sum(-1)
    G = G + (1e-7 * scale + 1e-12)[..., None, None] * torch.eye(
        n, dtype=G.dtype, device=G.device)
    L, info = torch.linalg.cholesky_ex(G)
    L = torch.where((info == 0)[..., None, None], L,
                    torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _decompose_all(refs: torch.Tensor, ests: torch.Tensor, flen: int = FLEN):
    """All S x S BSS-eval decompositions of each sample, sharing the Gram.

    refs/ests: ``[B, S, L]``.  Returns (sdr, sir, sar), each ``[B, S, S]``
    with entry ``[b, i, j]`` = metric(est_j vs ref_i), per mir_eval's
    _bss_decomp_mtifilt: p_true = proj(est_j | ref_i shifts), p_all =
    proj(est_j | all shifts).  The Gram of all sources' shifted versions
    depends on the references only: it is factorized once per sample and
    solved with the S estimates stacked as right-hand sides.
    """
    B, S, L = refs.shape
    out_len = L + flen - 1
    n_fft = int(2 ** np.ceil(np.log2(out_len)))
    a = torch.arange(flen, device=refs.device)
    src = torch.arange(S, device=refs.device)

    refs_f = torch.fft.rfft(refs, n=n_fft, dim=-1)       # [B, S, K]
    ests_f = torch.fft.rfft(ests, n=n_fft, dim=-1)       # [B, S, K]

    # the shared Gram of all sources' shifted versions
    corr_ij = _corr(refs_f[:, :, None], refs_f[:, None], n_fft)  # [B,S,S,n]
    G_blocks = _toeplitz_from_corr(corr_ij, flen)        # [B, S, S, f, f]
    G = G_blocks.permute(0, 1, 3, 2, 4).reshape(B, S * flen, S * flen)

    # cross-correlations ref_i x est_j, one gather for every pair
    d_corr = _corr(refs_f[:, :, None], ests_f[:, None], n_fft)   # [B,S,S,n]
    D = d_corr[..., (-a) % n_fft]                        # [B, S, S, flen]

    # one factorization, S stacked right-hand sides (one per estimate)
    D_all = D.permute(0, 1, 3, 2).reshape(B, S * flen, S)
    C = _psolve(G, D_all).reshape(B, S, flen, S)         # [b, s, flen, j]
    C = C.permute(0, 3, 1, 2)                            # [b, j, s, flen]
    # p_all[b, j] = sum_s conv(C[b, j, s], refs[b, s])
    p_all = torch.sum(_fftconvolve(C, refs_f[:, None], n_fft, out_len),
                      dim=2)                             # [B, j, out_len]

    # true-source projections: the diagonal Gram blocks, S RHS each
    Gjj = G_blocks[:, src, src]                          # [B, i, flen, flen]
    Cj = _psolve(Gjj, D.permute(0, 1, 3, 2))             # [B, i, flen, j]
    # p_true[b, i, j] = conv(Cj[b, i, :, j], refs[b, i])
    p_true = _fftconvolve(Cj.permute(0, 1, 3, 2), refs_f[:, :, None],
                          n_fft, out_len)                # [B, i, j, out_len]

    est_pad = F.pad(ests, (0, flen - 1))                 # [B, j, out_len]
    e_interf = p_all[:, None] - p_true                   # [B, i, j, out_len]
    e_artif = (est_pad - p_all)[:, None]                 # [B, 1, j, out_len]
    # s_true + e_spat == p_true by construction
    sdr = _db(torch.sum(p_true ** 2, -1),
              torch.sum((e_interf + e_artif) ** 2, -1))
    sir = _db(torch.sum(p_true ** 2, -1), torch.sum(e_interf ** 2, -1))
    sar = _db(torch.sum((p_true + e_interf) ** 2, -1),
              torch.sum(e_artif ** 2, -1).expand(B, S, S))
    return sdr, sir, sar


def bss_eval_sources(refs: torch.Tensor, ests: torch.Tensor,
                     compute_permutation: bool = True):
    """Batched bss_eval: refs/ests ``[B, S, L]`` -> (sdr, sir, sar, perm),
    each ``[B, S]``, with mir_eval.separation.bss_eval_sources' semantics
    (the permutation of the best mean SIR)."""
    B, S, _ = refs.shape
    sdr_m, sir_m, sar_m = _decompose_all(refs, ests)     # [B, S, S]
    idx = torch.arange(S, device=refs.device)

    if not compute_permutation:
        perm = idx.expand(B, S)
        return (sdr_m[:, idx, idx], sir_m[:, idx, idx], sar_m[:, idx, idx],
                perm)

    perms = torch.tensor(list(itertools.permutations(range(S))),
                         device=refs.device)             # [P, S]
    idx_ps = idx.expand(perms.shape)

    def gather(m):  # m [B, S, S] -> [B, P, S]: m[b, i, perms[p, i]]
        return m[:, idx_ps, perms]

    # torch.argmax returns the first maximum, as jnp.argmax
    best = torch.argmax(torch.mean(gather(sir_m), -1), -1)    # [B]

    def pick(m):
        return torch.gather(gather(m), 1,
                            best[:, None, None].expand(B, 1, S))[:, 0]

    return pick(sdr_m), pick(sir_m), pick(sar_m), perms[best]


def eval_metrics(refs: torch.Tensor, ests: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """get_metrics-style dict of ``[B]`` tensors: sdr / sir / sar (mean
    over sources, permuted) and si_sdr (fixed order), reference
    main.py:260-266."""
    sdr, sir, sar, _ = bss_eval_sources(refs, ests)
    return {"sdr": torch.mean(sdr, -1), "sir": torch.mean(sir, -1),
            "sar": torch.mean(sar, -1), "si_sdr": si_sdr(ests, refs)}
