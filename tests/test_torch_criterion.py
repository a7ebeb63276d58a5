"""The port's losses (avsep_tpu_torch/models/criterion.py) against the JAX
package's (avsep_tpu/models/criterion.py), values and gradients, on the
same numpy inputs.

Tolerances: the losses are float32 logs, products and means in another
summation order, held at 1e-6 relative; their gradients at 1e-6 relative
to the largest gradient.  At a saturated prediction (p exactly 0 or 1) the
input clip makes both sides' gradient the same bounded value, so it is
held to the same tolerance, and must be finite.  The PIT permutation and
the reordered tensor must agree exactly, ties included.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tests.torch_cpu  # noqa: F401 (torch's threads under xdist)
from avsep_tpu.models import criterion as jc
from avsep_tpu_torch.models import criterion as pc


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def _inputs(seed, shape, saturate=False):
    rs = np.random.RandomState(seed)
    p = rs.uniform(0.01, 0.99, shape).astype(np.float32)
    t = (rs.rand(*shape) > 0.5).astype(np.float32)
    w = rs.uniform(0.1, 3.0, shape).astype(np.float32)
    if saturate:
        p.flat[::7] = 0.0
        p.flat[3::7] = 1.0
    return p, t, w


def _grad_torch(fn, p):
    pt = torch.from_numpy(p).requires_grad_(True)
    out = fn(pt)
    (g,) = torch.autograd.grad(out, pt)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("kind", ["bce", "l1", "l2"])
@pytest.mark.parametrize("saturate", [False, True])
def test_weighted_loss_and_gradient_match_jax(kind, saturate):
    p, t, w = _inputs(1, (3, 16, 8), saturate)
    ref, rg = jax.value_and_grad(
        lambda x: jc.weighted_loss(x, jnp.asarray(t), jnp.asarray(w), kind))(
            jnp.asarray(p))
    got, g = _grad_torch(lambda x: pc.weighted_loss(
        x, torch.from_numpy(t), torch.from_numpy(w), kind), p)
    assert _rel(got, ref) < 1e-6
    assert np.isfinite(g).all()
    assert _rel(g, rg) < 1e-6


def test_bce_clamps_like_jax_at_saturation():
    """p = 0 and 1 against both targets: the clipped value and a finite
    gradient, the JAX package's, where torch's own BCE gives 1e12."""
    p = np.array([0.0, 1.0, 0.0, 1.0, 1e-9, 0.5], np.float32)
    t = np.array([1.0, 0.0, 0.0, 1.0, 1.0, 1.0], np.float32)
    ref = jc.bce_elementwise(jnp.asarray(p), jnp.asarray(t))
    rg = jax.grad(lambda x: jnp.sum(jc.bce_elementwise(x, jnp.asarray(t))))(
        jnp.asarray(p))
    got, g = _grad_torch(lambda x: torch.sum(pc.bce_elementwise(
        x, torch.from_numpy(t))), p)
    np.testing.assert_allclose(
        pc.bce_elementwise(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
        np.asarray(ref), rtol=1e-6)
    assert np.isfinite(g).all() and np.abs(g).max() <= 1.0 / pc._BCE_EPS
    assert _rel(g, rg) < 1e-6


@pytest.mark.parametrize("per_sample", [False, True])
@pytest.mark.parametrize("kind", ["bce", "l1"])
def test_multi_source_loss_and_gradient_match_jax(per_sample, kind):
    rs = np.random.RandomState(2)
    p = rs.uniform(0.01, 0.99, (2, 3, 16, 8)).astype(np.float32)
    t = (rs.rand(2, 3, 16, 8) > 0.5).astype(np.float32)
    w = rs.uniform(0.1, 3.0, (3, 16, 8)).astype(np.float32)
    r = rs.randn(3).astype(np.float32)        # weights the per-sample losses

    def jfn(x):
        out = jc.multi_source_loss(x, jnp.asarray(t), jnp.asarray(w), kind,
                                   per_sample=per_sample)
        return jnp.sum(out * r) if per_sample else out

    def pfn(x):
        out = pc.multi_source_loss(x, torch.from_numpy(t),
                                   torch.from_numpy(w), kind,
                                   per_sample=per_sample)
        return torch.sum(out * torch.from_numpy(r)) if per_sample else out

    ref, rg = jax.value_and_grad(jfn)(jnp.asarray(p))
    got, g = _grad_torch(pfn, p)
    assert _rel(got, ref) < 1e-6 and _rel(g, rg) < 1e-6
    ps = pc.multi_source_loss(torch.from_numpy(p), torch.from_numpy(t),
                              torch.from_numpy(w), kind, per_sample=True)
    whole = pc.multi_source_loss(torch.from_numpy(p), torch.from_numpy(t),
                                 torch.from_numpy(w), kind)
    assert abs(ps.mean().item() - whole.item()) <= 1e-6 * abs(whole.item())


@pytest.mark.parametrize("S", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_pit_matches_jax(S, weighted):
    rs = np.random.RandomState(S)
    p = rs.uniform(0.01, 0.99, (5, 16, 8, S)).astype(np.float32)
    t = (rs.rand(5, 16, 8, S) > 0.5).astype(np.float32)
    w = rs.uniform(0.1, 3.0, (5, 16, 8, S)).astype(np.float32)
    # sample 1: the targets are a permutation of the predictions
    t[1] = p[1][..., ::-1]
    jw = jnp.asarray(w) if weighted else None
    pw = torch.from_numpy(w) if weighted else None
    rl, rperm = jc.pit_loss(jnp.asarray(p), jnp.asarray(t), jw, kind="bce")
    rg = jax.grad(lambda x: jnp.sum(
        jc.pit_loss(x, jnp.asarray(t), jw, kind="bce")[0]))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    loss, perm = pc.pit_loss(pt, torch.from_numpy(t), pw, kind="bce")
    (g,) = torch.autograd.grad(loss.sum(), pt)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))
    assert _rel(loss.detach().numpy(), rl) < 1e-6
    assert _rel(g.numpy(), rg) < 1e-6
    assert perm[1].tolist() == list(range(S))[::-1]


@pytest.mark.parametrize("S", [2, 3])
def test_pit_ties_go_to_the_first_permutation(S):
    """Every permutation scores the same: both pick the identity; with two
    tied minima (sources 0 and 1 equal), both pick the earlier one."""
    p = np.full((2, 4, 4, S), 0.3, np.float32)
    t = np.full((2, 4, 4, S), 1.0, np.float32)
    _, rperm = jc.pit_loss(jnp.asarray(p), jnp.asarray(t), kind="bce")
    _, perm = pc.pit_loss(torch.from_numpy(p), torch.from_numpy(t),
                          kind="bce")
    assert perm.tolist() == np.asarray(rperm).tolist() == [list(range(S))] * 2
    rs = np.random.RandomState(9)
    p = rs.uniform(0.1, 0.9, (3, 4, 4, S)).astype(np.float32)
    p[..., 1] = p[..., 0]
    t = p[..., list(itertools.permutations(range(S)))[-1]].copy()
    _, rperm = jc.pit_loss(jnp.asarray(p), jnp.asarray(t), kind="l2")
    _, perm = pc.pit_loss(torch.from_numpy(p), torch.from_numpy(t),
                          kind="l2")
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))


@pytest.mark.parametrize("S", [2, 3])
def test_reorder_sources_matches_jax(S):
    rs = np.random.RandomState(20 + S)
    x = rs.randn(4, 6, 5, S).astype(np.float32)
    perms = np.array(list(itertools.permutations(range(S))))
    perm = perms[rs.randint(0, len(perms), 4)]
    ref = jc.reorder_sources(jnp.asarray(x), jnp.asarray(perm))
    got = pc.reorder_sources(torch.from_numpy(x), torch.from_numpy(perm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
