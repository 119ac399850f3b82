"""Blocked batched Cholesky / triangular inverse vs the XLA primitives.

ops/linalg.py::{blocked_cholesky, tri_lower_inverse, blocked_cho_inverse}
replace XLA's sequential-loop Cholesky and triangular solve in the
finalize stage (the 44 ms hot spot at K=100 —
benchmarks/results_ablate_K100_V10000.json).  The Cholesky factor of an
SPD matrix is unique, so exact agreement with jnp.linalg.cholesky up to
f32 rounding is the contract; NaN signaling on non-PD input must also
match (the PD-repair ladders key on isfinite).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from strutopy_tpu.ops.linalg import (
    blocked_cho_inverse,
    blocked_cholesky,
    cho_inverse,
    tri_lower_inverse,
)


def _spd(B, P, seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    A = rng.normal(0, 1, (B, P, P)).astype(np.float32)
    H = A @ np.transpose(A, (0, 2, 1)) / P + np.eye(P, dtype=np.float32) / cond
    return jnp.asarray(H)


@pytest.mark.parametrize("P", [8, 16, 33, 64, 99, 112])
def test_blocked_cholesky_matches_xla(P):
    H = _spd(12, P, seed=P)
    L_ref = np.asarray(jnp.linalg.cholesky(H))
    L = np.asarray(blocked_cholesky(H))
    assert np.all(np.tril(L) == L)  # strictly lower-triangular output
    np.testing.assert_allclose(L, L_ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("P", [6, 8, 24, 99])
def test_tri_lower_inverse(P):
    H = _spd(8, P, seed=P + 1)
    L = jnp.linalg.cholesky(H)
    W = np.asarray(tri_lower_inverse(L))
    eye = np.einsum("bij,bjk->bik", W, np.asarray(L))
    np.testing.assert_allclose(
        eye, np.broadcast_to(np.eye(P, dtype=np.float32), eye.shape),
        atol=5e-4)
    assert np.all(np.tril(W) == W)


@pytest.mark.parametrize("P", [33, 99])
def test_blocked_cho_inverse_matches_solve(P):
    H = _spd(8, P, seed=P + 2)
    L = jnp.linalg.cholesky(H)
    nu_ref = np.asarray(jax.vmap(cho_inverse)(L))
    nu = np.asarray(blocked_cho_inverse(L))
    np.testing.assert_allclose(nu, nu_ref, rtol=5e-3, atol=5e-4)
    # right-inverse check against the original H (tighter than vs ref)
    eye = np.einsum("bij,bjk->bik", nu, np.asarray(H))
    np.testing.assert_allclose(
        eye, np.broadcast_to(np.eye(P, dtype=np.float32), eye.shape),
        atol=5e-3)


def test_blocked_cholesky_nan_on_non_pd():
    """Non-PD input must be flagged with non-finite entries so the
    PD-repair ladder's isfinite check fires, as with XLA's Cholesky."""
    H = _spd(4, 33, seed=9)
    H = H.at[1].set(H[1] - 10.0 * jnp.eye(33))  # make batch row 1 indefinite
    L = np.asarray(blocked_cholesky(H))
    assert np.all(np.isfinite(L[0]))
    assert not np.all(np.isfinite(L[1]))
    assert np.all(np.isfinite(L[2:]))


def test_blocked_cholesky_jit_grad_free_under_jit():
    """Compiles under jit on the default test platform."""
    H = _spd(4, 99, seed=3)
    f = jax.jit(lambda h: jnp.sum(blocked_cholesky(h)))
    assert np.isfinite(float(f(H)))


def test_run_estep_blocked_matches_chol():
    """nu_method='blocked' through the full E-step: bound/eta/sigma_ss
    match the XLA chol path to f32 rounding (same Newton trajectory —
    the loop is untouched; only finalize's factorization changes)."""
    from strutopy_tpu.ops.estep import NewtonConfig, run_estep
    from strutopy_tpu.ops.linalg import precompute_sigma

    rng = np.random.default_rng(11)
    B, K, L, V = 32, 26, 48, 400
    beta = jnp.asarray(rng.dirichlet(np.ones(V), size=K), jnp.float32)
    words = jnp.asarray(
        np.stack([rng.choice(V, L, replace=False) for _ in range(B)]),
        jnp.int32)
    counts = jnp.asarray(rng.integers(1, 4, (B, L)), jnp.float32)
    mu = jnp.asarray(rng.normal(0, 0.3, (B, K - 1)), jnp.float32)
    eta0 = jnp.zeros((B, K - 1), jnp.float32)
    sigma = jnp.asarray(np.eye(K - 1) + 0.1, jnp.float32)
    siginv, sent = precompute_sigma(sigma)
    asp = jnp.zeros(B, jnp.int32)
    ok = jnp.ones(B, bool)
    base = run_estep(beta, mu, eta0, siginv, sent, words, counts, asp, ok,
                     cfg=NewtonConfig(), batch_size=16)
    blk = run_estep(beta, mu, eta0, siginv, sent, words, counts, asp, ok,
                    cfg=NewtonConfig(nu_method="blocked"), batch_size=16)
    np.testing.assert_allclose(float(blk.bound), float(base.bound),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(blk.eta), np.asarray(base.eta))
    np.testing.assert_allclose(np.asarray(blk.sigma_ss),
                               np.asarray(base.sigma_ss),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(blk.beta_ss),
                               np.asarray(base.beta_ss),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("P", [1, 2, 15, 16, 17])
def test_blocked_cholesky_edge_sizes(P):
    """Pad-boundary and tiny sizes: P=1 (scalar), P just below/at/above
    the 16 block, single-element batch."""
    H = _spd(1, P, seed=40 + P)
    L_ref = np.asarray(jnp.linalg.cholesky(H))
    L = np.asarray(blocked_cholesky(H))
    np.testing.assert_allclose(L, L_ref, rtol=2e-4, atol=2e-5)
    nu = np.asarray(blocked_cho_inverse(jnp.asarray(L)))
    eye = np.einsum("bij,bjk->bik", nu, np.asarray(H))
    np.testing.assert_allclose(
        eye, np.broadcast_to(np.eye(P, dtype=np.float32), eye.shape),
        atol=5e-3)


def test_default_chol_block_k_scaled():
    """0 = auto resolves 16 at K<=200 and 32 above, and the block size
    never changes the factorization beyond f32 rounding."""
    from strutopy_tpu.ops.linalg import default_chol_block

    assert default_chol_block(99) == 16
    assert default_chol_block(199) == 16
    assert default_chol_block(200) == 16
    assert default_chol_block(399) == 32
    H = _spd(2, 48, seed=77)
    L16 = np.asarray(blocked_cholesky(H, block=16))
    L32 = np.asarray(blocked_cholesky(H, block=32))
    np.testing.assert_allclose(L16, L32, rtol=2e-4, atol=2e-5)
