"""Branchless positive-definite repair and Cholesky helpers.

The reference repairs non-PD Hessians with a try/except ladder
(diagonal dominance via ``make_pd`` at src/modules/stm.py:964-984, then
a +1e-5 diagonal jitter, see src/modules/stm.py:1017-1021 and
decompose_hessian at :1031-1050).  Under ``jit``/``vmap`` there is no
exception control flow, so the ladder becomes: compute all candidate
factorizations, detect NaN (JAX's Cholesky signals failure with NaNs),
and select — the numeric outcome matches the reference's ladder.

Deliberate deviation from the reference: the sigma precision matrix is
the true inverse ``sigma^{-1} = L^{-T} L^{-1}``.  The reference computes
``np.linalg.inv(L).T * np.linalg.inv(L)`` with ELEMENTWISE ``*``
(src/modules/stm.py:501), which silently yields ``diag(1/L_ii^2)`` — a
diagonal approximation of the precision.  See PARITY_NOTES.md.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular

# Matmul precision for the f32 products the fit's accuracy rests on:
# every product in this module (the blocked factorization/inverse, and
# cho_inverse: sigma^{-1} and the "chol" path's nu), the finalize-stage
# MODEL quantities of ops/estep.py (the final Hessian,
# the bound's loglik/quad terms, the Newton-Schulz inverse), and the
# Newton search's gradient and Armijo objectives, which decide where
# the search stops.  On the GPU, DEFAULT and HIGH both let f32 products
# run as TF32, which keeps a 10-bit mantissa (~5e-4 relative); only
# HIGHEST is true f32.  On CPU all three are f32.
#
# Why HIGHEST: the PD-repair ladder produces Hessians whose smallest
# eigenvalues (0.014-0.050) sit far below ||H|| (~20-54).  On the five
# dumped barely-PD Hessians (tests/fixtures/nan_bisect_H.npz, after the
# make_pd repair), emulated TF32 operand rounding gives blocked_cholesky
# factor errors of 4.7e-4 to 2.6e-2 against float64 — the size of those
# eigenvalues, so log-det and nu would carry TF32 error — against
# <=1e-5 in true f32 (tests/test_linalg_precision.py).  An operand
# rounding of ~eps * ||H|| above the smallest eigenvalue drives pivots
# negative and the factor to NaN (the bf16 case that test also pins).
# In the search, TF32 Armijo objectives stop the line search on
# rounding noise before the 1e-5 gradient is met (oracle eta error
# 7e-2 instead of 2e-2 at K=100 on an H100).  The in-loop Newton
# Hessian (bf16 operands by design) is not affected.
#
# Read at trace time, so an A/B can patch it (pair a patch with
# jax.clear_caches()); ops/estep.py reads it through this module.
MODEL_PREC = jax.lax.Precision.HIGHEST


def make_pd(M: jax.Array) -> jax.Array:
    """Force diagonal dominance (reference make_pd, stm.py:964-984).

    Replaces each diagonal entry by the sum of absolute off-diagonal
    entries in its row whenever it is smaller, making the matrix
    diagonally dominant with non-negative diagonal (hence PSD for
    symmetric input).
    """
    dvec = jnp.diagonal(M)
    magnitudes = jnp.sum(jnp.abs(M), axis=1) - jnp.abs(dvec)
    dvec = jnp.maximum(dvec, magnitudes)
    return M - jnp.diag(jnp.diagonal(M)) + jnp.diag(dvec)


def chol_pd(H: jax.Array, jitter: float = 1e-5) -> jax.Array:
    """Cholesky with the reference's 3-rung PD-repair ladder.

    Rungs (mirroring stm.py:1017-1021 + :1039-1050): plain Cholesky;
    Cholesky of the diagonally-dominant repair; Cholesky of the repair
    plus ``jitter`` on the diagonal.  Returns the first finite factor.
    """
    L1 = jnp.linalg.cholesky(H)
    ok1 = jnp.all(jnp.isfinite(L1))
    H2 = make_pd(H)
    L2 = jnp.linalg.cholesky(H2)
    ok2 = jnp.all(jnp.isfinite(L2))
    eye = jnp.eye(H.shape[-1], dtype=H.dtype)
    L3 = jnp.linalg.cholesky(H2 + jitter * eye)
    L = jnp.where(ok1, L1, jnp.where(ok2, L2, L3))
    return L


def cho_inverse(L: jax.Array) -> jax.Array:
    """Inverse from a lower Cholesky factor: ``(L L^T)^{-1} = L^{-T} L^{-1}``.

    This is the reference's optimize_nu (stm.py:1052-1066): nu is the
    inverse of the (repaired) Hessian.
    """
    eye = jnp.eye(L.shape[-1], dtype=L.dtype)
    Linv = solve_triangular(L, eye, lower=True)
    return jnp.matmul(Linv.T, Linv, precision=MODEL_PREC)


def _small_chol(A: jax.Array) -> jax.Array:
    """Unrolled Cholesky-Banachiewicz for a (B, b, b) SPD batch.

    b sequential column steps, each a batched O(b^2) vector op —
    straight-line code, no lax loop.  Non-PD input yields NaN via
    sqrt of a negative pivot, matching jnp.linalg.cholesky's failure
    signaling.
    """
    b = A.shape[-1]
    L = jnp.zeros_like(A)
    for i in range(b):
        if i:
            corr = jnp.einsum(
                "brk,bk->br", L[:, i:, :i], L[:, i, :i],
                preferred_element_type=A.dtype, precision=MODEL_PREC,
            )
        else:
            corr = jnp.zeros_like(A[:, i:, i])
        v = A[:, i:, i] - corr  # (B, b-i)
        d = jnp.sqrt(v[:, :1])  # (B, 1); NaN if pivot < 0
        # v[0]/d == d, so one set covers pivot and column; a zero or
        # negative pivot propagates inf/NaN for the isfinite ladders
        L = L.at[:, i:, i].set(v / d)
    return L


def _small_tri_inv(L: jax.Array) -> jax.Array:
    """Unrolled forward-substitution inverse of a (B, m, m) lower batch."""
    m = L.shape[-1]
    rows = []
    eye = jnp.eye(m, dtype=L.dtype)
    for i in range(m):
        e = jnp.broadcast_to(eye[i], L.shape[:1] + (m,))
        if i:
            prev = jnp.stack(rows, axis=1)  # (B, i, m)
            corr = jnp.einsum(
                "bk,bkm->bm", L[:, i, :i], prev,
                preferred_element_type=L.dtype, precision=MODEL_PREC,
            )
        else:
            corr = jnp.zeros_like(e)
        rows.append((e - corr) / L[:, i, i][:, None])
    return jnp.stack(rows, axis=1)


def tri_lower_inverse(L: jax.Array, leaf: int = 8) -> jax.Array:
    """Batched lower-triangular inverse by divide and conquer.

    inv([[A, 0], [C, D]]) = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]: the two
    half-size inversions are independent, so the sequential depth is
    log2(n/leaf) with all O(n^3) work in batched einsums — versus the
    n-step sequential substitution of a triangular solve.
    """
    n = L.shape[-1]
    if n <= leaf:
        return _small_tri_inv(L)
    h = n // 2
    Ai = tri_lower_inverse(L[:, :h, :h], leaf)
    Di = tri_lower_inverse(L[:, h:, h:], leaf)
    CA = jnp.einsum("bij,bjk->bik", L[:, h:, :h], Ai,
                    preferred_element_type=L.dtype, precision=MODEL_PREC)
    X = -jnp.einsum("bij,bjk->bik", Di, CA,
                    preferred_element_type=L.dtype, precision=MODEL_PREC)
    B = L.shape[0]
    top = jnp.concatenate(
        [Ai, jnp.zeros((B, h, n - h), L.dtype)], axis=2)
    return jnp.concatenate([top, jnp.concatenate([X, Di], axis=2)], axis=1)


def default_chol_block(p: int) -> int:
    """K-scaled default panel size for :func:`blocked_cholesky`.

    Larger K takes a larger panel so that the number of sequential
    block steps stays near P/16 <= 25.  All block sizes give the same
    factorization up to f32 rounding.
    """
    return 16 if p <= 200 else 32


def blocked_cholesky(H: jax.Array, block: int = 16) -> jax.Array:
    """Batched lower Cholesky of (B, P, P) SPD matrices, straight-line.

    A right-looking blocked factorization: P/block sequential block
    steps, each one unrolled (B, block, block) factorization + a
    log-depth triangular inverse + two batched einsums.  The
    alternative is XLA's Cholesky (``nu_method="chol"``).

    P is padded up to a multiple of ``block`` with an identity tail
    (factor and inverse of the pad are identity; the result is sliced
    back), so any P works.  Non-PD inputs produce NaNs like
    jnp.linalg.cholesky — callers' isfinite repair ladders work
    unchanged.
    """
    B, P, _ = H.shape
    Pp = -(-P // block) * block
    if Pp != P:
        pad = jnp.zeros((B, Pp, Pp), H.dtype)
        pad = pad.at[:, :P, :P].set(H)
        idx = jnp.arange(P, Pp)
        H = pad.at[:, idx, idx].set(1.0)
    nb = Pp // block
    T = H  # trailing matrix, shrinks by one block per step
    cols = []
    for j in range(nb):
        Ajj = T[:, :block, :block]
        Ljj = _small_chol(Ajj)
        r = T.shape[1] - block
        if r:
            Wjj = tri_lower_inverse(Ljj, leaf=8)
            panel = jnp.einsum("brk,bik->bri", T[:, block:, :block], Wjj,
                               preferred_element_type=H.dtype, precision=MODEL_PREC)
            T = T[:, block:, block:] - jnp.einsum(
                "bri,bsi->brs", panel, panel,
                preferred_element_type=H.dtype, precision=MODEL_PREC)
            colj = jnp.concatenate([Ljj, panel], axis=1)  # (B, block+r, block)
        else:
            colj = Ljj
        cols.append(jnp.concatenate(
            [jnp.zeros((B, j * block, block), H.dtype), colj], axis=1))
    L = jnp.concatenate(cols, axis=2)
    return L[:, :P, :P] if Pp != P else L


def blocked_cho_inverse(L: jax.Array, leaf: int = 8) -> jax.Array:
    """Batched (L L^T)^{-1} = W^T W with W = L^{-1} from
    :func:`tri_lower_inverse` — replaces the per-doc triangular solves
    of :func:`cho_inverse` with log-depth batched einsums."""
    W = tri_lower_inverse(L, leaf=leaf)
    return jnp.einsum("bki,bkj->bij", W, W, preferred_element_type=L.dtype,
                      precision=MODEL_PREC)


def precompute_sigma(sigma: jax.Array, jitter: float = 1e-5):
    """Per-EM-iteration sigma factorization (reference stm.py:497-510).

    Returns ``(siginv, sigmaentropy)`` where ``sigmaentropy`` is
    ``sum(log(diag(chol(sigma))))`` (i.e. 0.5 * logdet sigma) and
    ``siginv`` is the true inverse (see module docstring for the
    deliberate deviation from the reference's elementwise product).
    Non-PD sigma falls back to the diagonal-dominance repair instead of
    the reference's broken except-branch (stm.py:503-510).
    """
    L = chol_pd(sigma, jitter=jitter)
    sigmaentropy = jnp.sum(jnp.log(jnp.diagonal(L)))
    siginv = cho_inverse(L)
    # symmetrize against accumulation of float error
    siginv = 0.5 * (siginv + siginv.T)
    return siginv, sigmaentropy
