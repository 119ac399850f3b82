"""Matmul-precision contract of the finalize path.

The PD-repair ladder can produce Hessians whose smallest eigenvalues
(0.014-0.05 on the five fixture documents) sit far below their norm
(~20-54).  ``blocked_cholesky`` factors such a matrix correctly only if
its Schur-complement products keep more precision than that gap: an
operand rounding of ~eps * ||H|| above the smallest eigenvalue drives
pivots negative, and the factor becomes NaN or carries errors as large
as the eigenvalues themselves (and with it log-det and nu).

Contract under test:

1. Every product in the blocked factorization/inverse path and the
   finalize-stage model quantities runs at ``ops/linalg.py::MODEL_PREC``,
   pinned to ``Precision.HIGHEST``: true f32 on the GPU.  DEFAULT and
   HIGH let the GPU run f32 products as TF32 (10-bit mantissa), which
   on the fixture gives factor errors of 4.7e-4 to 2.6e-2.
2. ``_chol_pd_batched`` has a scale-aware terminal rung (rel_jitter x
   per-doc max|H|): the reference ladder's fixed 1e-5 jitter is 1000x
   below the product error at matrix scale ~50, so a ladder without it
   could exhaust all rungs and return NaN.

CPU ignores matmul precision, so these tests EMULATE reduced-precision
products at the einsum level: TF32 rounds each f32 operand's mantissa to
10 bits (round to nearest even); bf16 casts it through bfloat16.

Fixture: tests/fixtures/nan_bisect_H.npz — five (eta, H) pairs dumped
from an N=250k spectral-init fit whose bound went NaN when these
products ran at bf16.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import strutopy_tpu.ops.estep as estep_mod
import strutopy_tpu.ops.linalg as linalg_mod
from strutopy_tpu.ops.linalg import blocked_cho_inverse, blocked_cholesky

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "nan_bisect_H.npz")

_REAL_EINSUM = jnp.einsum
_P = jax.lax.Precision


def _bf16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


def _tf32(x):
    """Round f32 values to TF32's 10-bit mantissa (nearest even)."""
    b = jax.lax.bitcast_convert_type(x, jnp.uint32)
    b = (b + jnp.uint32(0xFFF) + ((b >> 13) & jnp.uint32(1))) \
        & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(b, jnp.float32)


def _emulated_einsum(force=None):
    """Emulate GPU matmul precision for f32 operands.

    A product below HIGHEST reads its operands at TF32; HIGHEST is true
    f32.  ``force`` (an operand-rounding function) overrides every
    product's precision: it models code that never asks for more."""

    def einsum(subscripts, *ops, precision=None, **kw):
        is32 = [hasattr(o, "dtype") and o.dtype == jnp.float32 for o in ops]
        if not all(is32) or len(ops) != 2:
            return _REAL_EINSUM(subscripts, *ops, precision=_P.HIGHEST, **kw)
        if force is not None:
            rnd = force
        elif precision == _P.HIGHEST:
            rnd = None
        else:
            rnd = _tf32
        if rnd is not None:
            ops = tuple(rnd(o) for o in ops)
        return _REAL_EINSUM(subscripts, *ops, precision=_P.HIGHEST, **kw)

    return einsum


@pytest.fixture(scope="module")
def repaired_H():
    """The five dumped Hessians after the production PD-repair rung."""
    Hs = np.load(FIXTURE)["Hs"].astype(np.float32)  # (5, 49, 49)
    return estep_mod._make_pd_batched(jnp.asarray(Hs))


@pytest.fixture(scope="module")
def L64(repaired_H):
    """float64 factors of the repaired fixture."""
    return np.linalg.cholesky(np.asarray(repaired_H, np.float64))


def _factor_errors(L, L64):
    """Per-document max |L - L64| over the lower triangle."""
    return np.abs(np.tril(np.asarray(L, np.float64)) - L64).max(axis=(1, 2))


def test_production_precision_is_high_or_better():
    # on the GPU only HIGHEST is true f32 (HIGH may run as TF32)
    assert linalg_mod.MODEL_PREC == _P.HIGHEST


def test_fixture_is_barely_pd(repaired_H):
    # the regime that distinguishes f32 from TF32/bf16 operands: eig_min
    # far below eps * ||H||
    ev = np.linalg.eigvalsh(np.asarray(repaired_H, np.float64))
    assert (ev[:, 0] > 0).all()
    assert (ev[:, 0] < 0.008 * np.abs(ev).max(axis=1)).all()


def test_blocked_cholesky_finite_under_pinned_precision(
        repaired_H, L64, monkeypatch):
    # honor each call's requested precision with GPU semantics — the
    # shipped code asks for HIGHEST everywhere on the contract path, so
    # nothing is rounded to TF32
    monkeypatch.setattr(jnp, "einsum", _emulated_einsum())
    L = np.asarray(blocked_cholesky(repaired_H))
    assert np.isfinite(L).all(), (
        "blocked_cholesky NaN'd under GPU precision emulation: a "
        "product in ops/linalg.py lost its HIGHEST precision annotation"
    )
    # true f32 measures <= 1e-5 against float64 on this fixture
    assert _factor_errors(L, L64).max() <= 1e-4
    Hinv = np.asarray(blocked_cho_inverse(jnp.asarray(L)))
    assert np.isfinite(Hinv).all()


@pytest.mark.parametrize("doc", range(5))
def test_tf32_factor_error_is_what_the_pin_avoids(repaired_H, L64, doc,
                                                  monkeypatch):
    # what HIGH (TF32 on this card) would give, document by document:
    # factor errors of 4.7e-4 .. 2.6e-2, the size of the fixture's
    # smallest eigenvalues; the pinned HIGHEST path stays at f32 rounding
    pinned = _factor_errors(blocked_cholesky(repaired_H), L64)[doc]
    monkeypatch.setattr(jnp, "einsum", _emulated_einsum(force=_tf32))
    tf32 = _factor_errors(blocked_cholesky(repaired_H), L64)[doc]
    assert pinned <= 1e-4
    assert tf32 >= 4e-4
    assert tf32 >= 20 * pinned


def test_tf32_factor_error_reaches_the_smallest_eigenvalue(
        repaired_H, L64, monkeypatch):
    ev_min = np.linalg.eigvalsh(np.asarray(repaired_H, np.float64))[:, 0]
    monkeypatch.setattr(jnp, "einsum", _emulated_einsum(force=_tf32))
    err = _factor_errors(blocked_cholesky(repaired_H), L64)
    # the margin a finalize product needs is gone under TF32: the worst
    # document's factor error is a sizeable fraction of its smallest
    # eigenvalue
    assert (err / ev_min).max() > 0.2


def test_default_truncation_reproduces_the_bf16_nan(repaired_H, monkeypatch):
    # bf16 operand reads on EVERY product: the barely-PD fixture must
    # break, or it would not be guarding anything
    monkeypatch.setattr(jnp, "einsum", _emulated_einsum(force=_bf16))
    L = np.asarray(blocked_cholesky(repaired_H))
    assert not np.isfinite(L).all(), (
        "fixture no longer exercises the bf16-truncation failure mode"
    )


def test_ladder_terminal_rung_catches_rung3_failures():
    """Rung 4 (scale-aware jitter) factors documents where the fixed
    1e-5 rung-3 jitter fails — the N=1M ladder-exhaustion mode.  A
    chol_fn stub fails any matrix whose diagonal boost is below the
    rung-4 level, simulating precision-induced pivot flips."""
    rng = np.random.default_rng(0)
    B, K = 3, 16
    A = rng.normal(size=(B, K, K)).astype(np.float32)
    H = jnp.asarray(A @ np.transpose(A, (0, 2, 1)) + 30.0 * np.eye(K))
    H2 = estep_mod._make_pd_batched(H)  # == H here (already dominant)
    maxabs = jnp.max(jnp.abs(H2), axis=(1, 2))
    # fails rungs 1-3 (diag boost < 1e-3*maxabs), succeeds on rung 4
    thresh = jnp.diagonal(H2, axis1=1, axis2=2).sum(axis=1) \
        + 0.5e-3 * maxabs * K

    def flaky_chol(M):
        tr = jnp.diagonal(M, axis1=1, axis2=2).sum(axis=1)
        L = jnp.linalg.cholesky(M)
        bad = jnp.full_like(L, jnp.nan)
        return jnp.where((tr > thresh)[:, None, None], L, bad)

    L = estep_mod._chol_pd_batched(H, chol_fn=flaky_chol)
    assert np.isfinite(np.asarray(L)).all(), (
        "ladder returned NaN where the scale-aware terminal rung "
        "should have factored"
    )
    # the rung-4 factor is the Cholesky of H2 + 1e-3*max|H2|*I
    want = np.asarray(jnp.linalg.cholesky(
        H2 + (1e-3 * maxabs)[:, None, None] * jnp.eye(K)))
    np.testing.assert_allclose(np.asarray(L), want, rtol=1e-5, atol=1e-6)


def test_finalize_bmm_outer_f32_is_truncation_immune(monkeypatch):
    rng = np.random.default_rng(3)
    Bm = jnp.asarray(rng.normal(0, 1, (4, 16, 64)), jnp.float32)
    want = np.asarray(estep_mod._bmm_outer(Bm))

    monkeypatch.setattr(jnp, "einsum", _emulated_einsum())
    got = np.asarray(estep_mod._bmm_outer(Bm))
    # f32 operands (the finalize Hessian) must run at HIGHEST: TF32
    # rounding would give ~1e-3 errors here.  bf16 operands (the
    # in-loop Hessian) keep DEFAULT by design — not asserted here.
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_newton_search_is_tf32_immune(monkeypatch):
    """The gradient and the Armijo objectives decide where the Newton
    search stops.  With their products at TF32, the line search fails
    on rounding noise before the 1e-5 gradient is met: against the
    float64 oracle this small E-step's eta error grows from ~2e-5 to
    ~4e-2 and its bound error from ~6e-8 to ~1e-5.  They run at
    MODEL_PREC, so emulated GPU semantics must leave the f32 result."""
    import chip_smoke

    monkeypatch.setattr(jnp, "einsum", _emulated_einsum())
    err, _ = chip_smoke.oracle_estep_errors(n_docs=64, K=30, V=2000)
    assert err["eta"] <= 1e-3
    assert err["bound"] <= 1e-6
