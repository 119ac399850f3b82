"""Two-pass difficulty schedule: must reproduce the single-pass E-step.

Each Newton step is a pure per-doc function of eta (per-doc Armijo
selection, fixed CG count), so capping pass 1 and resuming stragglers
in regrouped chunks replays the exact same per-doc trajectories; only
the f32 scatter order of beta_ss differs.  These tests pin that
equivalence at the run_estep level and end-to-end through STM.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from strutopy_tpu.models.config import STMConfig

pytestmark = pytest.mark.smoke
from strutopy_tpu.models.stm import STM
from strutopy_tpu.ops.estep import NewtonConfig, run_estep
from strutopy_tpu.ops.linalg import precompute_sigma


def _problem(N=64, K=6, L=20, V=80, seed=0):
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.1), size=K).astype(np.float32)
    words = rng.integers(0, V, (N, L)).astype(np.int32)
    counts = rng.integers(1, 4, (N, L)).astype(np.float32)
    mu = rng.normal(0, 0.5, (N, K - 1)).astype(np.float32)
    eta0 = np.zeros((N, K - 1), np.float32)
    sigma = (np.eye(K - 1) + 0.1).astype(np.float32)
    aspects = np.zeros(N, np.int32)
    doc_ok = np.ones(N, bool)
    return beta, mu, eta0, sigma, words, counts, aspects, doc_ok


def test_two_pass_matches_single_pass():
    beta, mu, eta0, sigma, words, counts, aspects, doc_ok = _problem()
    siginv, sent = precompute_sigma(jnp.asarray(sigma))
    args = [jnp.asarray(x) for x in (beta, mu, eta0)] + [siginv, sent] + [
        jnp.asarray(x) for x in (words, counts, aspects, doc_ok)
    ]
    cfg = NewtonConfig(max_iters=24)
    one = run_estep(*args, cfg=cfg, batch_size=16)
    two = run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=4,
                    straggler_frac=1.0)

    # identical per-doc trajectories (not just close): eta bit-equal
    np.testing.assert_array_equal(np.asarray(two.eta), np.asarray(one.eta))
    np.testing.assert_array_equal(
        np.asarray(two.newton_iters), np.asarray(one.newton_iters)
    )
    np.testing.assert_allclose(two.bound, one.bound, rtol=1e-6)
    np.testing.assert_allclose(two.beta_ss, one.beta_ss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(two.sigma_ss, one.sigma_ss, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(two.theta, one.theta, rtol=1e-5, atol=1e-7)


def test_two_pass_budget_underrun_degrades_gracefully():
    """A straggler budget too small to cover every unconverged doc must
    behave like a per-doc max_iters cap: overflow docs keep pass-1 eta,
    everything stays finite, and no doc runs MORE iterations."""
    beta, mu, eta0, sigma, words, counts, aspects, doc_ok = _problem()
    siginv, sent = precompute_sigma(jnp.asarray(sigma))
    args = [jnp.asarray(x) for x in (beta, mu, eta0)] + [siginv, sent] + [
        jnp.asarray(x) for x in (words, counts, aspects, doc_ok)
    ]
    cfg = NewtonConfig(max_iters=24)
    one = run_estep(*args, cfg=cfg, batch_size=16)
    two = run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=4,
                    straggler_frac=0.25)
    i1 = np.asarray(one.newton_iters)
    i2 = np.asarray(two.newton_iters)
    assert np.all(i2 <= i1)
    assert np.isfinite(float(two.bound))
    np.testing.assert_allclose(two.bound, one.bound, rtol=5e-3)
    # docs whose budget was cut short are exactly the ones capped at
    # pass1_iters with more work left in the single-pass run
    short = i2 < i1
    assert np.all(i2[short] == 4)


def test_two_pass_pass1_covers_all_iters():
    """pass1_iters >= actual worst-case Newton count: pass 2 is a no-op
    and results still match."""
    beta, mu, eta0, sigma, words, counts, aspects, doc_ok = _problem(seed=3)
    siginv, sent = precompute_sigma(jnp.asarray(sigma))
    args = [jnp.asarray(x) for x in (beta, mu, eta0)] + [siginv, sent] + [
        jnp.asarray(x) for x in (words, counts, aspects, doc_ok)
    ]
    cfg = NewtonConfig(max_iters=24)
    one = run_estep(*args, cfg=cfg, batch_size=16)
    two = run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=23)
    np.testing.assert_array_equal(np.asarray(two.eta), np.asarray(one.eta))
    np.testing.assert_allclose(two.bound, one.bound, rtol=1e-6)


def test_two_pass_end_to_end_stm(toy_corpus, toy_dictionary, toy_metadata):
    train_docs = toy_corpus.train_docs
    kwargs = dict(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=3,
        init_type="random",
        model_type="STM",
        seed=123456,
    )
    m1 = STM(**kwargs)
    m1.expectation_maximization(saving=False)
    m2 = STM(
        **kwargs,
        config=STMConfig(
            K=3, model_type="STM", init_type="random",
            max_em_iter=3, newton_pass1_iters=5,
        ),
    )
    m2.expectation_maximization(saving=False)
    np.testing.assert_allclose(
        np.asarray(m2.last_bounds), np.asarray(m1.last_bounds), rtol=1e-5
    )
    np.testing.assert_allclose(m2.beta, m1.beta, atol=1e-5)


def test_warmup_switch_builds_cold_graph(toy_corpus, toy_dictionary, toy_metadata):
    """newton_warmup_iters: cold EM iterations run the single-pass
    graph, later ones the two-pass graph; the fit stays sane."""
    train_docs = toy_corpus.train_docs
    m = STM(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        config=STMConfig(
            K=3, model_type="STM", init_type="random", max_em_iter=4,
            newton_pass1_iters=5, newton_warmup_iters=2,
        ),
    )
    assert m._em_step_cold is not None
    m.expectation_maximization(saving=False)
    assert np.all(np.isfinite(np.asarray(m.last_bounds)))

    m_off = STM(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=2,
        init_type="random",
    )
    assert m_off._em_step_cold is None


def test_config_validates_two_pass():
    with pytest.raises(ValueError, match="newton_pass1_iters"):
        STMConfig(K=3, newton_pass1_iters=30, newton_max_iters=24)
    with pytest.raises(ValueError, match="straggler_frac"):
        STMConfig(K=3, newton_pass1_iters=4, newton_straggler_frac=0.0)


def test_straggler_overflow_diagnostic():
    """ADVICE r2: docs the straggler budget cannot admit must be counted
    into EStepResult.straggler_overflow instead of silently keeping
    their pass-1 eta."""
    beta, mu, eta0, sigma, words, counts, aspects, doc_ok = _problem(
        N=64, K=6, seed=1
    )
    siginv, sent = precompute_sigma(jnp.asarray(sigma))
    args = [jnp.asarray(x) for x in (beta, mu, eta0)] + [siginv, sent] + [
        jnp.asarray(x) for x in (words, counts, aspects, doc_ok)
    ]
    # pass1 of a single step with a minimal budget (one 16-doc chunk):
    # most docs are unconverged after 1 Newton step -> overflow > 0
    res_tight = run_estep(
        *args, cfg=NewtonConfig(max_iters=24), batch_size=16,
        pass1_iters=1, straggler_frac=0.01,
    )
    assert int(res_tight.straggler_overflow) > 0
    # a full budget admits everyone
    res_full = run_estep(
        *args, cfg=NewtonConfig(max_iters=24), batch_size=16,
        pass1_iters=1, straggler_frac=1.0,
    )
    assert int(res_full.straggler_overflow) == 0
    # single-pass path reports 0
    res_single = run_estep(*args, cfg=NewtonConfig(max_iters=24), batch_size=16)
    assert int(res_single.straggler_overflow) == 0


# ---------------------------------------------------------------------------
# fused finalize (round 3, ops/estep.py::_two_pass_fused_estep)
# ---------------------------------------------------------------------------


def _args(seed=0, **kw):
    beta, mu, eta0, sigma, words, counts, aspects, doc_ok = _problem(
        seed=seed, **kw)
    siginv, sent = precompute_sigma(jnp.asarray(sigma))
    return [jnp.asarray(x) for x in (beta, mu, eta0)] + [siginv, sent] + [
        jnp.asarray(x) for x in (words, counts, aspects, doc_ok)
    ]


def test_fused_matches_unfused_two_pass():
    """Same Newton trajectories; stats differ only in f32 sum order."""
    args = _args()
    cfg = NewtonConfig(max_iters=24)
    kw = dict(cfg=cfg, batch_size=16, pass1_iters=4, straggler_frac=1.0)
    two = run_estep(*args, **kw)
    fused = run_estep(*args, **kw, fused_finalize=True)
    np.testing.assert_array_equal(np.asarray(fused.eta), np.asarray(two.eta))
    np.testing.assert_array_equal(
        np.asarray(fused.newton_iters), np.asarray(two.newton_iters)
    )
    assert int(fused.straggler_overflow) == int(two.straggler_overflow) == 0
    np.testing.assert_allclose(fused.bound, two.bound, rtol=1e-6)
    np.testing.assert_allclose(fused.beta_ss, two.beta_ss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.sigma_ss, two.sigma_ss, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused.theta, two.theta, rtol=1e-5, atol=1e-7)


def test_fused_overflow_fallback_matches_unfused():
    """Budget overflow: the lax.cond sweep must finalize the overflow
    docs at their pass-1 eta, exactly like unfused pass 3."""
    args = _args(seed=1)
    cfg = NewtonConfig(max_iters=24)
    kw = dict(cfg=cfg, batch_size=16, pass1_iters=1, straggler_frac=0.01)
    two = run_estep(*args, **kw)
    fused = run_estep(*args, **kw, fused_finalize=True)
    assert int(two.straggler_overflow) > 0
    assert int(fused.straggler_overflow) == int(two.straggler_overflow)
    np.testing.assert_array_equal(np.asarray(fused.eta), np.asarray(two.eta))
    np.testing.assert_allclose(fused.bound, two.bound, rtol=1e-6)
    np.testing.assert_allclose(fused.beta_ss, two.beta_ss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(fused.sigma_ss, two.sigma_ss, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(fused.theta, two.theta, rtol=1e-5, atol=1e-7)


def test_fused_noop_without_pass2_budget():
    """pass1_iters >= max_iters leaves no pass-2 budget: fused must
    delegate to the unfused path (which finalizes inline anyway)."""
    args = _args(seed=3)
    cfg = NewtonConfig(max_iters=24)
    # pass1_iters == max_iters: rest == 0 (direct-caller-only regime)
    a = run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=24)
    b = run_estep(*args, cfg=cfg, batch_size=16, pass1_iters=24,
                  fused_finalize=True)
    np.testing.assert_array_equal(np.asarray(a.eta), np.asarray(b.eta))
    np.testing.assert_array_equal(np.asarray(a.bound), np.asarray(b.bound))


def test_fused_end_to_end_stm(toy_corpus, toy_dictionary, toy_metadata):
    train_docs = toy_corpus.train_docs
    base = dict(K=3, model_type="STM", init_type="random", max_em_iter=3,
                newton_pass1_iters=5)
    fits = []
    for fused in (False, True):
        m = STM(
            documents=train_docs,
            dictionary=toy_dictionary,
            K=3,
            X=toy_metadata[: len(train_docs)],
            config=STMConfig(**base, two_pass_fused=fused),
        )
        m.expectation_maximization(saving=False)
        fits.append(m)
    np.testing.assert_allclose(
        np.asarray(fits[1].last_bounds), np.asarray(fits[0].last_bounds),
        rtol=1e-5,
    )
    np.testing.assert_allclose(fits[1].beta, fits[0].beta, atol=1e-5)
    np.testing.assert_allclose(fits[1].theta, fits[0].theta, atol=1e-5)
