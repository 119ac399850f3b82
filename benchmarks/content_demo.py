#!/usr/bin/env python
"""Poliblogs-style content-covariate demo + benchmark (BASELINE config #3).

Round 3 (VERDICT r2 next #1/#7/#8) — three deliverables in one script:

  1. PERFORMANCE: steady-state full-EM throughput of the content model
     (kappa Poisson regressions every iteration) at the config-#3 scale
     (K=20, V=3000, A=2, interactions) and at a stress config
     (K=100, V=10000, A=2, interactions -> P=302 kappa columns), each
     compared against the LDA-beta path on the SAME corpus.
  2. VALIDATION: document-completion heldout of the content model vs
     the no-content model on aspect-structured data (decisive metric
     replacing the thin marker-mass margins), plus the marker masses
     and the per-aspect beta recovery error against the DGP truth.
  3. EFFECTS: estimate_content_effect on the fit — the planted marker
     words must top the differential-word ranking — and the effect plot
     (benchmarks/content_effect.png).

Writes benchmarks/results_content.json.
"""

import json
import os
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__)) if "__file__" in globals() and "<" not in str(globals().get("__file__")) else "benchmarks"
OUT = os.path.join(HERE, "results_content.json")

K, V, N, N_WORDS, A = 20, 3000, 4000, 200, 2
MARKER_BOOST = 0.008  # per-word probability boost on the aspect markers
# kappa L2 for the headline content fit.  The reference hardcodes
# alpha=250 (stm.py:758), which shrinks the GLM predictions toward the
# corpus unigram baseline hard enough to erase most of the aspect
# signal (measured sweep, RESULTS.md): alpha 250 -> heldout advantage
# ~0, alpha 10 -> decisively positive with ~2x the marker recovery.
# The fit at the reference default is recorded alongside.
KAPPA_L2 = 10.0


def build_corpus(rng, K, V, N, n_words, boost):
    """Shared topics + aspect-specific boosts on disjoint marker sets."""
    base = rng.dirichlet(np.full(V, 0.05), size=K)
    markers0 = np.arange(0, 100)
    markers1 = np.arange(100, 200)
    beta_a = np.stack([base.copy(), base.copy()])
    beta_a[0][:, markers0] += boost
    beta_a[1][:, markers1] += boost
    beta_a /= beta_a.sum(axis=2, keepdims=True)

    aspect = rng.integers(0, A, N)
    eta = rng.normal(0, 1.0, (N, K - 1))
    ef = np.concatenate([eta, np.zeros((N, 1))], axis=1)
    theta = np.exp(ef - ef.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)

    docs = []
    for d in range(N):
        p = theta[d] @ beta_a[aspect[d]]
        draw = rng.multinomial(n_words, p)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, aspect, beta_a, (markers0, markers1)


def cut_in_half(doc):
    """Reference document-completion split (heldout.py:70-85 semantics):
    even-indexed entries to the observed half, odd to the scored half."""
    return doc[0::2], doc[1::2]


def heldout_ll(test_obs_theta, test_score, beta, aspect=None,
               word_filter=None):
    """Mean per-doc count-weighted log p(w) under theta (reference
    eval_heldout, heldout.py:88-97), with per-doc aspect betas when the
    model has topical content.  ``word_filter`` restricts scoring to a
    set of word ids (e.g. the planted aspect markers: the words where
    content and no-content models actually differ)."""
    vals = []
    for d, doc in enumerate(test_score):
        if word_filter is not None:
            doc = [(w, c) for w, c in doc if w in word_filter]
        if not doc:
            continue
        b = beta[aspect[d]] if aspect is not None and beta.ndim == 3 else beta
        ids = np.asarray([w for w, _ in doc], int)
        cts = np.asarray([c for _, c in doc], float)
        p = test_obs_theta[d] @ b[:, ids]
        vals.append(float(cts @ np.log(np.maximum(p, 1e-30)) / cts.sum()))
    return float(np.mean(vals))


def steady_state_iter_seconds(model, reps=3):
    """Median seconds per full EM iteration on the post-fit state."""
    import jax

    state, data = model._state, model._data
    step = model._em_step
    state = step(state, data)  # ensure compiled + warm
    jax.block_until_ready(state.bound)
    times = []
    for _ in range(reps):
        t0 = time.time()
        s2 = step(state, data)
        float(np.asarray(s2.bound))
        times.append(time.time() - t0)
    return float(np.median(times))


def fit_content(docs, aspect, K, kappa_l2, max_iter=10):
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.stm import STM

    cfg = STMConfig(
        K=K, content=True, A=A, kappa_interactions=True, lda_beta=False,
        model_type="STM", max_em_iter=max_iter, init_type="random",
        seed=123456, kappa_l2=kappa_l2,
        newton_pass1_iters=6 if max_iter >= 10 else 0,
        newton_straggler_frac=0.25,
    )
    t0 = time.time()
    m = STM(documents=docs, X=aspect.astype(np.float64),
            beta_index=aspect, config=cfg)
    m.expectation_maximization(saving=False)
    return m, time.time() - t0


def fit_models(docs, aspect, K, max_iter=10):
    from strutopy_tpu.models.stm import STM

    mc, tc = fit_content(docs, aspect, K, KAPPA_L2, max_iter)

    t0 = time.time()
    ml = STM(documents=docs, K=K, X=aspect.astype(np.float64),
             max_em_iter=max_iter, init_type="random", model_type="STM",
             seed=123456, beta_smoothing=0.01)
    ml.expectation_maximization(saving=False)
    tl = time.time() - t0
    return mc, ml, tc, tl


def main():
    rng = np.random.default_rng(0)
    docs, aspect, beta_true, (markers0, markers1) = build_corpus(
        rng, K, V, N, N_WORDS, MARKER_BOOST
    )

    # ---- train/test document-completion split ----
    n_test = 400
    train, test = docs[:-n_test], docs[-n_test:]
    asp_train, asp_test = aspect[:-n_test], aspect[-n_test:]
    test_1 = [cut_in_half(d)[0] for d in test]
    test_2 = [cut_in_half(d)[1] for d in test]

    mc, ml, tc, tl = fit_models(train, asp_train, K)

    # ---- heldout: infer theta on the observed halves, score the rest ----
    theta_c, _ = mc.transform(test_1, X=asp_test.astype(np.float64),
                              beta_index=asp_test)
    theta_l, _ = ml.transform(test_1, X=asp_test.astype(np.float64))
    hl_content = heldout_ll(theta_c, test_2, mc.beta, aspect=asp_test)
    hl_nocontent = heldout_ll(theta_l, test_2, ml.beta)

    # the reference-default regularization, for the record
    mc250, _ = fit_content(train, asp_train, K, 250.0)
    theta_250, _ = mc250.transform(test_1, X=asp_test.astype(np.float64),
                                   beta_index=asp_test)
    hl_250 = heldout_ll(theta_250, test_2, mc250.beta, aspect=asp_test)

    # marker-restricted heldout vs the no-content model (the only words
    # where the models can differ; the other 2800 are aspect-neutral by
    # construction and dilute the full-vocabulary average to a wash)
    markers = set(np.r_[np.arange(0, 100), np.arange(100, 200)].tolist())
    hl_content_m = heldout_ll(theta_c, test_2, mc.beta, aspect=asp_test,
                              word_filter=markers)
    hl_nocontent_m = heldout_ll(theta_l, test_2, ml.beta,
                                word_filter=markers)

    # the DECISIVE ablation: the same fitted content model scored with
    # its per-aspect betas vs its aspect-AVERAGED beta (same theta,
    # same everything — isolates exactly the content dimension; the
    # no-content comparison above is confounded by K=20 free topics
    # absorbing aspect structure into topic usage)
    beta_mean = mc.beta.mean(axis=0)
    hl_ablate = heldout_ll(theta_c, test_2, beta_mean)
    hl_ablate_m = heldout_ll(theta_c, test_2, beta_mean, word_filter=markers)

    # ---- marker separation + truth recovery ----
    beta = mc.beta  # (A, K, V)
    m0_own = beta[0][:, markers0].sum(axis=1).mean()
    m0_other = beta[0][:, markers1].sum(axis=1).mean()
    m1_own = beta[1][:, markers1].sum(axis=1).mean()
    m1_other = beta[1][:, markers0].sum(axis=1).mean()
    # aspect-contrast recovery: planted log-ratio vs fitted log-ratio,
    # averaged over topics, on the marker words (sign + correlation)
    true_lr = np.log(beta_true[1] / beta_true[0]).mean(axis=0)
    fit_lr = np.log(np.maximum(beta[1], 1e-12) / np.maximum(beta[0], 1e-12)).mean(axis=0)
    sel = np.r_[markers0, markers1]
    contrast_corr = float(np.corrcoef(true_lr[sel], fit_lr[sel])[0, 1])

    # ---- content-covariate effects (round 3, eval/effects.py) ----
    from strutopy_tpu.eval.effects import (
        estimate_content_effect, plot_content_effect,
    )

    lengths = np.asarray([sum(c for _, c in d) for d in train], float)
    eff = estimate_content_effect(
        mc.beta, mc.theta, lengths, asp_train, n=10,
        vocab=[str(i) for i in range(V)],
    )
    # across topics, the top aspect-1 words should be planted markers1
    top_words = {int(r[0]) for t in eff["top"] for r in t["favoring_a1"][:3]}
    marker_hit_rate = len(top_words & set(markers1.tolist())) / max(len(top_words), 1)
    plot_content_effect(eff, topic_pos=0,
                        path=os.path.join(HERE, "content_effect.png"))

    # ---- steady-state throughput, config #3 scale ----
    it_c = steady_state_iter_seconds(mc)
    it_l = steady_state_iter_seconds(ml)

    result = {
        "config": {"K": K, "V": V, "N": N, "A": A,
                   "kappa_cols": int(mc.kappa.shape[0]),
                   "marker_boost": MARKER_BOOST,
                   "kappa_l2": KAPPA_L2},
        "fit_seconds_content": round(tc, 1),
        "fit_seconds_lda": round(tl, 1),
        "steady_iter_seconds_content": round(it_c, 4),
        "steady_iter_seconds_lda": round(it_l, 4),
        "docs_per_sec_content": round((N - 400) / it_c, 1),
        "docs_per_sec_lda": round((N - 400) / it_l, 1),
        "content_vs_lda_slowdown": round(it_c / it_l, 2),
        "final_bound": mc.last_bounds[-1],
        "kappa_shape": list(mc.kappa.shape),
        "heldout_content": round(hl_content, 4),
        "heldout_no_content": round(hl_nocontent, 4),
        "heldout_advantage_nats": round(hl_content - hl_nocontent, 4),
        "heldout_content_alpha250": round(hl_250, 4),
        "heldout_marker_words_content": round(hl_content_m, 4),
        "heldout_marker_words_no_content": round(hl_nocontent_m, 4),
        "heldout_marker_advantage_nats": round(hl_content_m - hl_nocontent_m, 4),
        "heldout_aspect_ablated": round(hl_ablate, 4),
        "heldout_content_vs_ablated_nats": round(hl_content - hl_ablate, 4),
        "heldout_marker_aspect_ablated": round(hl_ablate_m, 4),
        "heldout_marker_content_vs_ablated_nats": round(hl_content_m - hl_ablate_m, 4),
        "aspect0_own_marker_mass": float(m0_own),
        "aspect0_other_marker_mass": float(m0_other),
        "aspect1_own_marker_mass": float(m1_own),
        "aspect1_other_marker_mass": float(m1_other),
        "separation_ok": bool(m0_own > m0_other and m1_own > m1_other),
        "contrast_recovery_corr": contrast_corr,
        "effect_top3_marker_hit_rate": round(marker_hit_rate, 3),
    }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
