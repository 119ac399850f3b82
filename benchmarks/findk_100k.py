#!/usr/bin/env python
"""Heldout model selection at pod scale (VERDICT r2 next #2).

BASELINE config #5 names "K-sweep {25,50,100,200} with heldout-
likelihood model selection" on the scaled synthetic; round 2 recorded
the sweep's throughput but never exercised the SELECTION clause at
scale.  This runs the fast transform-based document-completion
protocol (reference src/05_train.py:42-179 semantics, single-fit
variant) at N=100k, V=50k with a planted K_true=50:

  * corpus: STM DGP with peaked Dirichlet(0.1) thetas over K_true=50
    topics (near-uniform thetas carry no per-doc signal — RESULTS.md);
  * for each K: fit on all N docs (spectral init, 10 EM iters,
    two-pass schedule), one-E-step transform of the test docs' FIRST
    completion halves, score the SECOND halves;
  * the heldout curve should be flat through the planted K_true and
    decline beyond it (measured: selected K=25 with K_true=50 within
    0.012 nats, then -0.023 to K=100 and -0.031 further to K=200 —
    the parsimonious end of the flat region, the classic shape).

Writes benchmarks/results_findk_100k.json.  Also records the
spectral-init wall-clock at this scale (VERDICT r2 next #5's timing).
"""

import json
import os
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

N, V, N_WORDS, K_TRUE = 100_000, 50_000, 300, 50
N_TEST = 20_000
K_GRID = (25, 50, 100, 200)
HERE = os.path.dirname(os.path.abspath(__file__)) if "__file__" in globals() and "<" not in str(globals().get("__file__")) else "benchmarks"
OUT = os.path.join(HERE, "results_findk_100k.json")
L = 256


def build_corpus(rng):
    beta_true = rng.dirichlet(np.full(V, 0.02), size=K_TRUE).astype(np.float64)
    theta = rng.dirichlet(np.full(K_TRUE, 0.1), size=N)  # peaked docs
    X = rng.integers(0, 2, N).astype(np.float64)

    words = np.zeros((N, L), np.int32)
    counts = np.zeros((N, L), np.float32)
    B = 2048
    for s in range(0, N, B):
        e = min(s + B, N)
        p = theta[s:e] @ beta_true
        for i in range(e - s):
            draw = rng.multinomial(N_WORDS, p[i])
            ids = np.nonzero(draw)[0][:L]
            m = len(ids)
            words[s + i, :m] = ids
            counts[s + i, :m] = draw[ids]
    return words, counts, X


def heldout_ll(theta, beta, w2, c2, chunk=1024):
    """mean_d [ sum_v c_v log(theta_d . beta[:, v]) / sum_v c_v ]."""
    beta = np.asarray(beta, np.float64)
    lls = []
    for s in range(0, len(w2), chunk):
        th = np.asarray(theta[s:s + chunk], np.float64)  # (b, K)
        w = w2[s:s + chunk]
        c = np.asarray(c2[s:s + chunk], np.float64)
        # p[d, l] = theta_d . beta[:, w[d, l]]
        bg = beta[:, w]  # (K, b, Lh)
        p = np.einsum("bk,kbl->bl", th, bg)
        ll = np.sum(c * np.log(np.maximum(p, 1e-30)), axis=1)
        tot = np.maximum(np.sum(c, axis=1), 1e-30)
        ok = tot > 1e-30
        lls.append((ll / tot)[ok])
    return float(np.concatenate(lls).mean())


def main():
    from strutopy_tpu.corpus.bow import PaddedCorpus
    from strutopy_tpu.models.stm import STM

    rng = np.random.default_rng(7)
    t0 = time.time()
    words, counts, X = build_corpus(rng)
    gen_s = time.time() - t0
    print(f"corpus generated in {gen_s:.1f}s", flush=True)

    doc_ok = counts.sum(axis=1) > 0
    corpus = PaddedCorpus(words, counts, doc_ok, V)

    # completion halves of the LAST N_TEST docs (entries are packed at
    # the front, so even/odd positions == the reference's even/odd
    # entry split, heldout.py:70-85)
    tw, tc = words[-N_TEST:], counts[-N_TEST:]
    w1, c1 = tw[:, 0::2], tc[:, 0::2]
    w2, c2 = tw[:, 1::2], tc[:, 1::2]
    test1 = PaddedCorpus(w1, c1, c1.sum(axis=1) > 0, V)
    X_test = X[-N_TEST:]

    results = {}
    timings = {}
    for K in K_GRID:
        t0 = time.time()
        m = STM(
            documents=corpus, K=K, X=X, max_em_iter=10,
            init_type="spectral", model_type="STM", seed=123456,
            beta_smoothing=0.01,
            batch_size=128 if K >= 200 else 256,
        )
        t_init = time.time() - t0
        m.expectation_maximization(saving=False)
        t_fit = time.time() - t0
        theta1, _ = m.transform(test1, X=X_test)
        t_tr = time.time() - t0
        ll = heldout_ll(theta1, m.beta, w2, c2)
        results[K] = ll
        timings[K] = {
            "init_incl_spectral_s": round(t_init, 1),
            "fit_s": round(t_fit - t_init, 1),
            "transform_s": round(t_tr - t_fit, 1),
        }
        print(f"K={K}: heldout={ll:.4f}  {timings[K]}", flush=True)

    best = max(results, key=results.get)
    out = {
        "config": {"N": N, "V": V, "K_true": K_TRUE, "n_test": N_TEST,
                   "K_grid": list(K_GRID), "protocol": "fast-transform",
                   "em_iters": 10, "beta_smoothing": 0.01},
        "heldout_by_K": {str(k): round(v, 5) for k, v in results.items()},
        "selected_K": int(best),
        "timings": timings,
        "corpus_gen_seconds": round(gen_s, 1),
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
