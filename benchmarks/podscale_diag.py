#!/usr/bin/env python
"""Diagnose the round-1 pod-scale bound decline (VERDICT.md weak #2).

Reproduces the scaled-synthetic DGP (K=100, V=50k, 300 words/doc, STM-OLS
prevalence) at an oracle-tractable N, then runs BOTH our device-path EM
(on CPU here, float32) and the float64 scipy oracle (fit_stm_ols) on
the SAME documents/covariates with the SAME seed-123456 init, printing
the two bound trajectories side by side plus per-iteration Newton
saturation stats.

Run from the repo root:
  python benchmarks/podscale_diag.py [N] [ITERS]
"""

import json
import os
import sys
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

N = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
ITERS = int(sys.argv[2]) if len(sys.argv) > 2 else 6
K, V, N_WORDS = 100, 50_000, 300
HERE = os.path.dirname(os.path.abspath(__file__)) or "benchmarks"
OUT = os.path.join(HERE, "results_podscale_diag.json")


def make_docs():
    """The scaled-synthetic DGP (seed 0), BoW-list format."""
    rng = np.random.default_rng(0)
    beta_true = rng.dirichlet(np.full(V, 0.02), size=K).astype(np.float64)
    eta = rng.normal(0.0, 1.0, (N, K - 1))
    ef = np.concatenate([eta, np.zeros((N, 1))], axis=1)
    theta = np.exp(ef - ef.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    X = rng.integers(0, 2, N).astype(np.float64)
    docs = []
    p = theta @ beta_true
    for i in range(N):
        draw = rng.multinomial(N_WORDS, p[i])
        ids = np.nonzero(draw)[0]
        docs.append([(int(w), int(draw[w])) for w in ids])
    return docs, X


def main():
    docs, X = make_docs()
    print(f"N={N} K={K} V={V}, mean unique terms "
          f"{np.mean([len(d) for d in docs]):.0f}", flush=True)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.stm import STM

    t0 = time.time()
    model = STM(
        documents=pad_corpus(docs, V=V),
        dictionary=None,
        K=K,
        X=X,
        max_em_iter=ITERS,
        init_type="random",
        model_type="STM",
        mode="ols",
        seed=123456,
        batch_size=250,
    )
    model.expectation_maximization(saving=False)
    ours = [float(b) for b in model.last_bounds]
    it_stats = getattr(model, "opt_iter_history", None)
    print(f"ours done in {time.time()-t0:.0f}s", flush=True)
    oi = np.asarray(model.state.opt_iters) if hasattr(model, "state") else None

    from strutopy_tpu.utils.reference_numpy import fit_stm_ols

    t0 = time.time()
    oracle_bounds, *_ = fit_stm_ols(docs, model.V, K, X, n_iter=ITERS)
    print(f"oracle done in {time.time()-t0:.0f}s", flush=True)

    print(f"{'iter':>4} {'ours (f32 device path)':>22} {'oracle (f64 scipy)':>22} "
          f"{'rel diff':>10}")
    for i, (a, b) in enumerate(zip(ours, oracle_bounds)):
        print(f"{i:>4} {a:>22.2f} {b:>22.2f} {abs(a-b)/abs(b):>10.2e}")
    if oi is not None:
        print(f"final-iter Newton iters: mean {oi.mean():.1f} "
              f"p50 {np.percentile(oi,50):.0f} p95 {np.percentile(oi,95):.0f} "
              f"max {oi.max()} (cap {model.config.newton_max_iters}) "
              f"saturated {(oi>=model.config.newton_max_iters).mean()*100:.1f}%")

    with open(OUT, "w") as f:
        json.dump({"config": {"N": N, "K": K, "V": V, "n_words": N_WORDS,
                              "iters": ITERS},
                   "ours": ours,
                   "oracle": [float(b) for b in oracle_bounds]}, f, indent=2)
    print("wrote", OUT)


if __name__ == "__main__":
    main()
