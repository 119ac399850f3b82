#!/usr/bin/env python
"""Content-model STRESS benchmark (VERDICT r2 next #1): K=100, V=10k,
A=2 with interactions -> P = K + A + A*K = 302 kappa columns, N=8192.

At this scale the V independent (P, P) Poisson-Newton solves are the
M-step's dominant cost; the round-3 solver (warm-started, early-exit,
blocked-Cholesky batched) must keep the content fit within a small
factor of the LDA-beta path.  Measures steady-state full-EM seconds
per iteration for both paths on the SAME corpus.

Writes benchmarks/results_content_stress.json.
"""

import json
import os
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__)) if "__file__" in globals() and "<" not in str(globals().get("__file__")) else "benchmarks"
OUT = os.path.join(HERE, "results_content_stress.json")

K, V, N, N_WORDS, A = 100, 10_000, 8192, 300, 2


def main():
    rng = np.random.default_rng(0)
    base = rng.dirichlet(np.full(V, 0.05), size=K)
    beta_a = np.stack([base, base])
    aspect = rng.integers(0, A, N)
    eta = rng.normal(0, 1.0, (N, K - 1))
    ef = np.concatenate([eta, np.zeros((N, 1))], axis=1)
    theta = np.exp(ef - ef.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    docs = []
    for d in range(N):
        p = theta[d] @ beta_a[aspect[d]]
        draw = rng.multinomial(N_WORDS, p)
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))

    import jax

    from strutopy_tpu.models.stm import STM

    def steady(m, reps=3):
        state, data = m._state, m._data
        step = m._em_step
        state = step(state, data)
        jax.block_until_ready(state.bound)
        ts = []
        for _ in range(reps):
            t0 = time.time()
            s2 = step(state, data)
            float(np.asarray(s2.bound))
            ts.append(time.time() - t0)
        return float(np.median(ts))

    common = dict(documents=docs, K=K, X=aspect.astype(np.float64),
                  max_em_iter=5, init_type="random", model_type="STM",
                  seed=123456, batch_size=256)

    t0 = time.time()
    mc = STM(content=True, A=A, beta_index=aspect, kappa_interactions=True,
             lda_beta=False, **common)
    mc.expectation_maximization(saving=False)
    fit_c = time.time() - t0
    it_c = steady(mc)

    t0 = time.time()
    ml = STM(**common)
    ml.expectation_maximization(saving=False)
    fit_l = time.time() - t0
    it_l = steady(ml)

    result = {
        "config": {"K": K, "V": V, "N": N, "A": A,
                   "kappa_cols": int(mc.kappa.shape[0])},
        "fit_seconds_content_5it": round(fit_c, 1),
        "fit_seconds_lda_5it": round(fit_l, 1),
        "steady_iter_seconds_content": round(it_c, 4),
        "steady_iter_seconds_lda": round(it_l, 4),
        "docs_per_sec_content": round(N / it_c, 1),
        "docs_per_sec_lda": round(N / it_l, 1),
        "content_vs_lda_slowdown": round(it_c / it_l, 2),
        "final_bound_content": mc.last_bounds[-1],
    }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
