#!/usr/bin/env python
"""Content stress A/B of the delta-magnitude convergence skip
(VERDICT r4 #5; the attack TODO.md named after the round-4
cancellation-free line search measured a 1.85x REGRESSION).

Config: the P=302 stress cell (K=100, V=10k, A=2 + interactions,
N=8192) where the content path measured 3.58x the LDA path
(results_content_stress.json).  All variants time steady-state EM
iterations from the SAME warmed state (5 default-config warm-up
iterations); each kappa_ftol_rel value is a distinct trace-time
constant, so every variant compiles its own graph — no jit-cache
aliasing (the round-3 vchunk lesson).

Also records, from the same state, one-step beta agreement vs the
ftol=0 exact path (the skip must not move the fitted model).

Usage:  python benchmarks/content_ftol_ab.py   (cwd = repo root)
Writes benchmarks/results_content_ftol.json.
"""

import json
import os
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(globals().get("__file__"))
        else os.path.join(os.getcwd(), "benchmarks"))
OUT = os.path.join(HERE, "results_content_ftol.json")

K, V, N, N_WORDS, A = 100, 10_000, 8192, 300, 2
FTOLS = (0.0, 1e-7, 1e-6, 1e-5)


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

    from strutopy_tpu.models.em import make_em_step
    from strutopy_tpu.models.stm import STM

    common = dict(documents=docs, K=K, X=aspect.astype(np.float64),
                  max_em_iter=5, init_type="random", model_type="STM",
                  seed=123456, batch_size=256)

    # one warmed content model; all variants step from ITS state
    mc = STM(content=True, A=A, beta_index=aspect, kappa_interactions=True,
             lda_beta=False, **common)
    mc.expectation_maximization(saving=False)
    state0, data = mc._state, mc._data
    jax.block_until_ready(state0.beta)

    # LDA reference path, same corpus, same-day timing
    ml = STM(**common)
    ml.expectation_maximization(saving=False)

    def steady(step, state, reps=5):
        s1 = step(state, data if step is not ml_step else ml._data)
        jax.block_until_ready(s1.bound)
        ts = []
        for _ in range(reps):
            t0 = time.time()
            s2 = step(state, data if step is not ml_step else ml._data)
            float(np.asarray(s2.bound))
            ts.append(time.time() - t0)
        return float(np.median(ts))

    ml_step = ml._em_step
    it_l = steady(ml_step, ml._state)
    results = {"config": {"K": K, "V": V, "N": N, "A": A, "P": 302,
                          "protocol": "median-of-5 steady iters from one "
                                      "5-warmup state"},
               "lda_iter_seconds": round(it_l, 4)}

    beta_ref = None
    for ftol in FTOLS:
        cfg = mc.config.replace(kappa_ftol_rel=ftol)
        step = make_em_step(cfg, mc._design, mc._kappa_design, mc._wcounts,
                            bucket_batches=mc._plan.batch_sizes
                            if hasattr(mc, "_plan") else None)
        s1 = step(state0, data)
        beta1 = np.asarray(s1.beta)
        if ftol == 0.0:
            beta_ref = beta1
        it_c = steady(step, state0)
        results[f"ftol_{ftol:g}"] = {
            "iter_seconds": round(it_c, 4),
            "vs_lda": round(it_c / it_l, 2),
            "one_step_beta_max_diff_vs_exact": float(
                np.abs(beta1 - beta_ref).max()),
            "bound": float(np.asarray(s1.bound)),
        }
        print(f"ftol={ftol:g}: {it_c:.3f}s/iter ({it_c / it_l:.2f}x LDA), "
              f"beta diff {results[f'ftol_{ftol:g}']['one_step_beta_max_diff_vs_exact']:.2e}",
              flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)

    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()
