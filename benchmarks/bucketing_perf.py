#!/usr/bin/env python
"""Ragged-length throughput: bucketing vs naive padding (VERDICT r4 #7).

Every recorded docs/s number so far used fixed-length documents
(bench.py: 300 tokens; podscale/1M: uniform L=300), where bucketing by
construction does nothing.  The subsystem it prices
(corpus/bucketing.py, SURVEY §5) exists for SKEWED real corpora: docs
padded to the global max length burn E-step FLOPs and memory on padding.
This benchmark measures that for the first time.

Config: the headline cell (K=100, V=10k, N=8,192, B=256) with doc
token counts drawn log-normal (median ~170, sigma 0.75) clipped to
[60, 1200] tokens -> ~30-500 unique terms per doc (realistic web-corpus
skew; the wiki corpus' own unique-length quartiles are 84/159/282).

Variants, all from the SAME corpus and 5 warm-up EM iterations
(steady-state protocol, CLAUDE.md):
  padded    — auto_bucket=False: every doc padded to the max length
  bucketed  — auto_bucket=True, max_buckets=4 (production default)
  bucketed8 — max_buckets=8 (does finer classing pay?)

Metric: full jitted EM iterations/s -> docs/s (the bucket loop lives in
em_iteration), timed by fetching the bound to host; best of 3 after a
same-graph warm call.  Also records each plan's padded area (the waste
being recovered) and the per-variant bound at the first timed iteration
(identical model: bucketing is a storage-order change only).

Usage:  python benchmarks/bucketing_perf.py     (cwd = repo root, GPU)
Writes benchmarks/results_bucketing_perf.json.
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
OUT = os.path.join(HERE, "results_bucketing_perf.json")

K, V, N, B = 100, 10_000, 8_192, 256
WARMUP, REPEATS = 5, 3


def ragged_corpus():
    rng = np.random.default_rng(0)
    beta = rng.dirichlet(np.full(V, 0.05), size=K)
    eta = rng.normal(0.0, 1.0, (N, K - 1))
    ef = np.concatenate([eta, np.zeros((N, 1))], axis=1)
    theta = np.exp(ef - ef.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    p = theta @ beta
    n_tok = np.clip(rng.lognormal(np.log(170.0), 0.75, N), 60, 1200)
    docs = []
    for d in range(N):
        draw = rng.multinomial(int(n_tok[d]), p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    X = rng.integers(0, 2, N).astype(np.float64)
    uniq = np.array([len(d) for d in docs])
    return docs, X, uniq


def main():
    import jax

    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.stm import STM

    docs, X, uniq = ragged_corpus()
    results = {
        "config": {"K": K, "V": V, "N": N, "batch": B,
                   "length_dist": "lognormal(log 170, 0.75) tokens, "
                                  "clip [60, 1200]"},
        "unique_len": {
            "min": int(uniq.min()), "p25": int(np.percentile(uniq, 25)),
            "median": int(np.median(uniq)),
            "p75": int(np.percentile(uniq, 75)), "max": int(uniq.max()),
            "mean": round(float(uniq.mean()), 1),
        },
        "variants": {},
    }
    print(json.dumps(results["unique_len"]), flush=True)

    for name, over in (("padded", dict(auto_bucket=False)),
                       ("bucketed", dict(auto_bucket=True, max_buckets=4)),
                       ("bucketed8", dict(auto_bucket=True, max_buckets=8))):
        cfg = STMConfig(K=K, model_type="STM", mode="ols",
                        init_type="random", batch_size=B,
                        newton_pass1_iters=6, newton_straggler_frac=0.25,
                        newton_warmup_iters=2, **over)
        m = STM(documents=docs, K=K, X=X, config=cfg)
        plan = m._plan  # always built; auto_bucket=False -> 1 bucket
        naive_area = N * int(uniq.max())
        rec = {
            "n_buckets": plan.n_buckets,
            "bucket_Ls": list(map(int, plan.Ls)),
            "bucket_sizes": list(map(int, plan.sizes)),
            "padded_area": int(plan.padded_area()),
            "area_vs_naive": round(plan.padded_area() / naive_area, 4),
        }
        for it in range(WARMUP):
            step = (m._em_step_cold
                    if m._em_step_cold is not None
                    and it < cfg.newton_warmup_iters else m._em_step)
            m._state = step(m._state, m._data)
        float(np.asarray(m._state.bound))  # drain warm-up + compile

        best = 1e9
        for _ in range(REPEATS):
            t0 = time.time()
            m._state = m._em_step(m._state, m._data)
            bound = float(np.asarray(m._state.bound))
            best = min(best, time.time() - t0)
        rec["docs_per_sec"] = round(N / best, 1)
        rec["iter_seconds"] = round(best, 4)
        rec["bound_after_timing"] = bound
        results["variants"][name] = rec
        print(name, json.dumps(rec), flush=True)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)

    pad = results["variants"]["padded"]["docs_per_sec"]
    buck = results["variants"]["bucketed"]["docs_per_sec"]
    results["bucketing_speedup"] = round(buck / pad, 3)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print("bucketing speedup:", results["bucketing_speedup"], flush=True)
    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()
