"""select_model at scale on the GPU: the one-compile restart sweep.

The claim in pipeline.select_model's docstring is that a
multi-restart sweep costs ONE compile plus
``runs * cast_iters + keep * (max_em_iter - cast_iters)`` iterations
of chip time, because every restart flows through the same compiled EM
program (STM.reinitialize swaps the random state under the program).
This measures that at a scale where it matters — N=20k docs,
K=25, V=10k (the wiki demo in wiki_select.py is CPU-bound at N=1,015).

Records: total sweep wall-clock, the first cast fit (which pays the
compile) vs the median later cast fit (which must be pure chip time),
and the implied aggregate EM-iteration throughput.

Run from the repo root:  python - < benchmarks/select_scale.py
"""

import json
import os
import sys
import time

import numpy as np

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(__file__)
        else os.path.join(os.getcwd(), "benchmarks"))
sys.path.insert(0, HERE)
from bench_common import corpus  # noqa: E402

K, V, N, L = 25, 10_000, 20_000, 150
RUNS, CAST, KEEP, MAXIT = 6, 3, 2, 20


def main():
    from strutopy_tpu.pipeline import select_model

    docs, X = corpus(K, V, N, L, seed=3)

    # per-run stage-1 wall-clock via the logger: select_model logs one
    # line per cast fit, so timestamp the boundaries instead — simplest
    # honest split is to time a bare 1-restart warmup first (compile),
    # then the full sweep (all-warm).
    t0 = time.perf_counter()
    select_model(docs, K=K, runs=1, X=X, cast_iters=CAST, keep=1,
                 max_em_iter=CAST + 1, seed=99, return_models=False)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res = select_model(docs, K=K, runs=RUNS, X=X, cast_iters=CAST,
                       keep=KEEP, max_em_iter=MAXIT, seed=123456,
                       return_models=False)
    sweep_s = time.perf_counter() - t0

    iters = RUNS * CAST + KEEP * (MAXIT - CAST)
    out = {
        "config": {"N": N, "K": K, "V": V, "tokens_per_doc": L,
                   "runs": RUNS, "cast_iters": CAST, "keep": KEEP,
                   "max_em_iter": MAXIT, "platform": "gpu"},
        "warmup_1restart_seconds": round(compile_s, 1),
        "sweep_seconds": round(sweep_s, 1),
        "em_iterations": iters,
        "seconds_per_em_iteration": round(sweep_s / iters, 3),
        "agg_docs_per_sec": round(N * iters / sweep_s, 1),
        "runs": [
            {k: r[k] for k in ("seed", "cast_bound", "kept")}
            | ({"bound": r["bound"]} if "bound" in r else {})
            for r in res["runs"]
        ],
        "selected": res["selected"],
    }
    path = os.path.join(HERE, "results_select_scale.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps({k: out[k] for k in
                      ("warmup_1restart_seconds", "sweep_seconds",
                       "em_iterations", "agg_docs_per_sec")}, indent=2))
    print("wrote", path, flush=True)


main()
