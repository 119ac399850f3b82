"""search_k on the REAL wiki corpus: the full R-stm-style model
selection table on the reference's own data.

The reference selects K by heldout alone
(/root/reference/src/06_example_application.py:183-195).  This runs
pipeline.search_k over the same K grid as the recorded find_k sweep
(RESULTS.md: {10, 15, 20, 30}, 60/40 split, spectral init, 10 EM
iters, fast transform-based completion) and records every diagnostic
R-stm's searchK would show: heldout, converged bound, semantic
coherence, exclusivity, Taddy residual dispersion, wall-clock.

Run from the repo root on the GPU:  python - < benchmarks/wiki_searchk.py
"""

import json
import os
import sys

import numpy as np

WIKI = "/root/reference/src/artifacts/wiki_data"
_DIR = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() else "benchmarks")
OUT = os.path.join(_DIR, "results_wiki_searchk.json")


def main():
    import jax

    from strutopy_tpu.corpus.io import read_mm
    from strutopy_tpu.pipeline import search_k

    docs = read_mm(os.path.join(WIKI, "BoW_corpus.mm"))
    assert len(docs) == 1015

    results = search_k(
        docs,
        K_candidates=[10, 15, 20, 30],
        proportion=0.6,
        init_type="spectral",
        max_em_iter=10,
    )
    rec = {
        "config": {
            "corpus": "reference wiki BoW_corpus.mm (N=1015, V=13852)",
            "proportion": 0.6,
            "init_type": "spectral",
            "max_em_iter": 10,
            "protocol": "fast transform-based completion",
            "platform": jax.devices()[0].platform,
        },
        "results": results,
    }
    with open(OUT, "w") as f:
        json.dump(rec, f, indent=2)
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    if "--platform" in sys.argv:
        import jax

        jax.config.update(
            "jax_platforms", sys.argv[sys.argv.index("--platform") + 1]
        )
    main()
