"""Direct head-to-head: the reference's own fit vs strutopy_tpu on the
SAME corpus and config.

BASELINE.md notes the reference publishes no timings, so this measures
one: the reference's committed wiki artifact config
(src/artifacts/reference_model/50/stm_config.json — K=50, random init,
STM/OLS prevalence on the `statistics` covariate, 25 EM iterations,
N=1,015, V=13,852) run LIVE with the reference's own code
(src/modules/stm.py, imported as-is; gensim is bypassed by feeding the
corpus through our Matrix Market reader, which yields the same
list-of-(id,count) documents).  Sanity anchor: the committed artifact's
final bound is -472,991.13 (BASELINE.md) — same config, so the live
run must land in that neighborhood (seed state differs from the
original joblib run, exact equality is not expected).

Then the same config through strutopy_tpu on the GPU, reporting both
wall-clocks and final bounds.  Nothing is written under
/root/reference (saving=False; reference logging goes to stderr).

Run from the repo root:  python - < benchmarks/reference_wall_clock.py
"""

import json
import os
import sys
import time

import numpy as np

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

REF = "/root/reference/src"
WIKI = os.path.join(REF, "artifacts/wiki_data")
_DIR = os.path.join(os.path.abspath(os.getcwd()), "benchmarks")
OUT = os.path.join(_DIR, "results_reference_wall_clock.json")

K, ITERS, SEED = 50, 25, 12345


def load_inputs():
    import pandas as pd

    from strutopy_tpu.corpus.io import read_gensim_dictionary, read_mm

    docs, V = read_mm(os.path.join(WIKI, "BoW_corpus.mm"), return_V=True)
    vocab = read_gensim_dictionary(os.path.join(WIKI, "dictionary.mm"))
    data = pd.read_csv(os.path.join(WIKI, "corpus_preproc.csv"))
    xmat = np.array(data.loc[:, ["statistics"]])
    assert len(vocab) == V == 13852 and len(docs) == len(xmat) == 1015
    return docs, vocab, xmat


def run_reference(docs, vocab, xmat):
    """The reference's own STM (src/modules/stm.py), their 03 script's
    exact kwargs (03_fit_reference_model.py:49-73).  gensim/qpsolvers
    are stubbed exactly as tests/conftest.py::ref_modules does — the
    random-init fit never touches solve_qp (spectral-only dep)."""
    import types

    for name, attrs in {
        "gensim": {"utils": types.ModuleType("gensim.utils")},
        "gensim.corpora": {},
        "gensim.corpora.dictionary": {"Dictionary": object},
        "qpsolvers": {"solve_qp": lambda *a, **k: None},
    }.items():
        if name not in sys.modules:
            mod = types.ModuleType(name)
            for k, v in attrs.items():
                setattr(mod, k, v)
            sys.modules[name] = mod
    sys.modules["gensim"].corpora = sys.modules["gensim.corpora"]
    sys.modules["gensim.corpora"].dictionary = (
        sys.modules["gensim.corpora.dictionary"])

    sys.path.insert(0, REF)
    from modules.stm import STM as RefSTM  # noqa: the reference's class

    np.random.seed(SEED)  # 03_fit_reference_model.py:32-33
    t0 = time.perf_counter()
    model = RefSTM(
        documents=docs, dictionary=vocab, X=xmat,
        init_type="random", model_type="STM", K=K,
        convergence_threshold=1e-5, lda_beta=True, max_em_iter=ITERS,
        kappa_interactions=False, sigma_prior=0, content=False,
    )
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.expectation_maximization(saving=False)
    fit_s = time.perf_counter() - t0
    return {
        "init_seconds": round(init_s, 1),
        "fit_seconds": round(fit_s, 1),
        "iterations_run": len(model.last_bounds),
        "final_bound": float(model.last_bounds[-1]),
        "committed_artifact_bound": -472991.13,
    }


def run_ours(docs, vocab, xmat):
    from strutopy_tpu.models.stm import STM

    t0 = time.perf_counter()
    model = STM(
        documents=docs, dictionary=vocab, X=xmat.astype(np.float64),
        K=K, init_type="random", model_type="STM", mode="ols",
        max_em_iter=ITERS, convergence_threshold=1e-5, seed=SEED,
    )
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.expectation_maximization(saving=False)
    fit_s = time.perf_counter() - t0
    # warm repeat: the steady-state serving of this config (compile and
    # spectral-free init amortized)
    t0 = time.perf_counter()
    model.reinitialize(SEED)
    model.expectation_maximization(saving=False)
    warm_s = time.perf_counter() - t0
    return {
        "init_seconds": round(init_s, 1),
        "fit_seconds_cold": round(fit_s, 1),
        "fit_seconds_warm": round(warm_s, 1),
        "iterations_run": len(model.last_bounds),
        "final_bound": float(model.last_bounds[-1]),
    }


def main():
    docs, vocab, xmat = load_inputs()
    print("reference fit (their code, CPU serial)...", flush=True)
    ref = run_reference(docs, vocab, xmat)
    print(json.dumps(ref, indent=2), flush=True)
    print("strutopy_tpu fit (one device)...", flush=True)
    ours = run_ours(docs, vocab, xmat)
    print(json.dumps(ours, indent=2), flush=True)
    res = {
        "config": {"corpus": "reference wiki (N=1015, V=13852)", "K": K,
                   "max_em_iter": ITERS, "init": "random",
                   "prevalence": "statistics (OLS)",
                   "source": "src/artifacts/reference_model/50/stm_config.json"},
        "reference": ref,
        "strutopy_tpu": ours,
        "speedup_cold": round(ref["fit_seconds"] / ours["fit_seconds_cold"], 1),
        "speedup_warm": round(ref["fit_seconds"] / ours["fit_seconds_warm"], 1),
    }
    with open(OUT, "w") as f:
        json.dump(res, f, indent=2)
    print("wrote", OUT, flush=True)


main()
