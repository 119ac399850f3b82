"""Quality head-to-head: the reference's own fits vs strutopy_tpu,
scored with the SAME float64 heldout likelihood on the SAME completion
split (VERDICT r3 next #1 — the north star's "matched heldout LL"
clause, measured instead of argued).

Protocol = the reference's own document-completion method
(/root/reference/src/05_train.py:73-132, modules/heldout.py:40-97):

  1. Sequential 80/20 train/test split; each test doc cut into
     even-position (test_1, observed) and odd-position (test_2, held
     out) unique-term halves.
  2. model_beta  fit on train + test   -> beta  (the full-corpus beta)
  3. model_theta fit on train + test_1 -> theta rows for test_1
  4. heldout LL = eval_heldout(test_2, theta_test1, beta)

Both frameworks fit THEIR OWN model_beta/model_theta on byte-identical
corpora, covariates, K, iteration budget, and convergence threshold
(random init: the reference's spectral path needs qpsolvers, which is
not installed — same situation as its committed wiki artifact, which
also used random init).  Scoring uses strutopy_tpu's float64
``eval_heldout`` (eval/heldout.py:21, verified == the reference's own
eval_heldout to <=1e-10 by tests/test_reference_parity.py) for BOTH
models, plus semantic coherence / exclusivity / top-10 FREX on both
betas.  Bound LEVELS are deliberately not compared (the reference's
bound carries its gradient/siginv bugs, PARITY_NOTES #1/#2); heldout
likelihood is implementation-independent.

Configs:
  - wiki K=50: the reference's committed corpus (N=1015, V=13852),
    its artifact config (25 EM iters).
  - synthetic K=100/V=10k: the headline bench family (bench.py
    make_corpus) at N=4096 — sized so the reference's ~31.5 ms/doc/iter
    serial E-step finishes in ~2h on this 1-core host.

Wall-clocks are recorded for completeness; the dedicated throughput
numbers live in results_reference_wall_clock.json / BENCH_r*.json.

Run from the repo root:  python - < benchmarks/quality_h2h.py
"""

import json
import os
import sys
import time
import types

import numpy as np

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

REF = "/root/reference/src"
_DIR = os.path.join(os.path.abspath(os.getcwd()), "benchmarks")
OUT = os.path.join(_DIR, "results_quality_h2h.json")

SEED = 12345


def stub_ref_deps():
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
    if REF not in sys.path:
        sys.path.insert(0, REF)


def load_wiki():
    import pandas as pd

    from strutopy_tpu.corpus.io import read_gensim_dictionary, read_mm

    wiki = os.path.join(REF, "artifacts/wiki_data")
    docs, V = read_mm(os.path.join(wiki, "BoW_corpus.mm"), return_V=True)
    vocab = read_gensim_dictionary(os.path.join(wiki, "dictionary.mm"))
    data = pd.read_csv(os.path.join(wiki, "corpus_preproc.csv"))
    X = np.array(data.loc[:, ["statistics"]], np.float64)
    assert len(vocab) == V == 13852 and len(docs) == len(X) == 1015
    return docs, vocab, X


def make_synth(N=4096, K=100, V=10_000, n_words=300, seed=0):
    """bench.py::make_corpus's exact DGP, N parameterized."""
    rng = np.random.default_rng(seed)
    beta_true = rng.dirichlet(np.full(V, 0.05), size=K)
    eta_true = rng.normal(0.0, 1.0, (N, K - 1))
    eta_full = np.concatenate([eta_true, np.zeros((N, 1))], axis=1)
    theta = np.exp(eta_full - eta_full.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    X = rng.integers(0, 2, N).astype(np.float64)[:, None]
    p = theta @ beta_true
    docs = []
    for d in range(N):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, [str(i) for i in range(V)], X


def split_completion(docs):
    """Reference split: sequential 80/20 + even/odd unique-term halves
    (modules/heldout.py:40-85)."""
    n_train = int(0.8 * len(docs))
    train, test = docs[:n_train], docs[n_train:]
    test_1 = [list(doc[0::2]) for doc in test]
    test_2 = [list(doc[1::2]) for doc in test]
    assert all(len(d) for d in test_1) and all(len(d) for d in test_2), (
        "a test doc's completion half is empty — protocol undefined"
    )
    return train, test, test_1, test_2


def fit_reference(docs_beta, docs_theta, vocab, X, K, iters, n_test1):
    stub_ref_deps()
    from modules.stm import STM as RefSTM

    out = {}
    betas = {}
    for tag, corpus in (("beta", docs_beta), ("theta", docs_theta)):
        np.random.seed(SEED)  # their 03 script's seeding
        t0 = time.perf_counter()
        m = RefSTM(
            documents=corpus, dictionary=vocab, X=X[: len(corpus)],
            init_type="random", model_type="STM", K=K,
            convergence_threshold=1e-5, lda_beta=True, max_em_iter=iters,
            kappa_interactions=False, sigma_prior=0, content=False,
        )
        m.expectation_maximization(saving=False)
        out[f"fit_{tag}_seconds"] = round(time.perf_counter() - t0, 1)
        out[f"iters_{tag}"] = len(m.last_bounds)
        betas[tag] = m
        print(f"  reference model_{tag}: {out[f'fit_{tag}_seconds']}s, "
              f"{out[f'iters_{tag}']} iters", flush=True)
    beta = np.asarray(betas["beta"].beta, np.float64)
    theta_full = np.asarray(betas["theta"].theta, np.float64)
    return beta, theta_full[-n_test1:], out


def fit_ours(docs_beta, docs_theta, vocab, X, K, iters, n_test1):
    from strutopy_tpu.models.stm import STM

    out = {}
    models = {}
    for tag, corpus in (("beta", docs_beta), ("theta", docs_theta)):
        t0 = time.perf_counter()
        m = STM(
            documents=corpus, dictionary=vocab, X=X[: len(corpus)],
            K=K, init_type="random", model_type="STM", mode="ols",
            max_em_iter=iters, convergence_threshold=1e-5, seed=SEED,
        )
        m.expectation_maximization(saving=False)
        out[f"fit_{tag}_seconds_cold"] = round(time.perf_counter() - t0, 1)
        # warm repeat = steady state (compile amortized; the compile
        # is a one-time cost per shape)
        t0 = time.perf_counter()
        m.reinitialize(SEED)
        m.expectation_maximization(saving=False)
        out[f"fit_{tag}_seconds_warm"] = round(time.perf_counter() - t0, 1)
        out[f"iters_{tag}"] = len(m.last_bounds)
        models[tag] = m
        print(f"  strutopy_tpu model_{tag}: cold "
              f"{out[f'fit_{tag}_seconds_cold']}s / warm "
              f"{out[f'fit_{tag}_seconds_warm']}s, "
              f"{out[f'iters_{tag}']} iters", flush=True)
    beta = np.asarray(models["beta"].beta, np.float64)
    theta_full = np.asarray(models["theta"].theta, np.float64)
    return beta, theta_full[-n_test1:], out


def score(beta, theta_test1, test_2, docs_beta):
    from strutopy_tpu.eval.diagnostics import (
        exclusivity,
        frex,
        semantic_coherence,
    )
    from strutopy_tpu.eval.heldout import eval_heldout

    heldout = float(eval_heldout(test_2, theta_test1, beta))
    coh = semantic_coherence(beta, docs_beta, M=10)
    excl = exclusivity(beta, M=10, w=0.7)
    fx = frex(beta, w=0.5)
    top10 = np.argsort(fx, axis=1)[:, -10:]
    frex_top10 = float(np.mean(np.take_along_axis(fx, top10, axis=1)))
    return {
        "heldout_ll": heldout,
        "semantic_coherence_mean": float(np.mean(coh)),
        "exclusivity_mean": float(np.mean(excl)),
        "frex_top10_mean": frex_top10,
    }


def run_config(name, docs, vocab, X, K, iters, results):
    print(f"=== config {name}: N={len(docs)}, V={len(vocab)}, K={K}, "
          f"iters={iters} ===", flush=True)
    train, test, test_1, test_2 = split_completion(docs)
    docs_beta = train + test
    docs_theta = train + test_1
    n_test1 = len(test_1)

    entry = {"N": len(docs), "V": len(vocab), "K": K,
             "max_em_iter": iters, "n_test_docs": len(test)}

    print("fitting strutopy_tpu (one device)...", flush=True)
    beta_o, theta_o, times_o = fit_ours(
        docs_beta, docs_theta, vocab, X, K, iters, n_test1)
    entry["strutopy_tpu"] = dict(times_o,
                                 **score(beta_o, theta_o, test_2, docs_beta))

    print("fitting the reference (their code, serial CPU)...", flush=True)
    beta_r, theta_r, times_r = fit_reference(
        docs_beta, docs_theta, vocab, X, K, iters, n_test1)
    entry["reference"] = dict(times_r,
                              **score(beta_r, theta_r, test_2, docs_beta))

    entry["heldout_delta_ours_minus_ref"] = round(
        entry["strutopy_tpu"]["heldout_ll"]
        - entry["reference"]["heldout_ll"], 6)
    results["configs"][name] = entry
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(entry, indent=2), flush=True)
    print("wrote", OUT, flush=True)


def main():
    results = {
        "protocol": (
            "document completion (reference 05_train.py): beta from "
            "train+test fit, theta from train+test_1 fit, both scored "
            "with the same float64 eval_heldout on test_2; random init, "
            "seed 12345, convergence_threshold 1e-5 both sides"
        ),
        "configs": {},
    }
    docs, vocab, X = load_wiki()
    run_config("wiki_K50", docs, vocab, X, K=50, iters=25, results=results)

    docs, vocab, X = make_synth()
    run_config("synth_K100_V10k_N4096", docs, vocab, X, K=100, iters=25,
               results=results)


if __name__ == "__main__":
    main()
