"""Spectral-vs-spectral quality head-to-head (VERDICT r4 #4).

The round-4 h2h (results_quality_h2h.json) covered random init only;
the reference's RECOMMENDED mode is spectral
(/root/reference/src/05_train.py:104), and our FISTA-NNLS recover_l2
(vs its quadprog, stm.py:229-296) had component-level parity tests but
never a fit-quality-level comparison.  This closes that half of the
clause: same protocol as quality_h2h.py (document completion, f64
scoring of test_2), both sides init_type="spectral".

The reference's spectral path needs qpsolvers (not installed).  Its QP
  min 0.5 x^T P x + q^T x  s.t.  x <= 0,  P = M M^T, q = M y
is, after z = -x, exactly NNLS  min_{z>=0} ||M^T z - y||  (PARITY_NOTES
#10).  We back the stub with an EXACT scipy substitute recovered from
(P, q) alone: factor P = L L^T, then the QP is min ||L^T z - L^{-1}q||
s.t. z >= 0 — scipy.optimize.nnls, active-set, exact.  This runs the
reference's own spectral_init end-to-end, not an approximation of it.

Phases (env H2H_SIDE=ours|ref|both, default both): ours needs the GPU
(fast), ref is hours of serial CPU — run them in separate windows.
Both write into benchmarks/results_quality_h2h_spectral.json.

Usage:  python benchmarks/quality_h2h_spectral.py
"""

import json
import os
import sys
import time

import numpy as np

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(globals().get("__file__"))
        else os.path.join(os.getcwd(), "benchmarks"))
sys.path.insert(0, HERE)

from quality_h2h import (  # noqa: E402
    REF, SEED, load_wiki, make_synth, score, split_completion, stub_ref_deps,
)

OUT = os.path.join(HERE, "results_quality_h2h_spectral.json")
SIDE = os.environ.get("H2H_SIDE", "both")


def exact_solve_qp(P=None, q=None, G=None, h=None, **kw):
    """Exact substitute for qpsolvers.solve_qp at the reference's
    recover_l2 call signature (G=I, h=0, i.e. x <= 0): z = -x turns the
    QP into NNLS; scipy.optimize.nnls is an exact active-set solver."""
    import scipy.linalg
    import scipy.optimize

    Pm = np.asarray(P, np.float64)
    qv = np.asarray(q, np.float64).ravel()
    # P = M M^T is PSD; tiny jitter for the rank-deficient corner
    L = np.linalg.cholesky(Pm + 1e-12 * np.eye(Pm.shape[0]))
    b = scipy.linalg.solve_triangular(L, qv, lower=True)
    z, _ = scipy.optimize.nnls(L.T, b)
    return -z  # the reference negates the solution again (condprob = z)


def install_exact_qp():
    stub_ref_deps()
    sys.modules["qpsolvers"].solve_qp = exact_solve_qp


def fit_reference_spectral(docs_beta, docs_theta, vocab, X, K, iters,
                           n_test1):
    install_exact_qp()
    from modules.stm import STM as RefSTM

    out = {}
    models = {}
    for tag, corpus in (("beta", docs_beta), ("theta", docs_theta)):
        np.random.seed(SEED)
        t0 = time.perf_counter()
        m = RefSTM(
            documents=corpus, dictionary=vocab, X=X[: len(corpus)],
            init_type="spectral", model_type="STM", K=K,
            convergence_threshold=1e-5, lda_beta=True, max_em_iter=iters,
            kappa_interactions=False, sigma_prior=0, content=False,
        )
        m.expectation_maximization(saving=False)
        out[f"fit_{tag}_seconds"] = round(time.perf_counter() - t0, 1)
        out[f"iters_{tag}"] = len(m.last_bounds)
        models[tag] = m
        print(f"  reference model_{tag} (spectral): "
              f"{out[f'fit_{tag}_seconds']}s, {out[f'iters_{tag}']} iters",
              flush=True)
    beta = np.asarray(models["beta"].beta, np.float64)
    theta_full = np.asarray(models["theta"].theta, np.float64)
    return beta, theta_full[-n_test1:], out


def fit_ours_spectral(docs_beta, docs_theta, vocab, X, K, iters, n_test1):
    from strutopy_tpu.models.stm import STM

    out = {}
    models = {}
    for tag, corpus in (("beta", docs_beta), ("theta", docs_theta)):
        t0 = time.perf_counter()
        m = STM(
            documents=corpus, dictionary=vocab, X=X[: len(corpus)],
            K=K, init_type="spectral", model_type="STM", mode="ols",
            max_em_iter=iters, convergence_threshold=1e-5, seed=SEED,
        )
        m.expectation_maximization(saving=False)
        out[f"fit_{tag}_seconds_cold"] = round(time.perf_counter() - t0, 1)
        out[f"iters_{tag}"] = len(m.last_bounds)
        out[f"nonfinite_bound_iters_{tag}"] = list(m.nonfinite_bound_iters)
        models[tag] = m
        print(f"  strutopy_tpu model_{tag} (spectral): "
              f"{out[f'fit_{tag}_seconds_cold']}s, "
              f"{out[f'iters_{tag}']} iters", flush=True)
    beta = np.asarray(models["beta"].beta, np.float64)
    theta_full = np.asarray(models["theta"].theta, np.float64)
    return beta, theta_full[-n_test1:], out


def main():
    results = {"protocol": (
        "document completion (reference 05_train.py), SPECTRAL init both "
        "sides (the reference's recommended mode, 05_train.py:104); its "
        "qpsolvers dependency replaced by an exact scipy NNLS solve of "
        "the same QP; f64 eval_heldout scoring of test_2; 25 EM iters, "
        "convergence_threshold 1e-5"), "configs": {}}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)

    for name, (docs, vocab, X), K in (
        ("wiki_K50", load_wiki(), 50),
        ("synth_K100_V10k_N4096", make_synth(), 100),
    ):
        train, test, test_1, test_2 = split_completion(docs)
        docs_beta, docs_theta = train + test, train + test_1
        n_test1 = len(test_1)
        entry = results["configs"].setdefault(
            name, {"N": len(docs), "V": len(vocab), "K": K,
                   "max_em_iter": 25})

        if SIDE in ("ours", "both") and "strutopy_tpu" not in entry:
            print(f"=== {name}: ours (spectral) ===", flush=True)
            beta_o, theta_o, times_o = fit_ours_spectral(
                docs_beta, docs_theta, vocab, X, K, 25, n_test1)
            entry["strutopy_tpu"] = dict(
                times_o, **score(beta_o, theta_o, test_2, docs_beta))
            with open(OUT, "w") as f:
                json.dump(results, f, indent=2)
            print(json.dumps(entry["strutopy_tpu"], indent=2), flush=True)

        if SIDE in ("ref", "both") and "reference" not in entry:
            print(f"=== {name}: reference (spectral, exact-QP) ===",
                  flush=True)
            beta_r, theta_r, times_r = fit_reference_spectral(
                docs_beta, docs_theta, vocab, X, K, 25, n_test1)
            entry["reference"] = dict(
                times_r, **score(beta_r, theta_r, test_2, docs_beta))
            with open(OUT, "w") as f:
                json.dump(results, f, indent=2)
            print(json.dumps(entry["reference"], indent=2), flush=True)

        if "strutopy_tpu" in entry and "reference" in entry:
            entry["heldout_delta_ours_minus_ref"] = round(
                entry["strutopy_tpu"]["heldout_ll"]
                - entry["reference"]["heldout_ll"], 6)
            with open(OUT, "w") as f:
                json.dump(results, f, indent=2)

    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()
