"""Diagnose the wiki spectral-h2h gap (ours -9.353 vs ref -8.564).

The spectral h2h (results_quality_h2h_spectral.json) measured a
-0.79-nat heldout gap in the reference's recommended mode.  From the
round-4 same-init experiment the FIT paths differ by only ~0.08 nats,
so the prime suspect is the INIT itself: our device-side f32 pipeline
(Gram + fast_anchor + 500-iter FISTA NNLS) vs the reference's f64
exact path (sparse Gram + greedy anchors + per-word exact QP,
/root/reference/src/modules/stm.py:30-296).  This script decomposes
the gap:

  A. compute both inits on the wiki model_beta corpus and compare
     anchors, per-word NNLS objectives, and beta rows;
  B. fit OUR model (CPU) from (i) our init, (ii) the reference's
     exact init, (iii) ours-with-exact-host-recovery variants, and
     score each with the f64 completion heldout.

Writes benchmarks/results_spectral_init_diag.json incrementally.
Pure CPU — safe to run while the GPU holds another job.

Usage: python benchmarks/spectral_init_diag.py
"""

import json
import os
import sys
import time

import numpy as np

HERE = os.path.join(os.path.abspath(os.getcwd()), "benchmarks")
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from quality_h2h import SEED, load_wiki, split_completion  # noqa: E402
from quality_h2h_spectral import install_exact_qp  # noqa: E402

OUT = os.path.join(HERE, "results_spectral_init_diag.json")
K = 50
ITERS = 25


def ref_init_stepwise(docs, V, maxV=5000):
    """The reference's spectral_init (stm.py:30-84) run step by step
    with the exact-QP stub, returning intermediates for comparison."""
    install_exact_qp()
    from modules.stm import create_dtm, fastAnchor, gram, recover_l2

    dtm = create_dtm(corpus=docs)
    if dtm.shape[1] < V:  # trailing vocab ids absent from the corpus
        from scipy.sparse import csr_matrix

        dtm = csr_matrix((dtm.data, dtm.indices, dtm.indptr),
                         shape=(dtm.shape[0], V))
    wprob = np.asarray(dtm.sum(axis=0)).ravel()
    wprob = wprob / wprob.sum()
    keep = np.argsort(-1 * wprob)[:maxV]
    dtm_f = dtm[:, keep]
    wprob_f = wprob[keep]
    Q_pristine = np.asarray(gram(dtm_f).todense())
    # flow Q through fastAnchor -> recover_l2 exactly as the reference's
    # spectral_init does: fastAnchor rescales the FIRST anchor row of
    # the caller's sparse Q in place before rebinding to a dense local
    # (stm.py:181-219), and recover_l2 then reads that mutated Q
    Q = gram(dtm_f)
    anchors = fastAnchor(Q, K, verbose=False).astype(int)
    beta_f = recover_l2(Q, anchors, wprob_f)
    beta = np.zeros((K, V))
    beta[:, keep] = beta_f
    beta = beta + 0.001 / V
    beta = beta / np.sum(beta)  # the reference's GLOBAL normalization
    return {"keep": keep, "wprob_f": wprob_f, "Q": Q_pristine,
            "anchors": keep[anchors], "anchors_f": anchors, "beta": beta}


def ours_init_stepwise(docs, V, maxV=5000, fista_iters=500,
                       gram_norm="l1"):
    """Our ops/spectral.py pipeline, stepwise (CPU devices, f32).

    gram_norm="l1" reproduces the pre-fix pipeline (the round-5 bug:
    the reference's Q is actually UNNORMALIZED — its sklearn normalize
    call mutates a discarded copy); "none" is the fixed default.
    """
    import jax.numpy as jnp

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.ops.spectral import (_gram_scan, fast_anchor,
                                           recover_l2)

    corpus = pad_corpus(docs, V=V)
    wcounts = corpus.word_counts()
    wprob = wcounts / max(wcounts.sum(), 1e-300)
    keep = np.argsort(-wprob)[: min(maxV, V)]
    Vp = len(keep)
    lookup = np.full(V, -1, np.int64)
    lookup[keep] = np.arange(Vp)
    words_f = lookup[np.minimum(corpus.words, V - 1)]
    counts_f = np.where(words_f >= 0, corpus.counts, 0.0).astype(np.float32)
    words_f = np.maximum(words_f, 0).astype(np.int32)
    nd = counts_f.sum(axis=1)
    counts_f = counts_f * (nd >= 2)[:, None]
    N = words_f.shape[0]
    B = min(1024, N)
    n_chunks = -(-N // B)
    N_pad = n_chunks * B
    if N_pad != N:
        words_f = np.pad(words_f, ((0, N_pad - N), (0, 0)))
        counts_f = np.pad(counts_f, ((0, N_pad - N), (0, 0)))
    Q, _ = _gram_scan(jnp.asarray(words_f), jnp.asarray(counts_f),
                      n_chunks, Vp, norm=gram_norm)
    anchors_f = np.asarray(fast_anchor(Q, K))
    beta_f = np.asarray(recover_l2(
        Q, jnp.asarray(anchors_f), jnp.asarray(wprob[keep], jnp.float32),
        iters=fista_iters), np.float64)
    beta = np.zeros((K, V))
    beta[:, keep] = beta_f
    beta = beta + 0.001 / V
    beta = beta / beta.sum(axis=1, keepdims=True)
    return {"keep": keep, "Q": np.asarray(Q, np.float64),
            "anchors": keep[anchors_f], "anchors_f": anchors_f,
            "beta": beta}


def nnls_objectives(Q, anchors_f, weights_rows):
    """Mean ||M^T z - Q_i||^2 over non-anchor words for given p(z|w)
    rows (Vp, K), vs the exact scipy solution."""
    import scipy.optimize

    M = Q[anchors_f]
    mask = np.ones(Q.shape[0], bool)
    mask[anchors_f] = False
    idx = np.nonzero(mask)[0]
    obj = np.zeros(len(idx))
    obj_exact = np.zeros(len(idx))
    for j, i in enumerate(idx):
        r = M.T @ weights_rows[i] - Q[i]
        obj[j] = r @ r
        z, rn = scipy.optimize.nnls(M.T, Q[i])
        obj_exact[j] = rn * rn
    return float(obj.mean()), float(obj_exact.mean())


def fit_ours_from_beta(beta_init, docs_beta, docs_theta, vocab, X,
                       n_test1, test_2, docs_for_score):
    """Fit our STM (CPU) with an injected beta init, score heldout."""
    from unittest import mock

    from quality_h2h import score

    from strutopy_tpu.models import stm as stm_mod

    res = {}
    thetas = {}
    betas = {}
    with mock.patch.object(stm_mod, "spectral_init",
                           lambda *a, **k: np.asarray(beta_init)):
        for tag, corpus in (("beta", docs_beta), ("theta", docs_theta)):
            t0 = time.perf_counter()
            m = stm_mod.STM(
                documents=corpus, dictionary=vocab, X=X[: len(corpus)],
                K=K, init_type="spectral", model_type="STM", mode="ols",
                max_em_iter=ITERS, convergence_threshold=1e-5, seed=SEED,
            )
            m.expectation_maximization(saving=False)
            res[f"fit_{tag}_seconds"] = round(time.perf_counter() - t0, 1)
            res[f"iters_{tag}"] = len(m.last_bounds)
            betas[tag] = np.asarray(m.beta, np.float64)
            thetas[tag] = np.asarray(m.theta, np.float64)
    res.update(score(betas["beta"], thetas["theta"][-n_test1:], test_2,
                     docs_for_score))
    return res


def main():
    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)

    docs, vocab, X = load_wiki()
    V = len(vocab)
    train, test, test_1, test_2 = split_completion(docs)
    docs_beta, docs_theta = train + test, train + test_1
    n_test1 = len(test_1)

    print("=== A: init comparison ===", flush=True)
    t0 = time.perf_counter()
    ref = ref_init_stepwise(docs_beta, V)
    print(f"  ref init: {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    ours = ours_init_stepwise(docs_beta, V)
    print(f"  ours init: {time.perf_counter() - t0:.1f}s", flush=True)

    keep_same = bool(np.array_equal(np.sort(ref["keep"]),
                                    np.sort(ours["keep"])))
    anchor_overlap = len(set(ref["anchors"].tolist())
                         & set(ours["anchors"].tolist()))
    # Q difference on the shared filtered vocab (map ours onto ref order)
    if keep_same:
        pos = {v: i for i, v in enumerate(ours["keep"])}
        perm = np.array([pos[v] for v in ref["keep"]])
        Q_ours_in_ref = ours["Q"][np.ix_(perm, perm)]
        q_err = float(np.abs(Q_ours_in_ref - ref["Q"]).max())
    else:
        q_err = None

    # FISTA-vs-exact NNLS objective gap on OUR OWN Q/anchors
    # (recover_l2 returns p(w|z); the objective needs p(z|w) rows, so
    # replicate the kernel's FISTA — same f32, same 64-step power
    # iteration for the step size — and stop before Bayes inversion)
    Qo = ours["Q"].astype(np.float32)
    M = Qo[ours["anchors_f"]]
    P = M @ M.T
    Qt = M @ Qo.T
    v = np.ones(K, np.float32) / np.sqrt(K)
    for _ in range(64):
        v = P @ v
        v = v / max(np.linalg.norm(v), 1e-30)
    step = 1.0 / max(float(v @ (P @ v)), 1e-30)
    Z = np.zeros((K, Qo.shape[0]), np.float32)
    Y = Z.copy()
    t = 1.0
    for _ in range(500):
        G = P @ Y - Qt
        Z_new = np.maximum(Y - step * G, 0.0)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t * t))
        Y = Z_new + ((t - 1.0) / t_new) * (Z_new - Z)
        Z, t = Z_new, t_new
    fista_obj, exact_obj = nnls_objectives(
        ours["Q"], ours["anchors_f"], Z.T.astype(np.float64))

    results["init_comparison"] = {
        "keep_sets_equal": keep_same,
        "anchor_overlap": anchor_overlap,
        "anchors_ref": ref["anchors"].tolist(),
        "anchors_ours": ours["anchors"].tolist(),
        "max_abs_Q_diff": q_err,
        "fista500_mean_nnls_objective": fista_obj,
        "exact_mean_nnls_objective": exact_obj,
    }
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results["init_comparison"], indent=2)[:1200],
          flush=True)

    if "init_comparison_fixed" not in results:
        t0 = time.perf_counter()
        fixed = ours_init_stepwise(docs_beta, V, gram_norm="none")
        print(f"  fixed init: {time.perf_counter() - t0:.1f}s", flush=True)
        if keep_same:
            pos = {v: i for i, v in enumerate(fixed["keep"])}
            perm = np.array([pos[v] for v in ref["keep"]])
            qf_err = float(np.abs(
                fixed["Q"][np.ix_(perm, perm)] - ref["Q"]).max())
        else:
            qf_err = None
        results["init_comparison_fixed"] = {
            "anchor_overlap": len(set(ref["anchors"].tolist())
                                  & set(fixed["anchors"].tolist())),
            "anchors_equal_ordered": bool(np.array_equal(
                ref["anchors"], fixed["anchors"])),
            "max_abs_Q_diff": qf_err,
            "max_abs_beta_diff": float(
                np.abs(fixed["beta"] - ref["beta"]).max()),
        }
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(json.dumps(results["init_comparison_fixed"], indent=2),
              flush=True)
    else:
        fixed = None

    print("=== B: cross fits (CPU) ===", flush=True)
    if fixed is None and "fit_from_our_init_fixed" not in results:
        fixed = ours_init_stepwise(docs_beta, V, gram_norm="none")
    for name, beta0 in (
        ("fit_from_ref_exact_init", ref["beta"]),
        ("fit_from_our_init_cpu", ours["beta"]),
        ("fit_from_our_init_fixed",
         fixed["beta"] if fixed is not None else None),
    ):
        if beta0 is None:
            continue
        if name in results:
            continue
        t0 = time.perf_counter()
        results[name] = fit_ours_from_beta(
            beta0, docs_beta, docs_theta, vocab, X, n_test1, test_2,
            docs_beta)
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(f"  {name}: heldout {results[name]['heldout_ll']:.4f} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)

    print("wrote", OUT, flush=True)


if __name__ == "__main__":
    main()
