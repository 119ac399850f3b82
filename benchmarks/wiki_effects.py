"""Method-of-composition prevalence effects on the REAL wiki corpus.

The reference's example application stops at printing raw gamma
differences between covariate groups
(/root/reference/src/06_example_application.py:343-351).  This runs the
full R-stm-style ``estimateEffect`` with ``uncertainty="Global"``
(eval/effects.py::estimate_effect_composition) on the reference's own
corpus and covariate: fit wiki K=50 with the committed seed-category
label X (the "statistics" indicator from corpus_preproc.csv — X.npy
matches that column exactly; pages reached from the Statistics seed
are 1, Machine-learning-only pages 0), draw theta from every
document's Laplace posterior, fit the per-topic OLS on each draw, and
combine with Rubin's rules.  Records, per strongly-affected topic:
plain and composition coefficients (the composition coef is mildly
attenuated — softmax of jittered logits smooths theta), both CI
variants, and the topic's real top words via the gensim dictionary
reader — so the output is checkable by eye (statistics-flavored topics
must move positively with X=1, ML/software topics negatively).

Run from the repo root on the GPU:  python - < benchmarks/wiki_effects.py
"""

import json
import os
import time

import numpy as np

WIKI = "/root/reference/src/artifacts/wiki_data"
REF50 = "/root/reference/src/artifacts/reference_model/50"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "results_wiki_effects.json")


def main():
    from strutopy_tpu.corpus.io import read_gensim_dictionary, read_mm
    from strutopy_tpu.eval.diagnostics import label_topics
    from strutopy_tpu.eval.effects import (
        estimate_effect,
        estimate_effect_composition,
        plot_effect,
    )
    from strutopy_tpu.models.stm import STM

    docs = read_mm(os.path.join(WIKI, "BoW_corpus.mm"))
    vocab = read_gensim_dictionary(os.path.join(WIKI, "dictionary.mm"))
    X = np.load(os.path.join(REF50, "X.npy")).astype(np.float64).ravel()
    assert len(docs) == len(X) == 1015

    K = 50
    model = STM(documents=docs, dictionary=vocab, K=K, X=X,
                init_type="spectral", max_em_iter=25, model_type="STM",
                seed=123456)
    t0 = time.time()
    model.expectation_maximization(saving=False)
    fit_s = time.time() - t0

    theta = np.asarray(model.theta)
    plain = estimate_effect(theta, X)
    t0 = time.time()
    comp = estimate_effect_composition(model, n_draws=25, seed=0)
    comp_s = time.time() - t0

    # the X column is the last coefficient (design = [intercept, X])
    b = comp["coef"][:, -1]
    se_c = comp["se"][:, -1]
    se_p = plain["se"][:, -1]
    order = np.argsort(-np.abs(b))
    prob_labels, _frex = label_topics(np.asarray(model.beta), vocab, n=7)

    rows = []
    for k in order[:8]:
        rows.append({
            "topic": int(k),
            "coef_plain": float(plain["coef"][k, -1]),
            "coef_composition": float(b[k]),
            "ci_plain": [float(plain["ci"][k, -1, 0]),
                         float(plain["ci"][k, -1, 1])],
            "ci_composition": [float(comp["ci"][k, -1, 0]),
                               float(comp["ci"][k, -1, 1])],
            "top_words": list(prob_labels[k]),
        })

    sig_plain = int(np.sum(np.abs(plain["coef"][:, -1]) > 1.96 * se_p))
    sig_comp = int(np.sum(np.abs(b) > 1.96 * se_c))
    result = {
        "config": {"K": K, "N": len(docs), "V": len(vocab),
                   "max_em_iter": 25, "n_draws": 25},
        "fit_seconds": round(fit_s, 1),
        "composition_seconds": round(comp_s, 1),
        "final_bound": float(model.last_bounds[-1]),
        # composition draws both widen (posterior jitter) and attenuate
        # (softmax smoothing shrinks coef AND residuals); report both so
        # the ratio is interpretable next to the coef columns
        "median_se_ratio_composition_over_plain":
            float(np.median(se_c / se_p)),
        "median_abs_coef_ratio_composition_over_plain": float(
            np.median(np.abs(b) / np.maximum(np.abs(plain["coef"][:, -1]),
                                             1e-12))
        ),
        "n_significant_plain": sig_plain,
        "n_significant_composition": sig_comp,
        "top_effects": rows,
    }
    with open(OUT, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result, indent=2))

    try:
        from strutopy_tpu.eval.diagnostics import plot_topic_quality

        plot_topic_quality(
            np.asarray(model.beta), model._corpus, theta=theta,
            path=os.path.join(os.path.dirname(OUT),
                              "wiki_topic_quality.png"),
        )
        sel = [int(k) for k in order[:10]]
        sub = {"coef": comp["coef"][sel], "ci": comp["ci"][sel],
               "topics": sel}
        fig = plot_effect(
            sub, path=os.path.join(os.path.dirname(OUT), "wiki_effects.png"),
        )
        del fig
    except Exception as e:  # plotting is best-effort (headless matplotlib)
        print("plot skipped:", e)


if __name__ == "__main__":
    main()
