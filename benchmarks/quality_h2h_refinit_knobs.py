"""Same-init quality variants on CPU: can a DOCUMENTED regularization
knob (beta_smoothing — a pseudocount the reference lacks; sigma_prior
— R-stm's own shrinkage parameter the reference exposes but its
committed config zeroes) match or beat the reference's heldout from
the reference's OWN deterministic init (stm.py:361 random.seed(123456))
at its committed 25-iteration budget?

Context (results_quality_h2h_traj_refinit.json): from the identical
init, plain ours reaches -8.024 at iter 25 vs the reference's -7.946 —
the reference's damped df (PARITY_NOTES #1: its gradient is missing
the e^eta factor, so per-doc eta optimization systematically
under-steps toward the prior) acts as implicit shrinkage, which wins
on a 1,015-doc corpus at K=50.  The principled response is explicit,
documented shrinkage, not bug emulation.

CPU run (N=1015 is CPU-friendly).

Usage: python benchmarks/quality_h2h_refinit_knobs.py
Writes benchmarks/results_quality_h2h_refinit_knobs.json incrementally.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.join(os.path.abspath(os.getcwd()), "benchmarks")
sys.path.insert(0, HERE)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from quality_h2h import load_wiki, split_completion  # noqa: E402

OUT = os.path.join(HERE, "results_quality_h2h_refinit_knobs.json")
K, ITERS = 50, 40

VARIANTS = {
    "smoothed_001": dict(beta_smoothing=0.01),
    "sigma_prior_02": dict(sigma_prior=0.2),
    "smoothed_001_sigma_02": dict(beta_smoothing=0.01, sigma_prior=0.2),
}


def _heldout(test_2, theta_test1, beta):
    from strutopy_tpu.eval.heldout import eval_heldout

    return float(eval_heldout(test_2, np.asarray(theta_test1, np.float64),
                              np.asarray(beta, np.float64)))


def main():
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.stm import STM

    docs, vocab, X = load_wiki()
    train, test, test_1, test_2 = split_completion(docs)
    docs_beta, docs_theta = train + test, train + test_1
    n_test1 = len(test_1)

    results = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            results = json.load(f)
    base = dict(K=K, model_type="STM", mode="ols", init_type="random",
                max_em_iter=ITERS, convergence_threshold=1e-5,
                newton_pass1_iters=6, newton_straggler_frac=0.25,
                newton_warmup_iters=2)
    for vname, over in VARIANTS.items():
        if vname in results:
            continue
        cfg = STMConfig(**dict(base, **over))
        mb = STM(documents=docs_beta, dictionary=vocab,
                 X=X[: len(docs_beta)], config=cfg, seed=123456)
        mt = STM(documents=docs_theta, dictionary=vocab,
                 X=X[: len(docs_theta)], config=cfg, seed=123456)
        traj = []
        for it in range(ITERS):
            step_b = (mb._em_step_cold
                      if mb._em_step_cold is not None
                      and it < cfg.newton_warmup_iters else mb._em_step)
            step_t = (mt._em_step_cold
                      if mt._em_step_cold is not None
                      and it < cfg.newton_warmup_iters else mt._em_step)
            mb._state = step_b(mb._state, mb._data)
            mt._state = step_t(mt._state, mt._data)
            traj.append(round(_heldout(
                test_2, mt.theta[-n_test1:], mb.beta), 5))
            if (it + 1) % 5 == 0:
                print(f"  [{vname}] iter {it + 1}: {traj[-1]:.4f}",
                      flush=True)
        results[vname] = {
            "seed": 123456, "heldout_by_iter": traj,
            "at_25": traj[24], "final": traj[-1],
            "peak": max(traj), "peak_iter": int(np.argmax(traj)) + 1,
        }
        with open(OUT, "w") as f:
            json.dump(results, f, indent=2)
        print(f"[{vname}] at_25 {traj[24]:.4f} peak {max(traj):.4f} "
              f"@ {np.argmax(traj) + 1}", flush=True)
    print("wrote", OUT, flush=True)


main()
