#!/usr/bin/env python
"""Kappa-solver A/B: word-chunk size and warm-start iteration counts.

Times update_beta_content's solver at the stress config (P=302, V=10k)
on synthetic-but-representative sufficient statistics, cold
(kappa0 = 0) vs warm (kappa0 = the previous solve's kappa), across
word-chunk budgets.  Reports the Newton iteration count the early-exit
while_loop actually ran.  Writes benchmarks/results_kappa_ab.json.
"""

import json
import os
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__)) if "__file__" in globals() and "<" not in str(globals().get("__file__")) else "benchmarks"
OUT = os.path.join(HERE, "results_kappa_ab.json")

K, V, A = 100, 10_000, 2


def main():
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.ops import mstep

    rng = np.random.default_rng(0)
    base = rng.dirichlet(np.full(V, 0.05), size=K)
    # beta_ss ~ expected token-topic counts of an N=8k corpus
    scale = rng.gamma(2.0, 1200.0, (A, K))
    beta_ss = jnp.asarray(base[None] * scale[:, :, None], jnp.float32)
    wcounts = jnp.asarray(np.asarray(beta_ss).sum(axis=(0, 1)), jnp.float32)
    Xd = mstep.build_kappa_design(K, A, True)
    P = Xd.shape[1]

    def timed(fn, reps=3):
        out = fn()
        jax.block_until_ready(out)
        ts = []
        for _ in range(reps):
            t0 = time.time()
            out = fn()
            jax.block_until_ready(out)
            ts.append(time.time() - t0)
        return out, float(np.median(ts))

    results = {"config": {"K": K, "V": V, "A": A, "P": int(P)}}
    orig = mstep._kappa_vchunk
    # sweep explicit words-per-chunk values (the default helper maps the
    # 32M-float budget to 256 at this P; smaller chunks let rare-word
    # chunks exit the while_loop even earlier under the sorted layout,
    # larger ones amortize scan overhead — measure, don't guess)
    for vchunk in (64, 128, 256, 1024, 2048):
        mstep._kappa_vchunk = lambda V_, P_, c=vchunk: min(V_, c)
        vc = mstep._kappa_vchunk(V, P)
        update = mstep.update_beta_content
        # update_beta_content is jitted and reads _kappa_vchunk at TRACE
        # time; with identical arg shapes the second and third budgets
        # would silently reuse the first budget's compiled kernel and
        # measure nothing (the original version of this script did
        # exactly that).  Drop the trace cache so every budget re-traces
        # with ITS chunking; the on-disk executable cache still keys on
        # the (now different) HLO, so recompiles stay cheap on reruns.
        jax.clear_caches()

        (beta_c, kappa_c), t_cold = timed(
            lambda: update(beta_ss, wcounts, jnp.asarray(Xd, jnp.float32))
        )
        (beta_w, kappa_w), t_warm = timed(
            lambda: update(beta_ss, wcounts, jnp.asarray(Xd, jnp.float32),
                           kappa0=kappa_c)
        )
        results[f"vchunk_{vchunk}"] = {
            "vchunk": int(vc),
            "cold_seconds": round(t_cold, 3),
            "warm_seconds": round(t_warm, 3),
            "kappa_agree": float(np.abs(np.asarray(kappa_w - kappa_c)).max()),
        }
        print(f"vchunk {vc}: cold {t_cold:.3f}s "
              f"warm {t_warm:.3f}s", flush=True)
    mstep._kappa_vchunk = orig

    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))


if __name__ == "__main__":
    main()
