"""A/B: extrapolated eta warm starts across EM iterations.

Steady-state E-steps start Newton at the previous iteration's optimum
(plain warm start).  Between EM iterations the per-doc optimum moves
smoothly (beta/mu/sigma drift), so a one-step linear extrapolation
    eta_start = eta_t + c * (eta_t - eta_{t-1})
may land closer to the new optimum and cut while_loop trips — the
Newton loop is ~55% of iteration time (results_ablate_K100_V10000.json).
Newton converges to the same per-doc optimum from any nearby start, so
the bound must be unchanged to float tolerance; only time and the
newton_iters distribution may move.

Protocol: bench config (K=100, V=10k, N=8192), 5 warm-up EM iterations
capturing eta after iterations 4 and 5, then every variant c times the
SAME jitted E-step on the SAME post-warm-up state with only the eta
input replaced (one compile, median-of-5 per variant, interleaved
rounds so drift cannot masquerade as a variant effect).
"""

import json
import os
import sys
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))  # repo root (strutopy_tpu)
sys.path.insert(0, _here)  # bench_common
import numpy as np
from bench_common import corpus

K, V, N, N_WORDS, BATCH = 100, 10_000, 8_192, 300, 256
CFG_KW = dict(newton_pass1_iters=6, newton_straggler_frac=0.25)
COEFFS = (0.0, 0.25, 0.5, 0.75, 1.0)
ROUNDS = 5
WARMUP = 5


def main():
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.em import CorpusData, local_estep_stats, make_em_step
    from strutopy_tpu.models.state import init_state
    from strutopy_tpu.ops import mstep

    docs, X = corpus(K, V, N, N_WORDS)
    pc = pad_corpus(docs, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random",
                    batch_size=BATCH, **CFG_KW)
    D_np, design = mstep.make_prevalence_design(X, pc.doc_ok)
    data = CorpusData.single(
        words=jnp.asarray(pc.words),
        counts=jnp.asarray(pc.counts),
        aspects=jnp.zeros(pc.N, jnp.int32),
        doc_ok=jnp.asarray(pc.doc_ok),
        D=jnp.asarray(D_np, jnp.float32),
    )
    state = init_state(jax.random.PRNGKey(0), K=K, V=V, N=pc.N,
                       P=D_np.shape[1])
    em = make_em_step(cfg, design, None, pc.word_counts())

    etas = []
    for _ in range(WARMUP):
        state = em(state, data)
        etas.append(np.asarray(state.eta))
    jax.block_until_ready(state.bound)
    eta_t = jnp.asarray(etas[-1])
    step = jnp.asarray(etas[-1] - etas[-2])
    print(f"mean |eta_t - eta_t-1| = {float(np.abs(etas[-1]-etas[-2]).mean()):.4f}",
          file=sys.stderr)

    # diagnostics graph (returns per-doc iters: extra live outputs) is
    # separate from the TIMING graph, which is exactly bench.py's
    # bound-only jit so numbers are comparable to the headline
    diag = jax.jit(
        lambda s, d: (lambda r: (r[0].bound, r[3]))(
            local_estep_stats(s, d, cfg))
    )
    estep = jax.jit(lambda s, d: local_estep_stats(s, d, cfg)[0].bound)

    variants = {}
    for c in COEFFS:
        st = state._replace(eta=eta_t + c * step)
        b, it = diag(st, data)
        float(np.asarray(estep(st, data)))  # compile timing graph
        variants[c] = dict(state=st,
                           bound=float(np.asarray(b)),
                           mean_iters=float(np.asarray(it).mean()),
                           times=[])
    # interleaved timing rounds
    for _ in range(ROUNDS):
        for c in COEFFS:
            st = variants[c]["state"]
            t0 = time.time()
            float(np.asarray(estep(st, data)))
            variants[c]["times"].append(time.time() - t0)

    out = {"config": dict(K=K, V=V, N=N, n_words=N_WORDS, batch=BATCH,
                          warmup=WARMUP, **CFG_KW),
           "protocol": f"median of {ROUNDS} interleaved rounds, "
                       f"{WARMUP} warm-up EM iterations, "
                       "same warmed state, eta input only",
           "variants": []}
    base = None
    for c in COEFFS:
        v = variants[c]
        dps = N / float(np.median(v["times"]))
        if c == 0.0:
            base = dps
        out["variants"].append({
            "c": c, "docs_per_sec": round(dps, 1),
            "mean_newton_iters": round(v["mean_iters"], 3),
            "bound": v["bound"],
            "vs_plain": round(dps / base, 4) if base else None,
        })
        print(f"c={c:4}: {dps:9.1f} docs/s  mean_iters={v['mean_iters']:.3f} "
              f"bound={v['bound']:.2f}", file=sys.stderr)

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_eta_extrap.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out["variants"]))


if __name__ == "__main__":
    main()
