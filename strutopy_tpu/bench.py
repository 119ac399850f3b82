"""Headline benchmark: steady-state E-step docs/s on one GPU at K=100, V=10k.

Prints ONE JSON line:
  {"metric": "estep_docs_per_sec_K100_V10k", "value": N, "unit": "docs/s",
   "device": {"platform": ..., "kind": ..., "count": ...},
   "card": "<nvidia-smi name, power.limit>"}

The E-step is timed at steady state: five full EM iterations run first
so eta is warm-started and beta/sigma/mu are fitted — the regime that
dominates a 25-iteration fit.  It refuses to run without a CUDA GPU.

    python bench.py        (or: python -m strutopy_tpu.cli bench)
"""

import json
import time

import numpy as np

K = 100
V = 10_000
N = 8_192
N_WORDS = 300  # tokens per doc (~150 unique terms)


def make_corpus(n_docs=N, K=K, V=V, n_words=N_WORDS, seed=0):
    """Synthetic STM-DGP corpus at the benchmark widths (BASELINE.json:
    'Scaled synthetic' family, sized to bench quickly)."""
    rng = np.random.default_rng(seed)
    beta_true = rng.dirichlet(np.full(V, 0.05), size=K)
    eta_true = rng.normal(0.0, 1.0, (n_docs, K - 1))
    eta_full = np.concatenate([eta_true, np.zeros((n_docs, 1))], axis=1)
    theta = np.exp(eta_full - eta_full.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    X = rng.integers(0, 2, n_docs).astype(np.float64)

    p = theta @ beta_true
    docs = []
    for d in range(n_docs):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    return docs, X


def measure_estep(docs, X):
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.em import CorpusData, make_em_step, local_estep_stats
    from strutopy_tpu.models.state import init_state
    from strutopy_tpu.ops import mstep

    corpus = pad_corpus(docs, V=V)
    # the two-pass difficulty schedule STM enables for real fits
    cfg = STMConfig(K=K, model_type="STM", mode="ols", init_type="random",
                    batch_size=256, newton_pass1_iters=6,
                    newton_straggler_frac=0.25)
    D_np, design = mstep.make_prevalence_design(X, corpus.doc_ok)
    data = CorpusData.single(
        words=jnp.asarray(corpus.words),
        counts=jnp.asarray(corpus.counts),
        aspects=jnp.zeros(corpus.N, jnp.int32),
        doc_ok=jnp.asarray(corpus.doc_ok),
        D=jnp.asarray(D_np, jnp.float32),
    )
    state = init_state(jax.random.PRNGKey(123456), K=K, V=V, N=corpus.N,
                       P=D_np.shape[1])
    em = make_em_step(cfg, design, None, corpus.word_counts())

    # 5 warm-up EM iterations: steady-state warm starts (with only 1
    # the Newton-iteration distribution is still cold and the two-pass
    # straggler budget starves)
    for _ in range(5):
        state = em(state, data)
    jax.block_until_ready(state.bound)

    estep = jax.jit(lambda s, d: local_estep_stats(s, d, cfg)[0].bound)
    jax.block_until_ready(estep(state, data))  # compile
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(estep(state, data))
        times.append(time.perf_counter() - t0)
    return corpus.N / float(np.median(times))


def main():
    import jax

    from strutopy_tpu.utils.runtime import enable_compile_cache, gpu_card, require_gpu

    require_gpu("bench.py")
    enable_compile_cache()
    docs, X = make_corpus()
    dps = measure_estep(docs, X)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "estep_docs_per_sec_K100_V10k",
        "value": dps,
        "unit": "docs/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": gpu_card(),
    }))

