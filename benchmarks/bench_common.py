"""Shared benchmark harness: synthetic corpus -> warmed state -> timing.

Every E-step A/B in this directory (estep_ab.py, ablate_estep.py) uses
the same recipe: STM-DGP corpus, pad, config, prevalence design, init,
5 warm-up EM iterations (steady state, as in strutopy_tpu/bench.py), then the median
of repeated timings of the jitted E-step.  Keeping it in one place
means a protocol change cannot silently desynchronize the baselines.
"""

import time

import numpy as np


def corpus(K, V, N, n_words, seed=0):
    """Synthetic STM-DGP corpus (BoW docs + binary covariate)."""
    rng = np.random.default_rng(seed)
    beta = rng.dirichlet(np.full(V, 0.05), size=K)
    eta = rng.normal(0.0, 1.0, (N, K - 1))
    ef = np.concatenate([eta, np.zeros((N, 1))], axis=1)
    theta = np.exp(ef - ef.max(axis=1, keepdims=True))
    theta /= theta.sum(axis=1, keepdims=True)
    p = theta @ beta
    docs = []
    for d in range(N):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    X = rng.integers(0, 2, N).astype(np.float64)
    return docs, X


def warmed_state(K, V, N, n_words, batch, cfg_kw, warmup: int = 5):
    """Build (state, data, pc, design, make_cfg) at steady state.

    ``make_cfg(**overrides)`` builds an STMConfig with the shared
    benchmark base (K/model/init/batch + cfg_kw) plus overrides, so
    variant sweeps measure on the SAME warmed state."""
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.em import CorpusData, make_em_step
    from strutopy_tpu.models.state import init_state
    from strutopy_tpu.ops import mstep

    docs, X = corpus(K, V, N, n_words)
    pc = pad_corpus(docs, V=V)

    def make_cfg(**overrides):
        kw = dict(K=K, model_type="STM", init_type="random",
                  batch_size=batch)
        kw.update(cfg_kw)
        kw.update(overrides)
        return STMConfig(**kw)

    cfg = make_cfg()
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
    for _ in range(warmup):
        state = em(state, data)
    jax.block_until_ready(state.bound)
    return state, data, pc, design, make_cfg


def time_estep(state, data, cfg, repeats: int = 5):
    """E-step wall time: returns (list of seconds per repeat, bound).

    The first call compiles and is not timed."""
    import jax

    from strutopy_tpu.models.em import local_estep_stats

    estep = jax.jit(lambda s, d: local_estep_stats(s, d, cfg)[0].bound)
    bound = float(estep(state, data))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(estep(state, data))
        times.append(time.perf_counter() - t0)
    return times, bound
