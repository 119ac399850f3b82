"""Streamed (out-of-core) EM must match the in-memory EM step.

models/streaming.py lifts em_iteration's doc loop to host level (one
corpus part on device at a time); the math is identical, so bounds,
beta, sigma and gamma must agree with make_em_step on the concatenated
corpus to f32-scatter-order tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.em import CorpusData, make_em_step
from strutopy_tpu.models.state import init_state
from strutopy_tpu.models.streaming import StreamedEM
from strutopy_tpu.ops import mstep


def _corpus(N=96, K=4, L=18, V=120, seed=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, V, (N, L)).astype(np.int32)
    counts = rng.integers(1, 3, (N, L)).astype(np.float32)
    aspects = np.zeros(N, np.int32)
    doc_ok = np.ones(N, bool)
    X = rng.integers(0, 2, N).astype(np.float64)
    return words, counts, aspects, doc_ok, X


@pytest.mark.parametrize("n_parts", [2, 3])
def test_streamed_matches_in_memory(n_parts):
    N, K, V = 96, 4, 120
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16,
                    sort_by_difficulty=False)
    D_np, design = mstep.make_prevalence_design(X, doc_ok)

    # ---- in-memory reference ----
    data = CorpusData.single(
        jnp.asarray(words), jnp.asarray(counts), jnp.asarray(aspects),
        jnp.asarray(doc_ok), jnp.asarray(D_np, jnp.float32),
    )
    state = init_state(jax.random.PRNGKey(0), K=K, V=V, N=N, P=D_np.shape[1])
    em = make_em_step(cfg, design, None, np.zeros(V))
    bounds_mem = []
    for _ in range(3):
        state = em(state, data)
        bounds_mem.append(float(np.asarray(state.bound)))

    # ---- streamed over host-numpy parts ----
    n = N // n_parts
    parts = [
        (words[i * n:(i + 1) * n], counts[i * n:(i + 1) * n],
         aspects[i * n:(i + 1) * n], doc_ok[i * n:(i + 1) * n],
         D_np[i * n:(i + 1) * n].astype(np.float32))
        for i in range(n_parts)
    ]
    sem = StreamedEM(cfg, design, parts)
    # identical init: slice the in-memory init per part
    full0 = init_state(jax.random.PRNGKey(0), K=K, V=V, N=N, P=D_np.shape[1])
    part_states = [
        full0._replace(
            eta=full0.eta[i * n:(i + 1) * n],
            mu=full0.mu[i * n:(i + 1) * n],
            theta=full0.theta[i * n:(i + 1) * n],
            opt_iters=full0.opt_iters[i * n:(i + 1) * n],
        )
        for i in range(n_parts)
    ]
    shared = full0
    bounds_str = []
    for _ in range(3):
        shared, part_states = sem.em_iteration(shared, part_states)
        bounds_str.append(float(np.asarray(shared.bound)))

    np.testing.assert_allclose(bounds_str, bounds_mem, rtol=2e-5)
    np.testing.assert_allclose(
        np.asarray(shared.beta), np.asarray(state.beta), atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(shared.sigma), np.asarray(state.sigma), rtol=2e-4, atol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(shared.gamma), np.asarray(state.gamma), rtol=2e-3, atol=2e-4
    )
    # eta accumulates the f32 moment-summation-order drift across the 3
    # iterations (same class as test_sharding's theta tolerance)
    eta_streamed = np.concatenate([np.asarray(s.eta) for s in part_states])
    np.testing.assert_allclose(eta_streamed, np.asarray(state.eta), atol=2e-3)


def test_streamed_provider_callable():
    """Callable provider: parts regenerated per call (the on-device-DGP
    pattern of a corpus generated on the device)."""
    N, K, V, n_parts = 64, 3, 80, 2
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V, seed=1)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16,
                    sort_by_difficulty=False)
    D_np, design = mstep.make_prevalence_design(X, doc_ok)
    n = N // n_parts

    calls = []

    def provider(p):
        calls.append(p)
        s = slice(p * n, (p + 1) * n)
        return (words[s], counts[s], aspects[s], doc_ok[s],
                D_np[s].astype(np.float32))

    sem = StreamedEM(cfg, design, provider, n_parts=n_parts)
    part_states = sem.init_parts(jax.random.PRNGKey(0), K=K, V=V)
    shared = init_state(jax.random.PRNGKey(0), K=K, V=V, N=n, P=D_np.shape[1])
    for _ in range(2):
        shared, part_states = sem.em_iteration(shared, part_states)
    assert np.isfinite(float(np.asarray(shared.bound)))
    # init_parts peeks part 0 for shapes; that fetch is CACHED and
    # reused by iteration 1's part-0 E-step instead of a second call
    assert calls == [0, 1, 0, 1]


def test_stm_stream_parts_matches_plain(toy_corpus, toy_dictionary, toy_metadata):
    """STM(stream_parts=N): the out-of-core surface must reproduce the
    in-memory fit (same API, corpus stays host-resident in parts)."""
    from strutopy_tpu.models.stm import STM

    train_docs = toy_corpus.train_docs
    kwargs = dict(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=3,
        init_type="random",
        model_type="STM",
        seed=123456,
    )
    m1 = STM(**kwargs)
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=3)
    assert ms._data is None  # corpus not device-resident
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(
        np.asarray(ms.last_bounds), np.asarray(m1.last_bounds), rtol=2e-4
    )
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.theta, m1.theta, atol=2e-3)


def test_stm_stream_parts_checkpoint_resume(
    tmp_path, toy_corpus, toy_dictionary, toy_metadata
):
    """Interrupt + resume must work through the streamed step closure
    (state slices per part from the restored full state)."""
    from strutopy_tpu.models.stm import STM

    train = toy_corpus.train_docs
    kw = dict(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], init_type="random",
        model_type="STM", seed=123456, stream_parts=2,
    )
    ckpt = str(tmp_path / "state.npz")
    m1 = STM(max_em_iter=4, **kw)
    m1.expectation_maximization(saving=False)

    m2a = STM(max_em_iter=2, **kw)
    m2a.expectation_maximization(saving=False, checkpoint_path=ckpt)
    m2b = STM(max_em_iter=4, **kw)
    m2b.expectation_maximization(saving=False, checkpoint_path=ckpt, resume=True)
    assert len(m2b.last_bounds) == len(m1.last_bounds)
    np.testing.assert_allclose(m2b.last_bounds, m1.last_bounds, rtol=1e-5)
    np.testing.assert_allclose(m2b.beta, m1.beta, atol=1e-5)


def test_stm_stream_parts_composes_with_mesh(
    toy_corpus, toy_dictionary, toy_metadata
):
    """Streaming x sharding (round 3, VERDICT r2 next #4): each device
    streams its shard of every part (per-part shard_mapped E-step, one
    psum per part); the composed fit must match the plain in-memory
    single-device fit."""
    from strutopy_tpu.models.stm import STM
    from strutopy_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")

    train_docs = toy_corpus.train_docs
    kwargs = dict(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=3,
        init_type="random",
        model_type="STM",
        seed=123456,
    )
    m1 = STM(**kwargs)
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=2, mesh=make_mesh(4))
    assert ms._data is None  # corpus not resident: parts stream per iter
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(
        np.asarray(ms.last_bounds), np.asarray(m1.last_bounds), rtol=2e-4
    )
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.theta, m1.theta, atol=2e-3)


def test_stm_stream_parts_composes_with_vocab_mesh(
    toy_corpus, toy_dictionary, toy_metadata
):
    """Streaming x 2-D (docs, vocab) mesh (round 3): each device streams
    its doc shard of every part while beta/beta_ss stay vocab-sharded;
    the composed fit must match the plain single-device fit."""
    from strutopy_tpu.models.stm import STM
    from strutopy_tpu.parallel.mesh import make_mesh_2d

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")

    words = list(toy_dictionary)
    while len(words) % 4:
        words.append(f"__pad_{len(words)}")
    train_docs = toy_corpus.train_docs
    kwargs = dict(
        documents=train_docs,
        dictionary=words,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=3,
        init_type="random",
        model_type="STM",
        seed=123456,
    )
    m1 = STM(**kwargs)
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=2, mesh=make_mesh_2d(2, 4))
    assert ms._data is None
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(
        np.asarray(ms.last_bounds), np.asarray(m1.last_bounds), rtol=2e-4
    )
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.theta, m1.theta, atol=2e-3)


def test_stm_stream_parts_vocab_mesh_requires_divisible_V(
    toy_corpus, toy_dictionary
):
    from strutopy_tpu.models.stm import STM
    from strutopy_tpu.parallel.mesh import make_mesh_2d

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    words = list(toy_dictionary)
    while len(words) % 4 == 0:  # force V % 4 != 0
        words.append(f"__pad_{len(words)}")
    with pytest.raises(ValueError, match="divisible"):
        STM(
            documents=toy_corpus.train_docs,
            dictionary=words,
            K=3,
            init_type="random",
            stream_parts=2,
            mesh=make_mesh_2d(2, 4),
        )


def test_streamed_content_requires_kappa_inputs():
    cfg = STMConfig(K=3, content=True, A=2, lda_beta=False)
    with pytest.raises(ValueError, match="kappa_design"):
        StreamedEM(cfg, None, [], n_parts=1)


def test_stm_stream_parts_content_matches_plain(toy_corpus, toy_dictionary):
    """Streamed content model (round 3): the kappa GLM runs once per
    iteration on the part-summed beta_ss, warm-started from the shared
    state — must reproduce the in-memory content fit."""
    from strutopy_tpu.models.stm import STM

    train_docs = toy_corpus.train_docs
    n = len(train_docs)
    beta_index = np.random.default_rng(0).integers(0, 2, n)
    kwargs = dict(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=beta_index.astype(float),
        content=True,
        A=2,
        beta_index=beta_index,
        lda_beta=False,
        kappa_interactions=True,
        max_em_iter=2,
        init_type="random",
        model_type="CTM",
        seed=123456,
    )
    m1 = STM(**kwargs)
    m1.expectation_maximization(saving=False)
    ms = STM(**kwargs, stream_parts=2)
    assert ms._data is None
    ms.expectation_maximization(saving=False)
    np.testing.assert_allclose(
        np.asarray(ms.last_bounds), np.asarray(m1.last_bounds), rtol=2e-4
    )
    np.testing.assert_allclose(ms.beta, m1.beta, atol=2e-4)
    np.testing.assert_allclose(ms.kappa, m1.kappa, atol=2e-3)


def test_prefetch_matches_no_prefetch():
    """The one-part-ahead prefetch thread must not change results:
    same bound and shared state as the synchronous path, bit-exact
    (identical device computation, only the fetch timing differs)."""
    N, K, V = 96, 4, 120
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V, seed=3)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16,
                    sort_by_difficulty=False)
    D_np, design = mstep.make_prevalence_design(X, doc_ok)
    n = N // 3
    parts = [
        (words[i * n:(i + 1) * n], counts[i * n:(i + 1) * n],
         aspects[i * n:(i + 1) * n], doc_ok[i * n:(i + 1) * n],
         D_np[i * n:(i + 1) * n].astype(np.float32))
        for i in range(3)
    ]
    outs = []
    for pf in (False, True):
        sem = StreamedEM(cfg, design, parts, prefetch=pf)
        shared = init_state(jax.random.PRNGKey(1), K=K, V=V, N=n,
                            P=D_np.shape[1])
        pstates = sem.init_parts(jax.random.PRNGKey(2), K=K, V=V)
        for _ in range(2):
            shared, pstates = sem.em_iteration(shared, pstates)
        outs.append((float(np.asarray(shared.bound)),
                     np.asarray(shared.beta), np.asarray(shared.sigma),
                     [np.asarray(ps.eta) for ps in pstates]))
    (b0, beta0, sig0, etas0), (b1, beta1, sig1, etas1) = outs
    assert b0 == b1
    np.testing.assert_array_equal(beta0, beta1)
    np.testing.assert_array_equal(sig0, sig1)
    for e0, e1 in zip(etas0, etas1):
        np.testing.assert_array_equal(e0, e1)


def test_streamed_n_parts_mismatch_raises():
    """An explicit n_parts that disagrees with a sequence provider's
    length would silently drop tail parts from every EM iteration —
    it must be rejected up front."""
    N, K, V = 32, 3, 60
    words, counts, aspects, doc_ok, X = _corpus(N=N, K=K, V=V)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=16)
    D_np, design = mstep.make_prevalence_design(X, doc_ok)
    n = N // 2
    parts = [
        (words[i * n:(i + 1) * n], counts[i * n:(i + 1) * n],
         aspects[i * n:(i + 1) * n], doc_ok[i * n:(i + 1) * n],
         D_np[i * n:(i + 1) * n].astype(np.float32))
        for i in range(2)
    ]
    with pytest.raises(ValueError, match="does not match"):
        StreamedEM(cfg, design, parts, n_parts=1)
    # matching n_parts (or omitted) is fine
    assert StreamedEM(cfg, design, parts, n_parts=2).n_parts == 2
