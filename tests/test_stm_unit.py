"""STM construction/shape tests mirroring reference tests/test_stm_unit.py."""

import numpy as np

from strutopy_tpu.models.stm import STM


def test_stm_random_init(toy_corpus, toy_dictionary, toy_metadata):
    train_docs = toy_corpus.train_docs
    K = 3
    N_train = len(train_docs)
    model = STM(
        documents=train_docs,
        dictionary=toy_dictionary,
        content=False,
        K=K,
        X=toy_metadata[:N_train],
        kappa_interactions=False,
        max_em_iter=1,
        sigma_prior=0,
        convergence_threshold=1e-5,
        init_type="random",
        model_type="CTM",
    )
    assert model.beta.shape == (K, len(toy_dictionary))
    assert model.theta.shape == (N_train, K)
    assert model.sigma.shape == (K - 1, K - 1)
    assert model.eta.shape == (N_train, K - 1)
    np.testing.assert_allclose(model.beta.sum(axis=1), 1.0, atol=1e-5)
    # sigma initialized at 20 * I (reference stm.py:459-461)
    np.testing.assert_allclose(model.sigma, 20 * np.eye(K - 1), atol=1e-6)


def test_stm_rejects_bad_config(toy_corpus, toy_dictionary):
    import pytest

    with pytest.raises(ValueError):
        STM(documents=toy_corpus.train_docs, dictionary=toy_dictionary, K=0)
    with pytest.raises(ValueError):
        STM(
            documents=toy_corpus.train_docs,
            dictionary=toy_dictionary,
            K=3,
            model_type="bogus",
        )


def test_save_model_contract(tmp_path, toy_corpus, toy_dictionary, toy_metadata):
    """Artifact contract matches reference save_model (stm.py:1120-1149)."""
    train_docs = toy_corpus.train_docs
    model = STM(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=1,
        init_type="random",
        model_type="STM",
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    for name in ["beta_hat", "theta_hat", "sigma_hat", "eta_hat", "mu_hat", "gamma_hat", "X"]:
        assert (tmp_path / f"{name}.npy").exists(), name
    assert (tmp_path / "lower_bound.pickle").exists()
    assert (tmp_path / "stm_config.json").exists()
    beta = np.load(tmp_path / "beta_hat.npy")
    assert beta.shape == (3, len(toy_dictionary))


def test_debug_checks_pass_on_healthy_fit(toy_corpus, toy_dictionary, toy_metadata):
    train = toy_corpus.train_docs
    model = STM(
        documents=train,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train)],
        max_em_iter=2,
        init_type="random",
        model_type="CTM",
    )
    model.config = model.config.replace(debug_checks=True)
    model.expectation_maximization(saving=False)
    assert np.isfinite(model.last_bounds).all()


def test_debug_validate_state_catches_bad_beta():
    import jax.numpy as jnp
    import pytest

    from strutopy_tpu.models.state import STMState
    from strutopy_tpu.utils.debug import NumericalCheckError, validate_state

    bad = STMState(
        beta=jnp.asarray([[0.5, jnp.nan]]),
        mu=jnp.zeros((1, 1)),
        sigma=jnp.eye(1),
        eta=jnp.zeros((1, 1)),
        theta=jnp.asarray([[0.5, 0.5]]),
        gamma=jnp.zeros((1, 1)),
        kappa=jnp.zeros((0, 2)),
        bound=jnp.asarray(-1.0),
        opt_iters=jnp.zeros((1,), jnp.int32),
    )
    with pytest.raises(NumericalCheckError):
        validate_state(bad, 0)


def test_transform_new_documents(toy_corpus, toy_dictionary, toy_metadata):
    """Serving path: theta inference for unseen docs under fixed params."""
    train = toy_corpus.train_docs
    model = STM(
        documents=train,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train)],
        max_em_iter=4,
        init_type="random",
        model_type="STM",
    )
    model.expectation_maximization(saving=False)

    test_docs = toy_corpus.test_docs
    X_new = toy_metadata[len(train) : len(train) + len(test_docs)]
    theta, eta = model.transform(test_docs, X=X_new)
    assert theta.shape == (len(test_docs), 3)
    assert eta.shape == (len(test_docs), 2)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-4)
    # transforming the training docs approximately reproduces the fitted
    # thetas (exact equality is impossible: model.theta comes from the
    # E-step BEFORE the final M-step updated beta/sigma, while transform
    # uses the final parameters — the reference has the same lag)
    theta_tr, _ = model.transform(train, X=toy_metadata[: len(train)])
    np.testing.assert_allclose(theta_tr, model.theta, atol=0.05)
    assert np.abs(theta_tr - model.theta).mean() < 0.01


def test_transform_ctm_needs_no_covariates(toy_corpus, toy_dictionary):
    model = STM(
        documents=toy_corpus.train_docs,
        dictionary=toy_dictionary,
        K=3,
        max_em_iter=2,
        init_type="random",
        model_type="CTM",
    )
    model.expectation_maximization(saving=False)
    theta, _ = model.transform(toy_corpus.test_docs)
    assert theta.shape[0] == len(toy_corpus.test_docs)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-4)


def test_infer_from_artifacts_roundtrip(tmp_path, toy_corpus, toy_dictionary, toy_metadata):
    """Serving from the saved artifact directory reproduces transform."""
    from strutopy_tpu.models.serving import infer_from_artifacts

    train = toy_corpus.train_docs
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], max_em_iter=3,
        init_type="random", model_type="STM",
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))

    test_docs = toy_corpus.test_docs
    X_new = toy_metadata[len(train) : len(train) + len(test_docs)]
    theta_live, _ = model.transform(test_docs, X=X_new)
    theta_art, _ = infer_from_artifacts(str(tmp_path), test_docs, X=X_new)
    np.testing.assert_allclose(theta_art, theta_live, atol=2e-3)


def test_theta_server_matches_one_shot(tmp_path, toy_corpus, toy_dictionary,
                                       toy_metadata):
    """ThetaServer (device-resident params, load-once) returns the same
    theta as the one-shot infer_from_artifacts path, and warmup runs."""
    from strutopy_tpu.models.serving import ThetaServer, infer_from_artifacts

    train = toy_corpus.train_docs
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], max_em_iter=3,
        init_type="random", model_type="STM",
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))

    test_docs = toy_corpus.test_docs
    X_new = toy_metadata[len(train): len(train) + len(test_docs)]
    theta_once, eta_once = infer_from_artifacts(str(tmp_path), test_docs,
                                                X=X_new)
    srv = ThetaServer(str(tmp_path))
    srv.warmup(n_docs=1, doc_len=8)
    theta_srv, eta_srv = srv.infer(test_docs, X=X_new)
    np.testing.assert_array_equal(theta_srv, theta_once)
    np.testing.assert_array_equal(eta_srv, eta_once)
    # a second call reuses the resident params and stays deterministic
    theta_again, _ = srv.infer(test_docs, X=X_new)
    np.testing.assert_array_equal(theta_again, theta_srv)


def test_infer_theta_preencoded_matches_list_docs(toy_corpus, toy_dictionary,
                                                  toy_metadata):
    """Passing a pre-encoded PaddedCorpus to infer_theta gives bit-identical
    theta to the list-of-tuples path (the bulk-serving fast path measured in
    benchmarks/serving_bench.py), and a vocab-id overflow raises instead of
    silently clamping."""
    import pytest

    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.serving import infer_theta

    train = toy_corpus.train_docs
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], max_em_iter=3,
        init_type="random", model_type="STM",
    )
    model.expectation_maximization(saving=False)

    test_docs = toy_corpus.test_docs
    beta = model.beta.astype(np.float32)
    sigma = model.sigma.astype(np.float32)
    gamma = np.asarray(model.gamma, np.float64)
    D = np.c_[np.ones(len(test_docs)),
              np.asarray(toy_metadata[len(train): len(train) + len(test_docs)])]
    mu = (D @ gamma.T).astype(np.float32)

    theta_list, eta_list = infer_theta(beta, sigma, mu, test_docs, model.config)
    pc = pad_corpus(test_docs, V=len(toy_dictionary))
    theta_pc, eta_pc = infer_theta(beta, sigma, mu, pc, model.config)
    np.testing.assert_array_equal(theta_pc, theta_list)
    np.testing.assert_array_equal(eta_pc, eta_list)

    bad_docs = [d for d in test_docs] + [[(len(toy_dictionary) + 5, 2)]]
    mu_bad = np.concatenate([mu, mu[:1]], axis=0)
    with pytest.raises(ValueError, match="word id"):
        infer_theta(beta, sigma, mu_bad, bad_docs, model.config)


def test_stm_rejects_covariate_length_mismatch(toy_corpus, toy_dictionary):
    """X shorter than the corpus must raise, not silently zero-fill
    covariates for the tail documents (ADVICE r1)."""
    import pytest

    docs = toy_corpus.train_docs
    with pytest.raises(ValueError, match="rows but the corpus"):
        STM(documents=docs, dictionary=toy_dictionary, K=3,
            X=np.ones(len(docs) - 3), model_type="STM", init_type="random")


def test_transform_ctm_with_empty_document(toy_corpus, toy_dictionary):
    """Regression: the CTM transform prior used doc_ok[:self.N] (self.N
    counts only REAL docs) against the corpus.N-row eta — any empty
    document mis-sized the mask and crashed with IndexError."""
    docs = list(toy_corpus.train_docs)
    docs.insert(3, [])  # one empty doc
    model = STM(
        documents=docs, dictionary=toy_dictionary, K=3,
        max_em_iter=2, init_type="random", model_type="CTM",
    )
    model.expectation_maximization(saving=False)
    theta, _ = model.transform(toy_corpus.test_docs)
    assert theta.shape[0] == len(toy_corpus.test_docs)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-4)


def test_stm_validates_beta_index(toy_corpus, toy_dictionary):
    """Short or out-of-range aspect arrays must error (the device
    gather/scatter would silently clamp/drop invalid aspect ids)."""
    import pytest

    train = toy_corpus.train_docs
    short = np.zeros(len(train) - 2, np.int32)
    with pytest.raises(ValueError, match="beta_index has"):
        STM(documents=train, dictionary=toy_dictionary, K=3,
            content=True, A=2, beta_index=short, max_em_iter=1,
            init_type="random")
    bad = np.zeros(len(train), np.int32)
    bad[0] = 2  # A=2 -> valid ids are {0, 1}
    with pytest.raises(ValueError, match="must lie in"):
        STM(documents=train, dictionary=toy_dictionary, K=3,
            content=True, A=2, beta_index=bad, max_em_iter=1,
            init_type="random")


def test_categorical_levels_ignore_bucket_padding(toy_corpus, toy_dictionary):
    """Regression: one-hot level inference ran on the bucket-padded X
    (zero-filled pad rows), emitting a spurious level-0 column whenever
    0 was not a real level of a categorical covariate."""
    train = toy_corpus.train_docs
    # 3-level categorical WITHOUT a zero level
    x = np.asarray([1.0, 2.0, 3.0])[np.arange(len(train)) % 3]
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3, X=x,
        max_em_iter=2, init_type="random", model_type="STM",
        batch_size=16,  # forces padding unless len(train) % 16 == 0
    )
    model.expectation_maximization(saving=False)
    # intercept + 3 one-hot level columns; a padding-induced level 0
    # would make it 5
    assert model.gamma.shape[1] == 4


def test_serving_prior_rejects_missing_intercept_when_fit_without():
    """_prior_means must dispatch on cfg.fit_intercept, not silently
    prepend an intercept when the column count happens to be P-1."""
    import pytest

    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.serving import _prior_means

    gamma = np.ones((2, 3))  # (K-1, P=3), fit WITHOUT intercept
    cfg = STMConfig(K=3, fit_intercept=False)
    X_bad = np.ones((4, 2))  # P-1 columns
    with pytest.raises(ValueError, match="expects a 3-column"):
        _prior_means(gamma, None, cfg, K=3, N_new=4, X=X_bad)
    mu = _prior_means(gamma, None, cfg, K=3, N_new=4, X=np.ones((4, 3)))
    assert mu.shape == (4, 2)


def test_serving_prior_rejects_covariate_posing_as_full_design():
    """Regression: an intercept-included fit handed a P-column X whose
    first column is NOT the constant 1 silently scaled the intercept
    coefficient by covariate values (garbage theta, no error) — the
    classic case being an intercept-only model (P=1) passed a 1-column
    covariate X."""
    import pytest

    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.serving import _prior_means

    cfg = STMConfig(K=3, fit_intercept=True)
    # intercept-only fit (P=1): a covariate X must be rejected
    gamma1 = np.ones((2, 1))
    with pytest.raises(ValueError, match="constant 1"):
        _prior_means(gamma1, None, cfg, K=3, N_new=4, X=np.arange(4.0))
    # an explicit intercept column of ones is accepted
    mu = _prior_means(gamma1, None, cfg, K=3, N_new=4, X=np.ones((4, 1)))
    np.testing.assert_allclose(mu, np.ones((4, 2)))
    # general P: full-width design with a non-constant first column
    gamma3 = np.ones((2, 3))
    with pytest.raises(ValueError, match="constant 1"):
        _prior_means(gamma3, None, cfg, K=3, N_new=4,
                     X=np.arange(12.0).reshape(4, 3))


def test_serving_prior_rejects_X_without_gamma():
    """X passed for a model with no prevalence regression (no gamma_hat,
    e.g. a CTM) must raise, not be silently ignored."""
    import pytest

    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.serving import _prior_means

    cfg = STMConfig(K=3, model_type="CTM")
    with pytest.raises(ValueError, match="no prevalence regression"):
        _prior_means(None, np.zeros(2), cfg, K=3, N_new=4, X=np.ones((4, 1)))


def test_theta_server_warmup_no_intercept_fit(tmp_path, toy_corpus,
                                              toy_dictionary, toy_metadata):
    """Regression: warmup always built a (P-1)-column X, which
    _prior_means correctly rejects for fit_intercept=False models —
    warmup crashed on every no-intercept fit."""
    from strutopy_tpu.models.serving import ThetaServer

    from strutopy_tpu.models.config import STMConfig

    train = toy_corpus.train_docs
    cfg = STMConfig(K=3, max_em_iter=2, init_type="random",
                    model_type="STM", fit_intercept=False)
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], config=cfg,
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    srv = ThetaServer(str(tmp_path))
    srv.warmup(n_docs=1, doc_len=8)  # must not raise


def test_serving_eta_mean_excludes_empty_docs(tmp_path, toy_corpus,
                                              toy_dictionary):
    """Regression: artifact serving averaged eta over ALL saved rows —
    empty (doc_ok=False) docs have eta frozen at exactly 0, shrinking
    the CTM prior mean vs STM.transform's real-docs-only mean."""
    from strutopy_tpu.models.serving import infer_from_artifacts

    docs = list(toy_corpus.train_docs)
    docs.insert(2, [])
    docs.insert(7, [])  # two empty docs
    model = STM(
        documents=docs, dictionary=toy_dictionary, K=3,
        max_em_iter=3, init_type="random", model_type="CTM",
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    theta_live, eta_live = model.transform(toy_corpus.test_docs)
    theta_art, eta_art = infer_from_artifacts(str(tmp_path),
                                              toy_corpus.test_docs)
    np.testing.assert_array_equal(theta_art, theta_live)
    np.testing.assert_array_equal(eta_art, eta_live)


def test_init_state_has_strong_typed_overflow_counter():
    """Regression: a weak-typed python-int straggler_overflow gave
    iteration 1 a different aval than the int32 array the EM step
    returns, silently forcing a full-graph retrace (a whole new
    compile) on iteration 2 of every fresh fit."""
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.models.state import init_state

    s = init_state(jax.random.PRNGKey(0), K=3, V=16, N=8, P=2)
    assert isinstance(s.straggler_overflow, jax.Array)
    assert s.straggler_overflow.dtype == jnp.int32
    assert not s.straggler_overflow.weak_type

    traces = []

    @jax.jit
    def step(state):
        traces.append(1)
        return state._replace(
            straggler_overflow=jnp.zeros((), jnp.int32),
            bound=state.bound + 1,
        )

    out = step(s)
    out = step(out)  # same avals -> no retrace
    assert len(traces) == 1


def test_summary_and_check_residuals(toy_corpus, toy_dictionary):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from strutopy_tpu.models.stm import STM

    model = STM(
        documents=toy_corpus.documents,
        dictionary=toy_dictionary,
        K=3,
        model_type="CTM",
        init_type="random",
        max_em_iter=2,
        batch_size=16,
    )
    s0 = model.summary(print_summary=False)
    assert "not fitted yet" in s0
    model.expectation_maximization(saving=False)
    s = model.summary(n=3, print_summary=False)
    assert "3 topics" in s and "em_iterations=2" in s
    assert s.count("): ") == 3  # one line per topic
    r = model.check_residuals()
    assert r["dispersion"] > 0 and r["df"] > 0


def test_theta_server_raw_text_requests(tmp_path):
    """End-to-end text serving: build_corpus -> fit -> save -> ThetaServer
    .infer_text on raw strings (align_corpus encoding, OOV report)."""
    from strutopy_tpu.corpus.preprocess import build_corpus
    from strutopy_tpu.models.serving import ThetaServer

    rng = np.random.default_rng(0)
    themes = (["apple", "banana", "cherry", "grape", "melon"],
              ["engine", "wheel", "brake", "clutch", "gearbox"])
    texts = []
    for i in range(40):
        words = rng.choice(themes[i % 2], size=25, replace=True)
        texts.append(" ".join(words))
    bow, vocab = build_corpus(texts, stopwords=None)
    model = STM(documents=bow, dictionary=vocab, K=2, model_type="CTM",
                init_type="spectral", max_em_iter=4, batch_size=8)
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))

    srv = ThetaServer(str(tmp_path))
    theta, eta, report = srv.infer_text(
        ["apple banana cherry xylophone", "engine wheel brake"],
        stopwords=None,
    )
    assert theta.shape == (2, 2)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, atol=1e-5)
    assert report["tokens_dropped"] == 1 and report["oov_types"] == 1
    # the two requests must land on OPPOSITE topics
    assert np.argmax(theta[0]) != np.argmax(theta[1])
    # matches the pre-encoded path exactly
    theta2, _ = srv.infer(report["bow"])
    np.testing.assert_array_equal(theta, theta2)


def test_theta_server_infer_text_requires_vocab(tmp_path, toy_corpus,
                                                toy_dictionary):
    from strutopy_tpu.models.serving import ThetaServer

    model = STM(documents=toy_corpus.train_docs, dictionary=toy_dictionary,
                K=3, model_type="CTM", init_type="random", max_em_iter=2)
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    (tmp_path / "vocab.json").unlink()  # reference-style artifact dir
    import pytest

    srv = ThetaServer(str(tmp_path))
    with pytest.raises(ValueError, match="vocab.json"):
        srv.infer_text(["some text"])


def test_infer_theta_mesh_matches_single_device(toy_corpus, toy_dictionary,
                                                toy_metadata):
    """Bulk serving under a 1-D document mesh: same theta/eta as the
    single-device path (virtual 8-CPU mesh); 2-D vocab-sharded serving
    (guard lifted round 4, gate E2) matches too."""
    from strutopy_tpu.models.serving import infer_theta
    from strutopy_tpu.parallel.mesh import make_mesh, make_mesh_2d

    train = toy_corpus.train_docs
    model = STM(
        documents=train, dictionary=toy_dictionary, K=3,
        X=toy_metadata[: len(train)], max_em_iter=2,
        init_type="random", model_type="STM",
    )
    model.expectation_maximization(saving=False)

    test_docs = toy_corpus.test_docs
    beta = model.beta.astype(np.float32)
    sigma = model.sigma.astype(np.float32)
    gamma = np.asarray(model.gamma, np.float64)
    D = np.c_[np.ones(len(test_docs)),
              np.asarray(toy_metadata[len(train): len(train) + len(test_docs)])]
    mu = (D @ gamma.T).astype(np.float32)

    theta_1, eta_1 = infer_theta(beta, sigma, mu, test_docs, model.config)
    theta_m, eta_m = infer_theta(beta, sigma, mu, test_docs, model.config,
                                 mesh=make_mesh(4))
    # bucket padding may differ (mesh-divisible plan), so chunk
    # boundaries shift: same documents, float-level tolerance
    np.testing.assert_allclose(theta_m, theta_1, atol=1e-5)
    np.testing.assert_allclose(eta_m, eta_1, atol=1e-4)

    # round 4 lifted the vocab-sharded guard (gate E2): 2-D serving now
    # runs and must match the single-device path (full parity coverage
    # in tests/test_vocab_sharding.py::test_serving_2d_mesh)
    theta_2d, eta_2d = infer_theta(beta, sigma, mu, test_docs, model.config,
                                   mesh=make_mesh_2d(2, 2))
    np.testing.assert_allclose(theta_2d, theta_1, atol=1e-5)
    np.testing.assert_allclose(eta_2d, eta_1, atol=1e-4)


def test_infer_theta_mesh_multibucket_matches_single_device():
    """Regression for the multichip-gate-E bug: with a MULTI-bucket plan
    and n_devices>1, the mesh serving path runs under jit (global,
    bucket-major output), while plan.storage_index describes the
    shard_map training path's device-major layout — de-permuting with
    the wrong index silently permuted documents past the first device's
    bucket-0 chunk."""
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.serving import infer_theta
    from strutopy_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(7)
    V = 320
    docs = []
    for _ in range(24):  # short docs -> the L=128 bucket
        ids = rng.choice(120, 10, replace=False)
        docs.append([(int(i), int(rng.integers(1, 4))) for i in sorted(ids)])
    for _ in range(24):  # >128 unique terms -> the L=256 bucket
        ids = rng.choice(V, 140, replace=False)
        docs.append([(int(i), int(rng.integers(1, 3))) for i in sorted(ids)])
    # interleave lengths so user order != bucket order
    order = rng.permutation(len(docs))
    docs = [docs[i] for i in order]

    K = 4
    beta = rng.dirichlet(np.ones(V) * 0.1, size=K).astype(np.float32)
    beta = beta[None]  # (A=1, K, V)
    sigma = (np.eye(K - 1) * 0.4).astype(np.float32)
    mu = rng.normal(0, 0.3, (len(docs), K - 1)).astype(np.float32)
    cfg = STMConfig(K=K, model_type="STM", init_type="random", batch_size=8)

    theta_1, eta_1 = infer_theta(beta, sigma, mu, docs, cfg)
    theta_m, eta_m = infer_theta(beta, sigma, mu, docs, cfg,
                                 mesh=make_mesh(4))
    np.testing.assert_allclose(theta_m, theta_1, atol=1e-5)
    np.testing.assert_allclose(eta_m, eta_1, atol=1e-4)


def test_encode_new_covariates_unit():
    """encode_new_covariates mirrors build_design's one-hot decision
    (ops/mstep.py::build_design, reference stm.py:657-671): categorical
    training X -> new raw values one-hot against the TRAINING levels;
    binary/multi-column X was never encoded -> None (pass-through)."""
    import pytest

    from strutopy_tpu.ops.mstep import encode_new_covariates

    ok = np.ones(6, bool)
    cat = np.asarray([1.0, 2.0, 3.0, 1.0, 2.0, 3.0])[:, None]
    # raw new values -> one-hot in TRAINING level order, even when the
    # new batch is missing a level
    enc = encode_new_covariates(np.asarray([3.0, 1.0]), cat, ok)
    np.testing.assert_array_equal(enc, [[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    # already-encoded one-hot passes through unchanged
    eye = np.eye(3)[[0, 2]]
    np.testing.assert_array_equal(encode_new_covariates(eye, cat, ok), eye)
    # binary / multi-column / absent training X was never encoded
    assert encode_new_covariates(
        np.asarray([1.0]), np.asarray([0.0, 1.0, 1.0]), np.ones(3, bool)
    ) is None
    assert encode_new_covariates(np.ones((2, 2)), np.ones((6, 2)), ok) is None
    assert encode_new_covariates(np.ones(2), None, ok) is None
    # unseen level / wrong arity are errors, not silent misalignment
    with pytest.raises(ValueError, match="not among the training"):
        encode_new_covariates(np.asarray([7.0]), cat, ok)
    with pytest.raises(ValueError, match="1-column categorical"):
        encode_new_covariates(np.ones((2, 2)), cat, ok)
    # level inference skips doc_ok=False rows (zero-filled padding)
    padded = np.r_[cat[:, 0], 0.0][:, None]
    ok7 = np.r_[np.ones(6, bool), np.zeros(1, bool)]
    enc = encode_new_covariates(np.asarray([2.0]), padded, ok7)
    np.testing.assert_array_equal(enc, [[0.0, 1.0, 0.0]])


def test_transform_raw_categorical_covariate(toy_corpus, toy_dictionary):
    """Regression: a model fit on a RAW 1-D categorical covariate
    (one-hot encoded internally by build_design) must accept raw values
    at transform time, with gamma's columns aligned to the TRAINING
    levels — inferring levels from the new batch alone would shift every
    later column whenever a level is absent from it."""
    import pytest

    train = toy_corpus.train_docs
    levels = np.asarray([2.0, 5.0, 9.0])
    x = levels[np.arange(len(train)) % 3]
    model = STM(documents=train, dictionary=toy_dictionary, K=3, X=x,
                max_em_iter=3, init_type="random", model_type="STM")
    model.expectation_maximization(saving=False)
    assert model.gamma.shape[1] == 4  # intercept + 3 level columns

    test_docs = toy_corpus.test_docs
    # new batch MISSING level 2.0
    x_new = np.asarray([5.0, 9.0])[np.arange(len(test_docs)) % 2]
    theta_raw, _ = model.transform(test_docs, X=x_new)
    onehot = (x_new[:, None] == levels[None, :]).astype(np.float64)
    theta_enc, _ = model.transform(test_docs, X=onehot)
    np.testing.assert_allclose(theta_raw, theta_enc, atol=1e-6)
    with pytest.raises(ValueError, match="not among the training"):
        model.transform(test_docs, X=np.full(len(test_docs), 7.0))


def test_serving_raw_categorical_covariate(tmp_path, toy_corpus,
                                           toy_dictionary):
    """infer_from_artifacts re-encodes raw categorical X with the
    training levels recovered from the saved X.npy artifact."""
    from strutopy_tpu.models.serving import infer_from_artifacts

    train = toy_corpus.train_docs
    levels = np.asarray([2.0, 5.0, 9.0])
    x = levels[np.arange(len(train)) % 3]
    model = STM(documents=train, dictionary=toy_dictionary, K=3, X=x,
                max_em_iter=3, init_type="random", model_type="STM")
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))

    test_docs = toy_corpus.test_docs
    x_new = np.asarray([5.0, 9.0])[np.arange(len(test_docs)) % 2]
    theta_live, _ = model.transform(test_docs, X=x_new)
    theta_art, _ = infer_from_artifacts(str(tmp_path), test_docs, X=x_new)
    np.testing.assert_allclose(theta_art, theta_live, atol=2e-3)


def test_stm_init_beta_injection(toy_corpus, toy_dictionary):
    """Explicit init_beta overrides init_type and reproduces the fit a
    model would produce from that init (shared-init completion
    protocols, warm starts — results_spectral_alignment.json)."""
    import pytest

    train = toy_corpus.train_docs
    V = len(toy_dictionary)
    K = 3
    rng = np.random.default_rng(5)
    g = rng.gamma(0.1, 1.0, (K, V))
    beta0 = g / g.sum(axis=1, keepdims=True)

    kw = dict(documents=train, dictionary=toy_dictionary, K=K,
              max_em_iter=2, model_type="CTM", seed=7)
    m1 = STM(init_beta=beta0, **kw)
    m1.expectation_maximization(saving=False)
    # un-normalized input is normalized per row, not rejected
    m2 = STM(init_beta=beta0 * 3.0, **kw)
    m2.expectation_maximization(saving=False)
    np.testing.assert_array_equal(np.asarray(m1.beta), np.asarray(m2.beta))
    # differs from the random-init fit (the injection actually took)
    m3 = STM(init_type="random", **kw)
    m3.expectation_maximization(saving=False)
    assert np.abs(np.asarray(m1.beta) - np.asarray(m3.beta)).max() > 1e-6

    with pytest.raises(ValueError, match="shape"):
        STM(init_beta=beta0[:, :-1], **kw)
    bad = beta0.copy()
    bad[0] = 0.0
    with pytest.raises(ValueError, match="all-zero"):
        STM(init_beta=bad, **kw)
    bad = beta0.copy()
    bad[0, 0] = -1.0
    with pytest.raises(ValueError, match="finite"):
        STM(init_beta=bad, **kw)
