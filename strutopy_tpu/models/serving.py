"""Standalone serving: theta inference from saved model artifacts.

Production path the reference lacks entirely: load a fitted model's
artifact directory (the reference-compatible ``*_hat.npy`` set written
by ``STM.save_model``) and infer topic proportions for new documents
with one batched E-step — no refit, no STM instance, no training
corpus.

    theta, eta = infer_from_artifacts("artifacts/fit", new_docs, X=X_new)
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


_SHARDED_ESTEP = None
_SHARDED_2D_STEPS: dict = {}


def _sharded_2d_step(mesh, cfg, bucket_batches, n_buckets: int, content: bool):
    """shard_map serving step for a 2-D (docs x vocab) mesh.

    Mirrors training's ``make_sharded_em_step`` (parallel/sharding.py):
    beta shards its vocab axis, corpus/per-doc arrays shard documents,
    and the E-step assembles per-chunk beta_doc blocks with one
    vocab-axis psum (ops/estep.py::_gather_beta).  Per-document outputs
    are bit-identical across vocab shards (each shard psums the same
    partial products), so the doc-axis out_specs are sound.  Cached per
    (mesh, cfg, shapes) so repeat requests reuse the compiled step."""
    key = (mesh, cfg, bucket_batches, n_buckets, content)
    step = _SHARDED_2D_STEPS.get(key)
    if step is None:
        # bound the cache: long-lived serving processes that vary
        # batch/bucket shapes or meshes would otherwise accumulate
        # compiled executables and pin mesh objects forever (ADVICE r4).
        # FIFO eviction; 16 shape classes cover any sane request mix.
        while len(_SHARDED_2D_STEPS) >= 16:
            _SHARDED_2D_STEPS.pop(next(iter(_SHARDED_2D_STEPS)))
        import jax
        from jax.sharding import PartitionSpec as P

        from strutopy_tpu.models.em import local_estep_stats
        from strutopy_tpu.parallel.mesh import DOC_AXIS, VOCAB_AXIS
        from strutopy_tpu.parallel.sharding import _data_specs, _state_specs

        def _local(state, data):
            _stats, eta, theta, _iters = local_estep_stats(
                state, data, cfg, bucket_batches, vocab_axis=VOCAB_AXIS
            )
            return eta, theta

        step = jax.jit(
            jax.shard_map(
                _local,
                mesh=mesh,
                in_specs=(_state_specs(content, True), _data_specs(n_buckets)),
                out_specs=(P(DOC_AXIS), P(DOC_AXIS)),
                check_vma=False,
            )
        )
        _SHARDED_2D_STEPS[key] = step
    return step


def _sharded_estep():
    """Lazily-built module-level jit of ``local_estep_stats`` for the
    mesh serving path (cfg and bucket batch sizes static).  One shared
    jitted callable means repeated ``infer_theta(mesh=...)`` calls at
    identical shapes reuse the compiled executable instead of paying a
    fresh trace (and, without the persistent XLA cache, a fresh
    compile) per call."""
    global _SHARDED_ESTEP
    if _SHARDED_ESTEP is None:
        import jax

        from strutopy_tpu.models.em import local_estep_stats

        _SHARDED_ESTEP = jax.jit(
            local_estep_stats,
            static_argnames=("cfg", "bucket_batches", "vocab_axis"),
        )
    return _SHARDED_ESTEP


def infer_theta(
    beta: np.ndarray,
    sigma: np.ndarray,
    mu_user: np.ndarray,
    documents,
    cfg,
    aspects_user: Optional[np.ndarray] = None,
    full_convergence: bool = True,
    mesh=None,
):
    """One batched E-step under fixed (beta, sigma) with per-doc prior
    means ``mu_user`` -> (theta, eta) in document order.

    ``full_convergence=True`` (default) guarantees every document its
    full Newton budget (the two-pass schedule with an uncapped
    straggler admission); ``False`` keeps the training config's capped
    budget — faster cold bulk scoring, but hard documents beyond the
    pass-2 cap return their pass-1 eta.

    ``mesh`` (a 1-D document mesh from ``parallel.mesh.make_mesh``, or
    a 2-D docs x vocab mesh from ``make_mesh_2d``) shards the batch
    over the document axis for bulk scoring.  Under a 1-D mesh
    beta/sigma replicate and the jitted E-step runs as pure data
    parallelism (per-document Newton is independent, so no collectives
    are semantically required).  Under a 2-D mesh beta additionally
    shards its VOCAB axis — the serving configuration for models too
    large to replicate per chip — and the E-step runs under shard_map
    exactly as training does, assembling per-chunk beta_doc blocks
    with one vocab-axis psum (ops/estep.py::_gather_beta).  Parity of
    both paths with the single-device path is tested on the virtual
    CPU mesh (tests/test_vocab_sharding.py, multichip gate E)."""
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.corpus.bow import PaddedCorpus, pad_corpus
    from strutopy_tpu.corpus.bucketing import (
        gather_per_bucket,
        make_bucket_plan,
        split_corpus_by_plan,
    )
    from strutopy_tpu.models.em import CorpusData, local_estep_stats
    from strutopy_tpu.models.state import STMState

    n_dev = 1
    n_vocab = 1
    if mesh is not None:
        from strutopy_tpu.parallel.mesh import DOC_AXIS, VOCAB_AXIS

        if VOCAB_AXIS in mesh.axis_names:
            n_vocab = int(mesh.shape[VOCAB_AXIS])
        n_dev = int(mesh.shape[DOC_AXIS])

    V = beta.shape[-1]
    if full_convergence and getattr(cfg, "newton_pass1_iters", 0):
        # The training schedule's straggler BUDGET (frac*N) is a
        # throughput trade: docs beyond it keep their pass-1 eta, which
        # EM's warm starts absorb over iterations — but a one-shot
        # inference starts cold at mu, so capped docs would silently
        # return under-converged.  frac=1.0 admits every unconverged
        # doc to pass 2 (full remaining budget, no overflow possible)
        # while keeping the schedule's dense packing: converged docs
        # still drop out after pass 1, so this is cheaper than
        # disabling the schedule outright.
        cfg = cfg.replace(newton_straggler_frac=1.0)
    if isinstance(documents, PaddedCorpus):
        corpus = documents
    else:
        corpus = pad_corpus(documents, V=V)
    live = (corpus.counts > 0) & corpus.doc_ok[:, None]
    max_id = int(corpus.words[live].max()) if live.any() else -1
    if max_id >= V:
        raise ValueError(
            f"documents contain word id {max_id} but the model vocabulary "
            f"has only {V} terms — were they encoded with a different "
            "vocabulary? (a silent gather-clamp would produce wrong theta)"
        )
    if corpus.V != V:
        corpus = PaddedCorpus(corpus.words, corpus.counts, corpus.doc_ok, V)
    N_new = corpus.N
    K = beta.shape[-2]

    if n_vocab > 1 and V % n_vocab:
        raise ValueError(
            f"model vocabulary V={V} is not divisible by the "
            f"{n_vocab}-way vocab mesh axis; pad the vocabulary "
            "(PaddedCorpus(..., V=...)) to a multiple, as the training "
            "fit did"
        )

    plan = make_bucket_plan(
        corpus, cfg.batch_size, n_devices=n_dev,
        max_buckets=cfg.max_buckets if cfg.auto_bucket else 1,
    )
    buckets = split_corpus_by_plan(corpus, plan)
    N_pad = plan.n_storage

    mu_user32 = np.asarray(mu_user, np.float32)
    if n_vocab > 1:
        # shard_map path: per-doc state lives in DEVICE-major/
        # bucket-minor storage order (the training layout), so each
        # device's doc shard aligns with its per-bucket corpus slices
        mu_storage = np.zeros((N_pad, mu_user32.shape[1]), np.float32)
        mu_storage[plan.storage_index] = mu_user32
    else:
        # eager / jit-global path: bucket-major front-packed
        mu_storage = np.concatenate(
            gather_per_bucket(mu_user32, plan), axis=0
        )

    if aspects_user is None:
        aspects_user = np.zeros(N_new, np.int32)
    aspect_buckets = gather_per_bucket(np.asarray(aspects_user, np.int32), plan)

    data = CorpusData(
        words=tuple(jnp.asarray(b.words) for b in buckets),
        counts=tuple(jnp.asarray(b.counts) for b in buckets),
        aspects=tuple(jnp.asarray(a) for a in aspect_buckets),
        doc_ok=tuple(jnp.asarray(b.doc_ok) for b in buckets),
        D=tuple(jnp.zeros((b.N, 1), jnp.float32) for b in buckets),
    )
    state = STMState(
        beta=jnp.asarray(beta, jnp.float32),
        mu=jnp.asarray(mu_storage),
        sigma=jnp.asarray(sigma, jnp.float32),
        eta=jnp.asarray(mu_storage),  # warm start at the prior mean
        theta=jnp.zeros((N_pad, K), jnp.float32),
        gamma=jnp.zeros((K - 1, 1), jnp.float32),
        kappa=jnp.zeros((0, V), jnp.float32),
        bound=jnp.asarray(0.0, jnp.float32),
        opt_iters=jnp.zeros((N_pad,), jnp.int32),
        straggler_overflow=jnp.zeros((), jnp.int32),
    )
    if mesh is not None and n_vocab > 1:
        from strutopy_tpu.parallel.sharding import shard_corpus, shard_state

        data = shard_corpus(mesh, data)
        state = shard_state(mesh, state, content=beta.ndim == 3)
        eta, theta = _sharded_2d_step(
            mesh, cfg, tuple(plan.batch_sizes), plan.n_buckets,
            beta.ndim == 3,
        )(state, data)
        # device-major storage order: storage_index maps user doc i to
        # its row directly (same de-permutation as STM.theta)
        return (
            np.asarray(theta)[plan.storage_index],
            np.asarray(eta)[plan.storage_index],
        )
    if mesh is not None:
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P

        from strutopy_tpu.parallel.mesh import DOC_AXIS

        def put(x, *spec):
            return jax.device_put(x, NamedSharding(mesh, P(*spec)))

        data = CorpusData(
            words=tuple(put(w, DOC_AXIS, None) for w in data.words),
            counts=tuple(put(c, DOC_AXIS, None) for c in data.counts),
            aspects=tuple(put(a, DOC_AXIS) for a in data.aspects),
            doc_ok=tuple(put(o, DOC_AXIS) for o in data.doc_ok),
            D=tuple(put(d, DOC_AXIS, None) for d in data.D),
        )
        state = STMState(
            beta=put(state.beta),
            mu=put(state.mu, DOC_AXIS, None),
            sigma=put(state.sigma),
            eta=put(state.eta, DOC_AXIS, None),
            theta=put(state.theta, DOC_AXIS, None),
            gamma=put(state.gamma),
            kappa=put(state.kappa),
            bound=put(state.bound),
            opt_iters=put(state.opt_iters, DOC_AXIS),
            straggler_overflow=put(state.straggler_overflow),
        )
        # jit so XLA partitions the whole E-step over the sharded
        # inputs (the eager path below runs each primitive unsharded);
        # module-level jit of local_estep_stats itself (cfg/batch sizes
        # static) so repeat calls at the same shapes hit the trace
        # cache — a fresh lambda per call would re-trace every time
        _stats, eta, theta, _iters = _sharded_estep()(
            state, data, cfg=cfg, bucket_batches=tuple(plan.batch_sizes)
        )
    else:
        _stats, eta, theta, _iters = local_estep_stats(
            state, data, cfg, plan.batch_sizes
        )
    # local_estep_stats concatenates per-bucket outputs, so under BOTH
    # paths used here (eager, and jit-with-NamedSharding global
    # semantics) theta/eta come back bucket-major with docs front-packed
    # per bucket — matching the gather_per_bucket inputs above.
    # plan.storage_index is the DEVICE-major layout of the shard_map
    # training path; it coincides with bucket-major packing only for
    # n_devices == 1 or a single bucket, so indexing with it under a
    # mesh silently permuted documents (caught by multichip gate E).
    offs = np.cumsum([0] + list(plan.sizes))
    idx = np.empty(N_new, np.int64)
    for off, ids in zip(offs[:-1], plan.doc_ids):
        idx[ids] = off + np.arange(len(ids))
    return np.asarray(theta)[idx], np.asarray(eta)[idx]


def _load_params(model_dir: str):
    """Load ``*_hat.npy`` artifacts + config -> (beta, sigma, gamma,
    eta_mean, cfg, train).  ``gamma``/``eta_mean`` may be None.

    ``train`` is ``(X_train, ok_train)`` (or None) — the saved raw
    covariates plus the empty-doc proxy mask, so the prior construction
    can re-encode a categorical covariate with the TRAINING levels."""
    from strutopy_tpu.corpus.io import load_model_artifacts
    from strutopy_tpu.models.config import STMConfig

    art = load_model_artifacts(model_dir)
    if "beta" not in art or "sigma" not in art:
        raise FileNotFoundError(
            f"{model_dir} does not contain beta_hat.npy/sigma_hat.npy — "
            "is it a model artifact directory written by save_model?"
        )
    cfg_path = os.path.join(model_dir, "stm_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            raw = f.read()
        try:
            cfg = STMConfig.from_json(raw)
        except TypeError:
            # foreign config (e.g. the reference's): fall back to shape-derived
            cfg = STMConfig(K=art["beta"].shape[-2])
    else:
        cfg = STMConfig(K=art["beta"].shape[-2])

    beta = np.asarray(art["beta"], np.float32)
    sigma = np.asarray(art["sigma"], np.float32)
    eta = art.get("eta")
    if eta is None:
        eta_mean = None
    else:
        eta = np.asarray(eta)
        # exclude empty (doc_ok=False) documents: the masked E-step
        # leaves their eta frozen at exactly 0, and STM.transform's CTM
        # prior mean averages over REAL docs only (models/stm.py) —
        # artifacts don't record doc_ok, but an exactly-all-zero row
        # identifies one (a real converged eta is never exactly 0 in
        # every coordinate)
        real = ~(eta == 0.0).all(axis=1)
        eta_mean = eta[real].mean(axis=0) if real.any() else eta.mean(axis=0)
    train = None
    X_train = art.get("X")
    if X_train is not None:
        ok = (real if eta is not None and len(eta) == len(X_train)
              else np.ones(len(X_train), bool))
        train = (np.asarray(X_train, np.float64), ok)
    return beta, sigma, art.get("gamma"), eta_mean, cfg, train


def _prior_means(gamma, eta_mean, cfg, K: int, N_new: int, X,
                 train=None) -> np.ndarray:
    """Per-document prior means mu (N_new, K-1) from the fitted prevalence
    model (or its fallbacks), matching STM.transform's semantics.

    ``train=(X_train, ok_train)`` (from ``_load_params``) re-encodes a
    1-D categorical covariate with the training levels, as
    STM.transform does."""
    if X is not None and gamma is None:
        raise ValueError(
            "X was passed but the model has no prevalence regression "
            "(no gamma_hat in the artifacts — a CTM or covariate-free "
            "fit); its theta priors come from the fitted eta mean, so X "
            "cannot be used"
        )
    if gamma is not None and X is not None:
        Xa = np.asarray(X, np.float64)
        if Xa.ndim == 1:
            Xa = Xa[:, None]
        if train is not None:
            from strutopy_tpu.ops.mstep import encode_new_covariates

            enc = encode_new_covariates(Xa, train[0], train[1])
            if enc is not None:
                Xa = enc
        P = gamma.shape[1]
        # dispatch on the fitted config, not a column-count guess: with
        # fit_intercept=False a (P-1)-column X is an ERROR, and silently
        # prepending an intercept would misalign every gamma column
        if cfg.fit_intercept and Xa.shape[1] == P - 1:
            D = np.c_[np.ones(N_new), Xa]
        elif Xa.shape[1] == P:
            # no-intercept fit, or the caller already included the
            # intercept column — for an intercept-included fit the
            # first column MUST then be the constant 1, or gamma's
            # intercept coefficient would be scaled by covariate values
            # (silently garbage theta for e.g. an intercept-only model
            # handed a 1-column covariate X)
            if cfg.fit_intercept and not np.allclose(Xa[:, 0], 1.0):
                raise ValueError(
                    f"X has {Xa.shape[1]} column(s), matching the full "
                    f"{P}-column design of an intercept-included fit, but "
                    "its first column is not the constant 1 — pass X "
                    "WITHOUT the intercept column (it is prepended here)"
                )
            D = Xa
        else:
            raise ValueError(
                f"X has {Xa.shape[1]} column(s) but gamma_hat expects a "
                f"{P}-column design; if the model was fit with a "
                "categorical covariate, pass the SAME one-hot encoding "
                "used at training (build_design one-hot encodes 1-D "
                "non-binary covariates)"
            )
        mu_user = D @ np.asarray(gamma, np.float64).T
    elif gamma is not None and gamma.shape[1] == 1 and cfg.fit_intercept:
        # intercept-only prevalence (STM fit without covariates)
        mu_user = np.tile(np.asarray(gamma, np.float64)[:, 0], (N_new, 1))
    elif gamma is not None and np.abs(gamma).sum() > 0:
        raise ValueError(
            "the model was fit with prevalence covariates (gamma_hat "
            "present); pass X for the new documents"
        )
    elif eta_mean is not None:
        mu_user = np.tile(eta_mean, (N_new, 1))
    else:
        mu_user = np.zeros((N_new, K - 1))
    return mu_user.astype(np.float32)


def _n_docs(documents) -> int:
    if isinstance(documents, (list, tuple)):
        return len(documents)
    return documents.N


def infer_from_artifacts(
    model_dir: str,
    documents,
    X=None,
    beta_index=None,
):
    """Load ``*_hat.npy`` artifacts + config and infer theta for new docs."""
    beta, sigma, gamma, eta_mean, cfg, train = _load_params(model_dir)
    K = beta.shape[-2]
    if beta.ndim == 3 and beta_index is None:
        raise ValueError(
            "this is a content-covariate model (per-aspect beta); pass "
            "beta_index for the new documents"
        )
    mu_user = _prior_means(gamma, eta_mean, cfg, K, _n_docs(documents), X,
                           train=train)
    return infer_theta(beta, sigma, mu_user, documents, cfg,
                       aspects_user=beta_index)


class ThetaServer:
    """Persistent serving handle: load artifacts ONCE, keep beta/sigma
    device-resident, and serve theta per request.

    ``infer_from_artifacts`` re-reads the artifact directory and re-uploads
    beta (K*V floats — 4 MB at K=100/V=10k) on every call; in the
    steady-state serving regime that transfer dominates small-batch
    latency.  ``ThetaServer`` pays the load + device transfer once::

        srv = ThetaServer("artifacts/fit")
        srv.warmup()                      # compile the serving shapes
        theta, eta = srv.infer(docs, X=X)

    The first request at a NEW (bucket length, batch) shape compiles;
    ``warmup`` pre-compiles the shape a given request size maps to.
    """

    def __init__(self, model_dir: str):
        import json

        import jax.numpy as jnp

        beta, sigma, gamma, eta_mean, cfg, train = _load_params(model_dir)
        self.cfg = cfg
        self.K = beta.shape[-2]
        self.V = beta.shape[-1]
        self.content = beta.ndim == 3
        self._gamma = gamma
        self._eta_mean = eta_mean
        self._train = train
        # vocabulary (saved by save_model beyond the reference artifact
        # set) enables raw-text requests; absent in reference-produced
        # artifact dirs, where only pre-encoded BoW can be served
        self.vocab = None
        vocab_path = os.path.join(model_dir, "vocab.json")
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                self.vocab = json.load(f)
        # Device-resident parameters: uploaded once, reused every call
        # (infer_theta's jnp.asarray is then a no-op).
        self._beta = jnp.asarray(beta, jnp.float32)
        self._sigma = jnp.asarray(sigma, jnp.float32)

    def infer(self, documents, X=None, beta_index=None,
              full_convergence: bool = True):
        """(theta, eta) for new documents, in document order.

        ``full_convergence=False`` trades guaranteed per-doc convergence
        for the training schedule's lower latency (see infer_theta)."""
        if self.content and beta_index is None:
            raise ValueError(
                "this is a content-covariate model (per-aspect beta); pass "
                "beta_index for the new documents"
            )
        mu_user = _prior_means(self._gamma, self._eta_mean, self.cfg, self.K,
                               _n_docs(documents), X, train=self._train)
        return infer_theta(self._beta, self._sigma, mu_user, documents,
                           self.cfg, aspects_user=beta_index,
                           full_convergence=full_convergence)

    def infer_text(self, texts, X=None, beta_index=None,
                   full_convergence: bool = True, stopwords="default"):
        """(theta, eta, report) for RAW TEXT requests: tokenizes and
        encodes against the model's saved vocabulary (align_corpus),
        then infers.  ``report`` is align_corpus's OOV loss summary
        plus the encoded BoW under ``"bow"``."""
        if self.vocab is None:
            raise ValueError(
                "this artifact directory has no vocab.json (written by "
                "save_model); re-save the model or pass pre-encoded BoW "
                "documents to infer()"
            )
        from strutopy_tpu.corpus.preprocess import DEFAULT_STOPWORDS, align_corpus

        if stopwords == "default":
            stopwords = DEFAULT_STOPWORDS
        bow, report = align_corpus(texts, self.vocab, stopwords=stopwords)
        theta, eta = self.infer(bow, X=X, beta_index=beta_index,
                                full_convergence=full_convergence)
        report = dict(report, bow=bow)
        return theta, eta, report

    def warmup(self, n_docs: int = 1, doc_len: int = 64) -> None:
        """Compile the serving path for the shape a ``n_docs``-request with
        ``doc_len`` distinct terms maps to (no-op if already compiled)."""
        rng = np.random.default_rng(0)
        docs = [
            [(int(w), 1) for w in rng.choice(self.V, size=min(doc_len, self.V),
                                             replace=False)]
            for _ in range(n_docs)
        ]
        if self._gamma is None:
            X = None
        else:
            P = self._gamma.shape[1]
            if self.cfg.fit_intercept:
                # intercept prepended by _prior_means -> P-1 covariate
                # columns (intercept-only fits take no X at all)
                X = None if P <= 1 else np.zeros((n_docs, P - 1))
            else:
                # no-intercept fit: the design IS the covariates
                X = np.zeros((n_docs, P))
        aspects = np.zeros(n_docs, np.int32) if self.content else None
        self.infer(docs, X=X, beta_index=aspects)
