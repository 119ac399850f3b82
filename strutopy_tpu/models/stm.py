"""The user-facing STM estimator.

API mirrors the reference ``STM`` class (src/modules/stm.py:311-399 and
its post-fit methods) so reference users can switch 1:1, while the
execution engine is the jitted/sharded EM step of
strutopy_tpu/models/em.py.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from strutopy_tpu.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus
from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.em import CorpusData, make_em_step
from strutopy_tpu.models.state import init_state
from strutopy_tpu.ops import mstep
from strutopy_tpu.ops.spectral import spectral_init
from strutopy_tpu.eval import diagnostics

logger = logging.getLogger(__name__)


class STM:
    """Structural Topic Model, fitted by batched variational EM in JAX.

    Reference-compatible construction (src/modules/stm.py:311-329)::

        model = STM(documents, dictionary, content=False, K=10, X=meta,
                    kappa_interactions=False, max_em_iter=25,
                    sigma_prior=0, convergence_threshold=1e-5,
                    init_type="random", model_type="STM", mode="ols")
        model.expectation_maximization(saving=True, output_dir=...)

    ``documents`` may be the reference's BoW list-of-tuples or a
    :class:`PaddedCorpus`.  Pass ``mesh`` (a 1-D ``jax.sharding.Mesh``)
    to shard documents across devices.  ``init_beta`` injects an
    explicit (K, V) initialization (overrides ``init_type``; warm
    starts and shared-init protocols — docs/TUNING.md); advanced knobs
    (``likelihood_temper``, ``kappa_ftol_rel``, Newton schedule, …)
    live on :class:`STMConfig` via ``config=``.
    """

    def __init__(
        self,
        documents,
        dictionary=None,
        content: bool = False,
        K: int = 10,
        X=None,
        kappa_interactions: bool = False,
        max_em_iter: int = 100,
        sigma_prior: float = 0.0,
        convergence_threshold: float = 1e-5,
        lda_beta: bool = True,
        beta_index=None,
        A: Optional[int] = None,
        dtype=np.float32,
        init_type: str = "spectral",
        model_type: str = "STM",
        mode: str = "ols",
        config: Optional[STMConfig] = None,
        mesh=None,
        batch_size: Optional[int] = None,
        seed: int = 123456,
        beta_smoothing: float = 0.0,
        stream_parts: int = 0,
        init_beta=None,
    ):
        if config is not None and seed != 123456 and config.seed != seed:
            # the explicit config wins over every kwarg; a conflicting
            # seed is the one silent override that corrupts experiments
            # (a "seed sweep" that fits the same model repeatedly), so
            # fail loudly instead of ignoring it
            raise ValueError(
                f"seed={seed} conflicts with config.seed={config.seed}: "
                "an explicit STMConfig overrides the seed kwarg — use "
                "config.replace(seed=...) instead"
            )
        if config is None:
            config = STMConfig(
                K=K,
                content=content,
                A=A if A is not None else (2 if content else 1),
                kappa_interactions=kappa_interactions,
                lda_beta=lda_beta and not content,
                model_type=model_type,
                mode=mode,
                max_em_iter=max_em_iter,
                convergence_threshold=convergence_threshold,
                sigma_prior=sigma_prior,
                init_type=init_type,
                seed=seed,
                beta_smoothing=beta_smoothing,
                # two-pass straggler schedule by default for real fits
                # (bound parity with single-pass ~1e-7): pass 1 caps
                # every chunk's Newton budget, stragglers regroup densely.
                # Short fits skip it (the extra compiled graph pair is
                # not worth <10 iterations).  Pass config=STMConfig(...)
                # for full control, incl. newton_pass1_iters=0.
                newton_pass1_iters=6 if max_em_iter >= 10 else 0,
                newton_straggler_frac=0.25,
            )
        if batch_size is not None:
            config = config.replace(batch_size=batch_size)
        self.config = config
        self.mesh = mesh

        # ----- corpus -----
        if isinstance(documents, PaddedCorpus):
            corpus = documents
        else:
            corpus = pad_corpus(documents, V=len(dictionary) if dictionary is not None else None)
        if dictionary is None:
            dictionary = Vocabulary.from_corpus(corpus)
        self.dictionary = dictionary
        self.V = max(corpus.V, len(dictionary))
        if corpus.V < self.V:
            corpus = PaddedCorpus(corpus.words, corpus.counts, corpus.doc_ok, self.V)
        self._corpus = corpus
        self.N = corpus.n_docs
        self.K = config.K
        self.A = config.A

        # ----- length bucketing + padding plan -----
        from strutopy_tpu.corpus.bucketing import (
            gather_per_bucket,
            make_bucket_plan,
            split_corpus_by_plan,
        )

        if corpus.n_docs == 0:
            raise ValueError(
                "corpus contains no non-empty documents; nothing to fit"
            )
        self._stream_parts = int(stream_parts or 0)
        if self._stream_parts > 1:
            # out-of-core path (models/streaming.py): the corpus stays
            # in host RAM, one part at a time moves to the device(s).
            # With a mesh, every part is document-sharded over it (each
            # device streams its shard of each part); a 2-D (docs,
            # vocab) mesh additionally shards beta/kappa/beta_ss over
            # the vocab axis (streaming.py round-3 extension).
            if mesh is not None:
                from strutopy_tpu.parallel.mesh import DOC_AXIS, VOCAB_AXIS

                if VOCAB_AXIS in mesh.axis_names:
                    nv = mesh.shape[VOCAB_AXIS]
                    if corpus.V % nv:
                        raise ValueError(
                            f"V={corpus.V} is not divisible by the "
                            f"{nv}-way vocab mesh axis; pad the "
                            "vocabulary to a multiple (streamed fits "
                            "shard beta over the vocab axis too)"
                        )
                # bucket sizes must divide evenly into parts AND into
                # each part's document shards (the vocab axis replicates
                # documents, so it does not enter the plan size)
                n_dev = self._stream_parts * mesh.shape[DOC_AXIS]
            else:
                n_dev = self._stream_parts
        elif mesh is None:
            n_dev = 1
        else:
            # bucket sizes must be multiples of the DOC-axis extent (the
            # number of document shards) — NOT the total device count: on
            # a 2-D (docs, vocab) mesh the vocab axis replicates documents,
            # and sizing the plan by devices.size would make P(DOC_AXIS)
            # shards non-bucket-contiguous, silently mispairing eta/mu
            # rows with documents inside shard_map
            from strutopy_tpu.parallel.mesh import DOC_AXIS

            n_dev = mesh.shape[DOC_AXIS]
        # streaming needs equal single-bucket parts (one compiled E-step
        # graph serves every part); bucket padding to a multiple of
        # n_devices*batch gives the part shape for free
        max_buckets = (
            1
            if self._stream_parts > 1 or not config.auto_bucket
            else config.max_buckets
        )
        plan = make_bucket_plan(
            corpus, config.batch_size, n_devices=n_dev, max_buckets=max_buckets
        )
        self._plan = plan
        buckets = split_corpus_by_plan(corpus, plan)
        N_pad = plan.n_storage
        # user doc i lives at storage row plan.storage_index[i]
        self._storage_index = plan.storage_index[: corpus.N]

        # ----- covariates (user order -> per-bucket arrays) -----
        self.X = np.asarray(X) if X is not None else None
        X_user = None
        if self.X is not None:
            Xa = self.X if self.X.ndim > 1 else self.X[:, None]
            if Xa.shape[0] != corpus.N:
                raise ValueError(
                    f"X has {Xa.shape[0]} rows but the corpus has "
                    f"{corpus.N} documents; covariates must cover every "
                    "document (silent zero-fill would produce wrong mu)"
                )
            X_user = Xa.astype(np.float64)

        aspects_user = np.zeros(corpus.N, np.int32)
        if config.content:
            if beta_index is None:
                raise ValueError("content=True requires beta_index (per-doc aspect)")
            bi = np.asarray(beta_index).astype(np.int32).ravel()
            # same guard class as OOV word ids (corpus/bow.py): a short
            # array would silently zero-fill and an out-of-range aspect
            # id would be clamped/dropped by the device gather/scatter,
            # silently corrupting beta_ss and the bound
            if len(bi) != corpus.N:
                raise ValueError(
                    f"beta_index has {len(bi)} entries but the corpus "
                    f"has {corpus.N} documents"
                )
            if bi.size and (bi.min() < 0 or bi.max() >= config.A):
                raise ValueError(
                    f"beta_index values must lie in [0, A={config.A}); "
                    f"got range [{bi.min()}, {bi.max()}]"
                )
            aspects_user[:] = bi
        self.betaindex = aspects_user

        doc_ok_storage = np.concatenate([b.doc_ok for b in buckets])
        if X_user is not None:
            X_buckets = gather_per_bucket(X_user, plan)
            X_storage = np.concatenate(X_buckets, axis=0)
        else:
            X_storage = None
        self._D_np, self._design = mstep.make_prevalence_design(
            X_storage,
            doc_ok_storage,
            fit_intercept=config.fit_intercept,
            ridge_alpha=config.ridge_alpha,
        )
        # per-bucket design rows (bucket-contiguous in storage order)
        D_buckets = np.split(
            self._D_np, np.cumsum([b.N for b in buckets])[:-1], axis=0
        )
        aspect_buckets = gather_per_bucket(aspects_user, plan)

        # the content model needs the covariate design; lda_beta=False
        # without content covariates is the A=1 SAGE topic model
        # (reference stm.py:767-768: covar = I_K)
        self._kappa_design = (
            mstep.build_kappa_design(
                config.K, config.A,
                config.kappa_interactions if config.content else False,
            )
            if (config.content or not config.lda_beta)
            else None
        )
        self._wcounts = corpus.word_counts()

        # ----- init -----
        np_rng = np.random.RandomState(config.seed)
        if init_beta is not None:
            # explicit beta injection: shared-init completion protocols
            # (two fits scored jointly stay topic-aligned when they
            # start from ONE init — worth ~2.4 nats of completion
            # heldout on wiki, results_spectral_alignment.json), warm
            # starts from a prior model, or externally computed inits.
            # The reference has no equivalent (its init is internal to
            # STM.__init__, stm.py:420-434).
            beta_init = np.asarray(init_beta, np.float64)
            if beta_init.shape != (config.K, self.V):
                raise ValueError(
                    f"init_beta has shape {beta_init.shape}, expected "
                    f"(K={config.K}, V={self.V})")
            if not np.all(np.isfinite(beta_init)) or (beta_init < 0).any():
                raise ValueError("init_beta must be finite and >= 0")
            row = beta_init.sum(axis=1, keepdims=True)
            if (row <= 0).any():
                raise ValueError("init_beta has an all-zero topic row")
            beta_init = beta_init / row
        elif config.init_type == "spectral":
            from strutopy_tpu.parallel.mesh import VOCAB_AXIS

            spectral_mesh = (
                mesh
                if mesh is not None
                and VOCAB_AXIS not in mesh.axis_names
                and self._stream_parts <= 1
                else None
            )
            beta_init = spectral_init(
                corpus, config.K, self.V, maxV=config.spectral_max_v,
                mesh=spectral_mesh,
            )
        else:
            # normalized Gamma(0.1, 1) rows (reference stm.py:425-428)
            g = np_rng.gamma(0.1, 1.0, (config.K, self.V))
            beta_init = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)

        self._state = init_state(
            jax.random.PRNGKey(config.seed),
            K=config.K,
            V=self.V,
            N=N_pad,
            P=self._D_np.shape[1],
            A=config.A,
            content=config.content,
            beta_init=jnp.asarray(beta_init),
            # keep kappa's shape identical across EM iterations (no
            # retraces): it must match the actual design width
            kappa_p=(
                self._kappa_design.shape[1]
                if (self._kappa_design is not None and not config.lda_beta)
                else 0
            ),
        )

        if self._stream_parts > 1:
            self._data = None
            self._em_step = self._make_streamed_step(
                config, buckets[0], aspect_buckets[0], D_buckets[0]
            )
            self._em_step_cold = (
                self._make_streamed_step(
                    config.replace(newton_pass1_iters=0),
                    buckets[0], aspect_buckets[0], D_buckets[0],
                )
                if config.newton_pass1_iters > 0 and config.newton_warmup_iters > 0
                else None
            )
            self.last_bounds = []
            self.nonfinite_bound_iters = []
            self.time_processed = None
            self.docs_per_sec = None
            return

        self._data = CorpusData(
            words=tuple(jnp.asarray(b.words) for b in buckets),
            counts=tuple(jnp.asarray(b.counts) for b in buckets),
            aspects=tuple(jnp.asarray(a) for a in aspect_buckets),
            doc_ok=tuple(jnp.asarray(b.doc_ok) for b in buckets),
            D=tuple(jnp.asarray(d, jnp.float32) for d in D_buckets),
        )

        if mesh is not None:
            from strutopy_tpu.parallel.sharding import (
                make_sharded_em_step,
                shard_corpus,
                shard_state,
            )

            self._data = shard_corpus(mesh, self._data)
            self._state = shard_state(mesh, self._state, config.content)
            build_step = lambda c: make_sharded_em_step(
                mesh, c, self._design, self._kappa_design, self._wcounts,
                n_buckets=plan.n_buckets,
                bucket_batches=plan.batch_sizes,
            )
        else:
            build_step = lambda c: make_em_step(
                c, self._design, self._kappa_design, self._wcounts,
                bucket_batches=plan.batch_sizes,
            )
        self._em_step = build_step(config)
        # with the two-pass schedule on, cold iterations (poor warm
        # starts -> most docs unconverged at the pass-1 cap) run the
        # single-pass graph instead; see STMConfig.newton_warmup_iters
        self._em_step_cold = (
            build_step(config.replace(newton_pass1_iters=0))
            if config.newton_pass1_iters > 0 and config.newton_warmup_iters > 0
            else None
        )

        self.last_bounds: list = []
        self.nonfinite_bound_iters: list = []
        self.time_processed: Optional[float] = None
        self.docs_per_sec: Optional[float] = None

    def _make_streamed_step(self, cfg, bucket, aspects_np, D_bucket):
        """(state, _) -> state over host-resident corpus parts.

        Wraps models/streaming.py::StreamedEM behind the same step
        signature as make_em_step, so expectation_maximization (incl.
        checkpoints/resume and the two-pass warm-up switch) works
        unchanged: per-part state slices come from the assembled state
        each call, and the new parts concatenate back.

        Note: the per-iteration reassembly transiently holds ~2x the
        per-doc state (eta/mu/theta) on device.  That state is small
        next to the corpus the streaming avoids keeping resident
        (1.2 GB vs 2.4+ GB at N=1M), but for the tightest memory budget
        drive :class:`StreamedEM` directly and keep part states
        resident."""
        from strutopy_tpu.models.streaming import StreamedEM

        P = self._stream_parts
        n_total = bucket.words.shape[0]
        if n_total % P:
            # the bucket plan is built with n_devices=stream_parts, which
            # guarantees divisibility today; pin the invariant so a future
            # plan change cannot silently drop tail documents (ADVICE r2)
            raise ValueError(
                f"bucket size {n_total} is not divisible by "
                f"stream_parts={P}; the padding plan must round to a "
                "multiple of stream_parts * batch_size"
            )
        part = n_total // P
        W, C, OK = bucket.words, bucket.counts, bucket.doc_ok
        A = np.ascontiguousarray(aspects_np, np.int32)
        D32 = np.ascontiguousarray(D_bucket, np.float32)

        def provider(p):
            s = slice(p * part, (p + 1) * part)
            return (W[s], C[s], A[s], OK[s], D32[s])

        sem = StreamedEM(
            cfg, self._design, provider, n_parts=P,
            kappa_design=self._kappa_design, wcounts=self._wcounts,
            mesh=self.mesh,
        )

        def step(state, _data):
            parts = [
                state._replace(
                    eta=state.eta[i * part:(i + 1) * part],
                    mu=state.mu[i * part:(i + 1) * part],
                    theta=state.theta[i * part:(i + 1) * part],
                    opt_iters=state.opt_iters[i * part:(i + 1) * part],
                )
                for i in range(P)
            ]
            shared, new_parts = sem.em_iteration(state, parts)
            return shared._replace(
                eta=jnp.concatenate([s.eta for s in new_parts]),
                mu=jnp.concatenate([s.mu for s in new_parts]),
                theta=jnp.concatenate([s.theta for s in new_parts]),
                opt_iters=jnp.concatenate([s.opt_iters for s in new_parts]),
            )

        return step

    # ------------------------------------------------------------------
    # fitting
    # ------------------------------------------------------------------

    def reinitialize(self, seed: int) -> "STM":
        """Re-draw the random initial state under a new seed, keeping
        the corpus, designs, and the already-compiled EM step.

        Powers :func:`strutopy_tpu.pipeline.select_model`'s
        multi-restart protocol (R-stm ``selectModel``): every restart
        flows through the one compiled EM program, so a ``runs=20``
        sweep costs ~20x one fit's *iterations*, not 20 compiles.
        Only meaningful for
        ``init_type='random'`` — spectral init is deterministic, so
        restarts would all coincide.
        """
        cfg = self.config
        if cfg.init_type != "random":
            raise ValueError(
                "reinitialize requires init_type='random': spectral "
                "init is deterministic, so re-seeded restarts would "
                "all produce the same model"
            )
        # normalized Gamma(0.1, 1) rows, same family as __init__
        np_rng = np.random.RandomState(seed)
        g = np_rng.gamma(0.1, 1.0, (cfg.K, self.V))
        beta_init = g / np.maximum(g.sum(axis=1, keepdims=True), 1e-300)
        state = init_state(
            jax.random.PRNGKey(seed),
            K=cfg.K,
            V=self.V,
            N=self._state.mu.shape[0],
            P=self._D_np.shape[1],
            A=cfg.A,
            content=cfg.content,
            beta_init=jnp.asarray(beta_init),
            kappa_p=self._state.kappa.shape[0],
        )
        if self.mesh is not None:
            from strutopy_tpu.parallel.sharding import shard_state

            state = shard_state(self.mesh, state, cfg.content)
        self._state = state
        self.last_bounds = []
        self.nonfinite_bound_iters = []
        self.time_processed = None
        self.docs_per_sec = None
        self._overflow_warned = False
        return self

    def expectation_maximization(
        self,
        saving: bool = False,
        output_dir=None,
        checkpoint_path: Optional[str] = None,
        checkpoint_every: int = 5,
        resume: bool = False,
        profile_dir: Optional[str] = None,
        start_iter: int = 0,
    ):
        """Run EM until convergence (reference stm.py:855-880).

        Beyond the reference: resumable checkpoints (``checkpoint_path``
        + ``resume=True``), per-iteration docs/sec instrumentation, and
        optional ``jax.profiler`` traces (``profile_dir``).

        ``start_iter`` continues a partial fit in place (the state and
        ``last_bounds`` carry over): iterations run from ``start_iter``
        to ``config.max_em_iter``, skipping the cold-start warmup
        switch that already ran.  Used by ``pipeline.select_model`` to
        run stage-2 survivors onward from their stage-1 state.
        """
        cfg = self.config
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            from strutopy_tpu.utils.checkpoint import load_checkpoint

            self._state, self.last_bounds, start_iter, _ = load_checkpoint(
                checkpoint_path
            )
            if self.mesh is not None:
                from strutopy_tpu.parallel.sharding import shard_state

                self._state = shard_state(self.mesh, self._state, cfg.content)
            logger.info("resumed from %s at EM iteration %d", checkpoint_path, start_iter)

        t0 = time.time()
        logger.info("Fit %s for %d topics", cfg.model_type, cfg.K)
        if profile_dir:
            jax.profiler.start_trace(profile_dir)
        try:
            for it in range(start_iter, cfg.max_em_iter):
                it_t0 = time.time()
                step = (
                    self._em_step_cold
                    if self._em_step_cold is not None
                    and it < cfg.newton_warmup_iters
                    else self._em_step
                )
                self._state = step(self._state, self._data)
                bound = float(self._state.bound)
                it_dt = time.time() - it_t0
                if not np.isfinite(bound):
                    # always-on sanitizer (VERDICT r4 #6): the reference
                    # asserts on its bound in the hot path
                    # (/root/reference/src/modules/stm.py:534,1117); a
                    # non-finite ELBO means the fit mis-executed even
                    # when theta/beta look sensible (the N=1M spectral
                    # pathology surfaced only in a benchmark JSON).
                    self.nonfinite_bound_iters.append(it)
                    if len(self.nonfinite_bound_iters) == 1:
                        logger.warning(
                            "EM iteration %d: NON-FINITE bound (%r) — the "
                            "fit is numerically damaged; check the init "
                            "(model.nonfinite_bound_iters records every "
                            "occurrence and save_model writes "
                            "fit_health.json)", it, bound,
                        )
                if cfg.debug_checks:
                    from strutopy_tpu.utils.debug import validate_state

                    validate_state(self._state, it)
                if cfg.newton_pass1_iters:
                    # unconditional (bound is already host-synced above;
                    # this read is free): silent under-convergence is
                    # exactly what this diagnostic exists to surface.
                    # WARN once per fit — overflow is routine for the
                    # default schedule on large corpora (bound parity
                    # vs single-pass ~1e-7), so a
                    # per-iteration warning would just be noise; the
                    # per-iteration count stays available at DEBUG and
                    # via model.straggler_overflow.
                    ov = int(np.asarray(self._state.straggler_overflow))
                    if ov > 0 and not getattr(self, "_overflow_warned", False):
                        self._overflow_warned = True
                        logger.warning(
                            "EM iteration %d: %d docs exceeded the two-pass "
                            "straggler budget and kept their pass-1 eta "
                            "(further occurrences logged at DEBUG; check "
                            "model.straggler_overflow, raise "
                            "newton_straggler_frac (%.2f) if bound/heldout "
                            "degrade)",
                            it, ov, cfg.newton_straggler_frac,
                        )
                    elif ov > 0:
                        logger.debug(
                            "EM iteration %d: straggler overflow %d", it, ov
                        )
                self.last_bounds.append(bound)
                self.docs_per_sec = self.N / max(it_dt, 1e-9)
                logger.info(
                    "EM iteration %d: bound %.4f (%.3fs, %.0f docs/s)",
                    it, bound, it_dt, self.docs_per_sec,
                )
                if checkpoint_path and (it + 1) % checkpoint_every == 0:
                    from strutopy_tpu.utils.checkpoint import save_checkpoint

                    save_checkpoint(
                        checkpoint_path, self._state, self.last_bounds, it + 1,
                        cfg.to_json(),
                    )
                if it >= 1:
                    old = self.last_bounds[-2]
                    rel = abs((bound - old) / abs(old)) if old != 0 else np.inf
                    if rel < cfg.convergence_threshold:
                        self.time_processed = time.time() - t0
                        logger.info(
                            "converged in iteration %d after %.2fs",
                            it, self.time_processed,
                        )
                        break
        finally:
            if profile_dir:
                jax.profiler.stop_trace()
        if self.time_processed is None:
            self.time_processed = time.time() - t0
            logger.info(
                "max EM iterations (%d) reached after %.2fs",
                cfg.max_em_iter,
                self.time_processed,
            )
        if checkpoint_path:
            from strutopy_tpu.utils.checkpoint import save_checkpoint

            save_checkpoint(
                checkpoint_path, self._state, self.last_bounds,
                len(self.last_bounds), cfg.to_json(),
            )
        if saving:
            assert output_dir is not None
            self.save_model(output_dir)
        return self

    fit = expectation_maximization

    # ------------------------------------------------------------------
    # fitted parameters (padding documents trimmed)
    # ------------------------------------------------------------------

    @property
    def beta(self) -> np.ndarray:
        return np.asarray(self._state.beta)

    @property
    def theta(self) -> np.ndarray:
        # state arrays are in (device-major, bucket-minor) storage order
        return np.asarray(self._state.theta)[self._storage_index]

    @property
    def eta(self) -> np.ndarray:
        return np.asarray(self._state.eta)[self._storage_index]

    @property
    def mu(self) -> np.ndarray:
        return np.asarray(self._state.mu)[self._storage_index]

    @property
    def sigma(self) -> np.ndarray:
        return np.asarray(self._state.sigma)

    @property
    def gamma(self) -> np.ndarray:
        return np.asarray(self._state.gamma)

    @property
    def kappa(self) -> np.ndarray:
        return np.asarray(self._state.kappa)

    @property
    def bound(self) -> float:
        return float(self._state.bound)

    @property
    def wcounts(self) -> np.ndarray:
        return self._wcounts

    @property
    def straggler_overflow(self) -> int:
        """Docs the last E-step's two-pass straggler budget could not
        admit (left at their pass-1 eta); 0 when the schedule is off."""
        return int(np.asarray(self._state.straggler_overflow))

    # ------------------------------------------------------------------
    # inference on new documents (serving)
    # ------------------------------------------------------------------

    def transform(self, documents, X=None, beta_index=None):
        """Infer theta/eta for NEW documents under the fitted model.

        The reference has no serving path (new documents require a full
        refit); this runs one batched E-step with the fitted beta/sigma
        and the prevalence prior mu = [1, X_new] @ gamma^T (or the CTM
        column mean), returning ``(theta, eta)`` in the documents' order.
        For serving from saved artifacts without an STM instance, see
        :func:`strutopy_tpu.models.serving.infer_from_artifacts`.
        """
        from strutopy_tpu.models.serving import infer_theta

        cfg = self.config
        N_new = documents.N if isinstance(documents, PaddedCorpus) else len(documents)

        if cfg.model_type == "CTM" or self.X is None:
            # mean over REAL docs only: exclude empty (doc_ok=False)
            # user docs, matching the fitted mu which divides by
            # doc_ok.sum() (ops/mstep.py CTM path).  self.eta is in
            # user order with corpus.N rows, so the mask must be the
            # FULL user-order doc_ok (self.N counts only real docs and
            # would mis-size the mask when empties exist)
            ok = self._corpus.doc_ok
            mu_row = self.eta[ok].mean(axis=0) if ok.any() else self.eta.mean(axis=0)
            mu_user = np.tile(mu_row, (N_new, 1))
        else:
            if X is None:
                raise ValueError(
                    "the model was fit with prevalence covariates; pass X "
                    "for the new documents"
                )
            Xa = np.asarray(X, np.float64)
            if Xa.ndim == 1:
                Xa = Xa[:, None]
            # a 1-D categorical covariate was one-hot encoded at fit time
            # (ops/mstep.py::build_design); encode the new values with
            # the TRAINING levels so raw covariates keep working
            enc = mstep.encode_new_covariates(
                Xa, self.X, self._corpus.doc_ok
            )
            if enc is not None:
                Xa = enc
            D_new = np.c_[np.ones(N_new), Xa] if cfg.fit_intercept else Xa
            if D_new.shape[1] != self.gamma.shape[1]:
                raise ValueError(
                    f"X has {Xa.shape[1]} column(s) but the fitted gamma "
                    f"expects a {self.gamma.shape[1]}-column design; "
                    "multi-column covariates must be passed with the same "
                    "encoding used at training"
                )
            mu_user = D_new @ np.asarray(self.gamma, np.float64).T

        aspects_user = None
        if cfg.content:
            if beta_index is None:
                raise ValueError("content model requires beta_index for new docs")
            aspects_user = np.asarray(beta_index, np.int32).ravel()

        return infer_theta(
            self.beta, self.sigma, mu_user.astype(np.float32), documents, cfg,
            aspects_user=aspects_user,
        )

    # ------------------------------------------------------------------
    # persistence (reference save_model artifact contract, stm.py:1120-1149)
    # ------------------------------------------------------------------

    def save_model(self, output_dir):
        os.makedirs(output_dir, exist_ok=True)
        np.save(os.path.join(output_dir, "beta_hat"), self.beta)
        np.save(os.path.join(output_dir, "theta_hat"), self.theta)
        np.save(os.path.join(output_dir, "sigma_hat"), self.sigma)
        np.save(os.path.join(output_dir, "eta_hat"), self.eta)
        np.save(os.path.join(output_dir, "mu_hat"), self.mu)
        if self.X is not None:
            np.save(os.path.join(output_dir, "X"), self.X)
        if self.config.model_type == "STM":
            np.save(os.path.join(output_dir, "gamma_hat"), self.gamma)
        if self.config.content:
            np.save(os.path.join(output_dir, "kappa_hat"), self.kappa)
        with open(os.path.join(output_dir, "lower_bound.pickle"), "wb") as f:
            pickle.dump(self.last_bounds, f)
        # fit-health flag (VERDICT r4 #6): non-finite bounds propagate
        # into the artifact set so downstream consumers see the damage
        nfi = list(getattr(self, "nonfinite_bound_iters", []))
        with open(os.path.join(output_dir, "fit_health.json"), "w") as f:
            json.dump({
                "bound_finite": not nfi,
                "nonfinite_bound_iters": nfi,
            }, f)
        with open(os.path.join(output_dir, "stm_config.json"), "w") as f:
            f.write(self.config.to_json())
        # beyond the reference artifact set: the vocabulary, so serving
        # can encode RAW TEXT against this model (ThetaServer.infer_text)
        with open(os.path.join(output_dir, "vocab.json"), "w") as f:
            json.dump(list(self.dictionary), f)

    # ------------------------------------------------------------------
    # post-fit analysis (reference stm.py:1151-1259)
    # ------------------------------------------------------------------

    def label_topics(self, topics=None, n: int = 10, frexweight: float = 0.5,
                     print_labels: bool = False):
        return diagnostics.label_topics(
            self.beta, self.dictionary, topics=topics, n=n,
            frexweight=frexweight, print_labels=print_labels,
        )

    def frex(self, w: float = 0.5) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.frex(beta, w=w)

    def find_thoughts(self, topics, threshold: float = 0.0, n: int = 3):
        return diagnostics.find_thoughts(self.theta, topics, threshold=threshold, n=n)

    def find_topic(self, query, n: int = 10, weighting: str = "prob",
                   frexweight: float = 0.5):
        """Topics most associated with a set of query words (R-stm
        ``findTopic``; see eval/diagnostics.py::find_topic)."""
        return diagnostics.find_topic(
            self.beta, query, self.dictionary, n=n, weighting=weighting,
            frexweight=frexweight, wcounts=self.wcounts,
        )

    def sage_labels(self, n: int = 7):
        """Per-(aspect, topic) top words of a content model (R-stm
        ``sageLabels`` analogue; see eval/diagnostics.py)."""
        if self.beta.ndim != 3:
            raise ValueError("sage_labels needs a content model (A-aspect beta)")
        return diagnostics.sage_labels(
            self.beta, self.dictionary, kappa=self.kappa,
            kappa_design=self._kappa_design, n=n,
        )

    def exclusivity(self, M: int = 10, w: float = 0.7) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.exclusivity(beta, M=M, w=w)

    def semantic_coherence(self, M: int = 10) -> np.ndarray:
        beta = self.beta
        if beta.ndim == 3:
            beta = beta.mean(axis=0)
        return diagnostics.semantic_coherence(beta, self._corpus, M=M)

    def topic_quality(self, M: int = 10, w: float = 0.7) -> dict:
        """Per-topic coherence/exclusivity pair (R-stm ``topicQuality``
        axes); plot with :func:`eval.diagnostics.plot_topic_quality`."""
        return diagnostics.topic_quality(self.beta, self._corpus, M=M, w=w)

    def to_ldavis(self, R: int = 30, lambda_step: float = 0.01,
                  path: Optional[str] = None) -> dict:
        """LDAvis JSON payload for the standard topic browser (R-stm
        ``toLDAvis``); see :func:`strutopy_tpu.eval.ldavis.to_ldavis`."""
        from strutopy_tpu.eval.ldavis import model_to_ldavis

        return model_to_ldavis(self, R=R, lambda_step=lambda_step, path=path)

    def topic_corr(self, method: str = "simple", cutoff: float = 0.01,
                   **huge_kwargs):
        """Topic correlation graph (R-stm ``topicCorr``).

        method="simple": threshold the fitted logistic-normal
        correlations (returns (adjacency, edges)); method="huge":
        sparse Gaussian-copula graph on theta via MB neighborhoods +
        StARS (returns the :func:`eval.graph.topic_graph_huge` dict).
        Plot either with :func:`eval.graph.plot_topic_graph`.
        """
        from strutopy_tpu.eval import graph as _graph

        if method == "simple":
            return _graph.topic_graph(np.asarray(self.sigma), cutoff=cutoff)
        if method == "huge":
            return _graph.topic_graph_huge(np.asarray(self.theta),
                                           **huge_kwargs)
        raise ValueError(f"method must be 'simple' or 'huge', got {method!r}")

    def check_residuals(self, tol: float = 0.01) -> dict:
        """Multinomial dispersion of the fit's residuals (R-stm
        ``checkResiduals``, Taddy 2012; see eval/residuals.py).
        Dispersion >> 1 suggests raising K."""
        from strutopy_tpu.eval.residuals import check_residuals

        beta = self.beta
        aspect = self.betaindex if beta.ndim == 3 else None
        return check_residuals(
            self._corpus, self.theta, beta, tol=tol, aspect=aspect
        )

    def summary(self, n: int = 5, print_summary: bool = True) -> str:
        """Printable model overview (R-stm ``summary.STM``): dimensions,
        convergence, and each topic's highest-probability words."""
        K = self.config.K
        lines = [
            f"A topic model with {K} topics, {self._corpus.N} documents "
            f"and a {len(self.dictionary)} word dictionary.",
            f"model_type={self.config.model_type} mode={self.config.mode} "
            f"content={self.config.content} "
            f"em_iterations={len(self.last_bounds)} "
            f"final_bound={self.last_bounds[-1]:.2f}"
            if self.last_bounds else "(not fitted yet)",
        ]
        if self.last_bounds:
            prob_labels, _frex_labels = self.label_topics(n=n)
            prop = self.theta.mean(axis=0)
            lines.append("Topics (highest probability words, mean proportion):")
            for k in range(K):
                words = ", ".join(str(w) for w in prob_labels[k])
                lines.append(f"  {k:>3} ({prop[k]:.3f}): {words}")
        out = "\n".join(lines)
        if print_summary:
            print(out)
        return out
