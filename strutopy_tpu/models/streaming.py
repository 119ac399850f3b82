"""Streamed (out-of-core) EM: corpora larger than device memory.

The single-device EM step (models/em.py) keeps the whole corpus
device-resident; at N=1M x 300 tokens that is ~2.4 GB of words+counts
plus transient copies, and it outgrows one device's memory as V and N
grow.  The streamed EM step splits the corpus into P equally-shaped parts
and streams one part at a time through the E-step:

  for each part:  E-step stats (sufficient statistics accumulate
                  on device; eta/theta warm starts persist per part)
  one M-step      on the summed stats (identical math to em.py:
                  prevalence -> mu -> sigma residual second pass ->
                  sigma/beta)

This is exactly em_iteration's dataflow with the doc loop lifted to
host level, so the result matches the in-memory step to f32 scatter
order (tests/test_streaming.py pins it).  Parts may live in host RAM
as numpy arrays (device-transferred per iteration and freed after —
the out-of-core case) or be produced on demand by a callback (e.g.
regenerated on device each iteration).

The reference has no analogue: its serial loop is bounded by host RAM
and days of runtime long before memory matters (SURVEY §2.5).
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.em import CorpusData, GlobalStats, local_estep_stats
from strutopy_tpu.models.state import STMState
from strutopy_tpu.ops import mstep

logger = logging.getLogger(__name__)

# a part: (words (n, L), counts (n, L), aspects (n,), doc_ok (n,), D (n, P))
Part = Tuple
PartProvider = Union[Sequence[Part], Callable[[int], Part]]


class StreamedEM:
    """EM over ``n_parts`` equally-shaped corpus parts.

    Args:
      cfg: fit configuration.  Content models stream too: the kappa
        GLM runs once per iteration on the summed beta_ss, which is
        (A, K, V)-small regardless of corpus size — pass
        ``kappa_design`` and ``wcounts``.
      design: prevalence design over the FULL corpus
        (``mstep.make_prevalence_design``).
      parts: either a sequence of Part tuples (host numpy or device
        arrays) or a callable ``provider(p) -> Part`` invoked once per
        part per iteration (arrays it returns are freed after the
        part's E-step — regenerate or re-read them each call).
      n_parts: required when ``parts`` is a callable.

    Every part must have the same (n, L) shape with n a multiple of
    ``cfg.batch_size`` (one compiled E-step graph serves all parts).
    """

    def __init__(
        self,
        cfg: STMConfig,
        design: mstep.PrevalenceDesign,
        parts: PartProvider,
        n_parts: Optional[int] = None,
        prefetch: bool = True,
        kappa_design=None,
        wcounts=None,
        mesh=None,
    ):
        if (cfg.content or not cfg.lda_beta) and (
            kappa_design is None or wcounts is None
        ):
            raise ValueError(
                "content/SAGE beta updates need kappa_design and wcounts"
            )
        self.cfg = cfg
        self.design = design
        self.kappa_design = kappa_design
        self.wcounts = wcounts
        self.mesh = mesh
        if callable(parts):
            if n_parts is None:
                raise ValueError("n_parts is required with a callable provider")
            self._provider = parts
            self.n_parts = n_parts
        else:
            parts = list(parts)
            if n_parts is not None and n_parts != len(parts):
                # a mismatch would silently drop tail parts from every
                # EM iteration (or IndexError mid-iteration if larger)
                raise ValueError(
                    f"n_parts={n_parts} does not match the {len(parts)} "
                    "parts provided; omit n_parts for sequence providers"
                )
            self._provider = lambda p: parts[p]
            self.n_parts = len(parts)

        self.prefetch = prefetch
        # always-on finite-bound sanitizer (VERDICT r4 #6): streamed
        # fits are where the N=1M non-finite bound mis-execution
        # surfaced; count occurrences and warn loudly on the first
        self.nonfinite_bound_count = 0
        # equal-shape contract (class docstring): pinned on first fetch,
        # checked on every later one — a ragged tail part would either
        # recompile the E-step per shape or fail opaquely inside jit
        # against part_states
        self._part_shape: Optional[Tuple[int, ...]] = None
        self._cached_part0: Optional[Part] = None
        # M-step finalize as jitted calls: streamed fits would otherwise
        # pay per-op dispatch latency for every eager jnp op, unlike
        # em.py's single-jit iteration
        self._prevalence = jax.jit(
            lambda mom: mstep.update_prevalence(
                mom, self.design, cfg.model_type, cfg.mode,
                ridge_alpha=cfg.ridge_alpha, lasso_alpha=cfg.lasso_alpha,
            )
        )
        self._sigma = jax.jit(
            lambda resid, sigma_ss: mstep.update_sigma(
                resid, sigma_ss, self.design.n_docs, cfg.sigma_prior
            )
        )
        if cfg.lda_beta:
            self._beta_lda = jax.jit(
                lambda beta_ss: mstep.update_beta_lda(
                    beta_ss, cfg.beta_smoothing
                )
            )
        if mesh is None:
            self._part_estep = jax.jit(self._part_estep_impl)
            self._mu_resid = jax.jit(self._mu_resid_impl)
        else:
            # streaming x sharding (round 3, VERDICT r2 next #4): every
            # part is itself document-sharded over the mesh — each
            # device streams ITS shard of each part, psumming the
            # part's sufficient statistics once; the host loop over
            # parts and the replicated M-step are unchanged.  On a 2-D
            # (docs, vocab) mesh, beta/kappa/beta_ss additionally shard
            # their vocab dimension (parallel/sharding._state_specs):
            # the E-step assembles beta_doc with one vocab-axis psum
            # per chunk and scatters phi shard-locally; the part psum
            # stays DOC-axis-only, and the host-level M-step operates
            # on the global (vocab-sharded) beta_ss under GSPMD.
            from jax.sharding import NamedSharding, PartitionSpec as P

            from strutopy_tpu.models.em import GlobalStats
            from strutopy_tpu.parallel.mesh import DOC_AXIS, VOCAB_AXIS
            from strutopy_tpu.parallel.sharding import _state_specs

            vocab_sharded = VOCAB_AXIS in mesh.axis_names
            doc = P(DOC_AXIS)
            rep = P()
            state_specs = _state_specs(cfg.content, vocab_sharded)
            data_specs = CorpusData.single(doc, doc, doc, doc, doc)
            stats_specs = GlobalStats(
                state_specs.beta, rep, rep, rep, rep, rep
            )
            vaxis = VOCAB_AXIS if vocab_sharded else None

            def _estep_local(state_p, data_p):
                stats, eta, theta, iters = local_estep_stats(
                    state_p, data_p, cfg, vocab_axis=vaxis
                )
                stats = GlobalStats(*jax.lax.psum(tuple(stats), DOC_AXIS))
                return stats, eta, theta, iters

            self._part_estep = jax.jit(jax.shard_map(
                _estep_local, mesh=mesh,
                in_specs=(state_specs, data_specs),
                out_specs=(stats_specs, doc, doc, doc),
                check_vma=False,
            ))

            def _mu_resid_local(D_p, gamma, mu_mean, ok_p, eta_p):
                mu_p = mstep.compute_mu(
                    D_p, gamma, mu_mean, ok_p, cfg.model_type
                )
                r = jax.lax.psum(mstep.residual_moment(eta_p, mu_p), DOC_AXIS)
                return mu_p, r

            self._mu_resid = jax.jit(jax.shard_map(
                _mu_resid_local, mesh=mesh,
                in_specs=(doc, rep, rep, doc, doc),
                out_specs=(doc, rep),
                check_vma=False,
            ))
            self._doc_sharding = NamedSharding(mesh, doc)

    def _fetch(self, p: int) -> CorpusData:
        """Materialize part p on device (runs on the prefetch thread).

        ``jnp.asarray`` on a host array starts the host->device copy;
        doing it one part ahead overlaps provider work (disk reads,
        numpy slicing, regeneration) and the transfer with the current
        part's E-step. Device-resident parts pass through untouched.
        Under a mesh, every field lands document-sharded."""
        if p == 0 and self._cached_part0 is not None:
            # init_parts already materialized part 0 for its shapes;
            # reuse it once instead of a second provider(0) call
            raw, self._cached_part0 = self._cached_part0, None
        else:
            raw = self._provider(p)
        shp = tuple(np.shape(raw[0]))
        if self._part_shape is None:
            self._part_shape = shp
        elif shp != self._part_shape:
            raise ValueError(
                f"part {p} has words shape {shp} but earlier parts had "
                f"{self._part_shape}: every part must share one (n, L) "
                "shape (one compiled E-step graph serves all parts; pad "
                "a short tail part instead of shrinking it)"
            )
        if self.mesh is not None:
            # device_put the HOST array with the sharding directly: only
            # each device's slice is transferred.  jnp.asarray first
            # would stage the whole part on the default device — a
            # full-part memory spike (and a >1 GB single transfer at
            # 1M-doc scale).
            w, c, a, ok, D = (
                jax.device_put(x, self._doc_sharding) for x in raw
            )
        else:
            w, c, a, ok, D = (jnp.asarray(x) for x in raw)
        return CorpusData.single(w, c, a, ok, D)

    # -- jitted pieces ----------------------------------------------------

    def _part_estep_impl(self, state_p: STMState, data_p: CorpusData):
        return local_estep_stats(state_p, data_p, self.cfg)

    def _mu_resid_impl(self, D_p, gamma, mu_mean, ok_p, eta_p):
        mu_p = mstep.compute_mu(D_p, gamma, mu_mean, ok_p, self.cfg.model_type)
        return mu_p, mstep.residual_moment(eta_p, mu_p)

    # -- driver -----------------------------------------------------------

    def init_parts(self, key, K: int, V: int) -> List[STMState]:
        """Per-part state slices (eta/mu/theta) + shared beta/sigma.

        Parts share one STMState *shape* so `_part_estep` compiles once."""
        from strutopy_tpu.models.state import init_state

        part0 = self._provider(0)
        self._cached_part0 = part0  # reused by the first _fetch(0)
        n = np.asarray(part0[0]).shape[0]
        P = self._P(part0)
        keys = jax.random.split(key, self.n_parts)
        return [
            init_state(keys[p], K=K, V=V, N=n, P=P)
            for p in range(self.n_parts)
        ]

    @staticmethod
    def _P(part) -> int:
        return np.asarray(part[4]).shape[1]

    def em_iteration(self, shared: STMState, part_states: List[STMState]):
        """One full EM iteration across all parts.

        ``shared`` carries beta/sigma/gamma/kappa (its per-doc fields
        are ignored); ``part_states`` carry per-part eta/mu/theta.
        Returns (new shared state with summed bound, new part states).
        """
        cfg = self.cfg
        stats_sum = None
        etas, iters_l, thetas = [], [], []
        parts_cache = []  # doc_ok + D stay for the mu/resid second pass

        # one-part-ahead prefetch: the provider's host work and the
        # host->device copy of part p+1 overlap part p's E-step (the
        # estep dispatch below is async).  Note the peak part-memory is
        # then TWO parts — pass prefetch=False when a part barely fits.
        ex = ThreadPoolExecutor(max_workers=1) if self.prefetch else None
        try:
            nxt = ex.submit(self._fetch, 0) if ex else None
            for p in range(self.n_parts):
                data_p = nxt.result() if ex else self._fetch(p)
                if ex:
                    nxt = (ex.submit(self._fetch, p + 1)
                           if p + 1 < self.n_parts else None)
                ps = part_states[p]
                state_p = ps._replace(
                    beta=shared.beta, sigma=shared.sigma, gamma=shared.gamma,
                    kappa=shared.kappa,
                )
                stats, eta_p, theta_p, it_p = self._part_estep(state_p, data_p)
                stats_sum = (
                    stats
                    if stats_sum is None
                    else GlobalStats(*(x + y for x, y in zip(stats_sum, stats)))
                )
                etas.append(eta_p)
                thetas.append(theta_p)
                iters_l.append(it_p)
                parts_cache.append((data_p.doc_ok[0], data_p.D[0]))
                del data_p  # free the part's corpus before the next
        finally:
            if ex:
                ex.shutdown(wait=True)

        mom = mstep.EtaMoments(Dt_eta=stats_sum.Dt_eta, eta_sum=stats_sum.eta_sum)
        gamma, mu_mean = self._prevalence(mom)
        if self.mesh is not None and mu_mean is None:
            # the shard_mapped mu/resid pass takes a fixed arity of
            # array args; STM mode ignores mu_mean, so pass zeros
            mu_mean = jnp.zeros_like(stats_sum.eta_sum)

        resid = None
        mus = []
        for p in range(self.n_parts):
            ok, D = parts_cache[p]
            mu_p, r = self._mu_resid(D, gamma, mu_mean, ok, etas[p])
            mus.append(mu_p)
            resid = r if resid is None else resid + r

        sigma = self._sigma(resid, stats_sum.sigma_ss)
        if cfg.lda_beta:
            beta = self._beta_lda(stats_sum.beta_ss)
            kappa = shared.kappa
        else:
            beta, kappa = mstep.update_beta_content(
                stats_sum.beta_ss,
                self.wcounts,
                self.kappa_design,
                alpha=cfg.kappa_l2,
                iters=cfg.kappa_newton_iters,
                kappa0=shared.kappa,
                tol=cfg.kappa_grad_tol,
                ftol_rel=cfg.kappa_ftol_rel,
            )

        new_shared = shared._replace(
            beta=beta, sigma=sigma, gamma=gamma, kappa=kappa,
            bound=stats_sum.bound,
            straggler_overflow=stats_sum.straggler_overflow,
        )
        if not np.isfinite(float(np.asarray(stats_sum.bound))):
            self.nonfinite_bound_count += 1
            if self.nonfinite_bound_count == 1:
                logger.warning(
                    "streamed EM: NON-FINITE bound — the fit is "
                    "numerically damaged even if theta/beta look "
                    "sensible; check the init "
                    "(StreamedEM.nonfinite_bound_count accumulates)"
                )
        new_parts = [
            part_states[p]._replace(
                eta=etas[p], theta=thetas[p], mu=mus[p], opt_iters=iters_l[p]
            )
            for p in range(self.n_parts)
        ]
        return new_shared, new_parts
