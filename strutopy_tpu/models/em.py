"""One EM iteration as a single jitted / sharded function.

The reference runs E and M as separate host-side phases with a serial
document loop in between (src/modules/stm.py:855-880).  Here the whole
iteration — sigma factorization, batched E-step, moment reduction,
prevalence/sigma/beta updates — is one pure function of
``(state, data)`` so XLA compiles it once and, under ``shard_map``,
inserts exactly three logical collectives per iteration: the psums of
``beta_ss``, ``sigma_ss``+bound, and the eta moments (see
strutopy_tpu/parallel/sharding.py).

Length bucketing: every per-document field of :class:`CorpusData` is a
TUPLE with one entry per length bucket (a single entry when bucketing
is off).  Buckets are contiguous ranges of the storage-ordered state
arrays, so per-bucket slices of eta/mu derive from the bucket shapes —
which are per-device shapes under shard_map and global shapes without a
mesh, making the same code correct in both contexts.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.state import STMState
from strutopy_tpu.ops.estep import NewtonConfig, run_estep
from strutopy_tpu.ops.linalg import precompute_sigma
from strutopy_tpu.ops import mstep


class CorpusData(NamedTuple):
    """Device-resident corpus + covariate design, per length bucket."""

    words: Tuple[jax.Array, ...]  # each (N_b, L_b) int32
    counts: Tuple[jax.Array, ...]  # each (N_b, L_b) float
    aspects: Tuple[jax.Array, ...]  # each (N_b,) int32
    doc_ok: Tuple[jax.Array, ...]  # each (N_b,) bool
    D: Tuple[jax.Array, ...]  # each (N_b, P); zero rows for padding

    @classmethod
    def single(cls, words, counts, aspects, doc_ok, D) -> "CorpusData":
        return cls((words,), (counts,), (aspects,), (doc_ok,), (D,))

    @property
    def n_buckets(self) -> int:
        return len(self.words)


class GlobalStats(NamedTuple):
    """Psummed cross-shard sufficient statistics."""

    beta_ss: jax.Array
    sigma_ss: jax.Array
    bound: jax.Array
    Dt_eta: jax.Array
    eta_sum: jax.Array
    # diagnostic (psums like the rest): two-pass straggler-budget
    # overflow count across shards/buckets
    straggler_overflow: jax.Array = 0


def _newton_cfg(cfg: STMConfig) -> NewtonConfig:
    return NewtonConfig(
        max_iters=cfg.newton_max_iters,
        grad_tol=cfg.newton_grad_tol,
        max_backtracks=cfg.newton_max_backtracks,
        cg_iters=cfg.newton_cg_iters,
        bf16_hessian=cfg.newton_bf16_hessian,
        fixed_iters=cfg.newton_fixed_iters,
        bf16_beta=cfg.newton_bf16_beta,
        nu_method=cfg.nu_method,
        chol_block=cfg.chol_block,
        likelihood_temper=cfg.likelihood_temper,
    )


def _bucket_offsets(data: CorpusData):
    offs = [0]
    for w in data.words:
        offs.append(offs[-1] + w.shape[0])
    return offs


def local_estep_stats(state: STMState, data: CorpusData, cfg: STMConfig,
                      bucket_batches: Optional[Tuple[int, ...]] = None,
                      vocab_axis: Optional[str] = None):
    """E-step over all buckets on the local shard.

    Returns (stats to psum, eta, theta, newton_iters) with the
    per-document outputs concatenated back into storage order.

    Difficulty-sorted chunking: within each bucket, documents are
    processed in ascending order of last iteration's Newton count, so a
    scan chunk's batched while_loop runs roughly its own documents'
    iterations instead of the bucket-wide worst case (measured 1.45x
    potential at K=100 steady state).  Sufficient statistics are
    permutation-invariant; per-document outputs are scattered back to
    storage order.
    """
    siginv, sigmaentropy = precompute_sigma(state.sigma)
    ncfg = _newton_cfg(cfg)
    offs = _bucket_offsets(data)

    beta_ss = jnp.zeros(state.beta.shape, state.beta.dtype)
    sigma_ss = jnp.zeros_like(state.sigma)
    bound = jnp.zeros((), state.beta.dtype)
    Dt_eta = None
    eta_sum = jnp.zeros(state.eta.shape[1], state.eta.dtype)
    overflow = jnp.zeros((), jnp.int32)
    etas, thetas, iters = [], [], []

    for b in range(data.n_buckets):
        lo, hi = offs[b], offs[b + 1]
        n_b = hi - lo
        B_b = (
            bucket_batches[b]
            if bucket_batches is not None
            else min(cfg.batch_size, n_b)
        )
        mu_b = jax.lax.slice_in_dim(state.mu, lo, hi, axis=0)
        eta_b = jax.lax.slice_in_dim(state.eta, lo, hi, axis=0)
        words_b, counts_b = data.words[b], data.counts[b]
        aspects_b, ok_b = data.aspects[b], data.doc_ok[b]

        sort = cfg.sort_by_difficulty and n_b > B_b
        if sort:
            prev = jax.lax.slice_in_dim(state.opt_iters, lo, hi, axis=0)
            perm = jnp.argsort(prev)
            mu_b = mu_b[perm]
            eta_b = eta_b[perm]
            words_b = words_b[perm]
            counts_b = counts_b[perm]
            aspects_b = aspects_b[perm]
            ok_b = ok_b[perm]

        res = run_estep(
            state.beta,
            mu_b,
            eta_b,
            siginv,
            sigmaentropy,
            words_b,
            counts_b,
            aspects_b,
            ok_b,
            cfg=ncfg,
            batch_size=B_b,
            vocab_axis=vocab_axis,
            pass1_iters=cfg.newton_pass1_iters,
            straggler_frac=cfg.newton_straggler_frac,
            scan_unroll=cfg.scan_unroll,
            fused_finalize=cfg.two_pass_fused,
        )
        eta_out, theta_out, iters_out = res.eta, res.theta, res.newton_iters
        if sort:
            eta_out = jnp.zeros_like(eta_out).at[perm].set(eta_out)
            theta_out = jnp.zeros_like(theta_out).at[perm].set(theta_out)
            iters_out = jnp.zeros_like(iters_out).at[perm].set(iters_out)

        mom = mstep.eta_moments(data.D[b], eta_out)
        beta_ss = beta_ss + res.beta_ss
        sigma_ss = sigma_ss + res.sigma_ss
        bound = bound + res.bound
        overflow = overflow + res.straggler_overflow
        Dt_eta = mom.Dt_eta if Dt_eta is None else Dt_eta + mom.Dt_eta
        eta_sum = eta_sum + mom.eta_sum
        etas.append(eta_out)
        thetas.append(theta_out)
        iters.append(iters_out)

    stats = GlobalStats(
        beta_ss=beta_ss,
        sigma_ss=sigma_ss,
        bound=bound,
        Dt_eta=Dt_eta,
        eta_sum=eta_sum,
        straggler_overflow=overflow,
    )
    return (
        stats,
        jnp.concatenate(etas, axis=0),
        jnp.concatenate(thetas, axis=0),
        jnp.concatenate(iters, axis=0),
    )


def em_iteration(
    state: STMState,
    data: CorpusData,
    design: mstep.PrevalenceDesign,
    kappa_design,
    wcounts,
    cfg: STMConfig,
    psum,
    bucket_batches: Optional[Tuple[int, ...]] = None,
    vocab_axis: Optional[str] = None,
):
    """One full EM iteration; ``psum`` reduces per-shard statistics
    (identity on a single device, ``lax.psum`` under shard_map —
    over the DOC axis only: with ``vocab_axis`` set, beta/beta_ss stay
    vocab-sharded and the per-doc quantities are replicated across
    vocab shards by the beta_doc gather-psum, so doc-axis reduction
    already yields full totals on every device).

    The sigma residual moment (eta - mu)^T (eta - mu) is computed on the
    local shard *after* mu is materialized from the new gamma — the
    numerically-direct form of reference update_sigma (stm.py:723) —
    and psummed; everything else in the M-step is replicated compute on
    already-psummed stats.
    """
    stats, eta, theta, newton_iters = local_estep_stats(
        state, data, cfg, bucket_batches, vocab_axis
    )
    stats = GlobalStats(*psum(tuple(stats)))

    mom = mstep.EtaMoments(Dt_eta=stats.Dt_eta, eta_sum=stats.eta_sum)
    gamma, mu_mean = mstep.update_prevalence(
        mom,
        design,
        cfg.model_type,
        cfg.mode,
        ridge_alpha=cfg.ridge_alpha,
        lasso_alpha=cfg.lasso_alpha,
    )
    mu = jnp.concatenate(
        [
            mstep.compute_mu(D_b, gamma, mu_mean, ok_b, cfg.model_type)
            for D_b, ok_b in zip(data.D, data.doc_ok)
        ],
        axis=0,
    )

    resid = psum(mstep.residual_moment(eta, mu))
    sigma = mstep.update_sigma(resid, stats.sigma_ss, design.n_docs, cfg.sigma_prior)

    if cfg.lda_beta:
        row_psum = (
            (lambda x: jax.lax.psum(x, vocab_axis)) if vocab_axis else None
        )
        beta = mstep.update_beta_lda(stats.beta_ss, cfg.beta_smoothing, row_psum)
        kappa = state.kappa
    else:
        wc = jnp.asarray(wcounts, state.beta.dtype)
        vocab_psum = vocab_pmax = None
        wc_total = None
        if vocab_axis is not None:
            # the per-word GLMs are shard-local; wcounts is captured as
            # the full replicated (V,) array, so slice this device's
            # contiguous vocab shard to match beta_ss/kappa
            Vl = stats.beta_ss.shape[-1]
            wc_total = jnp.sum(wc)
            wc = jax.lax.dynamic_slice_in_dim(
                wc, jax.lax.axis_index(vocab_axis) * Vl, Vl
            )
            vocab_psum = lambda x: jax.lax.psum(x, vocab_axis)
            vocab_pmax = lambda x: jax.lax.pmax(x, vocab_axis)
        beta, kappa = mstep.update_beta_content(
            stats.beta_ss,
            wc,
            kappa_design,
            alpha=cfg.kappa_l2,
            iters=cfg.kappa_newton_iters,
            # warm start from the previous EM iteration's kappa: at
            # iteration 0 state.kappa is zeros (== the cold start), so
            # this is free there and saves most Newton iterations at
            # steady state (VERDICT r2 next #1)
            kappa0=state.kappa,
            tol=cfg.kappa_grad_tol,
            vocab_psum=vocab_psum,
            vocab_pmax=vocab_pmax,
            wcounts_total=wc_total,
            ftol_rel=cfg.kappa_ftol_rel,
        )
    return STMState(
        beta=beta,
        mu=mu,
        sigma=sigma,
        eta=eta,
        theta=theta,
        gamma=gamma,
        kappa=kappa,
        bound=stats.bound,
        opt_iters=newton_iters,
        straggler_overflow=stats.straggler_overflow,
    )


def make_em_step(
    cfg: STMConfig,
    design: mstep.PrevalenceDesign,
    kappa_design,
    wcounts,
    bucket_batches: Optional[Tuple[int, ...]] = None,
):
    """Build the single-device jitted EM step: state, data -> state."""

    @jax.jit
    def em_step(state: STMState, data: CorpusData) -> STMState:
        return em_iteration(
            state, data, design, kappa_design, wcounts, cfg,
            psum=lambda x: x, bucket_batches=bucket_batches,
        )

    return em_step
