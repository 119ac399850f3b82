"""Batched variational E-step: the hot kernel of the framework.

Reference semantics (src/modules/stm.py:489-597): for every document,
minimize over the variational mean ``eta`` (K-1 free coordinates, the
K-th pinned to 0)

    f(eta) = 0.5 (eta-mu)^T Sigma^{-1} (eta-mu)
             - sum_l c_l log( sum_k e^{eta_k} beta_{k, w_l} )
             + N_d * logsumexp(eta~)

then compute the analytic Hessian (stm.py:986-1026), its Cholesky
factor, the variational covariance ``nu = H^{-1}`` (stm.py:1052-1066),
the per-document ELBO (stm.py:1068-1101) and the token-topic sufficient
statistics ``phi`` (stm.py:1103-1118), accumulating

    sigma_ss += nu        beta_ss[:, w_d] += phi_d      bound += bound_d

Batched design (replacing the reference's serial python loop of
per-doc ``scipy.optimize.minimize(BFGS)`` calls):

  * documents stream through a ``lax.scan`` in fixed-size chunks; each
    chunk runs an *explicitly batched* damped-Newton solver: ONE
    batch-level ``lax.while_loop`` whose body is straight-line batched
    linear algebra (a vmapped while-in-while variant took minutes to
    compile);
  * the Newton direction comes from Steihaug truncated CG, *unrolled*
    (pure batched (B,K)·(B,K,K) matvecs, no per-doc factorization);
  * the Armijo line search evaluates ALL candidate step sizes in one
    (B,T,K)x(B,K,L) contraction and selects the first acceptable one —
    a parallel sweep instead of a sequential backtracking loop;
  * the exact-Hessian / Cholesky / PD-repair ladder runs once per
    document at the converged eta (it defines nu and the bound);
  * phi scatter-adds land in one fused XLA scatter per chunk.

Everything is shape-polymorphic in (B, K, L) and free of host
callbacks, so the same function runs under ``shard_map`` with a final
``psum`` over the document mesh axis (see strutopy_tpu/parallel).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from strutopy_tpu.ops import linalg
from strutopy_tpu.ops.linalg import (
    blocked_cho_inverse,
    blocked_cholesky,
    cho_inverse,
    default_chol_block,
)


def _batch_diag(H):
    """Diagonal of a (B, K, K) stack as a masked reduction (no gather)."""
    K = H.shape[-1]
    eye = jnp.eye(K, dtype=H.dtype)
    return jnp.sum(H * eye[None], axis=2)


class NewtonConfig(NamedTuple):
    max_iters: int = 24
    grad_tol: float = 1e-5
    max_backtracks: int = 12
    cg_iters: int = 6  # inner CG steps (capped at K-1 internally)
    bf16_hessian: bool = True  # bf16 operands for the *in-loop* Hessian product
    # run exactly max_iters Newton steps in a fori_loop instead of the
    # early-exit while_loop (converged lanes are frozen by the done
    # mask either way)
    fixed_iters: bool = False
    # store the Newton loop's beta_doc operand in bfloat16: halves the
    # dominant in-loop device-memory read ((B, K, L) per f/g/H call and
    # per Armijo sweep).  Only the SEARCH PATH sees the rounded values; the
    # finalize pass (bound, phi, nu) always re-reads beta_doc in f32,
    # preserving the model-quantity precision split (CLAUDE.md).
    bf16_beta: bool = False
    # nu = H^{-1} strategy at the converged eta: "blocked" (straight-
    # line blocked Cholesky + divide-and-conquer triangular inverse,
    # exact to f32 rounding), "chol" (XLA Cholesky + triangular solve,
    # reference semantics), or "ns" (Newton-Schulz: ~1e-3 relative
    # sigma_ss error; log-det still from the Cholesky)
    nu_method: str = "blocked"
    # blocked_cholesky block size for nu_method="blocked"; 0 = auto
    # (ops/linalg.py::default_chol_block: 16 at K<=200, 32 above)
    chol_block: int = 0
    # likelihood tempering of the per-doc eta SEARCH objective
    # (VERDICT r4 #3): minimize quad + temper * (-loglik) instead of the
    # plain MAP objective, i.e. damp the likelihood gradient by a factor
    # <1 so eta converges closer to the prior mean on small corpora.
    # Principled form of the shrinkage the reference's df bug applies by
    # accident (its gradient drops the e^eta scaling,
    # /root/reference/src/modules/stm.py:946-958 — exact only at eta=0,
    # so BFGS systematically under-steps toward the likelihood).  Only
    # the Newton search path is tempered; the finalize pass (bound, phi,
    # nu) always evaluates the TRUE model at the tempered optimum.
    # 1.0 = off (exact MAP, the default).
    likelihood_temper: float = 1.0


class EStepResult(NamedTuple):
    beta_ss: jax.Array  # (K, V) or (A, K, V)
    sigma_ss: jax.Array  # (K-1, K-1)
    bound: jax.Array  # scalar
    eta: jax.Array  # (N, K-1)
    theta: jax.Array  # (N, K)
    newton_iters: jax.Array  # (N,) int32 diagnostics
    # scalar int32: unconverged docs the two-pass straggler budget could
    # not admit (left at their pass-1 eta); 0 on the single-pass path
    straggler_overflow: jax.Array = 0


# ---------------------------------------------------------------------------
# batched primitives (B docs at once; no vmap, no nested loops)
# ---------------------------------------------------------------------------


def _pad_eta(eta):
    """(B, K-1) -> (B, K) with the pinned last coordinate."""
    B = eta.shape[0]
    return jnp.concatenate([eta, jnp.zeros((B, 1), eta.dtype)], axis=1)


def _bmm_outer(Bm):
    """(B, K, L) x (B, K, L) -> (B, K, K) batched B @ B^T.

    f32 operands (the finalize Hessian, ``bf16=False``) multiply at
    ``linalg.MODEL_PREC`` (true f32); bf16 operands (the in-loop
    Hessian) keep the default: that reduced precision is the documented
    in-loop design.
    """
    prec = linalg.MODEL_PREC if Bm.dtype == jnp.float32 else None
    return jnp.einsum("bkl,bjl->bkj", Bm, Bm,
                      preferred_element_type=jnp.float32, precision=prec)


def _f_g_H_batched(eta, beta_doc, counts, mu, siginv, Nd, bf16: bool):
    """Objective, gradient, Hessian for a chunk.

    eta/mu (B, K-1); beta_doc (B, K, L); counts (B, L); Nd (B,).
    Math per reference f/df/hessian (stm.py:920-958, :986-1026) with the
    gradient's missing e^eta scaling fixed (PARITY_NOTES.md).
    """
    K = beta_doc.shape[1]
    eta_full = _pad_eta(eta)  # (B, K)
    m = jnp.max(eta_full, axis=1, keepdims=True)
    e = jnp.exp(eta_full - m)  # (B, K)
    sum_e = jnp.sum(e, axis=1, keepdims=True)
    theta = e / sum_e  # (B, K)

    a = e[:, :, None] * beta_doc  # (B, K, L)
    s = jnp.sum(a, axis=1)  # (B, L)
    s_safe = jnp.maximum(s, jnp.asarray(1e-35, s.dtype))
    cmask = counts > 0
    ll = jnp.sum(jnp.where(cmask, counts * (jnp.log(s_safe) + m), 0.0), axis=1)
    lse = (m + jnp.log(sum_e))[:, 0]
    diff = eta - mu  # (B, K-1)
    # the gradient and the Armijo objectives below decide where the
    # search stops, so their f32 products run at linalg.MODEL_PREC
    sdiff = jnp.einsum("bi,ij->bj", diff, siginv,
                       precision=linalg.MODEL_PREC)  # siginv symmetric
    f = 0.5 * jnp.sum(diff * sdiff, axis=1) - ll + Nd * lse

    phi_hat = a / s_safe[:, None, :]  # (B, K, L)
    phi_hat = jnp.where(cmask[:, None, :], phi_hat, 0.0)
    q = jnp.sum(phi_hat * counts[:, None, :], axis=2)  # (B, K)
    g_full = Nd[:, None] * theta - q
    g = sdiff + g_full[:, :-1]

    # Hessian: B B^T - diag(q) + Nd diag(theta) - Nd theta theta^T
    Bmat = phi_hat * jnp.sqrt(jnp.maximum(counts, 0.0))[:, None, :]
    if bf16:
        Bm = Bmat.astype(jnp.bfloat16)
    else:
        Bm = Bmat
    Hll = _bmm_outer(Bm)
    Hll = Hll - (Nd[:, None, None] * theta[:, :, None]) * theta[:, None, :]
    dcorr = Nd[:, None] * theta - q  # (B, K)
    Hll = Hll + dcorr[:, :, None] * jnp.eye(K, dtype=Hll.dtype)[None]
    H = Hll[:, : K - 1, : K - 1] + siginv[None]
    return f, g, H, theta, phi_hat


def _f_multi(eta, p, ts, beta_doc, counts, mu, siginv, Nd):
    """f(eta + t*p) for all T step sizes at once -> (B, T)."""
    cand = eta[:, None, :] + ts[None, :, None] * p[:, None, :]  # (B, T, K-1)
    B, T, _ = cand.shape
    cand_full = jnp.concatenate([cand, jnp.zeros((B, T, 1), cand.dtype)], axis=2)
    m = jnp.max(cand_full, axis=2, keepdims=True)
    e = jnp.exp(cand_full - m)  # (B, T, K)
    s = jnp.einsum("btk,bkl->btl", e, beta_doc,
                   precision=linalg.MODEL_PREC)  # (B, T, L)
    s = jnp.maximum(s, jnp.asarray(1e-35, s.dtype))
    cmask = counts > 0
    ll = jnp.sum(
        jnp.where(cmask[:, None, :], counts[:, None, :] * (jnp.log(s) + m), 0.0),
        axis=2,
    )
    lse = (m[:, :, 0] + jnp.log(jnp.sum(e, axis=2)))
    diff = cand - mu[:, None, :]
    dsig = jnp.einsum("btp,pq->btq", diff, siginv, precision=linalg.MODEL_PREC)
    quad = 0.5 * jnp.sum(diff * dsig, axis=2)
    return quad - ll + Nd[:, None] * lse


def _cg_batched(H, g, iters: int, bf16: bool = True):
    """Steihaug truncated CG for the whole chunk, fully unrolled.

    Pure batched matvecs — no lax loop, so the compiler sees
    straight-line code.  Freezes each lane at its first
    negative-curvature direction (descent guaranteed); Jacobi
    preconditioned with the abs-diagonal (safe for indefinite H).

    The repeated H reads dominate memory traffic (B*K^2*4 bytes per CG
    step); with ``bf16`` the matvec operand is bfloat16 (float32
    accumulate + float32 CG recurrences), halving that traffic — the
    direction is guarded by the Armijo sweep, so reduced matvec
    precision only perturbs the path, not the fixed point.
    """
    dinv = 1.0 / jnp.maximum(jnp.abs(_batch_diag(H)), 1e-20)
    Hm = H.astype(jnp.bfloat16) if bf16 else H
    r = -g
    z = dinv * r
    p = z
    rz = jnp.sum(r * z, axis=1)
    x = jnp.zeros_like(g)
    active = jnp.ones(g.shape[0], bool)
    for _ in range(iters):
        Ap = jnp.einsum("bij,bj->bi", Hm, p.astype(Hm.dtype),
                        preferred_element_type=jnp.float32)
        pAp = jnp.sum(p * Ap, axis=1)
        active = jnp.logical_and(active, pAp > 1e-30)
        alpha = rz / jnp.where(pAp > 1e-30, pAp, 1.0)
        am = active[:, None]
        x = jnp.where(am, x + alpha[:, None] * p, x)
        r = jnp.where(am, r - alpha[:, None] * Ap, r)
        z = dinv * r
        rz_new = jnp.sum(r * z, axis=1)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = jnp.where(am, z + beta[:, None] * p, p)
        rz = jnp.where(active, rz_new, rz)
    return x


def _batched_newton(beta_doc, counts, mu, eta0, siginv, cfg: NewtonConfig,
                    done0=None):
    """Damped Newton for a chunk.

    Returns (eta (B,K-1), n_iters (B,), done (B,)).  ``done`` is False
    only for docs that hit the ``max_iters`` cap while still improving
    (unconverged stragglers); each Newton step is a pure per-doc
    function of eta, so such docs can resume seamlessly in a later
    call with the remaining iteration budget (the two-pass schedule in
    :func:`run_estep`).  ``done0`` carries the prior call's done flags
    into such a resume — without it, docs that stopped on a line-search
    failure would re-attempt (and re-fail) the search once."""
    B, K, _ = beta_doc.shape
    if cfg.likelihood_temper != 1.0:
        # likelihood tempering (see NewtonConfig): the per-doc objective
        # is linear in counts (loglik and Nd*lse both scale), so scaling
        # the counts ONCE tempers f, g, H and the Armijo sweep uniformly
        counts = counts * jnp.asarray(cfg.likelihood_temper, counts.dtype)
    Nd = jnp.sum(counts, axis=1)
    cg_iters = min(cfg.cg_iters, K - 1)
    # step ladder 1, 1/2, 1/4, ...
    ts = jnp.exp2(-jnp.arange(cfg.max_backtracks, dtype=eta0.dtype))

    def cond(st):
        _eta, it, done, _n = st
        return jnp.logical_and(it < cfg.max_iters, ~jnp.all(done))

    def body(st):
        eta, it, done, n_iters = st
        f, g, H, _, _ = _f_g_H_batched(
            eta, beta_doc, counts, mu, siginv, Nd, cfg.bf16_hessian)
        conv = jnp.max(jnp.abs(g), axis=1) <= cfg.grad_tol

        p = _cg_batched(H, g, cg_iters, bf16=cfg.bf16_hessian)
        gTp = jnp.sum(g * p, axis=1)
        bad = gTp >= 0
        p = jnp.where(bad[:, None], -g, p)
        gTp = jnp.where(bad, -jnp.sum(g * g, axis=1), gTp)

        # parallel Armijo sweep: first (largest) acceptable step size
        fs = _f_multi(eta, p, ts, beta_doc, counts, mu, siginv, Nd)  # (B, T)
        ok = fs <= f[:, None] + 1e-4 * ts[None, :] * gTp[:, None]
        any_ok = jnp.any(ok, axis=1)
        # ts is descending, so the first acceptable step is the largest
        t = jnp.max(jnp.where(ok, ts[None, :], 0.0), axis=1)

        advance = jnp.logical_and(~done, ~conv)
        step = jnp.logical_and(advance, any_ok)
        eta = jnp.where(step[:, None], eta + t[:, None] * p, eta)
        n_iters = n_iters + advance.astype(jnp.int32)
        done = jnp.logical_or(done, jnp.logical_or(conv, ~any_ok))
        return (eta, it + 1, done, n_iters)

    st0 = (
        eta0,
        jnp.int32(0),
        jnp.zeros(B, bool) if done0 is None else done0,
        jnp.zeros(B, jnp.int32),
    )
    if cfg.fixed_iters:
        eta, _, done, n_iters = jax.lax.fori_loop(
            0, cfg.max_iters, lambda _, st: body(st), st0
        )
    else:
        eta, _, done, n_iters = jax.lax.while_loop(cond, body, st0)
    return eta, n_iters, done


def _make_pd_batched(M):
    """Batched diagonal-dominance repair (reference make_pd, stm.py:964-984)."""
    K = M.shape[-1]
    eye = jnp.eye(K, dtype=M.dtype)[None]
    dvec = jnp.diagonal(M, axis1=1, axis2=2)
    mag = jnp.sum(jnp.abs(M), axis=2) - jnp.abs(dvec)
    new_d = jnp.maximum(dvec, mag)
    return M * (1.0 - eye) + new_d[:, :, None] * eye


def _chol_pd_batched(H, jitter: float = 1e-5, chol_fn=jnp.linalg.cholesky,
                     rel_jitter: float = 1e-3):
    """Batched PD-repair Cholesky ladder (stm.py:1017-1050) + terminal rung.

    Rungs 1-3 are the reference's ladder: raw factor, make_pd repair,
    make_pd + fixed 1e-5 jitter.  Rung 4 goes beyond the reference: a
    SCALE-AWARE jitter (``rel_jitter`` x per-doc max|H|) for documents
    whose repaired matrix is so barely PD that finite-precision matmul
    error alone flips a pivot — the N=1M failure mode
    (tests/test_linalg_precision.py): at matrix scale ~50 the fixed
    1e-5 rung is 1000x below the bf16x3 product error, so the pre-fix
    ladder exhausted all rungs and returned NaN, silently poisoning nu
    -> sigma -> the whole fit.  rel_jitter=1e-3 sits ~100x above the
    Precision.HIGH error at ANY scale, making the ladder terminal in
    practice; it perturbs only documents that already failed three
    repair rungs.

    The repair rungs run under a scalar ``lax.cond``: at the converged
    eta the Hessian is almost always PD, so the common case pays for a
    single batched factorization.  ``chol_fn`` swaps the factorization
    (XLA's sequential-loop Cholesky vs :func:`~strutopy_tpu.ops.linalg.
    blocked_cholesky`); both signal non-PD input with NaNs.
    """
    K = H.shape[-1]
    L1 = chol_fn(H)
    ok1 = jnp.all(jnp.isfinite(L1.reshape(H.shape[0], -1)), axis=1)

    def repair(_):
        eye = jnp.eye(K, dtype=H.dtype)[None]
        H2 = _make_pd_batched(H)
        L2 = chol_fn(H2)
        ok2 = jnp.all(jnp.isfinite(L2.reshape(H.shape[0], -1)), axis=1)
        L3 = chol_fn(H2 + jitter * eye)
        ok3 = jnp.all(jnp.isfinite(L3.reshape(H.shape[0], -1)), axis=1)
        j4 = rel_jitter * jnp.max(jnp.abs(H2), axis=(1, 2))
        L4 = chol_fn(H2 + j4[:, None, None] * eye)
        fixed = jnp.where(ok2[:, None, None], L2,
                          jnp.where(ok3[:, None, None], L3, L4))
        return jnp.where(ok1[:, None, None], L1, fixed)

    return jax.lax.cond(jnp.all(ok1), lambda _: L1, repair, operand=None)


def _ns_inverse(H, iters: int = 18):
    """Batched symmetric-PD inverse by Newton-Schulz iteration.

    X_{k+1} = X_k (2I - H X_k) from X_0 = H / ||H||_1^2 — 2*iters
    batched (B, K, K) matmuls, no triangular solves.
    Quadratic convergence once ||I - H X|| < 1; 18 iterations cover
    cond(H) up to ~1e4 (the converged per-doc Hessians here are
    well-conditioned: Nd-scaled likelihood curvature + siginv).
    """
    n1 = jnp.max(jnp.sum(jnp.abs(H), axis=2), axis=1)
    X = H / (n1[:, None, None] ** 2)
    I2 = 2.0 * jnp.eye(H.shape[-1], dtype=H.dtype)[None]
    hi = linalg.MODEL_PREC  # nu is a model quantity: f32-exact
    for _ in range(iters):
        HX = jnp.einsum("bij,bjk->bik", H, X,
                        preferred_element_type=jnp.float32, precision=hi)
        X = jnp.einsum("bij,bjk->bik", X, I2 - HX,
                       preferred_element_type=jnp.float32, precision=hi)
    return X


def _finalize_chunk(eta, beta_doc, counts, mu, doc_w, siginv, sigmaentropy, Nd,
                    nu_method: str = "chol", chol_block: int = 0):
    """Per-doc nu / bound / phi / theta at the converged eta (float32)."""
    chol_block = chol_block or default_chol_block(eta.shape[-1])
    _f, _g, H, theta, phi_hat = _f_g_H_batched(
        eta, beta_doc, counts, mu, siginv, Nd, bf16=False
    )
    if nu_method == "blocked":
        # straight-line blocked factorization + log-depth triangular
        # inverse (ops/linalg.py): same math as the chol path, built
        # from batched einsums instead of XLA's sequential loops —
        # the (B, K-1, K-1) factorization is the finalize hot spot
        # (benchmarks/results_ablate_K100_V10000.json)
        L = _chol_pd_batched(
            H, chol_fn=functools.partial(blocked_cholesky, block=chol_block))
        nu = blocked_cho_inverse(L)
    else:
        L = _chol_pd_batched(H)
        if nu_method == "ns":
            # invert the (possibly PD-repaired) matrix L L^T, not the
            # raw H: matches the chol path's semantics and guarantees
            # NS convergence
            H_pd = jnp.einsum("bij,bkj->bik", L, L,
                              preferred_element_type=jnp.float32,
                              precision=linalg.MODEL_PREC)
            nu = _ns_inverse(H_pd)
        else:
            nu = jax.vmap(cho_inverse)(L)

    # per-doc ELBO, reference lower_bound (stm.py:1068-1101)
    eta_full = _pad_eta(eta)
    m = jnp.max(eta_full, axis=1, keepdims=True)
    e = jnp.exp(eta_full - m)
    # bound terms are model quantities: f32-exact products (the default
    # precision may round f32 operands to TF32 — see ops/linalg.py)
    hi = linalg.MODEL_PREC
    t_l = jnp.einsum("bk,bkl->bl", theta * e, beta_doc, precision=hi)
    t_l = jnp.maximum(t_l, jnp.asarray(1e-35, eta.dtype))
    cmask = counts > 0
    loglik = jnp.sum(
        jnp.where(cmask, counts * (jnp.log(t_l) + m), 0.0), axis=1
    )
    detTerm = -jnp.sum(jnp.log(jnp.diagonal(L, axis1=1, axis2=2)), axis=1)
    diff = eta - mu
    quad = 0.5 * jnp.sum(
        jnp.einsum("bi,ij->bj", diff, siginv, precision=hi) * diff, axis=1)
    bound = loglik + detTerm - quad - sigmaentropy

    phi = phi_hat * counts[:, None, :]  # (B, K, L) expected token-topic counts

    nu = doc_w[:, None, None] * nu
    bound = doc_w * bound
    phi = doc_w[:, None, None] * phi
    return theta, nu, bound, phi


# ---------------------------------------------------------------------------
# single-doc wrapper (tests / reference-parity checks)
# ---------------------------------------------------------------------------


def _doc_estep(beta_doc, counts, mu, eta0, doc_w, siginv, sigmaentropy, cfg: NewtonConfig):
    """E-step for ONE document. Returns (eta, theta, nu, bound, phi, n_iters)."""
    bd = beta_doc[None]
    c = counts[None]
    eta, n_iters, _ = _batched_newton(bd, c, mu[None], eta0[None], siginv, cfg)
    Nd = jnp.sum(c, axis=1)
    theta, nu, bound, phi = _finalize_chunk(
        eta, bd, c, mu[None], jnp.asarray([doc_w], eta.dtype), siginv,
        sigmaentropy, Nd, nu_method=cfg.nu_method, chol_block=cfg.chol_block,
    )
    return eta[0], theta[0], nu[0], bound[0], phi[0], n_iters[0]


def _f_g_H(eta, beta_doc, counts, mu, siginv, Nd, bf16: bool = False):
    """Single-doc objective/gradient/Hessian (test surface)."""
    f, g, H, theta, phi_hat = _f_g_H_batched(
        eta[None], beta_doc[None], counts[None], mu[None], siginv,
        jnp.asarray(Nd)[None], bf16,
    )
    return f[0], g[0], H[0], theta[0], phi_hat[0]


# ---------------------------------------------------------------------------
# chunked scan over the (local shard of the) corpus
# ---------------------------------------------------------------------------


def _local_word_ids(words, V_local, vocab_axis):
    """Map global word ids onto this device's vocab shard.

    Returns (local ids clamped into [0, V_local), ownership mask).
    Vocab shards hold contiguous [i*V_local, (i+1)*V_local) slices —
    the layout `device_put(beta, P(None, VOCAB_AXIS))` produces.
    """
    lo = jax.lax.axis_index(vocab_axis) * V_local
    wl = words - lo
    ok = (wl >= 0) & (wl < V_local)
    return jnp.where(ok, wl, 0), ok


def _gather_beta(beta, words, aspects, vocab_axis=None):
    """Gather per-doc topic-word slices -> (B, K, L).

    With ``vocab_axis`` set, ``beta`` is this device's (K, V/nv) vocab
    shard: each shard gathers the columns it owns (zeros elsewhere) and
    one ``psum`` over the vocab axis assembles the full (B, K, L) block
    — the vocab-parallel-embedding pattern, and the only per-chunk
    vocab collective on the E-step hot path (the Newton loop then runs
    on the assembled block, replicated across vocab shards).
    """
    if vocab_axis is not None:
        words, ok = _local_word_ids(words, beta.shape[-1], vocab_axis)
    if beta.ndim == 2:
        bd = jnp.transpose(jnp.take(beta, words, axis=1), (1, 0, 2))
    else:
        bd = jax.vmap(lambda a, w: jnp.take(beta[a], w, axis=1))(aspects, words)
    if vocab_axis is not None:
        bd = jnp.where(ok[:, None, :], bd, jnp.zeros((), bd.dtype))
        bd = jax.lax.psum(bd, vocab_axis)
    return bd


def _scatter_phi(beta_ss, phi, words, aspects, vocab_axis=None):
    """beta_ss[(aspect,) :, words] += phi for a whole chunk at once.

    With ``vocab_axis`` set, each device scatters only the words its
    vocab shard owns — beta_ss stays vocab-sharded with NO collective
    (the doc-axis psum of beta_ss happens once per EM iteration)."""
    B, K, L = phi.shape
    if vocab_axis is not None:
        words, ok = _local_word_ids(words, beta_ss.shape[-1], vocab_axis)
        phi = jnp.where(ok[:, None, :], phi, jnp.zeros((), phi.dtype))
    phi_flat = jnp.transpose(phi, (1, 0, 2)).reshape(K, B * L)
    if beta_ss.ndim == 2:
        idx = words.reshape(B * L)
        return beta_ss.at[:, idx].add(phi_flat)
    A, _, V = beta_ss.shape
    flat = jnp.transpose(beta_ss, (1, 0, 2)).reshape(K, A * V)
    idx = (aspects[:, None] * V + words).reshape(B * L)
    flat = flat.at[:, idx].add(phi_flat)
    return jnp.transpose(flat.reshape(K, A, V), (1, 0, 2))


def _two_pass_estep(
    beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok,
    cfg: NewtonConfig, B: int, pass1_iters: int, straggler_frac: float,
    vocab_axis, scan_unroll: int = 1,
) -> EStepResult:
    """Two-pass difficulty schedule (TODO r1: the 1.45x straggler bound).

    The batched while_loop runs every chunk to its WORST doc's Newton
    count; difficulty-sorting by stale counts only partly helps.  Here:
      pass 1  caps all chunks at ``pass1_iters`` steps;
      pass 2  densely regroups the unconverged docs (a static
              ``straggler_frac`` budget) and runs them to convergence
              with the remaining iteration budget;
      pass 3  finalizes (nu/bound/phi scatter) every doc in storage
              order.
    Each Newton step is a pure per-doc function of eta (per-doc Armijo,
    fixed CG count), so splitting/regrouping reproduces the single-pass
    trajectories exactly; only the f32 scatter order differs.  Docs
    beyond the straggler budget keep their pass-1 eta — same semantics
    as hitting ``max_iters`` (the budget is sized to make this rare;
    ``newton_iters`` records it when it happens).
    """
    N, L = words.shape
    C = N // B
    K = beta.shape[-2]
    Km1 = K - 1

    def chunked(x):
        return x.reshape((C, B) + x.shape[1:])

    def newton_scan(cfg_p, w_s, c_s, mu_s, eta_s, asp_s, done_s=None):
        def fn(_, chunk):
            w, c, mu_c, eta_c, asp, d0 = chunk
            bd = _gather_beta(beta, w, asp, vocab_axis)
            if cfg.bf16_beta:
                bd = bd.astype(jnp.bfloat16)
            eta, it, done = _batched_newton(
                bd, c, mu_c, eta_c, siginv, cfg_p, done0=d0
            )
            return None, (eta, it, done)

        if done_s is None:
            done_s = jnp.zeros(w_s.shape[:2], bool)
        _, (eta, it, done) = jax.lax.scan(
            fn, None, (w_s, c_s, mu_s, eta_s, asp_s, done_s),
            unroll=scan_unroll,
        )
        n = w_s.shape[0] * B
        return eta.reshape(n, Km1), it.reshape(n), done.reshape(n)

    # ----- pass 1: capped Newton over all docs -----
    cfg1 = cfg._replace(max_iters=min(pass1_iters, cfg.max_iters))
    eta, iters, done = newton_scan(
        cfg1, chunked(words), chunked(counts), chunked(mu), chunked(eta0),
        chunked(aspects),
    )

    # ----- pass 2: densely packed stragglers, remaining budget -----
    rest = cfg.max_iters - cfg1.max_iters
    M = min(max(-(-int(straggler_frac * N) // B) * B, B), N)
    # rest == 0 (pass1_iters >= max_iters, direct callers only) means
    # the trajectory is exactly the single-pass one: docs that hit
    # max_iters are NOT budget overflow — the single-pass path reports
    # 0 for the identical computation, and raising straggler_frac
    # could not help since no pass-2 budget exists
    overflow = (
        jnp.sum((~done) & doc_ok).astype(jnp.int32)
        if rest > 0 else jnp.int32(0)
    )
    if rest > 0 and M > 0:
        cfg2 = cfg._replace(max_iters=rest)
        # ascending sort: unconverged (False=0) docs pack to the front
        idx = jnp.argsort(done)[:M]
        # unconverged real docs the budget could NOT admit stay at their
        # pass-1 eta — surfaced so callers can raise straggler_frac
        # (ADVICE r2: silent under-convergence when >frac of docs need
        # more than pass1_iters steps at steady state)
        selected = jnp.zeros((N,), bool).at[idx].set(True)
        overflow = jnp.sum((~done) & (~selected) & doc_ok).astype(jnp.int32)
        eta2, it2, _ = newton_scan(
            cfg2,
            words[idx].reshape(M // B, B, L),
            counts[idx].reshape(M // B, B, L),
            mu[idx].reshape(M // B, B, Km1),
            eta[idx].reshape(M // B, B, Km1),
            aspects[idx].reshape(M // B, B),
            done[idx].reshape(M // B, B),
        )
        eta = eta.at[idx].set(eta2)
        iters = iters.at[idx].add(it2)

    # ----- pass 3: finalize + scatter in storage order -----
    beta_ss0 = jnp.zeros(beta.shape, beta.dtype)
    sigma_ss0 = jnp.zeros((Km1, Km1), beta.dtype)

    def fin(carry, chunk):
        beta_ss, sigma_ss = carry
        w, c, mu_c, eta_c, asp, ok = chunk
        doc_w = ok.astype(beta.dtype)
        bd = _gather_beta(beta, w, asp, vocab_axis)
        theta, nu, bound_d, phi = _finalize_chunk(
            eta_c, bd, c, mu_c, doc_w, siginv, sigmaentropy,
            jnp.sum(c, axis=1), nu_method=cfg.nu_method,
            chol_block=cfg.chol_block,
        )
        beta_ss = _scatter_phi(beta_ss, phi, w, asp, vocab_axis)
        return (beta_ss, sigma_ss + jnp.sum(nu, axis=0)), (theta, jnp.sum(bound_d))

    (beta_ss, sigma_ss), (theta, bounds) = jax.lax.scan(
        fin,
        (beta_ss0, sigma_ss0),
        (chunked(words), chunked(counts), chunked(mu), chunked(eta),
         chunked(aspects), chunked(doc_ok)),
        unroll=scan_unroll,
    )
    return EStepResult(
        beta_ss=beta_ss,
        sigma_ss=sigma_ss,
        bound=jnp.sum(bounds),
        eta=eta,
        theta=theta.reshape(N, K),
        newton_iters=iters,
        straggler_overflow=overflow,
    )


def _two_pass_fused_estep(
    beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects, doc_ok,
    cfg: NewtonConfig, B: int, pass1_iters: int, straggler_frac: float,
    vocab_axis, scan_unroll: int = 1,
) -> EStepResult:
    """Fused two-pass schedule: the finalize rides the Newton gathers.

    Identical per-doc Newton trajectories to :func:`_two_pass_estep`
    (pass 1 capped at ``pass1_iters``, stragglers densely regrouped),
    but nu/bound/phi are computed inside the SAME scan chunk that
    already holds the gathered ``beta_doc``:

      pass 1    capped Newton + finalize of the docs that CONVERGED;
      pass 2    straggler Newton + finalize of every doc pass 1 left
                unfinalized (converged or not — budget exhaustion
                finalizes at the current eta, like single-pass);
      fallback  if the straggler budget overflowed (rare — the budget
                is sized against it), one ``lax.cond``-guarded masked
                finalize sweep covers the overflow docs at their
                pass-1 eta.

    vs the unfused schedule this removes pass 3's full (B, K, L)
    beta_doc re-gather — the third full memory sweep of the E-step — at
    the cost of re-finalizing the straggler fraction.  Sufficient
    statistics accumulate in a different f32 summation order (the same
    acceptance as two-pass vs single-pass).  The ``lax.cond`` is
    collective-safe under a 2-D mesh: Newton runs on the
    vocab-psum-assembled beta_doc, so ``done`` — and hence the
    predicate — is replicated along the vocab axis, and run_estep has
    no doc-axis collectives (the doc psum happens in parallel/sharding
    after it returns), so doc-shard divergence cannot deadlock.
    """
    N, L = words.shape
    C = N // B
    K = beta.shape[-2]
    Km1 = K - 1

    def chunked(x):
        return x.reshape((C, B) + x.shape[1:])

    cfg1 = cfg._replace(max_iters=min(pass1_iters, cfg.max_iters))
    rest = cfg.max_iters - cfg1.max_iters

    beta_ss0 = jnp.zeros(beta.shape, beta.dtype)
    sigma_ss0 = jnp.zeros((Km1, Km1), beta.dtype)

    def make_pass(cfg_p, fin_converged_only: bool):
        def fn(carry, chunk):
            beta_ss, sigma_ss = carry
            w, c, mu_c, eta_c, asp, ok, d0 = chunk
            bd = _gather_beta(beta, w, asp, vocab_axis)
            bd_loop = bd.astype(jnp.bfloat16) if cfg.bf16_beta else bd
            eta, it, done = _batched_newton(
                bd_loop, c, mu_c, eta_c, siginv, cfg_p, done0=d0
            )
            # pass 1 finalizes the converged docs; pass 2 finalizes
            # exactly the docs pass 1 did not (~d0), converged or not
            fin = (done if fin_converged_only else ~d0) & ok
            theta, nu, bound_d, phi = _finalize_chunk(
                eta, bd, c, mu_c, fin.astype(beta.dtype), siginv,
                sigmaentropy, jnp.sum(c, axis=1),
                nu_method=cfg.nu_method, chol_block=cfg.chol_block,
            )
            beta_ss = _scatter_phi(beta_ss, phi, w, asp, vocab_axis)
            return (beta_ss, sigma_ss + jnp.sum(nu, axis=0)), (
                eta, theta, it, done, jnp.sum(bound_d))
        return fn

    # ----- pass 1: capped Newton + finalize of the converged docs -----
    (beta_ss, sigma_ss), (eta, theta, iters, done, bounds) = jax.lax.scan(
        make_pass(cfg1, True),
        (beta_ss0, sigma_ss0),
        (chunked(words), chunked(counts), chunked(mu), chunked(eta0),
         chunked(aspects), chunked(doc_ok), jnp.zeros((C, B), bool)),
        unroll=scan_unroll,
    )
    eta = eta.reshape(N, Km1)
    theta = theta.reshape(N, K)
    iters = iters.reshape(N)
    done = done.reshape(N)
    bound = jnp.sum(bounds)

    # ----- pass 2: densely packed stragglers + their finalize -----
    cfg2 = cfg._replace(max_iters=rest)
    M = min(max(-(-int(straggler_frac * N) // B) * B, B), N)
    idx = jnp.argsort(done)[:M]
    selected = jnp.zeros((N,), bool).at[idx].set(True)
    over = (~done) & (~selected) & doc_ok
    overflow = jnp.sum(over).astype(jnp.int32)
    (beta_ss, sigma_ss), (eta2, theta2, it2, _d2, bounds2) = jax.lax.scan(
        make_pass(cfg2, False),
        (beta_ss, sigma_ss),
        (words[idx].reshape(M // B, B, L),
         counts[idx].reshape(M // B, B, L),
         mu[idx].reshape(M // B, B, Km1),
         eta[idx].reshape(M // B, B, Km1),
         aspects[idx].reshape(M // B, B),
         doc_ok[idx].reshape(M // B, B),
         done[idx].reshape(M // B, B)),
        unroll=scan_unroll,
    )
    fin2 = ~done[idx]
    # eta2 rows of already-converged fillers are frozen by done0, so an
    # unconditional set matches the unfused schedule bitwise; theta only
    # overwrites what pass 2 actually finalized (pass-1 rows stay put)
    eta = eta.at[idx].set(eta2.reshape(M, Km1))
    theta = theta.at[idx].set(
        jnp.where(fin2[:, None], theta2.reshape(M, K), theta[idx])
    )
    iters = iters.at[idx].add(it2.reshape(M))
    bound = bound + jnp.sum(bounds2)

    # ----- overflow fallback: finalize budget-overflow docs at their
    # pass-1 eta (what _two_pass_estep's pass 3 does for them) -----
    def over_fin(_):
        def fn(carry, chunk):
            b_ss, s_ss, bnd = carry
            w, c, mu_c, eta_c, asp, m = chunk
            bd = _gather_beta(beta, w, asp, vocab_axis)
            _th, nu, bound_d, phi = _finalize_chunk(
                eta_c, bd, c, mu_c, m.astype(beta.dtype), siginv,
                sigmaentropy, jnp.sum(c, axis=1),
                nu_method=cfg.nu_method, chol_block=cfg.chol_block,
            )
            b_ss = _scatter_phi(b_ss, phi, w, asp, vocab_axis)
            return (b_ss, s_ss + jnp.sum(nu, axis=0),
                    bnd + jnp.sum(bound_d)), None
        (b_ss, s_ss, bnd), _ = jax.lax.scan(
            fn,
            (jnp.zeros_like(beta_ss0), sigma_ss0,
             jnp.zeros((), beta.dtype)),
            (chunked(words), chunked(counts), chunked(mu), chunked(eta),
             chunked(aspects), chunked(over)),
        )
        return b_ss, s_ss, bnd

    def no_over(_):
        return (jnp.zeros_like(beta_ss0), sigma_ss0,
                jnp.zeros((), beta.dtype))

    d_beta, d_sigma, d_bound = jax.lax.cond(overflow > 0, over_fin, no_over, None)
    return EStepResult(
        beta_ss=beta_ss + d_beta,
        sigma_ss=sigma_ss + d_sigma,
        bound=bound + d_bound,
        eta=eta,
        theta=theta,
        newton_iters=iters,
        straggler_overflow=overflow,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "batch_size", "vocab_axis",
        "pass1_iters", "straggler_frac", "scan_unroll", "fused_finalize",
    ),
)
def run_estep(
    beta,
    mu,
    eta0,
    siginv,
    sigmaentropy,
    words,
    counts,
    aspects,
    doc_ok,
    cfg: NewtonConfig = NewtonConfig(),
    batch_size: int = 1024,
    vocab_axis=None,
    pass1_iters: int = 0,
    straggler_frac: float = 0.3,
    scan_unroll: int = 1,
    fused_finalize: bool = False,
) -> EStepResult:
    """E-step over a (shard of a) corpus.

    Args:
      beta: (K, V) or (A, K, V) topic-word distributions; with
        ``vocab_axis`` set (inside shard_map over a 2-D mesh), the
        local (..., V/nv) vocab shard, and the returned beta_ss is the
        matching shard.
      mu: (N, K-1) prior means; eta0: (N, K-1) warm starts.
      siginv, sigmaentropy: from :func:`precompute_sigma`.
      words/counts: (N, L) padded corpus arrays (device).
      aspects: (N,) int32 content-covariate levels (zeros if unused).
      doc_ok: (N,) bool mask; False rows are padding documents.
      batch_size: docs per scan chunk; N must be a multiple
        (callers pad with dummy docs).
      pass1_iters: >0 enables the two-pass difficulty schedule
        (:func:`_two_pass_estep`).
      fused_finalize: with the two-pass schedule, fuse the finalize
        into passes 1 and 2 (:func:`_two_pass_fused_estep`), removing
        pass 3's full beta_doc re-gather.  No-op when pass1_iters is 0
        or leaves no pass-2 budget (the unfused path already finalizes
        inline with the only pass there is).
    """
    N, L = words.shape
    B = min(batch_size, N)
    if N % B != 0:
        raise ValueError(f"N={N} must be a multiple of batch_size={B}; pad the corpus")
    if pass1_iters:
        impl = (
            _two_pass_fused_estep
            if fused_finalize and cfg.max_iters > pass1_iters
            else _two_pass_estep
        )
        return impl(
            beta, mu, eta0, siginv, sigmaentropy, words, counts, aspects,
            doc_ok, cfg, B, pass1_iters, straggler_frac, vocab_axis,
            scan_unroll,
        )
    C = N // B
    K = beta.shape[-2]

    chunks = (
        words.reshape(C, B, L),
        counts.reshape(C, B, L),
        mu.reshape(C, B, K - 1),
        eta0.reshape(C, B, K - 1),
        aspects.reshape(C, B),
        doc_ok.reshape(C, B),
    )

    beta_ss0 = jnp.zeros(beta.shape, beta.dtype)
    sigma_ss0 = jnp.zeros((K - 1, K - 1), beta.dtype)

    def chunk_fn(carry, chunk):
        beta_ss, sigma_ss = carry
        w, c, mu_c, eta_c, asp, ok = chunk
        doc_w = ok.astype(beta.dtype)
        beta_doc = _gather_beta(beta, w, asp, vocab_axis)
        Nd = jnp.sum(c, axis=1)
        bd_loop = beta_doc.astype(jnp.bfloat16) if cfg.bf16_beta else beta_doc
        eta, iters, _ = _batched_newton(bd_loop, c, mu_c, eta_c, siginv, cfg)
        theta, nu, bound_d, phi = _finalize_chunk(
            eta, beta_doc, c, mu_c, doc_w, siginv, sigmaentropy, Nd,
            nu_method=cfg.nu_method, chol_block=cfg.chol_block,
        )
        beta_ss = _scatter_phi(beta_ss, phi, w, asp, vocab_axis)
        sigma_ss = sigma_ss + jnp.sum(nu, axis=0)
        return (beta_ss, sigma_ss), (eta, theta, jnp.sum(bound_d), iters)

    (beta_ss, sigma_ss), (eta, theta, bounds, iters) = jax.lax.scan(
        chunk_fn, (beta_ss0, sigma_ss0), chunks, unroll=scan_unroll
    )
    return EStepResult(
        beta_ss=beta_ss,
        sigma_ss=sigma_ss,
        bound=jnp.sum(bounds),
        eta=eta.reshape(N, K - 1),
        theta=theta.reshape(N, K),
        newton_iters=iters.reshape(N),
    )
