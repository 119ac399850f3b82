"""Spectral (anchor-word) initialization, Arora et al. 2013.

Reference: spectral_init / create_dtm / gram / fastAnchor / recover_l2
(src/modules/stm.py:30-296).  Device redesign:

  * the Gram matrix Q = H~^T H~ - H^ is accumulated as chunked dense
    (B, V') matmuls via ``lax.scan`` over document chunks
    (reference: scipy sparse matmul, stm.py:122-157); under a document
    mesh the per-shard partial Q simply psums;
  * fastAnchor's greedy K iterations run in a ``lax.fori_loop`` over the
    dense Q with a mask vector instead of in-place basis zeroing
    (reference: sparse-to-dense python loop, stm.py:160-226);
  * RecoverL2 is solved as a *batched NNLS*: the reference calls a
    quadprog QP per word with G=I, h=0 and flips the sign of the
    solution (stm.py:271-285) — substituting z = -x shows this is
    exactly ``min_{z>=0} 0.5 z^T M M^T z - (M q_i)^T z``, i.e.
    non-negative least squares, which a vmapped projected-gradient
    (FISTA) solver handles for all V' words at once with no QP library.

Deviations (PARITY_NOTES.md): the final re-expanded beta is
row-normalized per topic; the reference normalizes by the *global* sum
(stm.py:83), leaving rows summing to ~1/K — the E-step objective is
invariant to row scaling (absorbed by eta), so only the normalization
convention differs.  Q is UNNORMALIZED by default (``gram_norm="none"``)
— the reference's actual behavior: its sklearn ``normalize(Q,
copy=False)`` call (stm.py:155) receives a CSC matrix, normalizes a
converted csr COPY, and the return value is discarded.  The l1
(row-sum) variant its docstring describes measured 0.8-1.1 nats worse
end-to-end (results_quality_h2h_spectral.json /
results_spectral_init_diag.json).
"""

from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from strutopy_tpu.corpus.bow import PaddedCorpus, pad_corpus

logger = logging.getLogger(__name__)


def _gram_accum(words, counts, n_chunks: int, Vp: int):
    """Per-shard partial sums of the Gram statistics, chunked.

    Returns (sum_d outer(h~_d, h~_d), sum_d dtm_d / div_d) — plain sums
    over documents, so document shards combine with one psum.
    """
    N, L = words.shape
    B = N // n_chunks
    w_chunks = words.reshape(n_chunks, B, L)
    c_chunks = counts.reshape(n_chunks, B, L)

    def chunk_fn(carry, chunk):
        Q, hhat = carry
        w, c = chunk
        nd = jnp.sum(c, axis=1)  # (B,)
        div = nd * (nd - 1.0)
        inv_div = jnp.where(div > 0, 1.0 / jnp.maximum(div, 1e-30), 0.0)
        rows = jnp.zeros((B, Vp), c.dtype)
        rows = rows.at[jnp.arange(B)[:, None], w].add(c)
        htilde = rows * jnp.sqrt(inv_div)[:, None]
        Q = Q + htilde.T @ htilde
        hhat = hhat + jnp.sum(rows * inv_div[:, None], axis=0)
        return (Q, hhat), None

    Q0 = jnp.zeros((Vp, Vp), counts.dtype)
    h0 = jnp.zeros((Vp,), counts.dtype)
    (Q, hhat), _ = jax.lax.scan(chunk_fn, (Q0, h0), (w_chunks, c_chunks))
    return Q, hhat


def _gram_finish(Q, hhat, norm: str = "none"):
    """Subtract the diagonal correction and (optionally) normalize rows.

    ``norm="none"`` returns the raw Gram — the reference's ACTUAL
    behavior: its ``gram`` builds Q as a scipy CSC matrix and calls
    sklearn ``normalize(Q, copy=False)`` (stm.py:155), which converts
    CSC to a NEW csr copy, normalizes the copy, and returns it — but
    the reference discards the return value and hands the ORIGINAL,
    never-normalized Q to fastAnchor/recover_l2.  ``norm="l1"`` divides
    rows by their sums (the Arora et al. / R-stm conditional-
    distribution semantics the reference's docstring *describes*);
    ``norm="l2"`` is what its sklearn call *would* do if the result
    were kept.  The choice moves anchors and recovery: with l1 the
    wiki/synth spectral h2h measured 0.8-1.1 nats WORSE heldout than
    the reference's unnormalized Q (results_quality_h2h_spectral.json;
    max |Q_l1 - Q_ref| = 0.68, 13/50 different wiki anchors —
    results_spectral_init_diag.json), so "none" is the default.
    """
    Q = Q - jnp.diag(hhat)
    row_sums = jnp.sum(Q, axis=1, keepdims=True)
    if norm == "l1":
        Q = Q / jnp.maximum(row_sums, 1e-30)
    elif norm == "l2":
        Q = Q / jnp.maximum(
            jnp.sqrt(jnp.sum(Q * Q, axis=1, keepdims=True)), 1e-30)
    return Q, row_sums[:, 0]


@functools.partial(jax.jit, static_argnames=("n_chunks", "Vp", "norm"))
def _gram_scan(words, counts, n_chunks: int, Vp: int, norm: str = "none"):
    """Q = sum_d outer(h_d, h_d) - diag(sum_d dtm_d / div_d), chunked.

    words/counts: (N, L) already remapped to the filtered vocab
    (dropped terms have count 0); documents with < 2 tokens must have
    all-zero counts.
    """
    return _gram_finish(*_gram_accum(words, counts, n_chunks, Vp), norm=norm)


def _gram_scan_sharded(mesh, words_f, counts_f, B: int, Vp: int,
                       norm: str = "none"):
    """Gram matrix over a document mesh (SURVEY §2.5 item 2): each
    device scans its document shard and the (Vp, Vp) partial sums psum
    once across devices; the normalization runs replicated.

    Pads the document count to a multiple of mesh_size * B (padding
    rows have zero counts, contributing nothing to either sum).
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from strutopy_tpu.parallel.mesh import DOC_AXIS

    n_dev = mesh.shape[DOC_AXIS]
    N = words_f.shape[0]
    gran = n_dev * B
    N_pad = -(-N // gran) * gran
    if N_pad != N:
        words_f = np.pad(words_f, ((0, N_pad - N), (0, 0)))
        counts_f = np.pad(counts_f, ((0, N_pad - N), (0, 0)))
    n_chunks = (N_pad // n_dev) // B

    def local(w, c):
        Q, hhat = _gram_accum(w, c, n_chunks, Vp)
        return jax.lax.psum(Q, DOC_AXIS), jax.lax.psum(hhat, DOC_AXIS)

    doc = P(DOC_AXIS)
    sharded = jax.jit(jax.shard_map(
        local, mesh=mesh, in_specs=(doc, doc), out_specs=(P(), P()),
        check_vma=False,
    ))
    sh = NamedSharding(mesh, doc)
    # device_put the host arrays with the sharding directly so each
    # device receives only its slice; jnp.asarray first would stage the
    # full (N, L) corpus on the default device (~1 GB at N=1M, L=256 —
    # a per-device memory spike equal to the unsharded problem).
    Q, hhat = sharded(
        jax.device_put(words_f, sh),
        jax.device_put(counts_f, sh),
    )
    return jax.jit(functools.partial(_gram_finish, norm=norm))(Q, hhat)


@functools.partial(jax.jit, static_argnames=("K",))
def fast_anchor(Q, K: int):
    """Greedy anchor selection (reference fastAnchor, stm.py:160-226)."""
    Vp = Q.shape[0]

    def body(i, carry):
        Q, basis, used = carry
        rss = jnp.sum(Q * Q, axis=0) * (1.0 - used)
        maxind = jnp.argmax(rss)
        maxval = jnp.maximum(rss[maxind], 1e-30)
        q_row = Q[maxind] / jnp.sqrt(maxval)
        Q = Q.at[maxind].set(q_row)
        inner = Q @ q_row  # (Vp,)
        used = used.at[maxind].set(1.0)
        # subtract the projection, keeping all previously chosen
        # basis rows (incl. the current one) intact
        project = (inner * (1.0 - used))[:, None] * q_row[None, :]
        Q = Q - project
        basis = basis.at[i].set(maxind)
        return (Q, basis, used)

    basis0 = jnp.zeros((K,), jnp.int32)
    used0 = jnp.zeros((Vp,), Q.dtype)
    _, basis, _ = jax.lax.fori_loop(0, K, body, (Q, basis0, used0))
    return basis


@functools.partial(jax.jit, static_argnames=("iters",))
def recover_l2(Q, anchor, wprob, iters: int = 500):
    """Batched NNLS recovery of p(w|z) (reference recover_l2, stm.py:229-296).

    For every word i: z_i = argmin_{z>=0} ||M^T z - Q_i||^2 with
    M = Q[anchor] (K, Vp); anchors get one-hot rows; then Bayes-invert
    p(z|w) -> p(w|z) with the empirical word probabilities.
    """
    Vp = Q.shape[0]
    K = anchor.shape[0]
    M = Q[anchor]  # (K, Vp)
    P = M @ M.T  # (K, K)
    Qt = M @ Q.T  # (K, Vp): column i is M @ Q_i

    # Lipschitz constant via power iteration
    def power_body(_, v):
        v = P @ v
        return v / jnp.maximum(jnp.linalg.norm(v), 1e-30)

    v = jax.lax.fori_loop(0, 64, power_body, jnp.ones((K,), Q.dtype) / np.sqrt(K))
    lam = jnp.maximum(jnp.dot(v, P @ v), 1e-30)
    step = 1.0 / lam

    def fista_body(_, carry):
        Z, Y, t = carry
        G = P @ Y - Qt  # (K, Vp)
        Z_new = jnp.maximum(Y - step * G, 0.0)
        t_new = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        Y_new = Z_new + ((t - 1.0) / t_new) * (Z_new - Z)
        return (Z_new, Y_new, t_new)

    Z0 = jnp.zeros((K, Vp), Q.dtype)
    Z, _, _ = jax.lax.fori_loop(
        0, iters, fista_body, (Z0, Z0, jnp.asarray(1.0, Q.dtype))
    )

    # anchors: one-hot p(z|w)
    onehot = jax.nn.one_hot(jnp.arange(K), K, dtype=Q.dtype)  # (K, K)
    Z = Z.at[:, anchor].set(onehot.T)

    weights = Z.T  # (Vp, K) = p(z | w)
    A = weights * wprob[:, None]  # p(z|w) p(w)
    A = A / jnp.maximum(jnp.sum(A, axis=0, keepdims=True), 1e-30)  # (Vp, K)
    return A.T  # (K, Vp) = p(w | z)


def spectral_init(
    corpus,
    K: int,
    V: int | None = None,
    maxV: int = 5000,
    verbose: bool = False,
    dtype=jnp.float32,
    mesh=None,
    gram_norm: str = "none",
) -> np.ndarray:
    """Deterministic anchor-word beta initialization (K, V).

    Accepts BoW lists or a :class:`PaddedCorpus`.  Mirrors reference
    spectral_init (stm.py:30-84): top-``maxV`` frequency filter, Gram
    matrix, greedy anchors, L2 recovery, re-expansion with a
    ``0.001/V`` pseudocount.

    With ``mesh`` (a 1-D document mesh), the N-dependent stage — the
    Gram accumulation — runs document-sharded with one (Vp, Vp) psum;
    anchor finding and L2 recovery are O(Vp^2) and run replicated.

    ``gram_norm``: row normalization of Q — ``"none"`` (the reference's
    actual behavior: its sklearn normalize call mutates a discarded
    copy, default), ``"l1"`` (the Arora / R-stm conditional-
    distribution semantics) or ``"l2"``.  See ``_gram_finish``.
    """
    if not isinstance(corpus, PaddedCorpus):
        corpus = pad_corpus(corpus, V=V)
    V = corpus.V if V is None else V

    wcounts = corpus.word_counts()
    wprob = wcounts / max(wcounts.sum(), 1e-300)
    keep = np.argsort(-wprob)[: min(maxV, V)]
    Vp = len(keep)

    # remap term ids into the filtered vocab; drop the rest
    lookup = np.full(V, -1, np.int64)
    lookup[keep] = np.arange(Vp)
    words_f = lookup[np.minimum(corpus.words, V - 1)]
    counts_f = np.where(words_f >= 0, corpus.counts, 0.0).astype(np.float32)
    words_f = np.maximum(words_f, 0).astype(np.int32)

    # mask documents with < 2 surviving tokens (the reference would
    # divide by zero and asserts positive Q row sums instead)
    nd = counts_f.sum(axis=1)
    ok = nd >= 2
    if verbose and (~ok).sum():
        logger.info("spectral_init: dropping %d short documents", int((~ok).sum()))
    counts_f = counts_f * ok[:, None]

    # pad docs to a chunking-friendly multiple
    N = words_f.shape[0]
    B = min(1024, N)
    if mesh is not None:
        # honor the dtype parameter (the non-mesh branch casts inside
        # jnp.asarray); counts_f is float32 host-side by construction
        Q, row_sums = _gram_scan_sharded(
            mesh, words_f, counts_f.astype(dtype), B, Vp, norm=gram_norm
        )
    else:
        n_chunks = -(-N // B)
        N_pad = n_chunks * B
        if N_pad != N:
            words_f = np.pad(words_f, ((0, N_pad - N), (0, 0)))
            counts_f = np.pad(counts_f, ((0, N_pad - N), (0, 0)))
        Q, row_sums = _gram_scan(
            jnp.asarray(words_f), jnp.asarray(counts_f, dtype), n_chunks, Vp,
            norm=gram_norm,
        )
    if verbose:
        logger.info("spectral_init: gram done, finding %d anchors", K)
    anchor = fast_anchor(Q, K)
    beta_p = recover_l2(Q, anchor, jnp.asarray(wprob[keep], dtype))
    beta_p = np.asarray(beta_p, np.float64)

    beta = np.zeros((K, V))
    beta[:, keep] = beta_p
    beta = beta + 0.001 / V
    beta = beta / beta.sum(axis=1, keepdims=True)
    return beta
