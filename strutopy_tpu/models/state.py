"""Model state pytree.

The reference scatters model state across mutable ``STM`` instance
attributes (reference src/modules/stm.py:402-486).  Here the state is a
single immutable pytree so the whole EM step can be jitted / sharded /
checkpointed as one value.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp


class STMState(NamedTuple):
    """Global + per-document variational state of an STM fit.

    Shapes (K topics, V vocab, N docs, P design columns, A aspects):
      beta:  (K, V) or (A, K, V) topic-word distributions
      mu:    (N, K-1) prevalence prior means
      sigma: (K-1, K-1) prevalence prior covariance
      eta:   (N, K-1) variational means
      theta: (N, K)   simplex-mapped eta
      gamma: (K-1, P) prevalence coefficients (zeros for CTM)
      kappa: (P_kappa, V) content-model coefficients (empty if lda_beta)
    """

    beta: jax.Array
    mu: jax.Array
    sigma: jax.Array
    eta: jax.Array
    theta: jax.Array
    gamma: jax.Array
    kappa: jax.Array
    bound: jax.Array  # scalar ELBO of the last E-step
    opt_iters: jax.Array  # (N,) int32: Newton iterations per doc last E-step
    # (drives difficulty-sorted chunking: docs with similar convergence
    # cost share scan chunks, so easy chunks exit the batched while_loop
    # early instead of running to the slowest doc's count)
    # scalar int32: docs left at their pass-1 eta because the two-pass
    # straggler budget overflowed (newton_straggler_frac too small for
    # this corpus's difficulty distribution); 0 when the schedule is off
    straggler_overflow: jax.Array = 0


def init_state(
    key: jax.Array,
    K: int,
    V: int,
    N: int,
    P: int,
    A: int = 1,
    content: bool = False,
    beta_init: Optional[jax.Array] = None,
    kappa_p: Optional[int] = None,
    dtype=jnp.float32,
) -> STMState:
    """Initialize model state.

    Random init draws beta rows from normalized Gamma(0.1, 1) as the
    reference does (src/modules/stm.py:425-428); sigma starts at 20*I
    (src/modules/stm.py:459-461); mu/eta/theta start at zero.
    """
    if beta_init is None:
        g = jax.random.gamma(key, 0.1, (K, V), dtype=jnp.float32)
        beta = g / jnp.sum(g, axis=1, keepdims=True)
    else:
        beta = jnp.asarray(beta_init, dtype)
        if beta.ndim == 3:
            beta = beta[0] if not content else beta
    if content and beta.ndim == 2:
        beta = jnp.broadcast_to(beta[None], (A, K, V))
    beta = beta.astype(dtype)

    if kappa_p is None:
        # default matches build_kappa_design with interactions on; pass
        # the actual design width to keep state shapes iteration-stable
        kappa_p = K + A + A * K if content else 0
    return STMState(
        opt_iters=jnp.zeros((N,), jnp.int32),
        beta=beta,
        mu=jnp.zeros((N, K - 1), dtype),
        sigma=20.0 * jnp.eye(K - 1, dtype=dtype),
        eta=jnp.zeros((N, K - 1), dtype),
        theta=jnp.full((N, K), 1.0 / K, dtype),
        gamma=jnp.zeros((K - 1, P), dtype),
        kappa=jnp.zeros((kappa_p, V), dtype),
        bound=jnp.array(-jnp.inf, dtype),
        # a strong-typed int32 array, NOT the python-int field default:
        # a weak-typed 0 here gives iteration 1 a different aval than
        # the int32 the EM step returns, forcing a full-graph retrace
        # (a whole new compile) on iteration 2
        straggler_overflow=jnp.zeros((), jnp.int32),
    )
