"""Document-sharded EM under ``shard_map`` + ``psum``.

The device replacement for the reference's serial E-step loop
(src/modules/stm.py:519) and its joblib/filesystem "backend"
(src/05_train.py:130-179): documents shard over the ``docs`` mesh axis,
each device runs the batched Newton E-step on its shard, and the
sufficient statistics — ``beta_ss (K,V)``, ``sigma_ss ((K-1)^2)``, the
scalar bound and the eta regression moments — reduce with ``psum``
across devices.  The M-step then runs replicated on every device (it is tiny), and
the per-document state (eta, theta, mu) never leaves its shard.

Determinism: a psum of per-shard partial sums reorders float additions
relative to the single-device scan; tests assert 1-vs-8-shard agreement
to float32 tolerance (SURVEY.md §4).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.em import CorpusData, em_iteration
from strutopy_tpu.models.state import STMState
from strutopy_tpu.ops import mstep
from strutopy_tpu.parallel.mesh import DOC_AXIS, VOCAB_AXIS


def _state_specs(content: bool, vocab_sharded: bool = False):
    """PartitionSpecs for STMState: per-doc arrays shard, params replicate.

    With ``vocab_sharded``, beta (and kappa, whose columns are words)
    additionally shard their vocab (last) dimension over the VOCAB mesh
    axis (SURVEY §2.5's "V-sharding for large K×V": per-chip beta
    memory drops by the vocab mesh size)."""
    if vocab_sharded:
        beta_spec = P(None, None, VOCAB_AXIS) if content else P(None, VOCAB_AXIS)
        kappa_spec = P(None, VOCAB_AXIS)
    else:
        beta_spec = P()
        kappa_spec = P()
    return STMState(
        beta=beta_spec,
        mu=P(DOC_AXIS),
        sigma=P(),
        eta=P(DOC_AXIS),
        theta=P(DOC_AXIS),
        gamma=P(),
        kappa=kappa_spec,
        bound=P(),
        opt_iters=P(DOC_AXIS),
        straggler_overflow=P(),
    )


def _data_specs(n_buckets: int = 1):
    per_bucket = tuple(P(DOC_AXIS) for _ in range(n_buckets))
    return CorpusData(
        words=per_bucket,
        counts=per_bucket,
        aspects=per_bucket,
        doc_ok=per_bucket,
        D=per_bucket,
    )


def make_sharded_em_step(
    mesh: Mesh,
    cfg: STMConfig,
    design: mstep.PrevalenceDesign,
    kappa_design,
    wcounts,
    n_buckets: int = 1,
    bucket_batches=None,
):
    """Build the sharded EM step: (state, data) -> state.

    ``data`` and the per-document parts of ``state`` must be sharded
    over ``mesh`` along the document axis (see :func:`shard_corpus`).
    With length buckets, every bucket's size is a multiple of the mesh
    size, so each device's shard holds the same contiguous per-bucket
    layout and the in-step bucket offsets (derived from local shapes)
    line up with the state shards.

    When ``mesh`` has a VOCAB axis (from :func:`make_mesh_2d`), beta
    and beta_ss shard their vocab dimension over it: the E-step
    assembles per-chunk beta_doc blocks with one vocab-axis psum
    (ops/estep.py::_gather_beta) and scatters phi locally, and the
    M-step beta row sums psum over the vocab axis.  Corpus arrays stay
    doc-sharded (replicated across vocab shards).
    """
    vocab_sharded = VOCAB_AXIS in mesh.axis_names
    state_specs = _state_specs(cfg.content, vocab_sharded)
    data_specs = _data_specs(n_buckets)

    def _em_local(state: STMState, data: CorpusData) -> STMState:
        return em_iteration(
            state,
            data,
            design,
            kappa_design,
            wcounts,
            cfg,
            psum=lambda x: jax.lax.psum(x, DOC_AXIS),
            bucket_batches=bucket_batches,
            vocab_axis=VOCAB_AXIS if vocab_sharded else None,
        )

    sharded = jax.shard_map(
        _em_local,
        mesh=mesh,
        in_specs=(state_specs, data_specs),
        out_specs=state_specs,
        check_vma=False,
    )
    return jax.jit(sharded)


def shard_corpus(mesh: Mesh, data: CorpusData) -> CorpusData:
    """Place corpus arrays on the mesh, sharded along documents.

    (PartitionSpec subclasses tuple, so generic tree mapping would
    recurse into it — map fields explicitly.)"""
    sharding = NamedSharding(mesh, P(DOC_AXIS))
    put = lambda xs: tuple(jax.device_put(x, sharding) for x in xs)
    return CorpusData(
        words=put(data.words),
        counts=put(data.counts),
        aspects=put(data.aspects),
        doc_ok=put(data.doc_ok),
        D=put(data.D),
    )


def shard_state(mesh: Mesh, state: STMState, content: bool = False) -> STMState:
    vocab_sharded = VOCAB_AXIS in mesh.axis_names
    if vocab_sharded:
        nv = mesh.shape[VOCAB_AXIS]
        V = state.beta.shape[-1]
        if V % nv:
            raise ValueError(
                f"V={V} is not divisible by the {nv}-way vocab mesh axis; "
                "pad the vocabulary (PaddedCorpus(..., V=...)) to a multiple"
            )
    specs = _state_specs(content, vocab_sharded)
    return STMState(
        *(
            jax.device_put(x, NamedSharding(mesh, s))
            for x, s in zip(tuple(state), tuple(specs))
        )
    )
