"""Always-on non-finite-bound sanitizer (VERDICT r4 #6).

The N=1M streamed spectral fits once reported ``bound=nan`` while
theta/beta/heldout stayed finite — and the EM loop iterated on the nan
silently; the damage surfaced only in a benchmark's output.  The
reference asserts on its bound in the hot path (its src/modules/stm.py:534,1117).  These
tests reproduce the scenario's signature (per-doc eta overflow: the
quadratic bound term hits f32 inf with mixed signs, summing to nan,
while softmax-theta stays finite) and pin that both drivers now fail
LOUDLY: a warning fires, a state flag records it, and save_model
propagates it into fit_health.json.
"""

import json
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp

from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.stm import STM
from strutopy_tpu.models.state import init_state
from strutopy_tpu.models.streaming import StreamedEM
from strutopy_tpu.ops import mstep


def _poison_eta(shape, dtype=np.float32):
    """Mixed-sign huge eta: (eta-mu) @ siginv overflows f32 to +/-inf
    and the quadratic form's sum goes nan — finite theta (softmax of
    huge logits is one-hot), non-finite bound: the 1M signature."""
    eta = np.zeros(shape, dtype)
    eta[:, 0::2] = 1e21
    eta[:, 1::2] = -1e21
    return eta


def test_stm_flags_nonfinite_bound(tmp_path, caplog, toy_corpus,
                                   toy_dictionary, toy_metadata):
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
    poisoned = jnp.asarray(_poison_eta(np.asarray(model.eta).shape))
    model._state = model._state._replace(eta=poisoned)
    with caplog.at_level(logging.WARNING, logger="strutopy_tpu.models.stm"):
        model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    assert not np.isfinite(model.last_bounds[0])
    assert model.nonfinite_bound_iters == [0]
    assert any("NON-FINITE bound" in r.message for r in caplog.records)
    with open(os.path.join(str(tmp_path), "fit_health.json")) as f:
        health = json.load(f)
    assert health == {"bound_finite": False, "nonfinite_bound_iters": [0]}
    # theta stays finite — exactly why the old silent behavior was
    # dangerous: downstream outputs look plausible
    assert np.isfinite(np.asarray(model.theta)).all()


def test_stm_healthy_fit_reports_finite(tmp_path, toy_corpus,
                                        toy_dictionary, toy_metadata):
    train_docs = toy_corpus.train_docs
    model = STM(
        documents=train_docs,
        dictionary=toy_dictionary,
        K=3,
        X=toy_metadata[: len(train_docs)],
        max_em_iter=2,
        init_type="random",
        model_type="STM",
    )
    model.expectation_maximization(saving=True, output_dir=str(tmp_path))
    assert model.nonfinite_bound_iters == []
    with open(os.path.join(str(tmp_path), "fit_health.json")) as f:
        assert json.load(f)["bound_finite"] is True


def test_streamed_em_flags_nonfinite_bound(caplog):
    N, K, V, L, n_parts = 64, 4, 120, 18, 2
    rng = np.random.default_rng(0)
    words = rng.integers(0, V, (N, L)).astype(np.int32)
    counts = np.ones((N, L), np.float32)
    aspects = np.zeros(N, np.int32)
    doc_ok = np.ones(N, bool)
    X = rng.integers(0, 2, N).astype(np.float64)
    D_np, design = mstep.make_prevalence_design(X, doc_ok)
    n = N // n_parts
    parts = [
        (words[i * n:(i + 1) * n], counts[i * n:(i + 1) * n],
         aspects[i * n:(i + 1) * n], doc_ok[i * n:(i + 1) * n],
         D_np[i * n:(i + 1) * n].astype(np.float32))
        for i in range(n_parts)
    ]
    cfg = STMConfig(K=K, model_type="STM", init_type="random",
                    batch_size=16, sort_by_difficulty=False)
    sem = StreamedEM(cfg, design, parts)
    shared = init_state(jax.random.PRNGKey(0), K=K, V=V, N=n,
                        P=D_np.shape[1])
    part_states = sem.init_parts(jax.random.PRNGKey(0), K=K, V=V)
    poisoned = jnp.asarray(_poison_eta((n, K - 1)))
    part_states = [ps._replace(eta=poisoned) for ps in part_states]
    with caplog.at_level(logging.WARNING,
                         logger="strutopy_tpu.models.streaming"):
        shared, part_states = sem.em_iteration(shared, part_states)
    assert not np.isfinite(float(np.asarray(shared.bound)))
    assert sem.nonfinite_bound_count == 1
    assert any("NON-FINITE bound" in r.message for r in caplog.records)
