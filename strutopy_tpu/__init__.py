"""strutopy_tpu — a Structural Topic Model framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
reference implementation ``mkrcke/strutopy`` (pure NumPy/SciPy STM):
variational-EM fitting of STM/CTM logistic-normal topic models with
topical-prevalence and topical-content covariates, spectral (anchor
word) initialization, synthetic-corpus generation, document-completion
heldout likelihood and FREX/coherence/exclusivity topic diagnostics.

Architecture (batched for an accelerator, not a port):
  * documents are padded dense ``(N, L)`` arrays, not python lists
    (reference: list-of-tuples BoW, src/modules/stm.py:331).
  * the per-document E-step is a batched, fixed-shape damped-Newton
    solver under ``jax.vmap`` + ``lax.while_loop``
    (reference: per-doc ``scipy.optimize.minimize(BFGS)`` in a serial
    python loop, src/modules/stm.py:519-597).
  * sufficient statistics reduce over a ``jax.sharding.Mesh`` document
    axis with ``psum`` (reference: joblib process fan-out of
    independent fits only, src/05_train.py:177).
  * M-step regressions are closed-form / iterative XLA linear algebra
    (reference: sklearn, src/modules/stm.py:636-853).
"""

from strutopy_tpu.corpus.bow import PaddedCorpus, Vocabulary, pad_corpus
from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.models.stm import STM
from strutopy_tpu.models.serving import ThetaServer, infer_from_artifacts
from strutopy_tpu.models.streaming import StreamedEM
from strutopy_tpu.dgp.corpus_creation import CorpusCreation
from strutopy_tpu.eval.heldout import eval_heldout, cut_in_half, split_corpus

__version__ = "0.1.0"

__all__ = [
    "PaddedCorpus",
    "Vocabulary",
    "pad_corpus",
    "STMConfig",
    "STM",
    "ThetaServer",
    "infer_from_artifacts",
    "StreamedEM",
    "CorpusCreation",
    "eval_heldout",
    "cut_in_half",
    "split_corpus",
    "__version__",
]
