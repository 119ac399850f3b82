"""Test configuration: 8 virtual CPU devices for multi-chip sharding tests.

Must set env vars before the first jax import (SURVEY.md §4 /
driver contract: sharding is validated on a virtual CPU mesh).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Tests run on the virtual 8-device CPU mesh even where a GPU is
# present: pin the platform before any device use.
jax.config.update("jax_platforms", "cpu")

from strutopy_tpu.utils.runtime import enable_compile_cache

enable_compile_cache()

import numpy as np
import pytest

from strutopy_tpu.dgp.corpus_creation import CorpusCreation


@pytest.fixture(scope="session")
def toy_corpus():
    """Deterministic toy corpus mirroring the reference fixture
    (reference tests/conftest.py:7-33): K=3, 50 docs x 50 words, V=200,
    STM dgp, 80/20 split."""
    rng = np.random.default_rng(42)
    level, K = 1, 3
    gamma = rng.multivariate_normal(
        rng.standard_normal(level), np.diag(np.full(level, 0.001)), K - 1
    )
    corpus = CorpusCreation(
        n_topics=K,
        n_docs=50,
        n_words=50,
        V=200,
        level=level,
        dgp="STM",
        gamma=gamma,
        seed=42,
    )
    corpus.generate_documents(remove_terms=True)
    corpus.split_corpus(proportion=0.8)
    return corpus


@pytest.fixture(scope="session")
def toy_dictionary(toy_corpus):
    return toy_corpus.dictionary


@pytest.fixture(scope="session")
def toy_metadata(toy_corpus):
    return toy_corpus.metadata


@pytest.fixture(scope="session")
def ref_modules():
    """Import the reference's own modules (read-only, with stubs for its
    unavailable deps gensim/qpsolvers) for direct parity comparisons."""
    import sys
    import types

    ref_src = "/root/reference/src"
    if not os.path.isdir(ref_src):
        pytest.skip("reference source not mounted")
    for name, attrs in {
        "gensim": {"utils": types.ModuleType("gensim.utils")},
        "gensim.corpora": {},
        "gensim.corpora.dictionary": {"Dictionary": object},
        "qpsolvers": {"solve_qp": lambda *a, **k: None},
    }.items():
        if name not in sys.modules:
            mod = types.ModuleType(name)
            for k, v in attrs.items():
                setattr(mod, k, v)
            sys.modules[name] = mod
    sys.modules["gensim"].corpora = sys.modules["gensim.corpora"]
    sys.modules["gensim.corpora"].dictionary = sys.modules["gensim.corpora.dictionary"]

    sys.path.insert(0, ref_src)
    try:
        from modules import heldout as ref_heldout  # noqa
        from modules import stm as ref_stm  # noqa
    finally:
        sys.path.pop(0)
    return ref_stm, ref_heldout
