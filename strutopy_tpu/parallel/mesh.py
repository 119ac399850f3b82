"""Device mesh helpers.

The reference's only parallelism is joblib process fan-out of
*independent* fits (src/05_train.py:177-179).  Here a single fit scales
across chips: documents shard over the ``docs`` mesh axis and the
E-step sufficient statistics reduce with ``psum`` across devices
(SURVEY.md §2.5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


DOC_AXIS = "docs"
VOCAB_AXIS = "vocab"


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D document-parallel mesh over the first ``n_devices`` devices.

    Raises if fewer than ``n_devices`` devices exist — silently
    truncating would make an "8-way" mesh a 1-way mesh and void any
    multi-chip validation built on it.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"make_mesh({n_devices}) needs {n_devices} devices but the "
                f"{jax.default_backend()} backend has {len(devices)}; for a "
                "virtual CPU mesh set XLA_FLAGS=--xla_force_host_platform_"
                f"device_count={n_devices} and force jax_platforms=cpu "
                "before first device use"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DOC_AXIS,))


def make_mesh_2d(
    n_doc_shards: int,
    n_vocab_shards: int,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """2-D (docs, vocab) mesh for vocabulary-sharded EM (SURVEY §2.5).

    Documents shard over the first axis as in :func:`make_mesh`; the
    ``beta``/``beta_ss`` (K, V) arrays additionally shard their vocab
    dimension over the second axis, dropping per-chip K*V memory by
    ``n_vocab_shards``.  The GPUs of one host reach each other at the
    same rate, so the split follows the algorithm alone: vocab shards
    cut per-device beta memory at the cost of one beta_doc psum per
    E-step chunk (the only vocab collective on the hot path).
    """
    if devices is None:
        devices = jax.devices()
    need = n_doc_shards * n_vocab_shards
    if len(devices) < need:
        raise ValueError(
            f"make_mesh_2d({n_doc_shards}, {n_vocab_shards}) needs {need} "
            f"devices but the {jax.default_backend()} backend has "
            f"{len(devices)}"
        )
    grid = np.asarray(devices[:need]).reshape(n_doc_shards, n_vocab_shards)
    return Mesh(grid, (DOC_AXIS, VOCAB_AXIS))


def default_mesh() -> Optional[Mesh]:
    """Mesh over all local devices; None when there is a single device."""
    devs = jax.devices()
    if len(devs) <= 1:
        return None
    return make_mesh(devices=devs)
