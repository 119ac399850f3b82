"""chip_smoke.py, bench.py and the CLI's platform plumbing on CPU.

The GPU run itself is ``python chip_smoke.py`` on the card; here every
phase runs at a tiny size, and the entry points are checked to refuse a
machine without a GPU instead of measuring the host.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke as cs
from strutopy_tpu.cli import build_parser
from strutopy_tpu.models.config import STMConfig
from strutopy_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_on_cpu(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.fixture
def log():
    lines = []

    def _log(msg):
        lines.append(msg)

    _log.lines = lines
    return _log


# ----- refusing the host ----------------------------------------------------


def test_chip_smoke_refuses_without_gpu():
    proc = _run_on_cpu(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_bench_refuses_without_gpu():
    proc = _run_on_cpu(["bench.py"])
    assert proc.returncode != 0
    assert "GPU" in proc.stderr
    assert "docs/s" not in proc.stdout


def test_cli_platform_gpu_fails_without_gpu():
    proc = _run_on_cpu(["-m", "strutopy_tpu.cli", "--platform", "gpu", "bench"])
    assert proc.returncode != 0
    assert "--platform gpu needs a CUDA GPU" in proc.stderr


@pytest.mark.parametrize("platform", ["auto", "cpu", "gpu"])
def test_cli_accepts_platform(platform):
    args = build_parser().parse_args(["--platform", platform, "bench"])
    assert args.platform == platform


def test_cli_rejects_tpu_platform():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--platform", "tpu", "bench"])


# ----- the contract's last line -----------------------------------------


def test_result_line_is_the_contract():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line


def test_check_raises_above_limit(log):
    cs.check(log, "x", 1e-6, 1e-5, "why")
    with pytest.raises(AssertionError):
        cs.check(log, "y", 2e-5, 1e-5, "why")
    with pytest.raises(AssertionError):
        cs.check(log, "z", float("nan"), 1e-5, "why")
    assert "FAILED" in log.lines[-1] and "ok" in log.lines[0]


# ----- compile cache ------------------------------------------------------


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_to_repo(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = runtime.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ----- saved configs --------------------------------------------------------


def test_config_from_json_drops_retired_kernel_fields():
    saved = json.loads(STMConfig(K=7, model_type="CTM", mode="ridge",
                                 newton_cg_iters=9).to_json())
    saved.update(use_pallas=False, pallas_fgh=False, pallas_cg=True,
                 pallas_ls=False, pallas_iter=False, pallas_block=8,
                 cg_chunk_docs=64)
    cfg = STMConfig.from_json(json.dumps(saved))
    assert cfg == STMConfig(K=7, model_type="CTM", mode="ridge",
                            newton_cg_iters=9)


def test_config_from_json_still_rejects_unknown_fields():
    saved = json.loads(STMConfig(K=3).to_json())
    saved["dtype"] = "float32"  # a foreign config: callers fall back
    with pytest.raises(TypeError):
        STMConfig.from_json(json.dumps(saved))


# ----- each phase at a tiny size ------------------------------------------


def test_phase_device(log):
    dev = cs.phase_device(log)
    assert dev.platform == "cpu"
    assert "compile_cache=" in log.lines[0]


def test_phase_oracle_estep(log):
    cs.phase_oracle_estep(log, n_docs=32, K=6, V=300)
    assert sum(ln.endswith(" ok") for ln in log.lines) == 4


def test_phase_oracle_trajectory(log):
    cs.phase_oracle_trajectory(log, N=60, K=5, V=200, n_words=40, iters=3)
    # the cold-start iteration and the later ones, each against its limit
    assert [ln.endswith(" ok") for ln in log.lines[-2:]] == [True, True]
    assert "cold-start" in log.lines[-2] and "later iterations" in log.lines[-1]


def test_phase_finalize(log):
    cs.phase_finalize(log)
    assert [ln.endswith(" ok") for ln in log.lines] == [True, True]


def test_phase_fit(log):
    cs.phase_fit(log, N=300, K=4, V=400, n_words=30, em_iters=3,
                 workers=1, batches=(1, 8))
    # two checks per request size
    assert sum(ln.endswith(" ok") for ln in log.lines) == 4
    # the fit sees 90% of the documents; the other 30 are scored
    heldout = [ln for ln in log.lines if ln.startswith("heldout")]
    assert len(heldout) == 1 and "30 held-out documents, fit on the other 270" in heldout[0]


def test_training_vocabulary_drops_unseen_test_terms():
    train = [[(0, 2), (5, 1)], [(5, 3), (9, 1)]]
    test = [[(5, 1), (7, 4)], [(9, 2), (0, 1), (3, 1)]]
    tr, te, V, dropped = cs.training_vocabulary(train, test)
    # 0, 5, 9 are seen in training: renumbered 0, 1, 2
    assert V == 3
    assert tr == [[(0, 2), (1, 1)], [(1, 3), (2, 1)]]
    assert te == [[(1, 1)], [(2, 2), (0, 1)]]
    assert dropped == 5


class _InlinePool:
    """multiprocessing context stand-in that maps in this process."""

    def Pool(self, n):  # noqa: N802 (mirrors the multiprocessing API)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def map(self, fn, jobs):
        return [fn(j) for j in jobs]


def test_make_fit_corpus_merges_parts(monkeypatch):
    import multiprocessing

    monkeypatch.setattr(multiprocessing, "get_context", lambda _m: _InlinePool())
    docs, X, V = cs.make_fit_corpus(N=90, K=4, V=500, n_words=20, workers=3)
    assert len(docs) == len(X) == 90
    assert set(np.unique(X)) <= {0.0, 1.0}
    ids = {w for doc in docs for w, _ in doc}
    # unused terms removed: the ids are exactly 0..V-1
    assert ids == set(range(V))
    assert all(sum(c for _, c in doc) == 20 for doc in docs)


def test_phase_multichip_on_virtual_devices(log):
    cs.phase_multichip(log, N=256, K=4, V=300, n_words=20, workers=1)
    assert sum(ln.endswith(" ok") for ln in log.lines) == 3
