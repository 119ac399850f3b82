#!/usr/bin/env python
"""Smoke test of the STM main path on CUDA GPUs, through the public API.

    python chip_smoke.py               # one GPU: phases 1-4
    python chip_smoke.py --multichip   # four GPUs: phase 5 only

Phases, in one process and in this order (any failure ends the run
with a non-zero exit):

1. device: refuse anything but a GPU; print the card, JAX and the
   compile cache.
2. oracle parity at real widths against the float64 NumPy/SciPy oracle
   (strutopy_tpu/utils/reference_numpy.py): one E-step at K=100,
   V=10k on 256 documents, and a 4-iteration STM-OLS trajectory.
3. finalize precision: blocked Cholesky and inverse of the dumped
   barely-PD Hessians (tests/fixtures/nan_bisect_H.npz) against float64.
4. fit, heldout and serving at the "Scaled synthetic" deployment of
   BASELINE.json (N=100k, K=100, V=50k): a 3-iteration spectral STM fit
   on 90% of the documents, saved to disk; document-completion heldout
   on the other 10%; and ThetaServer answers compared with
   STM.transform.
5. (--multichip) 1-D, 2-D and streamed fits over four GPUs against the
   single-GPU fit, with per-card peak memory (nu_method="chol" in all
   four: see phase_multichip).

Every line before the last names the card (nvidia-smi name and power
limit); the last line is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "tests", "fixtures", "nan_bisect_H.npz")

# phase-4 deployment: BASELINE.json configs[3], "Scaled synthetic"
FIT_N, FIT_K, FIT_V, FIT_WORDS, FIT_SEED = 100_000, 100, 50_000, 150, 2024


class Log:
    """Prints each line prefixed with the card it ran on and the seconds
    since the run started (compilation dominates a cold run)."""

    def __init__(self, card: str):
        self.card = card
        self.t0 = time.perf_counter()

    def __call__(self, msg: str) -> None:
        print(f"[{self.card}] +{time.perf_counter() - self.t0:.1f}s {msg}",
              flush=True)


def check(log, name: str, value: float, limit: float, reason: str) -> None:
    """Print ``value`` beside its limit; raise when it is not below it."""
    ok = bool(np.isfinite(value)) and value <= limit
    log(f"{name}: {value:.3e} (limit {limit:.0e}: {reason}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} = {value!r} exceeds {limit!r}")


def _peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device(log):
    import jax

    from strutopy_tpu.utils.runtime import enable_compile_cache

    cache = enable_compile_cache()
    dev = jax.devices()[0]
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__} "
        f"compile_cache={cache}")
    return dev


# ---------------------------------------------------------------------------
# 2. oracle parity
# ---------------------------------------------------------------------------


def oracle_estep_errors(n_docs=256, K=100, V=10_000):
    """One E-step against reference_numpy.e_step from the same state.

    The state is the benchmark's (strutopy_tpu/bench.py): Gamma(0.1) beta, mu = eta = 0, sigma = 20 I,
    then one oracle EM iteration.  (From that cold start itself the
    per-document optimum is ill-determined: BFGS and Newton stop at
    points whose eta differ by O(1).)  Returns (errors, summary line)."""
    import jax.numpy as jnp

    from strutopy_tpu.bench import make_corpus
    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.models.em import _newton_cfg
    from strutopy_tpu.ops.estep import run_estep
    from strutopy_tpu.ops.linalg import precompute_sigma
    from strutopy_tpu.utils import reference_numpy as ref

    docs, _X = make_corpus(n_docs=n_docs, K=K, V=V)
    rng = np.random.RandomState(123456)
    g = rng.gamma(0.1, 1.0, (K, V))
    beta = g / g.sum(axis=1, keepdims=True)
    mu = np.zeros((n_docs, K - 1))
    eta = np.zeros((n_docs, K - 1))
    sigma = 20.0 * np.eye(K - 1)
    beta_ss, sigma_ss, _, eta, _ = ref.e_step(docs, beta, mu, eta, sigma)
    beta, mu, sigma = ref.m_step_ctm_lda(beta_ss, sigma_ss, eta, n_docs)

    t0 = time.perf_counter()
    r_beta_ss, r_sigma_ss, r_bound, r_eta, _ = ref.e_step(docs, beta, mu, eta, sigma)
    t_ref = time.perf_counter() - t0

    pc = pad_corpus(docs, V=V)
    siginv, sigent = precompute_sigma(jnp.asarray(sigma, jnp.float32))
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    res = run_estep(
        f32(beta), f32(mu), f32(eta), siginv, sigent,
        jnp.asarray(pc.words), jnp.asarray(pc.counts),
        jnp.zeros(pc.N, jnp.int32), jnp.asarray(pc.doc_ok),
        cfg=_newton_cfg(STMConfig(K=K)), batch_size=n_docs,
    )
    bound = float(res.bound)
    errors = {
        "bound": abs(bound - r_bound) / abs(r_bound),
        "eta": np.abs(np.asarray(res.eta, np.float64) - r_eta).max(),
        "sigma_ss": (np.abs(np.asarray(res.sigma_ss, np.float64) - r_sigma_ss).max()
                     / np.abs(r_sigma_ss).max()),
        "beta_ss": (np.abs(np.asarray(res.beta_ss, np.float64) - r_beta_ss).max()
                    / np.abs(r_beta_ss).max()),
    }
    summary = (f"oracle E-step K={K} V={V} docs={n_docs}: bound {bound:.6f} vs "
               f"oracle {r_bound:.6f} (oracle {t_ref:.1f}s on the host)")
    return errors, summary


def phase_oracle_estep(log, n_docs=256, K=100, V=10_000):
    err, summary = oracle_estep_errors(n_docs, K, V)
    log(summary)
    # CPU measures 6.8e-7, 1.9e-2, 9.4e-5 and 2.6e-4 for these four
    why = "f32 Newton vs f64 BFGS, each stopping at a 1e-5 gradient"
    check(log, "E-step bound rel err", err["bound"], 1e-4,
          "the repo's bound parity aim")
    check(log, "E-step eta max abs err", err["eta"], 5e-2,
          why + "; eta is flat along weakly identified directions")
    check(log, "E-step sigma_ss max err / max|sigma_ss|", err["sigma_ss"], 1e-3, why)
    check(log, "E-step beta_ss max err / max|beta_ss|", err["beta_ss"], 2e-3, why)


def phase_oracle_trajectory(log, N=300, K=30, V=1000, n_words=100, iters=4):
    """tests/test_integration.py's STM-OLS trajectory through STM."""
    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.stm import STM
    from strutopy_tpu.utils.reference_numpy import fit_stm_ols

    rng = np.random.default_rng(0)
    beta_true = rng.dirichlet(np.full(V, 0.02), size=K)
    ef = np.c_[rng.normal(0, 1, (N, K - 1)), np.zeros(N)]
    theta = np.exp(ef - ef.max(1, keepdims=True))
    theta /= theta.sum(1, keepdims=True)
    p = theta @ beta_true
    docs = []
    for d in range(N):
        draw = rng.multinomial(n_words, p[d])
        ids = np.nonzero(draw)[0]
        docs.append(list(zip(ids.tolist(), draw[ids].tolist())))
    X = rng.integers(0, 2, N).astype(np.float64)

    m = STM(documents=pad_corpus(docs, V=V), K=K, X=X, max_em_iter=iters,
            init_type="random", model_type="STM", seed=123456)
    m.expectation_maximization(saving=False)
    ours = np.asarray(m.last_bounds, np.float64)
    oracle = np.asarray(fit_stm_ols(docs, V, K, X, n_iter=iters)[0])
    log(f"oracle trajectory N={N} K={K} V={V}: ours {np.round(ours, 3).tolist()} "
        f"oracle {np.round(oracle, 3).tolist()}")
    rel = np.abs(ours - oracle) / np.abs(oracle)
    # The first E-step starts every document at eta = 0 under a
    # Gamma(0.1) beta; where the bf16-Hessian Newton search stops there
    # hangs on the last bits of its inputs: perturbing the initial beta
    # by 4e-7 relative moves this error over 1.6e-3..3.0e-3 on CPU.
    check(log, "trajectory cold-start (first) iteration rel err", float(rel[0]),
          5e-3, "f32 Newton (bf16 in-loop Hessian) vs f64 BFGS from eta = 0; "
          "ulp-level input changes move it by 1e-3")
    check(log, "trajectory later iterations max rel err", float(rel[1:].max()),
          2e-3, "warm-started E-steps; the same perturbations give <=1.1e-3")


# ---------------------------------------------------------------------------
# 3. finalize precision
# ---------------------------------------------------------------------------


def phase_finalize(log):
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.ops.estep import _make_pd_batched
    from strutopy_tpu.ops.linalg import blocked_cho_inverse, blocked_cholesky

    H = _make_pd_batched(jnp.asarray(np.load(FIXTURE)["Hs"], jnp.float32))
    H64 = np.asarray(H, np.float64)
    # jitted, as in the E-step: one compile instead of hundreds of eager ops
    L = jax.jit(blocked_cholesky)(H)
    Hinv = np.asarray(jax.jit(blocked_cho_inverse)(L), np.float64)
    L = np.asarray(L, np.float64)
    if not (np.isfinite(L).all() and np.isfinite(Hinv).all()):
        raise AssertionError("blocked factor or inverse of the fixture is not finite")
    L_err = np.abs(np.tril(L) - np.linalg.cholesky(H64)).max()
    inv64 = np.linalg.inv(H64)
    inv_err = np.abs(Hinv - inv64).max() / np.abs(inv64).max()
    why = "f32 rounding; TF32 products give 4.7e-4..2.6e-2"
    check(log, "fixture factor max abs err", L_err, 1e-4, why)
    check(log, "fixture inverse max err / max|inverse|", inv_err, 1e-4, why)


# ---------------------------------------------------------------------------
# 4. fit, heldout and serving at full width
# ---------------------------------------------------------------------------


def _sample_part(args):
    """Worker: one part of the corpus, in the base vocabulary's ids."""
    from strutopy_tpu.dgp.corpus_creation import CorpusCreation

    K, n_docs, n_words, beta, gamma, seed = args
    cc = CorpusCreation(n_topics=K, n_docs=n_docs, n_words=n_words,
                        V=beta.shape[1], level=1, dgp="STM", beta=beta,
                        gamma=gamma, seed=seed)
    cc.generate_documents(remove_terms=False, dictionary=False)
    orig = np.empty(cc.V_used, np.int64)
    for o, n in cc.new_ids.items():
        orig[n] = o
    docs = [[(int(orig[w]), c) for w, c in doc] for doc in cc.documents]
    return docs, cc.metadata[:, 0].astype(np.float64)


def make_fit_corpus(N=FIT_N, K=FIT_K, V=FIT_V, n_words=FIT_WORDS,
                    seed=FIT_SEED, workers=None):
    """STM-DGP corpus from CorpusCreation with one binary prevalence
    covariate: (documents, X, V_used).

    One CorpusCreation draws beta and gamma; the documents are drawn in
    parts of the same DGP (one seed each) by worker processes, since
    sampling 100k documents over 50k terms takes minutes in one
    process.  Unused terms are removed afterwards."""
    import multiprocessing

    from strutopy_tpu.dgp.corpus_creation import CorpusCreation

    base = CorpusCreation(n_topics=K, n_docs=1, n_words=n_words, V=V,
                          level=1, dgp="STM", seed=seed)
    workers = workers or min(16, os.cpu_count() or 1)
    sizes = np.diff(np.linspace(0, N, workers + 1).astype(int))
    jobs = [(K, int(n), n_words, base.beta, base.gamma, seed + 1 + i)
            for i, n in enumerate(sizes)]
    if workers == 1:
        parts = [_sample_part(jobs[0])]
    else:
        with multiprocessing.get_context("spawn").Pool(workers) as pool:
            parts = pool.map(_sample_part, jobs)
    base.documents = [doc for docs, _ in parts for doc in docs]
    base.remove_infrequent_terms()
    X = np.concatenate([x for _, x in parts])
    return base.documents, X, base.V


def training_vocabulary(train, test):
    """Re-number the terms to those seen in ``train`` and drop the other
    tokens from ``test``, as a model drops terms outside its vocabulary.

    Returns (train, test, V, dropped test tokens)."""
    seen = sorted({w for doc in train for w, _ in doc})
    remap = {w: i for i, w in enumerate(seen)}
    train = [[(remap[w], c) for w, c in doc] for doc in train]
    kept, dropped = [], 0
    for doc in test:
        kept.append([(remap[w], c) for w, c in doc if w in remap])
        dropped += sum(c for w, c in doc if w not in remap)
    return train, kept, len(seen), dropped


def phase_fit(log, N=FIT_N, K=FIT_K, V=FIT_V, n_words=FIT_WORDS,
              em_iters=3, workers=None, batches=(1, 8, 64)):
    import jax

    from strutopy_tpu import STM, ThetaServer, cut_in_half, eval_heldout

    t0 = time.perf_counter()
    docs, X, _ = make_fit_corpus(N, K, V, n_words, workers=workers)
    n_test = N // 10
    train, test, V_used, dropped = training_vocabulary(docs[:-n_test], docs[-n_test:])
    test_1, test_2 = cut_in_half(test)
    X_test = X[-n_test:]
    log(f"corpus N={N} K={K} V={V_used} (of {V}) ~{n_words} tokens/doc; "
        f"{n_test} documents held out, {dropped} of their tokens outside "
        f"the training vocabulary: {time.perf_counter() - t0:.1f}s on the host")

    t0 = time.perf_counter()
    m = STM(documents=train, K=K, X=X[:-n_test], init_type="spectral",
            model_type="STM", mode="ols", max_em_iter=em_iters)
    t_setup = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        m.expectation_maximization(saving=True, output_dir=out_dir)
        bounds = np.asarray(m.last_bounds)
        steady = m.N / m.docs_per_sec
        log(f"fit: bounds {bounds.tolist()}; set-up {t_setup:.2f}s (corpus "
            f"to device, spectral init); EM {m.time_processed:.2f}s for "
            f"{len(bounds)} iterations, first includes compilation; steady "
            f"EM iteration {steady:.3f}s; peak_bytes_in_use "
            f"{_peak_bytes(jax.devices()[0])}")
        if len(bounds) != em_iters or not np.isfinite(bounds).all():
            raise AssertionError(f"fit bounds {bounds.tolist()} are not "
                                 f"{em_iters} finite values")
        if m.N != N - n_test:
            raise AssertionError(f"fit on {m.N} documents, not the "
                                 f"{N - n_test} training documents")

        t0 = time.perf_counter()
        theta_h, _ = m.transform(test_1, X=X_test)
        ll = eval_heldout(test_2, theta_h, m.beta)
        log(f"heldout (document completion on the {n_test} held-out "
            f"documents, fit on the other {m.N}): {ll:.6f} in "
            f"{time.perf_counter() - t0:.2f}s")
        if not np.isfinite(ll):
            raise AssertionError(f"heldout score {ll!r} is not finite")

        t0 = time.perf_counter()
        srv = ThetaServer(out_dir)
        for n in batches:  # warm-up: compile each request's shapes
            srv.infer(test_1[:n], X=X_test[:n])
        log(f"ThetaServer load + warm-up {time.perf_counter() - t0:.2f}s")
        for n in batches:
            t0 = time.perf_counter()
            theta_s, _ = srv.infer(test_1[:n], X=X_test[:n])
            dt = time.perf_counter() - t0
            theta_t, _ = m.transform(test_1[:n], X=X_test[:n])
            row_err = np.abs(theta_s.sum(axis=1) - 1.0).max()
            check(log, f"serve {n} docs ({dt * 1e3:.1f} ms): |row sum - 1|",
                  row_err, 1e-5, "theta is a softmax in f32")
            check(log, f"serve {n} docs: max |theta - STM.transform|",
                  np.abs(theta_s - theta_t).max(), 1e-4,
                  "same model and Newton path; batch shapes change f32 "
                  "reduction order only")


# ---------------------------------------------------------------------------
# 5. four GPUs
# ---------------------------------------------------------------------------


def phase_multichip(log, N=FIT_N, K=FIT_K, V=FIT_V, n_words=FIT_WORDS,
                    em_iters=2, workers=None, n_devices=4):
    import gc

    import jax

    from strutopy_tpu import STM
    from strutopy_tpu.corpus.bow import pad_corpus
    from strutopy_tpu.models.config import STMConfig
    from strutopy_tpu.parallel.mesh import make_mesh, make_mesh_2d

    devs = jax.devices()
    if len(devs) < n_devices:
        raise AssertionError(f"--multichip needs {n_devices} devices, found {len(devs)}")
    docs, X, V_used = make_fit_corpus(N, K, V, n_words, workers=workers)
    # the 2-D mesh shards beta's vocab axis: pad V to a multiple of it
    corpus = pad_corpus(docs, V=-(-V_used // n_devices) * n_devices)
    # nu_method="chol": the per-document finalize solver runs inside each
    # shard and does not touch the sharding under test, and XLA's
    # Cholesky compiles in a fraction of the unrolled blocked one's time
    # (four meshes, four cold compiles)
    cfg = STMConfig(K=K, model_type="STM", mode="ols", init_type="random",
                    max_em_iter=em_iters, newton_straggler_frac=0.25,
                    nu_method="chol")
    kw = dict(documents=corpus, K=K, X=X, config=cfg)

    def fit(**extra):
        t0 = time.perf_counter()
        m = STM(**kw, **extra)
        m.expectation_maximization(saving=False)
        bounds = list(m.last_bounds)
        del m
        gc.collect()
        return bounds, time.perf_counter() - t0

    # the sharded fits run first: peak_bytes_in_use is a high-water mark,
    # and the single-device fit would raise device 0's
    cases = {
        "1-D make_mesh(4)": dict(mesh=make_mesh(n_devices)),
        "2-D make_mesh_2d(2, 2)": dict(mesh=make_mesh_2d(2, n_devices // 2)),
        "stream_parts=2 on make_mesh(4)": dict(stream_parts=2,
                                               mesh=make_mesh(n_devices)),
    }
    sharded = {}
    for name, extra in cases.items():
        sharded[name] = fit(**extra)
        log(f"{name}: bounds {sharded[name][0]} in {sharded[name][1]:.1f}s")
    peaks = [_peak_bytes(d) for d in devs[:n_devices]]
    log(f"peak_bytes_in_use per device after the sharded fits: {peaks}")
    ref_bounds, dt = fit()
    log(f"single device {devs[0]}: bounds {ref_bounds} in {dt:.1f}s")
    for name, (bounds, _) in sharded.items():
        if not np.isfinite(bounds).all():
            raise AssertionError(f"{name}: non-finite bounds {bounds}")
        rel = float(np.max(np.abs(np.subtract(bounds, ref_bounds))
                           / np.abs(ref_bounds)))
        check(log, f"{name} vs single device: bound rel diff", rel, 1e-4,
              "f32 statistics summed across devices in another order")
    if None not in peaks:
        check(log, "max peak / mean peak over devices",
              max(peaks) / float(np.mean(peaks)), 2.0,
              "the sharded fits must not pile onto one device")


# ---------------------------------------------------------------------------


def result_line(platform: str, kind: str, count: int) -> str:
    """The last line of a successful run."""
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multichip", action="store_true",
                    help="run only the four-GPU phase")
    args = ap.parse_args(argv)

    import jax

    from strutopy_tpu.utils.runtime import gpu_card, require_gpu

    require_gpu("chip_smoke.py")
    log = Log(gpu_card())
    dev = phase_device(log)
    if args.multichip:
        phase_multichip(log)
        count = 4
    else:
        phase_oracle_estep(log)
        phase_oracle_trajectory(log)
        phase_finalize(log)
        phase_fit(log)
        count = len(jax.devices())
    print(result_line(dev.platform, dev.device_kind, count), flush=True)


if __name__ == "__main__":
    main()
