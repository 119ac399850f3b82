"""Serving-path benchmark: theta inference from saved artifacts on the GPU.

The serving layer (strutopy_tpu/models/serving.py::infer_from_artifacts)
is a production path the reference lacks entirely — load a fitted
model's ``*_hat.npy`` directory and infer topic proportions for new
documents without an STM instance or a refit.  This records its
numbers on real hardware:

  * bulk throughput: docs/s end-to-end (host padding + bucketing +
    device E-step + de-permute) for a large batch of unseen docs;
  * online latency: wall-clock per call at batch sizes 1 / 32 / 256
    (shapes pre-compiled — the steady-state serving regime).

Usage:  python - < benchmarks/serving_bench.py   (cwd = repo root)
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(__file__)
        else os.path.join(os.getcwd(), "benchmarks"))
sys.path.insert(0, HERE)
from bench_common import corpus  # noqa: E402

K, V, N_FIT, N_SERVE, L = 100, 10_000, 20_000, 50_000, 150


def main():
    from strutopy_tpu.models.serving import infer_from_artifacts
    from strutopy_tpu.models.stm import STM

    print(f"fit: N={N_FIT} K={K} V={V}", flush=True)
    docs, X = corpus(K, V, N_FIT, L, seed=0)
    words = [f"w{i}" for i in range(V)]
    t0 = time.time()
    model = STM(documents=docs, dictionary=words, K=K, X=X,
                init_type="spectral", max_em_iter=10, seed=1)
    model.expectation_maximization(saving=False)
    fit_s = time.time() - t0
    print(f"fit done in {fit_s:.1f}s, bound={model.last_bounds[-1]:.1f}",
          flush=True)

    out = {"config": {"K": K, "V": V, "N_fit": N_FIT, "N_serve": N_SERVE,
                      "tokens_per_doc": L, "em_iters": 10,
                      "init": "spectral"},
           "fit_seconds": round(fit_s, 1)}

    with tempfile.TemporaryDirectory() as d:
        model.save_model(d)
        serve_docs, serve_X = corpus(K, V, N_SERVE, L, seed=7)

        # Bulk: first call includes compile; second call is steady state.
        t0 = time.time()
        theta, _eta = infer_from_artifacts(d, serve_docs, X=serve_X)
        cold = time.time() - t0
        assert theta.shape == (N_SERVE, K)
        assert np.all(np.isfinite(theta))
        assert np.allclose(theta.sum(axis=1), 1.0, atol=1e-3)
        t0 = time.time()
        theta2, _ = infer_from_artifacts(d, serve_docs, X=serve_X)
        warm = time.time() - t0
        assert np.allclose(theta, theta2, atol=1e-5)
        out["bulk"] = {
            "cold_seconds": round(cold, 2),
            "warm_seconds": round(warm, 2),
            "warm_docs_per_sec": round(N_SERVE / warm, 1),
        }
        print(f"bulk: cold {cold:.2f}s, warm {warm:.2f}s "
              f"({N_SERVE / warm:,.0f} docs/s)", flush=True)

        # Decomposition: the end-to-end number is host-ingest-bound
        # (pad_corpus loops over python list-docs).  A production bulk
        # feed pre-encodes once — infer_theta accepts a PaddedCorpus
        # directly, so measure (a) the one-time host encode and (b) the
        # pre-encoded inference path on its own.
        from strutopy_tpu.corpus.bow import pad_corpus
        from strutopy_tpu.models.serving import infer_theta

        beta = model.beta.astype(np.float32)
        sigma = model.sigma.astype(np.float32)
        gamma = np.asarray(model.gamma, np.float64)
        t0 = time.time()
        pc_serve = pad_corpus(serve_docs, V=V)
        pad_s = time.time() - t0
        D_serve = np.c_[np.ones(N_SERVE), serve_X]
        mu_serve = (D_serve @ gamma.T).astype(np.float32)
        infer_theta(beta, sigma, mu_serve, pc_serve, model.config)  # warm
        times = []
        for _ in range(3):
            t0 = time.time()
            theta3, _ = infer_theta(beta, sigma, mu_serve, pc_serve,
                                    model.config)
            times.append(time.time() - t0)
        pre_s = float(np.median(times))
        assert np.allclose(theta, theta3, atol=1e-5)
        out["bulk_preencoded"] = {
            "host_encode_seconds": round(pad_s, 2),
            "infer_seconds": round(pre_s, 2),
            "docs_per_sec": round(N_SERVE / pre_s, 1),
        }
        print(f"pre-encoded bulk: encode {pad_s:.2f}s once, infer "
              f"{pre_s:.2f}s ({N_SERVE / pre_s:,.0f} docs/s)", flush=True)

        # Online latency, two regimes:
        #   (a) per-call params: infer_theta is handed HOST numpy
        #       beta/sigma each request (what a naive caller does) — every
        #       call re-uploads beta (K*V*4 bytes) to the device;
        #   (b) ThetaServer: params uploaded ONCE at load, device-resident
        #       across requests (the production steady state).
        from strutopy_tpu.models.serving import ThetaServer

        srv = ThetaServer(d)
        lat, lat_srv = {}, {}
        for B in (1, 32, 256):
            sub_docs = serve_docs[:B]
            X_sub = serve_X[:B]
            D = np.c_[np.ones(B), X_sub]
            mu_user = (D @ gamma.T).astype(np.float32)
            args = (beta, sigma, mu_user, sub_docs, model.config)
            infer_theta(*args)  # compile + warm this shape
            times = []
            for _ in range(5):
                t0 = time.time()
                infer_theta(*args)
                times.append(time.time() - t0)
            med = float(np.median(times))
            lat[str(B)] = {"median_ms": round(med * 1e3, 1),
                           "docs_per_sec": round(B / med, 1)}
            print(f"online B={B} (per-call params): {med * 1e3:.1f} ms "
                  f"median ({B / med:,.0f} docs/s)", flush=True)

            theta_srv, _ = srv.infer(sub_docs, X=X_sub)  # warm (same shape)
            assert np.allclose(theta_srv, theta[:B], atol=1e-5)
            times = []
            for _ in range(5):
                t0 = time.time()
                srv.infer(sub_docs, X=X_sub)
                times.append(time.time() - t0)
            med = float(np.median(times))
            lat_srv[str(B)] = {"median_ms": round(med * 1e3, 1),
                               "docs_per_sec": round(B / med, 1)}
            print(f"online B={B} (ThetaServer):      {med * 1e3:.1f} ms "
                  f"median ({B / med:,.0f} docs/s)", flush=True)
        out["online_latency"] = lat
        out["online_latency_server"] = lat_srv

        # Raw-text end-to-end: tokenize + align_corpus (native C++
        # encode against the model's vocab.json) + infer, the
        # ThetaServer.infer_text path.  Texts reuse the model's token
        # strings so OOV is controlled (~2% planted).
        rng = np.random.default_rng(11)
        N_TEXT = 10_000
        toks = np.array(words + ["oovword"])
        texts = [
            " ".join(toks[rng.integers(0, len(toks), size=L)])
            for _ in range(N_TEXT)
        ]
        # the model was fit with prevalence covariates, so new texts
        # need their X too (reuse the serve draw's covariate rows)
        t0 = time.time()
        theta_t, _eta_t, report = srv.infer_text(texts, X=serve_X[:N_TEXT])
        cold_s = time.time() - t0          # includes the 10k-shape compile
        t0 = time.time()
        theta_t, _eta_t, report = srv.infer_text(texts, X=serve_X[:N_TEXT])
        text_s = time.time() - t0          # steady state: encode + infer
        assert theta_t.shape == (N_TEXT, K)
        assert report["oov_types"] == 1
        out["raw_text_end_to_end"] = {
            "n_docs": N_TEXT,
            "cold_seconds": round(cold_s, 2),
            "seconds": round(text_s, 2),
            "docs_per_sec": round(N_TEXT / text_s, 1),
            "tokens_dropped": report["tokens_dropped"],
        }
        print(f"raw text end-to-end: cold {cold_s:.2f}s, warm {text_s:.2f}s "
              f"({N_TEXT / text_s:,.0f} docs/s incl. C++ encode)", flush=True)

    path = os.path.join(HERE, "results_serving.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
