#!/usr/bin/env python
"""Where does steady-state E-step time go? Newton loop vs finalize+scatter.

Times three jitted variants over the SAME warmed state (K=100 headline
config): (a) the full E-step, (b) gather + Newton loop only, (c)
gather + finalize + phi scatter only (Newton skipped).  (b) + (c)
roughly re-adds to (a) — the residual is scan/op overhead.  Guides
whether a scatter/finalize kernel is worth building.

Usage: ablate_estep.py [K] [V]  ->  benchmarks/results_ablate.json
"""

import json
import os
import sys
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(__file__)
        else os.path.join(os.getcwd(), "benchmarks"))
sys.path.insert(0, HERE)
from bench_common import warmed_state  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from strutopy_tpu.models.em import _newton_cfg, local_estep_stats
    from strutopy_tpu.ops import estep as E
    from strutopy_tpu.ops.linalg import precompute_sigma

    K = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    V = int(sys.argv[2]) if len(sys.argv) > 2 else 10_000
    N, n_words = 4096, 300
    B = 128 if K > 150 else 256
    common = dict(newton_pass1_iters=0)  # single-pass: clean ablation

    state, data, pc, design, make_cfg = warmed_state(
        K, V, N, n_words, B, common
    )
    cfg = make_cfg()
    ncfg = _newton_cfg(cfg)
    w, c = data.words[0], data.counts[0]
    asp, ok = data.aspects[0], data.doc_ok[0]
    Nn, L = w.shape
    C = Nn // B
    beta = state.beta
    mu, eta0 = state.mu, state.eta
    siginv, sent = precompute_sigma(state.sigma)

    chunks = (
        w.reshape(C, B, L), c.reshape(C, B, L),
        mu.reshape(C, B, K - 1), eta0.reshape(C, B, K - 1),
        asp.reshape(C, B), ok.reshape(C, B),
    )

    def full(_):
        r = E.run_estep(beta, mu, eta0, siginv, sent, w, c, asp, ok,
                        cfg=ncfg, batch_size=B)
        return r.bound + jnp.sum(r.beta_ss[0])

    def newton_only(_):
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            eta, iters, _ = E._batched_newton(beta_doc, cc, mu_c, eta_c,
                                              siginv, ncfg)
            return carry + jnp.sum(eta) + jnp.sum(iters), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def finalize_only(_):
        beta_ss0 = jnp.zeros(beta.shape, beta.dtype)

        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_ss, sigma_ss = carry
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            theta, nu, bound_d, phi = E._finalize_chunk(
                eta_c, beta_doc, cc, mu_c, okc.astype(beta.dtype), siginv,
                sent, Nd, nu_method=ncfg.nu_method)
            beta_ss = E._scatter_phi(beta_ss, phi, ww, aspc, None)
            return (beta_ss, sigma_ss + jnp.sum(nu, axis=0)), jnp.sum(bound_d)
        (bss, sss), b = jax.lax.scan(
            chunk_fn, (beta_ss0, jnp.zeros((K - 1, K - 1), beta.dtype)), chunks)
        return jnp.sum(b) + jnp.sum(bss[0]) + jnp.sum(sss)

    def gather_only(_):
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            return carry + jnp.sum(beta_doc[:, 0]), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def chol_nu_only(_):
        # isolate the per-doc (K-1, K-1) Cholesky + cho_inverse
        from strutopy_tpu.ops.linalg import cho_inverse

        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            _f, _g, H, th, ph = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            Lc = E._chol_pd_batched(H)
            nu = jax.vmap(cho_inverse)(Lc)
            return carry + jnp.sum(nu[:, 0, 0]) + jnp.sum(
                jnp.diagonal(Lc, axis1=1, axis2=2)), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def scatter_only(_):
        # fgh (for phi) + the beta_ss scatter, NO chol/nu
        beta_ss0 = jnp.zeros(beta.shape, beta.dtype)

        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_ss = carry
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            _f, _g, _H, th, phi_hat = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            phi = phi_hat * cc[:, None, :]
            beta_ss = E._scatter_phi(beta_ss, phi, ww, aspc, None)
            return beta_ss, None
        bss, _ = jax.lax.scan(chunk_fn, beta_ss0, chunks)
        return jnp.sum(bss[0])

    def fgh_only(_):
        # the shared fgh pass by itself (baseline for the two above)
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            f, g, H, th, ph = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            return carry + jnp.sum(f) + jnp.sum(H[:, 0, 0]) + jnp.sum(ph[:, 0, 0]), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def chol_only(_):
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            _f, _g, H, th, ph = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            Lc = E._chol_pd_batched(H)
            return carry + jnp.sum(jnp.diagonal(Lc, axis1=1, axis2=2)), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def ns_nu(_):
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            _f, _g, H, th, ph = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            Lc = E._chol_pd_batched(H)
            H_pd = jnp.einsum("bij,bkj->bik", Lc, Lc,
                              preferred_element_type=jnp.float32)
            nu = E._ns_inverse(H_pd)
            return carry + jnp.sum(nu[:, 0, 0]) + jnp.sum(
                jnp.diagonal(Lc, axis1=1, axis2=2)), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    beta_T = jnp.asarray(np.asarray(beta).T.copy())  # (V, K)

    def gather_vk(_):
        # row-gather from a (V, K) layout + transpose to (B, K, L)
        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            bd = jnp.transpose(beta_T[ww.reshape(-1)].reshape(
                ww.shape[0], ww.shape[1], -1), (0, 2, 1))  # (B, K, L)
            return carry + jnp.sum(bd[:, 0]), None
        out, _ = jax.lax.scan(chunk_fn, jnp.float32(0), chunks)
        return out

    def scatter_vk(_):
        # fgh (for phi) + row-scatter into a (V, K) accumulator
        bss0 = jnp.zeros((beta.shape[-1], beta.shape[-2]), beta.dtype)

        def chunk_fn(carry, chunk):
            ww, cc, mu_c, eta_c, aspc, okc = chunk
            beta_doc = E._gather_beta(beta, ww, aspc, None)
            Nd = jnp.sum(cc, axis=1)
            _f, _g, _H, th, phi_hat = E._f_g_H_batched(
                eta_c, beta_doc, cc, mu_c, siginv, Nd, bf16=False)
            phi = phi_hat * cc[:, None, :]
            phi_T = jnp.transpose(phi, (0, 2, 1)).reshape(-1, phi.shape[1])
            return carry.at[ww.reshape(-1)].add(phi_T), None
        bss, _ = jax.lax.scan(chunk_fn, bss0, chunks)
        return jnp.sum(bss[0])

    results = {"config": {"K": K, "V": V, "N": N, "batch": B}}
    for name, fn in [("full", full), ("newton_only", newton_only),
                     ("finalize_scatter", finalize_only),
                     ("gather_only", gather_only),
                     ("fgh_only", fgh_only),
                     ("chol_nu", chol_nu_only),
                     ("scatter", scatter_only),
                     ("chol_only", chol_only),
                     ("ns_nu", ns_nu),
                     ("gather_vk", gather_vk),
                     ("scatter_vk", scatter_vk)]:
        jf = jax.jit(fn)
        float(np.asarray(jf(0)))  # compile + warm
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            float(np.asarray(jf(0)))
            best = min(best, time.time() - t0)
        results[name] = {"seconds": round(best, 4),
                         "docs_per_sec": round(Nn / best, 1)}
        print(f"{name}: {best*1e3:.1f} ms  ({Nn/best:.0f} docs/s)", flush=True)
    with open(os.path.join(HERE, f"results_ablate_K{K}_V{V}.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
