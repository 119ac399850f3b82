#!/usr/bin/env python
"""Steady-state E-step A/Bs on one GPU, for the choices decided on
other hardware:

  cg        the plain (XLA) E-step at K=200 and K=400 with the default
            newton_cg_iters, the stage a hand-written CG kernel would
            replace;
  nu        nu_method="blocked" (the default) against "chol" (XLA's
            Cholesky + triangular solves) at K=100 and K=400;
  prec      ops/linalg.py::MODEL_PREC, the precision of the finalize
            products and of the Newton search's gradient and Armijo
            objectives, at HIGHEST (the default, true f32) against HIGH
            (TF32) at K=100.

Protocol: bench.py's cell (V=10k, 300 tokens/doc, batch 256, two-pass
schedule p1=6/frac=0.25) at N=8,192 documents, one warmed state per K
(5 EM iterations), variants timed in turns A, B, B, A, each turn the
median of 5 E-steps after a compiling call (its seconds are kept as
``first_call_s``: compilation, or a compile-cache load, plus one run).
Refuses to run without a GPU.

Usage (repo root):  python benchmarks/estep_ab.py [cg nu prec] [--K 100 ...]
Writes the turns to $ESTEP_AB_OUT (default estep_ab.json in the working
directory) and prints one line per turn.
"""

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

from bench_common import time_estep, warmed_state  # noqa: E402

V, N, NW = 10_000, 8_192, 300
SCHEDULE = dict(newton_pass1_iters=6, newton_straggler_frac=0.25)


def main():
    import jax

    import strutopy_tpu.ops.linalg as LA
    from strutopy_tpu.utils.runtime import enable_compile_cache, gpu_card, require_gpu

    require_gpu("estep_ab.py")
    enable_compile_cache()
    card = gpu_card()
    ap = argparse.ArgumentParser()
    ap.add_argument("which", nargs="*", choices=["cg", "nu", "prec"])
    ap.add_argument("--K", type=int, nargs="+", help="only these K")
    args = ap.parse_args()
    which = args.which or ["cg", "nu", "prec"]
    out_path = os.path.abspath(os.environ.get("ESTEP_AB_OUT", "estep_ab.json"))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    results = {"card": card, "device_kind": jax.devices()[0].device_kind,
               "config": {"V": V, "N": N, "tokens": NW, "batch": 256,
                          **SCHEDULE}, "turns": []}

    def record(K, variant, state, data, cfg):
        t0 = time.perf_counter()
        times, bound = time_estep(state, data, cfg)
        first = time.perf_counter() - t0 - sum(times)
        med = statistics.median(times)
        row = {"K": K, "variant": variant, "docs_per_sec": N / med,
               "median_s": med, "all_s": times, "bound": bound,
               "first_call_s": first}
        results["turns"].append(row)
        print(f"[{card}] K={K} {variant}: {N / med:.1f} docs/s "
              f"(median {med:.5f}s of {len(times)}; bound {bound:.3f}; "
              f"first call {first:.1f}s)", flush=True)
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)

    Ks = sorted({K for K, tag in ((200, "cg"), (400, "cg"), (100, "nu"),
                                  (400, "nu"), (100, "prec"))
                 if tag in which and (not args.K or K in args.K)})
    for K in Ks:
        state, data, _pc, _design, make_cfg = warmed_state(
            K, V, N, NW, 256, SCHEDULE)
        if "cg" in which and K in (200, 400):
            record(K, "plain", state, data, make_cfg())
        if "nu" in which and K in (100, 400):
            for nu in ("blocked", "chol", "chol", "blocked"):
                record(K, f"nu_method={nu}", state, data, make_cfg(nu_method=nu))
        if "prec" in which and K == 100:
            P = jax.lax.Precision
            for prec in (P.HIGHEST, P.HIGH, P.HIGH, P.HIGHEST):
                LA.MODEL_PREC = prec  # read at trace time
                jax.clear_caches()
                record(K, f"MODEL_PREC={prec.name}", state, data, make_cfg())
            LA.MODEL_PREC = P.HIGHEST
    print(f"[{card}] wrote {out_path}", flush=True)


if __name__ == "__main__":
    main()
