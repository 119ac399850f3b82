#!/usr/bin/env python
"""Micro-tune blocked_cholesky block size / tri_lower_inverse leaf.

Times chol + cho_inverse on the finalize stage's real shapes
((256, 99, 99) at K=100, (64, 199, 199) at K=200), scaled to the
per-E-step call count (one per chunk of 4096 docs).

Usage: cholblock_ab.py  ->  benchmarks/results_cholblock.json
"""

import functools
import json
import os
import sys
import time

from strutopy_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np

HERE = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() and "<" not in str(__file__)
        else os.path.join(os.getcwd(), "benchmarks"))


def main():
    import jax
    import jax.numpy as jnp

    from strutopy_tpu.ops.linalg import blocked_cholesky, tri_lower_inverse

    results = {}
    for (B, P) in ((256, 99), (64, 199)):
        rng = np.random.default_rng(0)
        A = rng.normal(0, 1, (B, P, P)).astype(np.float32)
        H = jnp.asarray(A @ A.transpose(0, 2, 1) / P +
                        0.5 * np.eye(P, dtype=np.float32))
        key = f"B{B}_P{P}"
        results[key] = {}

        def timeit(fn):
            jf = jax.jit(fn)
            float(np.asarray(jf(H)))
            best = 1e9
            for _ in range(5):
                t0 = time.time()
                float(np.asarray(jf(H)))
                best = min(best, time.time() - t0)
            return best

        t = timeit(lambda h: jnp.sum(jnp.linalg.cholesky(h)))
        results[key]["xla_chol"] = round(t * 1e3, 3)
        print(f"{key} xla_chol: {t*1e3:.2f} ms", flush=True)
        for block in (8, 16, 32):
            for leaf in (8, 16):
                if leaf > block:
                    continue

                def fn(h, block=block, leaf=leaf):
                    L = blocked_cholesky(h, block=block)
                    W = tri_lower_inverse(L, leaf=leaf)
                    nu = jnp.einsum("bki,bkj->bij", W, W)
                    return jnp.sum(nu) + jnp.sum(
                        jnp.log(jnp.diagonal(L, axis1=1, axis2=2)))
                t = timeit(fn)
                results[key][f"blk{block}_leaf{leaf}"] = round(t * 1e3, 3)
                print(f"{key} blk{block}_leaf{leaf}: {t*1e3:.2f} ms",
                      flush=True)
    with open(os.path.join(HERE, "results_cholblock.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
