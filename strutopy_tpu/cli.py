"""Command-line interface: the numbered-script surface of the reference
(`src/01..06_*.py`, `script.sh`) as subcommands.

    python -m strutopy_tpu.cli synth  --K 10 --n-corpora 2 --out artifacts/synth
    python -m strutopy_tpu.cli fit    --corpus corpus.pickle --K 20 --out artifacts/fit
    python -m strutopy_tpu.cli train-eval --corpus-dir artifacts/synth/K10_gf1/0 --K 10
    python -m strutopy_tpu.cli find-k --corpus corpus.pickle --K 10 15 20
    python -m strutopy_tpu.cli bench
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle

import numpy as np


def _load_corpus(path):
    if path.endswith(".pickle") or path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    if path.endswith(".json"):
        with open(path) as f:
            return json.load(f)
    if path.endswith(".mm"):
        # C++ parse+pack when the native lib is available (exact python
        # parity, tests/test_wiki_real_data.py) — the python loop is the
        # bulk-serving bottleneck at scale
        from strutopy_tpu.corpus import native

        pc = native.read_mm_padded(path)
        if pc is not None:
            return pc
        # honor the header's declared term count (a dictionary's highest
        # ids may never occur in any document) — same V the native
        # reader uses, so both ingest paths agree on shapes
        from strutopy_tpu.corpus.bow import pad_corpus
        from strutopy_tpu.corpus.io import read_mm

        bow, V = read_mm(path, return_V=True)
        return pad_corpus(bow, V=V)
    raise ValueError(f"unsupported corpus format: {path}")


def _add_mesh_arg(p):
    p.add_argument("--n-devices", type=int, default=0,
                   help="shard documents over this many devices (0 = single)")


def _mesh_from_args(args):
    if getattr(args, "n_devices", 0) and args.n_devices > 1:
        from strutopy_tpu.parallel.mesh import make_mesh

        return make_mesh(args.n_devices)
    return None


def _select_platform(platform: str) -> None:
    """Apply ``--platform`` before any device use; ``gpu`` exits when
    there is no CUDA GPU instead of falling back to the CPU."""
    if platform == "auto":
        return
    import jax

    from strutopy_tpu.utils.runtime import require_gpu

    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    else:
        jax.config.update("jax_platforms", "cuda")
        require_gpu("--platform gpu")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="strutopy_tpu")
    ap.add_argument(
        "--platform",
        choices=["auto", "cpu", "gpu"],
        default="auto",
        help="force the JAX backend (default: auto-detected); gpu fails "
             "when no CUDA GPU is available",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("synth", help="create synthetic corpora (ref: 04_create_synthetic_corpora)")
    p.add_argument("--K", type=int, required=True)
    p.add_argument("--n-corpora", type=int, default=20)
    p.add_argument("--n-docs", type=int, default=1500)
    p.add_argument("--n-words", type=int, default=150)
    p.add_argument("--V", type=int, default=5000)
    p.add_argument("--gamma-factors", type=float, nargs="+", default=[1, 5, 10])
    p.add_argument("--beta", type=str, default=None, help="path to beta_hat.npy")
    p.add_argument("--gamma", type=str, default=None, help="path to gamma_hat.npy")
    p.add_argument("--out", type=str, required=True)

    p = sub.add_parser("fit", help="fit one STM (ref: 03_fit_reference_model)")
    p.add_argument("--corpus", type=str, required=True, help="pickled BoW corpus")
    p.add_argument("--K", type=int, required=True)
    p.add_argument("--X", type=str, default=None, help="covariates .npy")
    p.add_argument("--init", choices=["spectral", "random"], default="spectral")
    p.add_argument("--model", choices=["STM", "CTM"], default="STM")
    p.add_argument("--mode", choices=["ols", "ridge", "lasso"], default="ols")
    p.add_argument("--max-em-iter", type=int, default=25)
    p.add_argument("--beta-smoothing", type=float, default=0.0,
                   help="pseudocount added to the phi stats before beta "
                        "normalization (0 = reference semantics; unseen "
                        "words then get beta=0 and heldout can be -inf)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resumable EM checkpoint path (.npz)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    _add_mesh_arg(p)

    p = sub.add_parser("train-eval", help="document-completion heldout (ref: 05_train)")
    p.add_argument("--corpus-dir", type=str, required=True,
                   help="dir with train_docs/test_docs pickles (from synth)")
    p.add_argument("--K", type=int, required=True)
    p.add_argument("--model", choices=["STM", "CTM"], default="STM")
    p.add_argument("--init", choices=["spectral", "random"], default="spectral")
    p.add_argument("--max-em-iter", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="single-fit transform-based completion (2x faster)")
    _add_mesh_arg(p)

    p = sub.add_parser("find-k", help="heldout K selection (ref: 06_example_application)")
    p.add_argument("--corpus", type=str, required=True)
    p.add_argument("--K", type=int, nargs="+", required=True)
    p.add_argument("--X", type=str, default=None)
    p.add_argument("--models", nargs="+", default=["STM"])
    p.add_argument("--max-em-iter", type=int, default=10)
    p.add_argument("--fast", action="store_true",
                   help="single-fit transform-based completion (2x faster)")
    _add_mesh_arg(p)

    p = sub.add_parser("search-k", help="per-K diagnostics table: heldout, bound, "
                       "coherence, exclusivity, residual dispersion (R-stm searchK)")
    p.add_argument("--corpus", type=str, required=True)
    p.add_argument("--K", type=int, nargs="+", required=True)
    p.add_argument("--X", type=str, default=None)
    p.add_argument("--max-em-iter", type=int, default=10)
    _add_mesh_arg(p)

    p = sub.add_parser("select", help="multi-random-restart selection at fixed K "
                       "(R-stm selectModel): cast runs, keep the best by bound, "
                       "report the coherence/exclusivity frontier")
    p.add_argument("--corpus", type=str, required=True)
    p.add_argument("--K", type=int, required=True)
    p.add_argument("--X", type=str, default=None)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--cast-iters", type=int, default=4)
    p.add_argument("--keep", type=int, default=None)
    p.add_argument("--max-em-iter", type=int, default=50)
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--plot", type=str, default=None,
                   help="write the plotModels-style frontier figure here")
    _add_mesh_arg(p)

    p = sub.add_parser("infer", help="serve: theta for new docs from saved artifacts")
    p.add_argument("--model-dir", type=str, required=True,
                   help="artifact directory written by `fit`")
    p.add_argument("--corpus", type=str, default=None, help="pickled BoW docs")
    p.add_argument("--text", type=str, default=None,
                   help="raw-text input instead of --corpus: .json/.jsonl "
                   "(text field) or one document per line; encoded against "
                   "the model's saved vocab.json")
    p.add_argument("--X", type=str, default=None, help="covariates .npy for the new docs")
    p.add_argument("--out", type=str, required=True, help="output theta .npy")

    sub.add_parser("bench", help="run the E-step throughput benchmark (GPU)")
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    _select_platform(args.platform)

    from strutopy_tpu.utils.runtime import enable_compile_cache

    enable_compile_cache()

    if args.cmd == "synth":
        from strutopy_tpu.pipeline import create_synthetic_corpora

        beta = np.load(args.beta) if args.beta else None
        gamma = np.load(args.gamma) if args.gamma else None
        create_synthetic_corpora(
            K=args.K,
            beta=beta,
            gamma=gamma,
            gamma_factors=args.gamma_factors,
            n_corpora=args.n_corpora,
            n_docs=args.n_docs,
            n_words=args.n_words,
            V=args.V,
            output_dir=args.out,
        )
        print(f"wrote synthetic corpora to {args.out}")

    elif args.cmd == "fit":
        from strutopy_tpu.pipeline import fit_model

        corpus = _load_corpus(args.corpus)
        X = np.load(args.X) if args.X else None
        model = fit_model(
            corpus,
            K=args.K,
            X=X,
            output_dir=args.out,
            max_em_iter=args.max_em_iter,
            init_type=args.init,
            model_type=args.model,
            mode=args.mode,
            mesh=_mesh_from_args(args),
            checkpoint_path=args.checkpoint,
            resume=args.resume,
            beta_smoothing=args.beta_smoothing,
        )
        print(f"final bound: {model.last_bounds[-1]:.2f}; artifacts in {args.out}")

    elif args.cmd == "train-eval":
        from strutopy_tpu.pipeline import train_and_eval_heldout

        with open(os.path.join(args.corpus_dir, "train_docs.pickle"), "rb") as f:
            train = pickle.load(f)
        with open(os.path.join(args.corpus_dir, "test_docs.pickle"), "rb") as f:
            test = pickle.load(f)
        X = None
        meta_path = os.path.join(args.corpus_dir, "metadata.npy")
        if os.path.exists(meta_path):
            X = np.load(meta_path)
        ll, _, _ = train_and_eval_heldout(
            train,
            test,
            K=args.K,
            X=X,
            model_type=args.model,
            init_type=args.init,
            max_em_iter=args.max_em_iter,
            mesh=_mesh_from_args(args),
            fast=args.fast,
        )
        print(f"heldout log-likelihood: {ll:.5f}")

    elif args.cmd == "find-k":
        from strutopy_tpu.pipeline import find_k

        corpus = _load_corpus(args.corpus)
        X = np.load(args.X) if args.X else None
        results = find_k(
            corpus,
            K_candidates=args.K,
            X=X,
            model_types=args.models,
            max_em_iter=args.max_em_iter,
            mesh=_mesh_from_args(args),
            fast=args.fast,
        )
        print(json.dumps(results, indent=2))

    elif args.cmd == "search-k":
        from strutopy_tpu.pipeline import search_k

        corpus = _load_corpus(args.corpus)
        X = np.load(args.X) if args.X else None
        results = search_k(
            corpus,
            K_candidates=args.K,
            X=X,
            max_em_iter=args.max_em_iter,
            mesh=_mesh_from_args(args),
        )
        print(json.dumps(results, indent=2))

    elif args.cmd == "select":
        from strutopy_tpu.pipeline import select_model

        corpus = _load_corpus(args.corpus)
        X = np.load(args.X) if args.X else None
        res = select_model(
            corpus,
            K=args.K,
            runs=args.runs,
            X=X,
            cast_iters=args.cast_iters,
            keep=args.keep,
            max_em_iter=args.max_em_iter,
            seed=args.seed,
            mesh=_mesh_from_args(args),
            return_models=False,
        )
        if args.plot:
            import matplotlib

            matplotlib.use("Agg")
            from strutopy_tpu.eval.plots import plot_select_model

            plot_select_model(res, path=args.plot)
        print(json.dumps({k: res[k] for k in ("runs", "kept", "selected")},
                         indent=2))

    elif args.cmd == "infer":
        X = np.load(args.X) if args.X else None
        if (args.corpus is None) == (args.text is None):
            raise SystemExit("infer needs exactly one of --corpus / --text")
        if args.text:
            from strutopy_tpu.models.serving import ThetaServer

            if args.text.endswith((".json", ".jsonl")):
                from strutopy_tpu.corpus.acquire import load_texts_json

                texts, _ = load_texts_json(args.text)
            else:
                with open(args.text) as f:
                    texts = [ln.rstrip("\n") for ln in f if ln.strip()]
            theta, _eta, report = ThetaServer(args.model_dir).infer_text(texts, X=X)
            print(json.dumps({k: report[k] for k in
                              ("tokens_dropped", "oov_types", "docs_emptied")}))
        else:
            from strutopy_tpu.models.serving import infer_from_artifacts

            corpus = _load_corpus(args.corpus)
            theta, _eta = infer_from_artifacts(args.model_dir, corpus, X=X)
        np.save(args.out, theta)
        print(f"wrote theta {theta.shape} to {args.out}")

    elif args.cmd == "bench":
        # in-process: one process per card
        from strutopy_tpu.bench import main as bench_main

        bench_main()


if __name__ == "__main__":
    main()
