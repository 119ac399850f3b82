"""Typed configuration for STM fits.

Single config object replacing both the reference's kwargs surface
(reference src/modules/stm.py:311-329) and the older nested settings
dict (reference archive/main.py:51-98) whose drift broke
heldout.py:100-155 — see SURVEY.md §5 "Config / flag system".
"""

from __future__ import annotations

import dataclasses
import json


# execution options of kernels that no longer exist; saved configs may
# still name them (see STMConfig.from_json)
_RETIRED_FIELDS = ("use_pallas", "pallas_fgh", "pallas_cg", "pallas_ls",
                   "pallas_iter", "pallas_block", "cg_chunk_docs")


@dataclasses.dataclass(frozen=True)
class STMConfig:
    """Configuration of an STM/CTM fit.

    Field names mirror the reference ``STM.__init__`` kwargs
    (reference src/modules/stm.py:311-329) so users of the reference
    can map 1:1; execution knobs are grouped at the bottom.
    """

    K: int
    # topical content
    content: bool = False
    A: int = 1
    kappa_interactions: bool = False
    lda_beta: bool = True
    # additive pseudocount on the phi sufficient statistics before the
    # LDA-style row normalization.  0.0 (default) reproduces the
    # reference's update_beta exactly (stm.py:739-745: bare
    # row-normalize, so words unseen in training get beta=0 and any
    # heldout occurrence scores -inf); a small value (e.g. 0.01..0.05)
    # keeps every word representable in a completion heldout.
    beta_smoothing: float = 0.0
    # prevalence regression
    model_type: str = "STM"  # "STM" | "CTM"
    mode: str = "ols"  # "ols" | "ridge" | "lasso"
    fit_intercept: bool = True
    ridge_alpha: float = 0.1  # matches reference Ridge(alpha=0.1), stm.py:685
    lasso_alpha: float = 1.0  # matches reference Lasso(alpha=1), stm.py:679
    # EM loop
    max_em_iter: int = 100
    convergence_threshold: float = 1e-5
    sigma_prior: float = 0.0
    # initialization
    init_type: str = "spectral"  # "spectral" | "random"
    seed: int = 123456  # reference seeds numpy with 123456 (stm.py:361)
    spectral_max_v: int = 5000  # reference maxV default (stm.py:422)
    # content-model (kappa) Poisson regression
    kappa_l2: float = 250.0  # reference alpha=250 (stm.py:758)
    # per-word Newton CAP: the batched solver exits early once every
    # word's gradient max-norm is below kappa_grad_tol (the reference
    # fits each word to sklearn tol=1e-5, stm.py:820); warm-started
    # steady-state updates typically take 2-4 iterations
    kappa_newton_iters: int = 40
    kappa_grad_tol: float = 1e-6
    # delta-magnitude convergence skip (ops/mstep.py::update_beta_content):
    # freeze words whose accepted Newton step improves the objective by
    # less than this RELATIVE amount — at the f32 cancellation floor the
    # gradient may never meet kappa_grad_tol while iterations only churn.
    # 0 = off (bit-identical to the pre-knob exit)
    kappa_ftol_rel: float = 0.0
    # E-step solver
    newton_max_iters: int = 24
    newton_grad_tol: float = 1e-5  # scipy BFGS gtol default the reference relies on
    newton_max_backtracks: int = 12
    newton_cg_iters: int = 6  # Steihaug CG steps (capped at K-1; 6 matches cg=12 bounds to 0.05% at K=100-200)
    newton_bf16_hessian: bool = True  # bf16 operands for the in-loop Hessian product
    newton_fixed_iters: bool = False  # run exactly max_iters (fori_loop)
    # two-pass difficulty schedule (ops/estep.py::_two_pass_estep):
    # pass 1 caps every chunk at newton_pass1_iters Newton steps, pass 2
    # densely regroups the unconverged stragglers (a static
    # newton_straggler_frac budget of N) and finishes them, pass 3
    # finalizes.  0 disables (single-pass while_loop per chunk).
    newton_pass1_iters: int = 0
    newton_straggler_frac: float = 0.3
    # fuse the finalize (nu/bound/phi) into passes 1 and 2 of the
    # two-pass schedule (ops/estep.py::_two_pass_fused_estep): removes
    # pass 3's full beta_doc re-gather at the cost of re-finalizing the
    # straggler fraction.  Same per-doc Newton trajectories; stats land
    # in a different f32 summation order.  Ignored when the two-pass
    # schedule is off.
    two_pass_fused: bool = False
    # with the two-pass schedule on, run the first N EM iterations on
    # the single-pass graph: cold warm starts leave most docs
    # unconverged at the pass-1 cap, starving the straggler budget
    # (costs one extra compile; irrelevant once fits exceed ~5 iters)
    newton_warmup_iters: int = 2
    # execution
    batch_size: int = 256  # docs per E-step scan chunk (per device; smaller chunks reduce Newton convergence coupling)
    # bf16 beta_doc for the Newton search path (finalize stays f32)
    newton_bf16_beta: bool = False
    # nu inverse strategy: "blocked" (straight-line blocked Cholesky +
    # divide-and-conquer triangular inverse, exact to f32 rounding —
    # ops/linalg.py::blocked_cholesky), "chol" (XLA Cholesky +
    # triangular solves), or "ns" (Newton-Schulz, ~1e-3 sigma_ss error)
    nu_method: str = "blocked"
    # blocked_cholesky block size (only read when nu_method="blocked");
    # 0 = auto: 16 at K<=200, 32 above
    chol_block: int = 0
    # likelihood tempering of the per-doc eta search objective
    # (ops/estep.py::NewtonConfig.likelihood_temper): values < 1 damp
    # the likelihood gradient so eta shrinks toward the prior mean —
    # the principled form of the implicit shrinkage the reference's df
    # bug applies on small corpora (PARITY_NOTES #1).  The finalize
    # pass (bound/phi/nu) always evaluates the TRUE model.  1.0 = off.
    likelihood_temper: float = 1.0
    debug_checks: bool = False  # host-side numerical sanitizers per EM iter
    # length bucketing: run the E-step per document-length class at its
    # own (static) padded L instead of the global max
    auto_bucket: bool = True
    max_buckets: int = 4
    # order docs by last iteration's Newton count so scan chunks group
    # similarly-hard documents (each chunk's while_loop runs to its own
    # max, not the corpus max)
    sort_by_difficulty: bool = True
    # unroll factor for the E-step's over-chunks lax.scan: >1 lets XLA
    # interleave consecutive chunks' small ops
    scan_unroll: int = 1

    def __post_init__(self):
        if self.K < 2:
            raise ValueError("Number of topics K must be >= 2")
        if self.model_type not in ("STM", "CTM"):
            raise ValueError(f"model_type must be STM or CTM, got {self.model_type}")
        if self.mode not in ("ols", "ridge", "lasso"):
            raise ValueError(f"mode must be ols/ridge/lasso, got {self.mode}")
        if self.init_type not in ("spectral", "random"):
            raise ValueError(f"init_type must be spectral or random, got {self.init_type}")
        if not 0.0 <= self.sigma_prior <= 1.0:
            raise ValueError("sigma_prior must be in [0, 1]")
        if self.content and self.A < 2:
            raise ValueError("content=True requires A >= 2 aspects")
        if self.beta_smoothing < 0.0:
            raise ValueError("beta_smoothing must be >= 0")
        if self.nu_method not in ("chol", "ns", "blocked"):
            raise ValueError(
                f"nu_method must be chol, ns or blocked, got {self.nu_method}")
        if self.newton_pass1_iters < 0 or self.newton_pass1_iters >= self.newton_max_iters and self.newton_pass1_iters != 0:
            raise ValueError(
                "newton_pass1_iters must be 0 (off) or in [1, newton_max_iters)"
            )
        if not 0.0 < self.newton_straggler_frac <= 1.0:
            raise ValueError("newton_straggler_frac must be in (0, 1]")
        if self.newton_warmup_iters < 0:
            raise ValueError("newton_warmup_iters must be >= 0")
        if not 0.0 < self.likelihood_temper <= 1.0:
            raise ValueError("likelihood_temper must be in (0, 1]")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "STMConfig":
        """Parse ``to_json`` output; the options of the removed E-step
        kernels, which configs saved by older versions carry, are
        dropped.  Any other unknown field raises ``TypeError``."""
        kw = json.loads(s)
        for name in _RETIRED_FIELDS:
            kw.pop(name, None)
        return cls(**kw)

    def replace(self, **kw) -> "STMConfig":
        return dataclasses.replace(self, **kw)
