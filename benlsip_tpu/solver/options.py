"""Solver hyperparameter configuration.

The reference exposes ~20 keyword hyperparameters with defaults on
`tralcnllss` (`/root/reference/src/basic_tralcnlss.jl:177-197`) plus two
hard-wired module consts for logging (ref :3-4, SURVEY.md §2.3 quirk 5).
Here they form one frozen (hashable, jit-static) dataclass with *exactly*
the reference defaults, and the logging side effects become proper knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Hyperparameters of the TRALCNLLS iteration.

    Field-by-field mirror of the reference keyword list
    (ref `src/basic_tralcnlss.jl:177-197`); tolerances defaulting to
    sqrt(eps(T)) are encoded as None and resolved against the working dtype
    at solve time (ref :181-182).
    """

    # Outer augmented-Lagrangian loop (ref :177-186)
    mu0: float = 10.0            # initial penalty parameter
    tau: float = 100.0           # penalty increase factor
    omega0: float = 1.0          # initial criticality tolerance scale
    eta0: float = 1.0            # initial feasibility tolerance scale
    feas_tol: Optional[float] = None   # ‖c(x)‖ tolerance; None -> sqrt(eps)
    crit_tol: Optional[float] = None   # criticality tolerance; None -> sqrt(eps)
    k_crit: float = 1.0          # omega = omega0 / mu^k_crit (ref :153-163)
    k_feas: float = 0.1          # eta   = eta0   / mu^k_feas
    beta_crit: float = 1.0       # omega tightening exponent on accept (ref :281)
    beta_feas: float = 0.9       # eta tightening exponent on accept (ref :282)

    # Trust-region control (ref :187-191)
    eta1: float = 0.25           # step acceptance threshold
    eta2: float = 0.75           # very-successful threshold
    gamma1: float = 0.0625       # radius decrease factor
    gamma2: float = 2.0          # radius increase factor
    gamma_c: float = 10.0        # legacy Cauchy expansion factor (ref :191)

    # Inner/CG tolerances (ref :192-194)
    kappa1: float = 1e-2         # projected-Cauchy sufficient-decrease fraction
    kappa2: float = 0.1          # CG relative tolerance
    kappa3: float = 0.1          # minor-loop reduced-gradient fraction
    cauchy_max_trials: int = 16  # projected-Cauchy backtracking trial cap
                                 # (the reference's expansion/backtracking
                                 # loop cap, ref :481-496)
    projected_cauchy_threshold: int = 32
    # Free-dimension count (n - m) above which the projected-search Cauchy
    # step (one exact projection activates any number of bounds) replaces
    # the reference's one-bound-per-segment breakpoint walk (ref :615-637),
    # whose sequential trip count grows with the active set.

    # Iteration caps (ref :195-197)
    max_outer_iter: int = 500
    max_inner_iter: int = 500
    max_minor_iter: int = 50

    # Stall detection (new; the reference burns its caps when a tolerance
    # sits below the dtype's criticality floor — fatal for batched lockstep
    # execution where one stuck instance stalls the whole chunk).
    stall_window: int = 12       # TR iterations without pi improving by
    stall_ratio: float = 0.99    # a factor stall_ratio -> exit subproblem
    outer_stall_window: int = 6  # same at the outer level (with feasibility
                                 # already at tolerance) -> SOLVE_STALLED

    # New knobs (absent in the reference)
    matmul_precision: str = "highest"
    # Accelerators run f32 matmuls at reduced precision by default (TF32,
    # ~3 decimal digits, on the GPU); Gauss-Newton on medium/large
    # instances then loses the accuracy it needs — config 3 (n=192,
    # d=1024) stopped converging on the earlier accelerator's default.
    # "highest" (true f32) is the correct default for a solver; set
    # "default" to opt out on small well-conditioned batches where speed
    # matters more.  chip_smoke.check_matmul_precision pins that the two
    # differ on the GPU.
    project_x0: bool = True      # project x0 onto {Ax=b, xl≤x≤xu} at entry;
                                 # the reference silently misbehaves on
                                 # infeasible starts (its iterations only
                                 # move within the feasible polyhedron)
    gram_hessian: str = "auto"
    # "on"/"off"/"auto": materialize the Gram matrix G = JᵀJ + mu CᵀC once
    # per Jacobian refresh so every H·v in CG/Cauchy reads an (n,n) operator
    # instead of streaming the (d,n) Jacobian twice — the CG loop at
    # config-3/4 scale is HBM-bandwidth-bound, not flop-bound.  "auto" turns
    # it on when n ≥ 64 and d + p ≥ 2n (bandwidth regime with an amortizable
    # O(dn²) build).  Off for tiny batched instances: the Gram form squares
    # the Jacobian's conditioning, which the f32 bulk phase of the
    # mixed-precision pipeline has no accuracy headroom for at default
    # tolerances (the f64 phases are indifferent).
    gn_factorization: str = "auto"
    # "normal"/"qr"/"cholqr2"/"auto": HOW the materialized (n,n) Hessian
    # operator is built when `gram_hessian` turns materialization on.
    # "normal" forms the Gram matrix G = JᵀJ + mu CᵀC (one GEMM, but
    # everything below κ(J)²·eps rounds away); "qr" takes the thin-QR
    # factor R of [J; sqrt(mu)C] via blocked Householder (RᵀR = G exactly,
    # accurate to κ(J)·eps, but panel-serialized — slow at large shapes
    # and not distributable); "cholqr2" builds the same R through
    # CholeskyQR2 (ops/qr.cholqr2_r): three GEMM-class passes,
    # κ-grade after the refinement pass (any κ via the
    # shift rescue), and distributable — under spmd_axis the Gram passes
    # psum and J is never gathered — the BASELINE north-star "QR+PCG"
    # route at scale.  "auto" picks "normal" for f64 and, for f32/bf16
    # working dtypes (where κ² eats the entire accuracy budget:
    # eps(f32)·κ² > 1 already at κ ~ 3e3), "qr" at small n (batched
    # Householder under vmap) or "cholqr2" at n ≥ 64 / under spmd_axis.  Also selects
    # the multiplier estimate's algebra (solver/multipliers.py): QR of Cᵀ
    # vs Cholesky of CCᵀ (ref :897-901).
    linear_residuals: bool = False
    # The residuals are AFFINE in x (constant Jacobian J) — constrained
    # linear least squares, the workload class of BASELINE configs 3/4.
    # The subproblem then computes the JᵀJ block of the Gram operator ONCE
    # per subproblem (ops/al.gram_j) and every per-acceptance refresh
    # rebuilds only the mu·CᵀC term (p ≪ n) + the factorization: the
    # 2dn² refresh GEMM is the largest device cost of a config-4-shaped
    # solve, so this removes most of the device work for linear problems.  Correctness contract: jac_res(x) must actually be
    # x-independent — the solver cannot verify this and will silently use
    # a stale JᵀJ if it is not.  No effect in matrix-free mode
    # (gram_hessian off: H·v streams J, there is no refresh to cache) or
    # on the Householder "qr" route (R of [J; sqrt(mu)C] has no reusable
    # J-only block).
    tr_factor: float = 0.1       # initial radius = tr_factor*‖g‖ (ref :817-819)
    chol_reg: float = 0.0        # jitter on A Z Aᵀ factorizations
    spmd_axis: Optional[str] = None
    # Mesh-axis name the residual dimension is sharded over when the solve
    # runs INSIDE shard_map (the explicit-collectives blocked mode,
    # dist/sharded.py:solve_large_blocked_shardmap): every d-contraction
    # (rᵀr, Jᵀr, JᵀJ, ‖Jv‖²) then carries one explicit psum through
    # dist/collectives.py.  None (default) = unsharded and pjit modes,
    # where XLA inserts the collectives from sharding constraints instead.
    gram_layout: str = "replicated"
    # Layout of the materialized Gram operator under spmd_axis.
    # "replicated": one n² psum per refresh, every device stores the full
    # (n, n) G, matvecs are local.  "sharded": reduce-scatter instead
    # (half the refresh traffic, n²/D memory per device — mandatory once
    # n² no longer fits replicated), matvecs pay one tiled n-vector
    # all_gather (ops/al.with_gram_rows).  Ignored when spmd_axis is None
    # or the operator is not materialized.
    reduce_schedule: str = "xla"
    # How the sharded-Gram reduce-scatter is scheduled: "xla" =
    # lax.psum_scatter (one fused collective), "ring" = the hand-scheduled
    # D−1-hop ppermute ring (dist/collectives.ring_psum_scatter), which
    # exposes each hop to XLA's async-collective overlap — the knob for
    # controlling the communication schedule directly on pod-scale meshes.
    unroll_limit: int = 0
    # Static trip-count threshold below which the bounded inner loops
    # (Cauchy walk, projected CG, minor iterations) compile as masked
    # straight-line code instead of lax.while_loop (solver/loops.py).
    # 0 = always while_loop: chosen on the earlier accelerator, where the
    # unrolled programs compiled far slower for no warm gain; not yet
    # measured on the H100 (ROADMAP Speed item 3).  Part of
    # compiled-program identity (static under jit).
    verbose: bool = False        # iteration log via host callback (the
                                 # reference hard-wires verbose=true, ref :3)

    def __post_init__(self):
        # Sanity check mirrored from ref :200.
        assert 0 < self.eta1 <= self.eta2 < 1 and 0 < self.gamma1 < 1 < self.gamma2, (
            "Invalid trust region updates parameters"
        )

    def resolve_tols(self, dtype) -> "SolverOptions":
        """Fill None tolerances with sqrt(eps(dtype)) (ref :181-182)."""
        import math

        import jax.numpy as jnp

        # jnp.finfo, not np.finfo: the latter rejects ml_dtypes (bf16).
        se = float(math.sqrt(float(jnp.finfo(dtype).eps)))
        return dataclasses.replace(
            self,
            feas_tol=self.feas_tol if self.feas_tol is not None else se,
            crit_tol=self.crit_tol if self.crit_tol is not None else se,
        )
