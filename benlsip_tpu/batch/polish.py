"""Warm-start SQP polish: the fast path of the mixed-precision pipeline.

`refine_f64` (batch/refine.py) restarts the full TRALCNLLS machinery —
trust region, Cauchy breakpoints, projected CG, exact-projection
criticality each iteration — to certify f32 bulk solutions at f64 KKT
grade.  That machinery exists to make *global* progress; a warm start
doesn't need it.  At the f32 solution the active set is identified and the
point is within ~sqrt(eps(f32)) of the optimum, so a handful of
fixed-active-set Gauss-Newton SQP steps converge to the f64 KKT region:

    min_dx ½‖J dx + r‖²  s.t.  C dx + c = 0,  A dx = (b - Ax),  dx_i = 0 (i fixed)

solved as one dense (n+p+m) KKT system per step (tiny for the batched-small
regime; vmapped over instances so it's one batched solve on the device).
Fixed variables are eliminated by masking: with Z = diag(free),

    [ Z JᵀJ Z + diag(fixed) + reg·Z    (E Z)ᵀ ] [dx]   [ -Z Jᵀ r ]
    [            E Z                    -δI    ] [nu] = [   -e    ]

whose fixed rows read dx_i = 0 exactly, and whose stationarity rows at
convergence (dx → 0) read Z(Jᵀr + Cᵀnu_c + Aᵀnu_a) = 0 — the KKT
stationarity condition on the free variables, so nu_c IS the converged
multiplier estimate y (compare `least_squares_multipliers`,
ref `/root/reference/src/basic_tralcnlss.jl:887-903`, which ignores A and
bounds).

Each polished instance is *certified* with the same oracle the solver and
the reference's tests use — exact-projection criticality
‖P_Ω(x − ∇L) − x‖ (ref `test/problems/sphere_regression.jl:58-62`) plus
‖c(x)‖ — and instances that fail certification (mis-identified active set,
constraint degeneracy) fall back to the full `refine_f64` on a gathered
sub-batch.  Wrong-active-set guesses therefore cost time, never accuracy.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.constraints import Polyhedron
from ..harness.devices import local_cpu
from ..harness.steps import dispatch, note_fallback
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from ..solver.status import SOLVE_CONVERGED, SOLVE_MAX_OUTER
from .vmap_solve import BatchedProblem

Array = jax.Array


def _factor_phase(fns, poly: Polyhedron, x0: Array, refactor_steps: int,
                  active_tol: float, reg: float, dual_reg: float):
    """Active-set settling + KKT factorization steps (single instance).

    Runs the refactorizing Gauss-Newton steps — the O(dn²) JᵀJ formation +
    O((n+p+m)³) LU each, the dominant polish cost at config-3 scale — and
    returns (x, nu, lu, piv, free) for the chord phase to iterate on.

    Active-set identification: bounds within active_tol (relative) of the
    warm start are candidates (the f32 solver's projections place truly
    active variables ON the bound, so the tolerance only absorbs f32
    rounding).  Which candidates are FIXED is re-decided every refactor
    step from the current Lagrangian gradient — a semismooth active-set
    Newton: at a lower-bound optimum the bound multiplier is
    sigma_i = (nabla L)_i >= 0 (<= 0 at an upper), so a candidate whose
    gradient sign says "the optimizer wants to move inward" is released.
    The first step has no multiplier estimate yet (nu = 0 makes the sign
    rule the raw-gradient test, which mis-judges under Ax=b coupling) and
    fixes every candidate; from step 2 on, nu from the previous KKT solve
    makes the rule exact.  A wrong face then self-corrects instead of
    trapping GN on it (measured: 60/64 -> 64/64 certified on the dense
    config-3 family).  The steps must be a STATIC Python unroll: under
    vmap a lax.cond becomes a select that executes both branches, which
    would pay the refactorization every step anyway.
    """
    dtype = x0.dtype
    n = x0.shape[0]
    A, b = poly.A, poly.b
    m = A.shape[0]
    p = fns.nlconstraints(x0).shape[0]

    scale = 1.0 + jnp.abs(x0)
    at_lo = jnp.isfinite(poly.xl) & ((x0 - poly.xl) <= active_tol * scale)
    at_hi = jnp.isfinite(poly.xu) & ((poly.xu - x0) <= active_tol * scale)
    x_start = jnp.where(at_lo, poly.xl, jnp.where(at_hi, poly.xu, x0))

    from jax.scipy.linalg import lu_factor, lu_solve

    x, nu = x_start, jnp.zeros((p + m,), dtype)
    lu = piv = free = None
    for k in range(max(refactor_steps, 1)):  # static unroll
        r = fns.residuals(x)
        J = fns.jac_res(x)
        c = fns.nlconstraints(x)
        e = jnp.concatenate([c, A @ x - b], axis=0)    # (p+m,)

        C = fns.jac_nlcons(x)
        E = jnp.concatenate([C, A], axis=0)            # (p+m, n)
        gL = J.T @ r + E.T @ nu
        keep_lo = at_lo & (gL >= 0)
        keep_hi = at_hi & (gL <= 0)
        fixed = (at_lo | at_hi) if k == 0 else (keep_lo | keep_hi)
        free = (~fixed).astype(dtype)

        EZ = E * free[None, :]
        JZ = J * free[None, :]
        H = JZ.T @ JZ + jnp.diag(fixed.astype(dtype)) + reg * jnp.diag(free)
        kk = n + p + m
        K = jnp.zeros((kk, kk), dtype)
        K = K.at[:n, :n].set(H)
        K = K.at[:n, n:].set(EZ.T)
        K = K.at[n:, :n].set(EZ)
        K = K.at[n:, n:].set(-dual_reg * jnp.eye(p + m, dtype=dtype))
        lu, piv = lu_factor(K)
        rhs = jnp.concatenate([-(free * (J.T @ r)), -e])
        sol = lu_solve((lu, piv), rhs)
        x = jnp.clip(x + sol[:n] * free, poly.xl, poly.xu)
        nu = sol[n:]
    return x, nu, lu, piv, free


def _kkt_solve_qr(RJ: Array, Qw: Array, Tw: Array, rhs_x: Array, rhs_e: Array):
    """Solve the GN KKT system through its range-space QR factors.

        [ RJᵀRJ   (EZ)ᵀ ] [dx]   [rhs_x]        RJ  = qr_r([JZ; D_fixed])
        [  EZ       0   ] [dν] = [rhs_e]        Wᵀ  = RJ⁻ᵀ(EZ)ᵀ = Qw Tw

    Substituting t = RJ dx eliminates the primal block: the dual solves
    TwᵀTw dν = W z₀ − rhs_e with z₀ = RJ⁻ᵀ rhs_x, then t = z₀ − Wᵀdν and
    dx = RJ⁻¹ t.  Every operation is a triangular solve or an orthogonal
    product, so the factorization error is O(κ(J)·eps) — the LU of the
    assembled KKT matrix (whose H block carries JᵀJ) is O(κ(J)²·eps),
    which is the difference between an f32 factor that contracts under
    iterative refinement and one that diverges at κ(J) ≳ 3e3 (the
    BASELINE north-star "QR+PCG" regime).
    """
    from jax.scipy.linalg import solve_triangular

    z0 = solve_triangular(RJ.T, rhs_x, lower=True)
    if Tw.shape[0] == 0:
        dnu = jnp.zeros_like(rhs_e)
        t = z0
    else:
        u = Qw.T @ z0 - solve_triangular(Tw.T, rhs_e, lower=True)
        dnu = solve_triangular(Tw, u, lower=False)
        t = z0 - Qw @ (Tw @ dnu)
    dx = solve_triangular(RJ, t, lower=False)
    return dx, dnu


def _factor_phase_qr(fns, poly: Polyhedron, x0: Array, refactor_steps: int,
                     active_tol: float, reg: float):
    """QR-factored twin of `_factor_phase` (same active-set settling logic,
    same GN steps) returning (x, nu, RJ, Qw, Tw, free).

    Instead of assembling and LU-factoring the (n+p+m) KKT matrix — whose
    H = (JZ)ᵀ(JZ) block squares the Jacobian's conditioning before the
    factorization ever sees it — this factors the Jacobian itself:
    RJ = qr_r([JZ; D]) with D = diag(fixed ? 1 : sqrt(reg)) (so RJᵀRJ =
    H exactly), and the constraint coupling through the thin QR of
    Wᵀ = RJ⁻ᵀ(EZ)ᵀ, a thin QR with only p+m columns (ops/qr.py).
    """
    dtype = x0.dtype
    n = x0.shape[0]
    A, b = poly.A, poly.b
    m = A.shape[0]
    p = fns.nlconstraints(x0).shape[0]

    scale = 1.0 + jnp.abs(x0)
    at_lo = jnp.isfinite(poly.xl) & ((x0 - poly.xl) <= active_tol * scale)
    at_hi = jnp.isfinite(poly.xu) & ((poly.xu - x0) <= active_tol * scale)
    x_start = jnp.where(at_lo, poly.xl, jnp.where(at_hi, poly.xu, x0))

    from jax.scipy.linalg import solve_triangular

    from ..ops.qr import qr_r, thin_qr

    x, nu = x_start, jnp.zeros((p + m,), dtype)
    RJ = Qw = Tw = free = None
    sreg = jnp.sqrt(jnp.asarray(reg, dtype))
    for k in range(max(refactor_steps, 1)):  # static unroll (see _factor_phase)
        r = fns.residuals(x)
        J = fns.jac_res(x)
        c = fns.nlconstraints(x)
        e = jnp.concatenate([c, A @ x - b], axis=0)    # (p+m,)

        C = fns.jac_nlcons(x)
        E = jnp.concatenate([C, A], axis=0)            # (p+m, n)
        gL = J.T @ r + E.T @ nu
        keep_lo = at_lo & (gL >= 0)
        keep_hi = at_hi & (gL <= 0)
        fixed = (at_lo | at_hi) if k == 0 else (keep_lo | keep_hi)
        free = (~fixed).astype(dtype)

        EZ = E * free[None, :]
        JZ = J * free[None, :]
        dbot = jnp.where(fixed, jnp.ones((), dtype), sreg)
        RJ = qr_r(jnp.concatenate([JZ, jnp.diag(dbot)], axis=0))   # (n, n)
        Wt = solve_triangular(RJ.T, EZ.T, lower=True)              # (n, p+m)
        Qw, Tw = thin_qr(Wt)
        rhs = -(free * (J.T @ r))
        dx, dnu = _kkt_solve_qr(RJ, Qw, Tw, rhs, -e)
        x = jnp.clip(x + dx * free, poly.xl, poly.xu)
        nu = dnu
    return x, nu, RJ, Qw, Tw, free


def _certify(fns, poly: Polyhedron, x: Array, nu: Array, p: int,
             crit_tol: float, feas_tol: float):
    """Shared certification tail of both chord phases.

    Exact-projection criticality (the solver's own oracle; see
    solver/subproblem.criticality_measure) + feasibility.  The
    projection's dual is warm-started with the chord phase's own A-block
    multipliers: at a KKT point the projection of z = x - (J^T r + C^T y)
    satisfies v(lam*) = x with lam* = nu_A exactly (stationarity
    gL = -A^T nu_A + bound-normal components), so the dual Newton starts
    at its solution and certifies in ~1 step instead of ~5 cold — the
    in-loop cold-restart rescue bounds the cost when the identification
    is off (ops/polyproject.py).  Returns (x, y, converged, pix, feas, objective).
    """
    from ..ops.polyproject import projection_polyhedron

    A, b = poly.A, poly.b
    y = nu[:p]
    r = fns.residuals(x)
    c = fns.nlconstraints(x)
    gL = fns.jac_res(x).T @ r + fns.jac_nlcons(x).T @ y
    pix = jnp.linalg.norm(
        projection_polyhedron(poly, x - gL, lam0=nu[p:]) - x
    )
    feas = jnp.sqrt(jnp.sum(c * c) + jnp.sum((A @ x - b) ** 2))
    converged = (pix <= crit_tol) & (feas <= feas_tol)
    return x, y, converged, pix, feas, 0.5 * jnp.vdot(r, r)


def _chord_phase_qr(fns, poly: Polyhedron, x: Array, nu: Array, RJ: Array,
                    Qw: Array, Tw: Array, free: Array, chord_steps: int,
                    crit_tol: float, feas_tol: float):
    """QR-factored twin of `_chord_phase`: frozen (RJ, Qw, Tw) solves with
    the exact KKT residual in delta form (see `_chord_phase` on why the
    incremental dual is load-bearing).  Returns the same tuple.

    The factored solve runs in the FACTORS' dtype: when the fused device
    path passes f32 factors with f64 state, this is mixed-precision
    iterative refinement (f64 residuals set the accuracy, the f32 factor
    only the contraction rate), so the per-step triangular solves stay in
    f32.  With matching dtypes (the host path) the casts are no-ops.
    """
    A, b = poly.A, poly.b
    p = nu.shape[0] - A.shape[0]
    fdt = RJ.dtype

    for _ in range(chord_steps):  # static unroll
        r = fns.residuals(x)
        J = fns.jac_res(x)
        c = fns.nlconstraints(x)
        C = fns.jac_nlcons(x)
        e = jnp.concatenate([c, A @ x - b], axis=0)
        gL = J.T @ r + jnp.concatenate([C, A], axis=0).T @ nu
        dx, dnu = _kkt_solve_qr(
            RJ, Qw, Tw, (-(free * gL)).astype(fdt), (-e).astype(fdt)
        )
        x = jnp.clip(x + dx.astype(x.dtype) * free, poly.xl, poly.xu)
        nu = nu + dnu.astype(nu.dtype)
    return _certify(fns, poly, x, nu, p, crit_tol, feas_tol)


def _chord_phase(fns, poly: Polyhedron, x: Array, nu: Array, lu: Array,
                 piv: Array, free: Array, chord_steps: int,
                 crit_tol: float, feas_tol: float):
    """Frozen-LU (chord) Newton steps + certification (single instance).

    Each step reuses the factor-phase LU with a fresh right-hand side —
    a frozen-Jacobian Newton step, linearly convergent from the warm
    start, at O(dn) per step.  When the LU was computed in a lower
    precision (the split pipeline: f32 factors promoted to f64), this is
    classic mixed-precision iterative refinement of the KKT system: the
    contraction factor is ~kappa(K)·eps(f32) per step, and the certified
    accuracy comes from the f64 residuals, not the factor.

    The update is in INCREMENTAL (delta) form for both primal and dual:
    the right-hand side is the exact KKT residual at the current (x, nu)
    evaluated in the working dtype, −[Z(Jᵀr + Eᵀnu); e], and the solve
    yields (dx, dnu).  The non-incremental form (fresh nu each step from
    rhs = −[ZJᵀr; e]) has a fixed point whose stationarity holds through
    the FROZEN operator E₃₂ baked into the LU — a ~‖nu‖·eps(f32)
    stationarity floor (measured ~1e-7 on the dense config-3 family)
    that no number of chord steps crosses.  The delta form's fixed point
    zeroes the exact-operator residual, so accuracy is limited only by
    the f64 evaluation, while the f32 factor merely sets the contraction
    rate.

    Returns (x, y, converged, pix, feas, objective).
    """
    n = x.shape[0]
    A, b = poly.A, poly.b
    p = nu.shape[0] - A.shape[0]
    from jax.scipy.linalg import lu_solve

    for _ in range(chord_steps):  # static unroll
        r = fns.residuals(x)
        J = fns.jac_res(x)
        c = fns.nlconstraints(x)
        C = fns.jac_nlcons(x)
        e = jnp.concatenate([c, A @ x - b], axis=0)
        gL = J.T @ r + jnp.concatenate([C, A], axis=0).T @ nu
        rhs = jnp.concatenate([-(free * gL), -e])
        sol = lu_solve((lu, piv), rhs)
        x = jnp.clip(x + sol[:n] * free, poly.xl, poly.xu)
        nu = nu + sol[n:]
    return _certify(fns, poly, x, nu, p, crit_tol, feas_tol)


def _resolve_kkt(kkt_factorization: str, dtype) -> str:
    """"auto" → "qr" for f32/bf16 factor dtypes (where the LU of the
    assembled normal-equations KKT has no κ² headroom), "lu" for f64."""
    if kkt_factorization != "auto":
        return kkt_factorization
    low = jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))
    return "qr" if low else "lu"


def _polish_one(fns, poly: Polyhedron, x0: Array, num_steps: int, active_tol: float,
                reg: float, dual_reg: float, crit_tol: float, feas_tol: float,
                refactor_steps: int = 2, kkt: str = "lu"):
    """Polish a single instance (vmapped by the callers): factor phase
    (refactorizing GN steps) + chord phase (frozen-factor steps) +
    certification, all in the working dtype on one device.  kkt selects
    the factorization route: "lu" (assembled KKT) or "qr" (range-space).

    Returns (x, y, converged, pix, feas, objective).
    """
    rs = min(max(refactor_steps, 1), num_steps)
    if kkt == "qr":
        with jax.named_scope("polish_factor_qr"):
            x, nu, RJ, Qw, Tw, free = _factor_phase_qr(fns, poly, x0, rs, active_tol, reg)
        with jax.named_scope("polish_chord_certify"):
            return _chord_phase_qr(fns, poly, x, nu, RJ, Qw, Tw, free, num_steps - rs,
                                   crit_tol, feas_tol)
    with jax.named_scope("polish_factor_lu"):
        x, nu, lu, piv, free = _factor_phase(fns, poly, x0, rs, active_tol, reg, dual_reg)
    with jax.named_scope("polish_chord_certify"):
        return _chord_phase(fns, poly, x, nu, lu, piv, free, num_steps - rs,
                            crit_tol, feas_tol)


@functools.lru_cache(maxsize=128)
def _polish_runner(fns_key, poly_axes_key, num_steps, active_tol, reg, dual_reg,
                   crit_tol, feas_tol, refactor_steps, kkt="lu"):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x0_i, poly_i):
        bp_i = BatchedProblem(
            residuals=residuals,
            nlconstraints=nlconstraints,
            jac_res=jac_res,
            jac_nlcons=jac_nlcons,
        )
        fns = bp_i.instance_fns(theta_i)
        # Full-precision matmuls for the same reason as solve_fixed_point
        # (no-op on CPU, where the polish runs by default).
        with jax.default_matmul_precision("highest"):
            return _polish_one(fns, poly_i, x0_i, num_steps, active_tol, reg,
                               dual_reg, crit_tol, feas_tol, refactor_steps, kkt)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, Polyhedron(*poly_axes_key))))


def sqp_polish(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 3,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    dual_reg: float = 1e-14,
    refactor_steps: int = 2,
    kkt_factorization: str = "auto",
):
    """Batched fixed-active-set SQP polish of warm starts X0.

    Returns (X, Y, converged, pix, feas, objective), all with leading batch
    axis.  `converged` is the per-instance certification mask.
    """
    n = X0.shape[-1]
    dtype = X0.dtype
    opts = options.resolve_tols(jnp.dtype(dtype))
    poly = bp.polyhedron(n, dtype)
    from .vmap_solve import poly_batch_axes

    poly_axes = poly_batch_axes(poly)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    run = _polish_runner(fns_key, poly_axes, num_steps, active_tol, reg, dual_reg,
                         float(opts.crit_tol), float(opts.feas_tol), refactor_steps,
                         _resolve_kkt(kkt_factorization, dtype))
    return run(theta, X0, poly)


@functools.lru_cache(maxsize=128)
def _factor_runner(fns_key, poly_axes_key, refactor_steps, active_tol, reg, dual_reg):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x0_i, poly_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        # Full-precision f32 matmuls: the KKT build is exactly the op class
        # a reduced-precision default (TF32 on the GPU) breaks (see
        # SolverOptions.matmul_precision).
        with jax.default_matmul_precision("highest"):
            return _factor_phase(fns, poly_i, x0_i, refactor_steps, active_tol,
                                 reg, dual_reg)

    def run(theta, X0, poly):
        x, nu, lu, piv, free = jax.vmap(
            one, in_axes=(0, 0, Polyhedron(*poly_axes_key))
        )(theta, X0, poly)
        # One flat f32 buffer so the host pulls the whole factor-phase
        # output in a single D2H transfer (per-leaf pulls pay the link's
        # round-trip each); piv rides separately (int).
        flat = jnp.concatenate(
            [a.reshape(a.shape[0], -1) for a in (x, nu, lu, free)], axis=1
        )
        return flat, piv

    return jax.jit(run)


@functools.lru_cache(maxsize=128)
def _factor_runner_qr(fns_key, poly_axes_key, refactor_steps, active_tol, reg):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x0_i, poly_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        with jax.default_matmul_precision("highest"):
            return _factor_phase_qr(fns, poly_i, x0_i, refactor_steps, active_tol, reg)

    def run(theta, X0, poly):
        x, nu, RJ, Qw, Tw, free = jax.vmap(
            one, in_axes=(0, 0, Polyhedron(*poly_axes_key))
        )(theta, X0, poly)
        # One flat f32 buffer, same rationale as _factor_runner.  RJ is
        # upper-triangular by construction: ship only its n(n+1)/2
        # triangle — RJ is ~96% of the payload at config-3 shape (n=192),
        # so this halves the transfer.
        n = RJ.shape[-1]
        iu = jnp.triu_indices(n)
        RJ_tri = RJ[:, iu[0], iu[1]]
        flat = jnp.concatenate(
            [a.reshape(a.shape[0], -1) for a in (x, nu, RJ_tri, Qw, Tw, free)], axis=1
        )
        return flat

    return jax.jit(run)


@functools.lru_cache(maxsize=128)
def _chord_runner_qr(fns_key, poly_axes_key, chord_steps, crit_tol, feas_tol):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x_i, nu_i, RJ_i, Qw_i, Tw_i, free_i, poly_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        # Bound-snap as in _chord_runner (fixed coords arrive f32-rounded).
        fixedm = free_i == 0
        lo_near = jnp.abs(x_i - poly_i.xl) <= jnp.abs(poly_i.xu - x_i)
        x_i = jnp.where(fixedm & jnp.isfinite(poly_i.xl) & lo_near, poly_i.xl, x_i)
        x_i = jnp.where(fixedm & jnp.isfinite(poly_i.xu) & ~lo_near, poly_i.xu, x_i)
        with jax.default_matmul_precision("highest"):
            return _chord_phase_qr(fns, poly_i, x_i, nu_i, RJ_i, Qw_i, Tw_i,
                                   free_i, chord_steps, crit_tol, feas_tol)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, 0, Polyhedron(*poly_axes_key))))


@functools.lru_cache(maxsize=128)
def _chord_runner(fns_key, poly_axes_key, chord_steps, crit_tol, feas_tol):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x_i, nu_i, lu_i, piv_i, free_i, poly_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        # Fixed variables arrive on the f32-rounded image of their bound;
        # snap them to the working-dtype bound (a no-op when the factor
        # phase ran in the same dtype) so the exact-projection certificate
        # doesn't see a ~eps(f32) face offset.
        fixedm = free_i == 0
        lo_near = jnp.abs(x_i - poly_i.xl) <= jnp.abs(poly_i.xu - x_i)
        x_i = jnp.where(fixedm & jnp.isfinite(poly_i.xl) & lo_near, poly_i.xl, x_i)
        x_i = jnp.where(fixedm & jnp.isfinite(poly_i.xu) & ~lo_near, poly_i.xu, x_i)
        with jax.default_matmul_precision("highest"):
            return _chord_phase(fns, poly_i, x_i, nu_i, lu_i, piv_i, free_i,
                                chord_steps, crit_tol, feas_tol)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, Polyhedron(*poly_axes_key))))


def sqp_polish_split(
    bp32: BatchedProblem,
    theta32,
    X32: Array,
    bp64: BatchedProblem,
    theta64,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 5,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    dual_reg: float = 1e-14,
    refactor_steps: int = 2,
    kkt_factorization: str = "auto",
):
    """Device-factored SQP polish: f32 factor phase where X32 lives (the
    device after the bulk solve), f64 chord phase on host with the promoted
    factors — mixed-precision iterative refinement of the KKT system.

    The O(dn² + (n+p+m)³) build+factor work runs at device f32 rates on data
    that is already device-resident; the host pays only O(dn + n²) per
    chord step in f64.  Accuracy comes from the f64 residuals (certified
    with the exact-projection oracle exactly as `sqp_polish`); an
    ill-conditioned instance whose f32 factor cannot contract simply fails
    certification and takes the standard fallback.  The default f32
    factorization is the range-space QR (`_factor_phase_qr`): its
    contraction factor is O(κ(J)·eps(f32)) where the assembled-KKT LU's
    is O(κ(J)²·eps(f32)) — measured on the κ=1e4 ill-conditioned family,
    the LU split certifies 0/8 while QR matches the all-f64 polish.

    Step-count convention (unified across every polish path): `num_steps`
    is the TOTAL Newton-step budget — `refactor_steps` factor-phase steps
    followed by `num_steps − refactor_steps` chord steps, exactly as in
    `sqp_polish` and the fused device path, so tuning num_steps transfers
    between certify="host" and certify="device".

    Returns (X, Y, converged, pix, feas, objective) in f64 on host.
    """
    n = X32.shape[-1]
    opts = options.resolve_tols(jnp.dtype(jnp.float64))
    kkt = _resolve_kkt(kkt_factorization, X32.dtype)
    from .vmap_solve import poly_batch_axes

    poly32 = bp32.polyhedron(n, jnp.float32)
    fns_key32 = (bp32.residuals, bp32.nlconstraints, bp32.jac_res, bp32.jac_nlcons)
    rs = min(max(refactor_steps, 1), num_steps)
    chord_steps = num_steps - rs
    piv = None
    if kkt == "qr":
        fr = _factor_runner_qr(fns_key32, poly_batch_axes(poly32), rs, active_tol, reg)
        flat32 = fr(theta32, X32, poly32)
    else:
        fr = _factor_runner(fns_key32, poly_batch_axes(poly32), rs, active_tol, reg, dual_reg)
        flat32, piv = fr(theta32, X32, poly32)

    # Static output shapes: p via eval_shape (no device compute), m from A.
    B = X32.shape[0]
    m = poly32.A.shape[-2]
    fns0 = bp64.instance_fns(jax.tree.map(lambda a: a[:1][0], theta64))
    p = jax.eval_shape(
        fns0.nlconstraints, jax.ShapeDtypeStruct((n,), jnp.float64)
    ).shape[0]
    q = p + m
    tri = n * (n + 1) // 2
    if kkt == "qr":
        # x, nu, RJ (triangular-packed — see _factor_runner_qr), Qw, Tw, free
        shapes = ((B, n), (B, q), (B, tri), (B, n, q), (B, q, q), (B, n))
    else:
        kk = n + q
        shapes = ((B, n), (B, q), (B, kk, kk), (B, n))

    cpu = local_cpu()
    with jax.default_device(cpu):
        flat_h = np.asarray(flat32)          # ONE D2H pull of the f32 payload
        parts, off = [], 0
        for shp in shapes:
            size = int(np.prod(shp[1:]))
            parts.append(
                jnp.asarray(flat_h[:, off:off + size].reshape(shp), jnp.float64)
            )
            off += size

        poly64 = bp64.polyhedron(n, jnp.float64)
        fns_key64 = (bp64.residuals, bp64.nlconstraints, bp64.jac_res, bp64.jac_nlcons)
        if kkt == "qr":
            x, nu, RJ_tri, Qw, Tw, free = parts
            iu = np.triu_indices(n)
            RJ_h = np.zeros((B, n, n), np.float64)
            RJ_h[:, iu[0], iu[1]] = np.asarray(RJ_tri)
            RJ = jnp.asarray(RJ_h)
            cr = _chord_runner_qr(fns_key64, poly_batch_axes(poly64), chord_steps,
                                  float(opts.crit_tol), float(opts.feas_tol))
            return cr(theta64, x, nu, RJ, Qw, Tw, free, poly64)
        x, nu, lu, free = parts
        piv_h = jnp.asarray(np.asarray(piv))
        cr = _chord_runner(fns_key64, poly_batch_axes(poly64), chord_steps,
                           float(opts.crit_tol), float(opts.feas_tol))
        return cr(theta64, x, nu, lu, piv_h, free, poly64)


@functools.lru_cache(maxsize=128)
def _fused_polish_core(fns_key32, fns_key64, poly_axes_key, num_steps, active_tol,
                       reg, crit_tol, feas_tol, refactor_steps, rounds, p,
                       straggler_bucket):
    """Traceable core of the one-dispatch device certification: f32 QR
    factor phase + f64 chord + certify, with bucketed straggler re-polish
    passes — returned UNJITTED so larger fused programs (the whole-
    pipeline fusion in batch/fused_small.py) can inline it.

    A host-driven device path pays one dispatch per polish phase plus a
    device→host sync per round to decide whether to re-polish; for the
    batched-small regime that dispatch floor can exceed the polish
    compute itself (VERDICT r3 weak #3).  Fusing factor + chord +
    certification + the rounds loop into ONE jitted program pays
    dispatch once.  The f32 factor phase keeps the O(dn² + n³)
    build+factor work in f32 (range-space QR), and only the
    O(dn + n²)-per-step chord iteration runs in f64: the split-polish
    cost model (`sqp_polish_split`) with zero host legs.

    Straggler compaction (VERDICT r4 #4): the round-4 version's re-polish
    rounds re-ran the ENTIRE batch whenever any instance failed — at
    config-5 scale (B=16,384, ~1 straggler) that batch-global round cost
    more than the whole solve.  Re-polish
    passes now gather at most `straggler_bucket` uncertified lanes
    (static-shape `lax.top_k` + gather), re-polish only those, and
    scatter back.  Each uncertified lane still gets up to `rounds - 1`
    re-polishes (the round-4 contract), served least-attempted-first;
    the pass cap `8 * (rounds - 1)` serves up to 8 buckets of
    stragglers fully before the host-side fallback takes over.  The
    while_loop predicate makes all of it free in the common
    all-certified case.
    """
    r32, nl32, jr32, jn32 = fns_key32
    r64, nl64, jr64, jn64 = fns_key64
    rs = min(max(refactor_steps, 1), num_steps)
    axes = Polyhedron(*poly_axes_key)

    def one_round(theta32_i, poly32_i, theta64_i, poly64_i, x64_i):
        fns32 = BatchedProblem(residuals=r32, nlconstraints=nl32,
                               jac_res=jr32, jac_nlcons=jn32).instance_fns(theta32_i)
        fns64 = BatchedProblem(residuals=r64, nlconstraints=nl64,
                               jac_res=jr64, jac_nlcons=jn64).instance_fns(theta64_i)
        with jax.default_matmul_precision("highest"):
            x32 = x64_i.astype(jnp.float32)
            with jax.named_scope("polish_factor_qr_f32"):
                x, nu, RJ, Qw, Tw, free = _factor_phase_qr(
                    fns32, poly32_i, x32, rs, active_tol, reg)
            # Promote to f64 and snap fixed coords to the f64 bound (they
            # arrive on the f32-rounded image of the face; see _chord_runner).
            x_i = x.astype(jnp.float64)
            fixedm = free == 0
            lo_near = jnp.abs(x_i - poly64_i.xl) <= jnp.abs(poly64_i.xu - x_i)
            x_i = jnp.where(fixedm & jnp.isfinite(poly64_i.xl) & lo_near, poly64_i.xl, x_i)
            x_i = jnp.where(fixedm & jnp.isfinite(poly64_i.xu) & ~lo_near, poly64_i.xu, x_i)
            with jax.named_scope("polish_chord_certify_f64"):
                # Factors stay f32: _chord_phase_qr solves in the factors'
                # dtype (mixed-precision iterative refinement — promoting
                # them to f64 buys no accuracy).
                return _chord_phase_qr(
                    fns64, poly64_i, x_i, nu.astype(jnp.float64),
                    RJ, Qw, Tw, free.astype(jnp.float64),
                    num_steps - rs, crit_tol, feas_tol)

    def run(theta32, X32, poly32, theta64, poly64):
        B = X32.shape[0]
        f64 = jnp.float64
        K = min(max(straggler_bucket, 1), B)
        max_passes = 8 * max(rounds - 1, 0)
        vround = jax.vmap(one_round, in_axes=(0, axes, 0, axes, 0))

        def gather_poly(pl, idx):
            # Gather only per-instance (axis-0) fields; shared fields pass
            # through so vround's in_axes stay valid for the bucket.
            return Polyhedron(*[
                f if ax is None else f[idx] for f, ax in zip(pl, axes)
            ])

        # Pass 1: polish the full batch.
        x, y, ok, pix, feas, obj = vround(
            theta32, poly32, theta64, poly64, X32.astype(f64)
        )

        def body(st):
            k, x, y, ok, pix, feas, obj, att = st
            # Lanes still owed a re-polish, least-attempted first (so a
            # straggler population larger than one bucket is served
            # round-robin instead of the first K lanes hogging passes).
            eligible = (~ok) & (att < rounds - 1)
            score = jnp.where(eligible, (rounds - att).astype(jnp.float32), 0.0)
            _, idx = jax.lax.top_k(score, K)
            th32_k = jax.tree.map(lambda a: a[idx], theta32)
            th64_k = jax.tree.map(lambda a: a[idx], theta64)
            poly32_k = gather_poly(poly32, idx)
            poly64_k = gather_poly(poly64, idx)
            nx, ny, nok, npix, nfeas, nobj = vround(
                th32_k, poly32_k, th64_k, poly64_k, x[idx]
            )
            # Only lanes that were actually eligible take the new state
            # (top_k pads the bucket with certified lanes when fewer than
            # K are eligible); the re-polished point is taken certified or
            # not — the host rounds-loop semantics (polish_then_refine).
            upd = eligible[idx]
            x = x.at[idx].set(jnp.where(upd[:, None], nx, x[idx]))
            y = y.at[idx].set(jnp.where(upd[:, None], ny, y[idx]))
            ok = ok.at[idx].set(jnp.where(upd, nok, ok[idx]))
            pix = pix.at[idx].set(jnp.where(upd, npix, pix[idx]))
            feas = feas.at[idx].set(jnp.where(upd, nfeas, feas[idx]))
            obj = obj.at[idx].set(jnp.where(upd, nobj, obj[idx]))
            att = att.at[idx].add(upd.astype(att.dtype))
            return (k + 1, x, y, ok, pix, feas, obj, att)

        def cond(st):
            k, _x, _y, ok, _p, _f, _o, att = st
            return (k < max_passes) & jnp.any((~ok) & (att < rounds - 1))

        if max_passes > 0:
            st = (jnp.zeros((), jnp.int32), x, y, ok, pix, feas, obj,
                  jnp.zeros((B,), jnp.int32))
            _, x, y, ok, pix, feas, obj, _ = jax.lax.while_loop(cond, body, st)
        return x, y, ok, pix, feas, obj

    return run


@functools.lru_cache(maxsize=128)
def _fused_polish_runner(*key):
    """Jitted wrapper of `_fused_polish_core` (same cache key)."""
    return jax.jit(_fused_polish_core(*key))


def sqp_polish_fused(
    bp32: BatchedProblem,
    theta32,
    X32: Array,
    bp64: BatchedProblem,
    theta64,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 5,
    active_tol: float = 1e-4,
    reg: float = 0.0,
    refactor_steps: int = 2,
    rounds: int = 2,
    straggler_bucket: int = 64,
):
    """Fully device-resident split polish: certification in one dispatch.

    All inputs must live on the same device (the bulk device): theta32/X32
    are the bulk phase's working set, theta64/bp64 the f64 master data.
    Returns (X, Y, converged, pix, feas, objective) in f64, device-resident.
    See `_fused_polish_runner` for the cost model; `straggler_bucket`
    bounds how many uncertified lanes each in-dispatch re-polish pass
    touches (the config-5 fix: batch-global re-polish rounds cost 3x the
    solve for one straggler in 16,384 lanes).
    """
    n = X32.shape[-1]
    opts = options.resolve_tols(jnp.dtype(jnp.float64))
    poly32 = bp32.polyhedron(n, jnp.float32)
    poly64 = bp64.polyhedron(n, jnp.float64)
    from .vmap_solve import poly_batch_axes

    fns_key32 = (bp32.residuals, bp32.nlconstraints, bp32.jac_res, bp32.jac_nlcons)
    fns_key64 = (bp64.residuals, bp64.nlconstraints, bp64.jac_res, bp64.jac_nlcons)
    fns0 = bp64.instance_fns(jax.tree.map(lambda a: a[:1][0], theta64))
    p = jax.eval_shape(
        fns0.nlconstraints, jax.ShapeDtypeStruct((n,), jnp.float64)
    ).shape[0]
    run = _fused_polish_runner(
        fns_key32, fns_key64, poly_batch_axes(poly32), num_steps, active_tol,
        reg, float(opts.crit_tol), float(opts.feas_tol), refactor_steps,
        rounds, p, straggler_bucket,
    )
    return dispatch("fused_certify", run, theta32, X32, poly32, theta64, poly64)


def _gather_uncertified(ok_h: np.ndarray, pad_cap: int, B: int):
    """Indices of uncertified instances, padded to a power-of-two bucket.

    Padding to the next power of two (capped at `pad_cap`) bounds the
    number of distinct compiled shapes to log2(pad_cap) so a handful of
    stragglers never pays a full-batch program or a fresh compile per
    count.  Returns (idx, k, idx_padded).
    """
    idx = np.nonzero(~ok_h)[0]
    k = len(idx)
    bucket = 1
    while bucket < k:
        bucket *= 2
    bucket = min(max(bucket, 1), min(pad_cap, B))
    pad = (-k) % bucket
    idx_p = np.concatenate([idx, np.repeat(idx[:1], pad)])
    return idx, k, idx_p


def _take_batched(bp64: BatchedProblem, theta64, idx_p: np.ndarray):
    """Gather instance subset idx_p from theta and any per-instance
    (batched) polyhedron fields."""
    from .vmap_solve import _POLY_BASE_RANK

    take = lambda a: a[idx_p]
    theta_f = jax.tree.map(take, theta64)
    upd = {
        f: take(getattr(bp64, f))
        for f in ("A", "b", "xl", "xu")
        if getattr(bp64, f) is not None
        and getattr(bp64, f).ndim > getattr(_POLY_BASE_RANK, f)
    }
    bp_f = dataclasses.replace(bp64, **upd) if upd else bp64
    return bp_f, theta_f


def polish_then_refine(
    bp: BatchedProblem,
    theta,
    X32: Array,
    options: SolverOptions = SolverOptions(),
    num_steps: int = 3,
    active_tol: float = 1e-4,
    fallback_pad: int = 64,
    chunk: int = 512,
    device: Optional[object] = "cpu",
    rounds: int = 2,
    refactor_steps: int = 2,
    bp32: Optional[BatchedProblem] = None,
    theta32=None,
    split: str = "auto",
    kkt_factorization: str = "auto",
    fallback_device: Optional[object] = "cpu",
    straggler_bucket: int = 64,
) -> Tuple[Array, Array, SolveInfo]:
    """f64 certification phase: SQP polish + full-refine fallback.

    `num_steps` is the total Newton-step budget per polish pass on every
    path (refactor_steps factor-phase steps + the rest chord steps; see
    `sqp_polish_split`), so the knob transfers between certify modes.

    Polishes every instance (cheap); instances whose certification fails
    get up to `rounds-1` further polish rounds (same compiled program, a
    few ms each — GN simply hadn't contracted enough yet), and only then
    are gathered host-side, padded to a multiple of `fallback_pad`
    (bounding compile-cache churn across shapes), and re-solved through the
    full `refine_f64` path, then scattered back.  Returns f64
    (X, Y, SolveInfo).

    With `bp32`/`theta32` (the bulk phase's device-resident f32 working
    set) and `split` "auto"/"on", the first polish round is
    `sqp_polish_split`: the KKT factorizations run in f32 on the bulk
    device, the host only iterates chord steps in f64 — the polish cost
    at config-3 scale (n≈200) drops from O(dn²+n³) to O(dn+n²) per
    instance on host.  "auto" enables it when n ≥ 64 (for tiny instances
    the host factors faster than one extra device round-trip).
    """
    from .refine import refine_f64

    # Transfer FIRST, cast on the target device: casting first would run
    # the f64 astype on the source device and double the bytes moved.
    # Everything below (including the tiny SolveInfo bookkeeping ops) runs
    # under the target device context — with an accelerator default device
    # every uncommitted jnp op would cost a host↔device round trip.
    # device=None means "where the
    # bulk solutions live": inputs may arrive with mixed commitments
    # (host-resident problem data, device-resident X32), so everything is
    # still gathered onto ONE device — X32's — rather than left in place.
    from .refine import _cast_tree

    if device == "cpu":
        dev = local_cpu()
    elif device is None:
        dev = next(iter(X32.devices()))
    else:
        dev = device
    on_accelerator = dev.platform != "cpu"
    if on_accelerator and kkt_factorization == "auto":
        # Device-resident f64 certification (certify="device") uses the
        # range-space QR factorization on any accelerator.  Chosen on the
        # earlier accelerator, which had no f64 LU; the GPU has one
        # (cuSOLVER getrf), so LU vs QR here is not yet measured on the
        # H100 (ROADMAP Speed item 4).
        kkt_factorization = "qr"
    if on_accelerator:
        # One packed H2D transfer of the f64 master data (per-leaf puts
        # each pay the link's round-trip; harness/transfer.py).
        from ..harness.transfer import pack_device_put

        poly_fields = {
            f: getattr(bp, f) for f in ("A", "b", "xl", "xu")
            if getattr(bp, f) is not None
        }
        theta_p, poly_p = pack_device_put((theta, poly_fields), dev)
    ctx = jax.default_device(dev)
    f64 = lambda t: _cast_tree(t, jnp.float64)

    with ctx:
        put = lambda t: jax.tree.map(lambda a: jax.device_put(a, dev), t)
        if on_accelerator:
            theta64 = f64(theta_p)
            # Fields absent from poly_p were None on bp and stay None.
            bp64 = dataclasses.replace(bp, **{k: f64(v) for k, v in poly_p.items()})
        else:
            theta64 = f64(put(theta))
            bp64 = dataclasses.replace(
                bp,
                A=None if bp.A is None else f64(put(bp.A)),
                b=None if bp.b is None else f64(put(bp.b)),
                xl=None if bp.xl is None else f64(put(bp.xl)),
                xu=None if bp.xu is None else f64(put(bp.xu)),
            )
        # split="off" is the documented opt-out from f32 factors (families
        # whose conditioning needs the all-f64 polish); honor it here too —
        # the fused path's factor phase is f32 by construction.
        use_fused = (
            on_accelerator and bp32 is not None and theta32 is not None
            and split != "off"
        )
        use_split = (
            bp32 is not None
            and theta32 is not None
            and not on_accelerator  # device polish is fused on-device instead
            and (split == "on" or (split == "auto" and X32.shape[-1] >= 64))
        )
        if use_fused:
            # Single-dispatch on-device certification (f32 factors + f64
            # chord + the rounds loop fused; see sqp_polish_fused).
            X, Y, ok, pix, feas, obj = sqp_polish_fused(
                bp32, theta32, X32, bp64, theta64, options,
                num_steps=num_steps, active_tol=active_tol,
                refactor_steps=refactor_steps, rounds=rounds,
                straggler_bucket=straggler_bucket,
            )
        elif use_split:
            X, Y, ok, pix, feas, obj = sqp_polish_split(
                bp32, theta32, X32, bp64, theta64, options,
                num_steps=num_steps, active_tol=active_tol,
                refactor_steps=refactor_steps,
                kkt_factorization=kkt_factorization,
            )
        else:
            X64 = f64(put(X32))
            X, Y, ok, pix, feas, obj = sqp_polish(
                bp64, theta64, X64, options, num_steps=num_steps, active_tol=active_tol,
                refactor_steps=refactor_steps, kkt_factorization=kkt_factorization,
            )
        ok_h = np.asarray(ok)
        B0 = X.shape[0]
        # The fused device path already ran its rounds inside the single
        # dispatch; anything still uncertified goes straight to the
        # full-refine fallback.
        for _ in range(0 if use_fused else rounds - 1):
            if ok_h.all():
                break
            # Re-polish ONLY the uncertified subset (padded to a power-of-
            # two bucket): a full-batch host re-polish for a handful of
            # stragglers was the dominant config-3 wall component
            # (measured 0.53 s for B=64 on the 2-core host vs ~10 ms for
            # the gathered singleton).  The re-polished state is taken for
            # every gathered instance, certified or not — keeping only the
            # certified ones would make further rounds (and the fallback
            # warm start) re-run from a byte-identical point, i.e.
            # deterministic no-ops.
            idx2, k2, idx2_p = _gather_uncertified(ok_h, fallback_pad, B0)
            bp_r, theta_r = _take_batched(bp64, theta64, idx2_p)
            X2, Y2, ok2, pix2, feas2, obj2 = sqp_polish(
                bp_r, theta_r, X[idx2_p], options, num_steps=num_steps,
                active_tol=active_tol, refactor_steps=refactor_steps,
                kkt_factorization=kkt_factorization,
            )
            sel = jnp.asarray(idx2)
            X = X.at[sel].set(X2[:k2])
            Y = Y.at[sel].set(Y2[:k2])
            pix = pix.at[sel].set(pix2[:k2])
            feas = feas.at[sel].set(feas2[:k2])
            obj = obj.at[sel].set(obj2[:k2])
            ok = ok.at[sel].set(ok2[:k2])
            ok_h = np.asarray(ok)
        B = X.shape[0]
        opts = options.resolve_tols(jnp.dtype(jnp.float64))
        info = SolveInfo(
            converged=ok,
            status=jnp.where(ok, SOLVE_CONVERGED, SOLVE_MAX_OUTER),
            outer_iters=jnp.zeros((B,), jnp.int32),
            inner_iters=jnp.full((B,), num_steps, jnp.int32),
            pix=pix,
            feas=feas,
            mu=jnp.full((B,), opts.mu0, X.dtype),
            objective=obj,
            minor_iters=jnp.zeros((B,), jnp.int32),
            cg_iters=jnp.zeros((B,), jnp.int32),
        )
        if ok_h.all():
            return X, Y, info
        return fallback_full_refine(
            bp64, theta64, X, Y, info, options, fallback_pad, chunk,
            fallback_device, migrate_to_host=use_fused,
        )


def fallback_full_refine(
    bp64, theta64, X, Y, info: SolveInfo, options, fallback_pad, chunk,
    fallback_device, migrate_to_host: bool,
):
    """Full-f64-refine fallback for uncertified lanes (`info.converged`):
    gather into padded buckets, refine, apply the stall-restart rescue,
    scatter back.  Shared by `polish_then_refine` and the whole-pipeline
    fusion (`batch/fused_small.py`)."""
    from .refine import refine_f64

    ok_h = np.asarray(info.converged)
    B = X.shape[0]
    # Fallback: full f64 refine on the uncertified instances, warm-started
    # from the polished points (strictly better than the bulk output).
    idx, k, idx_p = _gather_uncertified(ok_h, fallback_pad, B)
    # Counted (harness/steps.py) so a caller can tell how much of a batch
    # the device path left to this fallback.
    note_fallback(k)
    if migrate_to_host:
        # The fused path's accumulators are device-resident; the
        # fallback merge below scatters CPU results into them, which
        # jit rejects as a cross-device computation.  Results leave
        # for the host after this function anyway — pull them now.
        host = local_cpu()
        X, Y = jax.device_put(X, host), jax.device_put(Y, host)
        info = SolveInfo(*[
            jax.device_put(getattr(info, f), host) for f in SolveInfo._fields
        ])
        theta64 = jax.tree.map(lambda a: jax.device_put(a, host), theta64)
        bp64 = dataclasses.replace(bp64, **{
            f: jax.device_put(getattr(bp64, f), host)
            for f in ("A", "b", "xl", "xu") if getattr(bp64, f) is not None
        })
    bp_f, theta_f = _take_batched(bp64, theta64, idx_p)
    # The full-refine fallback stays on its own device (CPU by default, a
    # placement chosen on the earlier accelerator, whose full f64 solver
    # program faulted; ROADMAP Speed item 5 measures it on the H100).
    Xf, Yf, inf_f = refine_f64(
        bp_f, theta_f, X[idx_p], options, device=fallback_device, chunk=chunk
    )
    # Stall-restart rescue (the config-5 uncertified-tail root cause):
    # when the polish warm start is bad
    # (e.g. a near-degenerate instance whose chord Newton diverged to
    # a box corner), the fallback refine can over-escalate the penalty
    # chasing feasibility-from-far and hit the stall exit with mu so
    # high that the criticality noise floor sits above crit_tol — yet
    # a RESTART from its own (much improved) output converges in a few
    # outers with a fresh mu0/tolerance schedule and freshly estimated
    # multipliers.  One extra pass, only for still-unconverged lanes.
    bad = ~np.asarray(inf_f.converged)
    if bad.any():
        # Gather ONLY the stalled lanes (padded bucket, same discipline
        # as the fallback gather itself): the common case is ~1 straggler
        # in a fallback_pad-wide bucket, and re-refining the whole bucket
        # would pay the full f64 solver on every lane to rescue one.
        sel2, k2, sel2_p = _gather_uncertified(~bad, fallback_pad, len(bad))
        bp_r, theta_r = _take_batched(bp_f, theta_f, sel2_p)
        Xf2, Yf2, inf_f2 = refine_f64(
            bp_r, theta_r, Xf[sel2_p], options, device=fallback_device, chunk=chunk
        )
        # Numpy indices, like the scatter below: a jnp index array
        # would commit to the ambient device and re-mix devices with
        # the CPU-resident fallback results.
        Xf = Xf.at[sel2].set(Xf2[:k2])
        Yf = Yf.at[sel2].set(Yf2[:k2])
        inf_f = SolveInfo(*[
            getattr(inf_f, f).at[sel2].set(getattr(inf_f2, f)[:k2])
            for f in SolveInfo._fields
        ])

    # Numpy indices: under a device ctx a jnp.asarray(idx) would be
    # committed to the accelerator and re-mix devices with the
    # CPU-resident fallback results.
    X = X.at[idx].set(Xf[:k])
    Y = Y.at[idx].set(Yf[:k])
    info = SolveInfo(*[
        getattr(info, f).at[idx].set(getattr(inf_f, f)[:k]) for f in SolveInfo._fields
    ])
    return X, Y, info
