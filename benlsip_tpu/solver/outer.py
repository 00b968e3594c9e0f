"""Outer augmented-Lagrangian driver: penalty/multiplier/tolerance schedule.

Re-design of the `tralcnllss` body
(`/root/reference/src/basic_tralcnlss.jl:167-298`): LANCELOT-style outer
loop — solve the TR subproblem to tolerance omega; if the subproblem iterate
is feasible enough (‖c‖ ≤ eta) accept it, update multipliers y ← y + mu·c
and tighten both tolerances (ref :273-283); otherwise raise the penalty
mu ← tau·mu and reset the tolerances (ref :284-289).  Convergence when
pi(x) ≤ crit_tol and ‖c‖ ≤ feas_tol (ref :276).

The loop is exposed in stepped form (`outer_init` / `outer_cond` /
`outer_body`) so the checkpoint harness (`harness/checkpoint.py`) can run K
outer iterations per device call and serialize the carry pytree between
calls; `solve_fixed_point` fuses the same pieces into one `lax.while_loop`
— a single XLA computation that vmaps over instance batches (each instance
runs its own schedule via masked selects).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.constraints import Polyhedron
from .multipliers import least_squares_multipliers
from .options import SolverOptions
from .status import SOLVE_CONVERGED, SOLVE_MAX_OUTER, SOLVE_STALLED
from .subproblem import linear_gram_cache, solve_subproblem

Array = jax.Array


def initial_tolerances(mu, omega0, eta0, k_crit, k_feas):
    """omega = omega0/mu^k_crit, eta = eta0/mu^k_feas
    (ref `src/basic_tralcnlss.jl:153-163`)."""
    return omega0 / mu**k_crit, eta0 / mu**k_feas


def default_atol(dtype) -> float:
    """The reference's sqrt(eps(T)) working tolerance (ref :181-182).

    jnp.finfo, not np.finfo: the latter rejects ml_dtypes (bf16)."""
    return float(jnp.finfo(dtype).eps) ** 0.5


class SolveInfo(NamedTuple):
    """Diagnostics for a solve (new: the reference returns only (x, y))."""

    converged: Array      # bool: first-order critical point reached
    status: Array         # SOLVE_* code
    outer_iters: Array    # outer AL iterations performed
    inner_iters: Array    # total TR iterations across subproblems
    pix: Array            # final criticality measure pi(x)
    feas: Array           # final ‖c(x)‖
    mu: Array             # final penalty parameter
    objective: Array      # final 1/2 ‖r(x)‖² (the printed objective, ref :292)
    minor_iters: Array = 0  # total minor iterations across subproblems
    cg_iters: Array = 0     # total projected-CG steps across subproblems


class OuterCarry(NamedTuple):
    """The solver's full state between outer iterations — a plain pytree,
    so it serializes with orbax for checkpoint/resume (SURVEY.md §5)."""

    x: Array
    y: Array
    mu: Array
    omega: Array
    eta: Array
    cx: Array
    pix: Array
    best_pix: Array
    stall: Array
    outer: Array
    inner_total: Array
    minor_total: Array
    cg_total: Array
    critical: Array


def outer_init(
    fns, poly: Polyhedron, x0: Array, opts: SolverOptions, y0: Array | None = None
) -> OuterCarry:
    """Initial carry: projection of x0, LS multipliers, tolerance schedule
    (ref :204-231).

    `y0` warm-starts the constraint multipliers (continuation/sweep reuse:
    a good y skips the first multiplier-correction outer iterations); None
    keeps the reference's least-squares estimate (ref :887-902)."""
    dtype = x0.dtype
    if opts.project_x0:
        from ..ops.polyproject import projection_polyhedron

        x0 = projection_polyhedron(poly, x0)  # no-op for feasible x0
    cx0 = fns.nlconstraints(x0)
    mu0 = jnp.asarray(opts.mu0, dtype)
    omega0, eta0 = initial_tolerances(mu0, opts.omega0, opts.eta0, opts.k_crit, opts.k_feas)
    # Same dtype-aware "auto" resolution as the operator build
    # (solver/subproblem.py): QR-of-Cᵀ where κ² eats the f32/bf16 budget,
    # the reference's Cholesky-of-CCᵀ algebra (ref :897-901) for f64.
    use_qr_mult = opts.gn_factorization in ("qr", "cholqr2") or (
        opts.gn_factorization == "auto"
        and jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16))
    )
    if y0 is None:
        y0 = least_squares_multipliers(
            x0, fns.residuals, fns.jac_res, fns.jac_nlcons,
            method="qr" if use_qr_mult else "normal",
            axis=opts.spmd_axis,
        )
    else:
        y0 = jnp.asarray(y0, dtype)
    return OuterCarry(
        x=x0,
        y=y0,
        mu=mu0,
        omega=jnp.asarray(omega0, dtype),
        eta=jnp.asarray(eta0, dtype),
        cx=cx0,
        pix=jnp.asarray(jnp.inf, dtype),
        best_pix=jnp.asarray(jnp.inf, dtype),
        stall=jnp.asarray(0, jnp.int32),
        outer=jnp.asarray(1, jnp.int32),
        inner_total=jnp.asarray(0, jnp.int32),
        minor_total=jnp.asarray(0, jnp.int32),
        cg_total=jnp.asarray(0, jnp.int32),
        critical=jnp.asarray(False),
    )


def outer_done(c: OuterCarry, opts: SolverOptions) -> Array:
    """Loop-termination predicate (negation of ref :246 plus stall exit)."""
    return c.critical | (c.outer > opts.max_outer_iter) | (c.stall >= opts.outer_stall_window)


def outer_body(
    fns, poly: Polyhedron, opts: SolverOptions, atol: float, c: OuterCarry,
    gram_cache: dict | None = None,
) -> OuterCarry:
    """One outer AL iteration (ref :246-295).

    `gram_cache` is the once-per-solve constant-J cache
    (subproblem.linear_gram_cache); callers that step the loop manually
    (harness/checkpoint.py) may omit it — the subproblem then recomputes
    the cache per call, which is correct, just one GEMM less amortized.
    """
    # Tolerance floors (LANCELOT-style, absent in the reference): the
    # schedules drive omega/eta below the *final* tolerances, demanding
    # accuracy fp64 cannot certify — and a feasibility demand below
    # feas_tol needlessly escalates mu, which raises the criticality
    # noise floor (grad noise ∝ mu·eps) above crit_tol.  Clamp both.
    omega_eff = jnp.maximum(c.omega, opts.crit_tol)
    eta_eff = jnp.maximum(c.eta, opts.feas_tol)

    sub = solve_subproblem(
        fns, poly, c.x, c.y, c.mu, omega_eff, opts, atol, **(gram_cache or {})
    )
    feas = jnp.linalg.norm(sub.cx)

    accept = feas <= eta_eff                     # ref :273
    critical = accept & (sub.pix <= opts.crit_tol) & (feas <= opts.feas_tol)  # ref :276

    x = jnp.where(accept, sub.x, c.x)
    cx = jnp.where(accept, sub.cx, c.cx)

    # Accept branch (ref :278-283): multipliers + tolerance tightening,
    # penalty unchanged.  Reject branch (ref :284-289): mu ← tau·mu,
    # tolerances reset against the *new* mu.
    mu_next = jnp.where(accept, c.mu, c.mu * opts.tau)
    update = accept & (~critical)
    y = jnp.where(update, c.y + c.mu * sub.cx, c.y)
    omega = jnp.where(
        critical,
        c.omega,
        jnp.where(update, c.omega / c.mu**opts.beta_crit, opts.omega0 / mu_next**opts.k_crit),
    )
    eta = jnp.where(
        critical,
        c.eta,
        jnp.where(update, c.eta / c.mu**opts.beta_feas, opts.eta0 / mu_next**opts.k_feas),
    )
    # Outer stall: pi not improving while feasibility is already at
    # final tolerance (otherwise mu escalation is still doing real work).
    improved = sub.pix < opts.stall_ratio * c.best_pix
    at_floor = feas <= opts.feas_tol
    stall = jnp.where(improved | ~at_floor, 0, c.stall + 1)

    if opts.verbose:
        from ..harness.logging import emit_outer_iter
        from ..ops.al import _psum

        rxn = fns.residuals(x)
        jax.debug.callback(
            emit_outer_iter,
            c.outer + 1,
            _psum(jnp.vdot(rxn, rxn), opts.spmd_axis),
            feas,
            mu_next,
            sub.pix,
            omega,
            ordered=True,
        )

    return OuterCarry(
        x=x,
        y=y,
        mu=mu_next,
        omega=omega,
        eta=eta,
        cx=cx,
        pix=sub.pix,
        best_pix=jnp.minimum(sub.pix, c.best_pix),
        stall=stall,
        outer=c.outer + 1,
        inner_total=c.inner_total + sub.inner_iters,
        minor_total=c.minor_total + sub.minor_iters,
        cg_total=c.cg_total + sub.cg_iters,
        critical=critical,
    )


def carry_info(out: OuterCarry, opts: SolverOptions, objective=None) -> SolveInfo:
    if objective is None:
        objective = jnp.asarray(jnp.nan, out.x.dtype)
    return SolveInfo(
        objective=objective,
        converged=out.critical,
        status=jnp.where(
            out.critical,
            SOLVE_CONVERGED,
            jnp.where(out.stall >= opts.outer_stall_window, SOLVE_STALLED, SOLVE_MAX_OUTER),
        ),
        outer_iters=out.outer - 1,
        inner_iters=out.inner_total,
        minor_iters=out.minor_total,
        cg_iters=out.cg_total,
        pix=out.pix,
        feas=jnp.linalg.norm(out.cx),
        mu=out.mu,
    )


def solve_fixed_point(
    fns,
    poly: Polyhedron,
    x0: Array,
    opts: SolverOptions,
    y0: Array | None = None,
):
    """Run the full TRALCNLLS iteration from x0; returns (x, y, SolveInfo).

    Mirror of `tralcnllss` (ref `src/basic_tralcnlss.jl:167-298`); `fns`
    holds the user callables.  Fully jittable; vmap for instance batches.
    """
    dtype = x0.dtype
    opts = opts.resolve_tols(jnp.dtype(dtype))
    atol = default_atol(dtype)

    # Trace the whole iteration under the configured matmul precision: an
    # accelerator's default f32 product is reduced-precision (TF32 on the
    # GPU) and Gauss-Newton cannot converge on it for medium instances
    # (see SolverOptions.matmul_precision).
    with jax.default_matmul_precision(opts.matmul_precision):
        c0 = outer_init(fns, poly, x0, opts, y0)
        # Constant-J problems: one J^T J GEMM for the whole solve
        # (loop-invariant input to the while_loop below).
        gram_cache = linear_gram_cache(fns, c0.x, opts)
        out = lax.while_loop(
            lambda c: ~outer_done(c, opts),
            lambda c: outer_body(fns, poly, opts, atol, c, gram_cache),
            c0,
        )
        # At a critical exit the reference skips the multiplier update
        # (ref :276-283), returning a y that is one first-order update stale —
        # the converged estimate is the y_bar = y + mu·c its own gradient used.
        y_final = jnp.where(out.critical, out.y + out.mu * out.cx, out.y)
        rx = fns.residuals(out.x)
        from ..ops.al import _psum

        obj = _psum(0.5 * jnp.vdot(rx, rx), opts.spmd_axis)
        return out.x, y_final, carry_info(out, opts, objective=obj)
