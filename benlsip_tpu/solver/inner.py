"""Inner step: gradient-projection Cauchy search + active-set minor iterations.

Re-design of `inner_step` / `cauchy_step` / `next_breakpoint` /
`minor_iterate` (`/root/reference/src/basic_tralcnlss.jl:394-675`).

The reference walks breakpoints of the projected-gradient path with a
mutable active set, refactorizing the augmented Cholesky at every bound
activation.  Here both loops are `lax.while_loop` state machines over an
immutable bool mask; each activation refreshes the m×m masked factor
(`ops/cholesky.py`).  All shapes are static, so the whole inner step jits
once and vmaps over batches with per-instance divergent active sets.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.al import AlHessian, hv, vhv
from ..ops.constraints import (
    ActiveSet,
    Polyhedron,
    active_bounds_at,
    binding_bounds_coupled,
    make_active_set,
    nb_fix,
    step_active_bounds,
)
from ..ops.project import norm_reduced_gradient, project_tangent
from .cg import linesearch, projected_cg
from .loops import run_bounded
from .status import CG_NEGATIVE_CURVATURE

Array = jax.Array


def next_breakpoint(
    d: Array, s: Array, d_l: Array, d_u: Array, fixed: Array
) -> Tuple[Array, Array]:
    """Smallest theta with a free component of s + theta·d at a bound.

    Vectorized `next_breakpoint` (ref `src/basic_tralcnlss.jl:536-562`):
    the O(n) scalar scan becomes a masked elementwise minimum + argmin.  Returns (theta, index); theta = +inf when no free direction
    moves (the reference returns ind = -1 then).
    """
    theta_i = jnp.where(
        d < 0,
        (d_l - s) / jnp.where(d < 0, d, 1.0),
        jnp.where(d > 0, (d_u - s) / jnp.where(d > 0, d, 1.0), jnp.inf),
    )
    theta_i = jnp.where(fixed, jnp.inf, theta_i)
    ind = jnp.argmin(theta_i)
    return theta_i[ind], ind


class _CauchyCarry(NamedTuple):
    s: Array
    fixed: Array
    chol: Array
    d: Array
    Hd: Array
    phi_p: Array
    phi_pp: Array
    done: Array


def cauchy_step(
    x: Array,
    g: Array,
    H: AlHessian,
    poly: Polyhedron,
    delta: Array,
    atol: float,
    chol_reg: float = 0.0,
    unroll_limit: int | None = None,
    axis: str | None = None,
) -> Tuple[Array, ActiveSet]:
    """First local minimum of the model along the projected-gradient path.

    Mirrors the live 6-arg `cauchy_step` (ref `src/basic_tralcnlss.jl:574-639`):
    identify bounds active at x (ref :591), project -g onto the tangent space
    (ref :592), then walk breakpoint segments of the ∞-norm-boxed path —
    fixing one bound per segment, re-projecting d, and tracking slope
    phi' = sᵀHd + gᵀd and curvature phi'' = dᵀHd (ref :609-636) — until the
    first segment containing a local minimum.

    Returns (s_c, active_set_after) — the reference leaves the mutated
    `lincons` visible to the minor loop, reproduced here by returning it.
    """
    dtype = x.dtype
    n = x.shape[0]
    m = poly.A.shape[0]

    # ref :591 fixes ALL bounds active at x, which makes a touched bound
    # unreleasable — the solver then stalls at points where the gradient
    # pushes *into* the feasible box (invisible to the reference's tests,
    # where no bound ever activates).  GPCG intent: fix only the BINDING
    # active bounds — judged through the A-coupling via projection
    # multipliers (see binding_bounds_coupled) — and a non-binding bound
    # whose projected direction turns against it is re-fixed by a theta = 0
    # breakpoint below.
    fixed0 = binding_bounds_coupled(poly, x, g, atol, reg=chol_reg)
    aset0 = make_active_set(poly, fixed0, reg=chol_reg)
    d0 = project_tangent(poly, aset0, -g)

    # Per-segment bounds of the Cauchy box (ref :602-603).
    d_u = jnp.minimum(poly.xu - x, delta)
    d_l = jnp.maximum(poly.xl - x, -delta)

    # Slope phi' = sᵀHd + gᵀd with gᵀd = -‖d‖² (P symmetric idempotent and
    # d = P(-g) ⇒ gᵀd = -‖Pg‖² = -‖d‖² exactly).  Computing gᵀd as a raw dot
    # cancels to projection roundoff ~eps·‖g‖ and its *sign* flips once
    # ‖Pg‖² < eps·‖g‖, stalling the solver at pi ~ sqrt(eps)·scale; -‖d‖²
    # is exact to relative eps.  (The reference computes the raw dot,
    # ref :610 — its tests never push into this regime.)
    Hd0 = hv(H, d0, axis)
    c0 = _CauchyCarry(
        s=jnp.zeros((n,), dtype),
        fixed=fixed0,
        chol=aset0.chol,
        d=d0,
        Hd=Hd0,
        phi_p=-jnp.vdot(d0, d0),
        phi_pp=jnp.vdot(d0, Hd0),
        # Noise guard (cf. projected_cg): a projected gradient at roundoff
        # scale means x is tangent-space stationary — walking breakpoints on
        # noise wastes the whole segment budget.
        done=jnp.linalg.norm(d0) <= 10.0 * jnp.finfo(dtype).eps * jnp.linalg.norm(g),
    )

    def cond(c: _CauchyCarry):
        # ref :615: while !min_found && nb_fix < n - m
        return (~c.done) & (jnp.sum(c.fixed.astype(jnp.int32)) < n - m)

    def body(c: _CauchyCarry):
        theta, ind = next_breakpoint(c.d, c.s, d_l, d_u, c.fixed)
        delta_t = jnp.where(c.phi_pp > 0, -c.phi_p / jnp.where(c.phi_pp > 0, c.phi_pp, 1.0), 0.0)

        at_min = c.phi_p >= 0                                        # ref :620
        interior_min = (c.phi_p < 0) & (c.phi_pp > 0) & (delta_t < theta)  # ref :622
        advance = (~at_min) & (~interior_min)                        # ref :627

        theta_safe = jnp.where(jnp.isfinite(theta), theta, 0.0)
        s = jnp.where(
            at_min,
            c.s,
            jnp.where(interior_min, c.s + delta_t * c.d, c.s + theta_safe * c.d),
        )

        fixed = jnp.where(advance, c.fixed.at[ind].set(True), c.fixed)
        aset = make_active_set(poly, fixed, reg=chol_reg)
        d_new = project_tangent(poly, aset, -g)
        Hd_new = hv(H, d_new, axis)
        d = jnp.where(advance, d_new, c.d)
        Hd = jnp.where(advance, Hd_new, c.Hd)
        # gᵀd = -‖d‖² (see init comment).
        phi_p = jnp.where(advance, jnp.vdot(s, Hd_new) - jnp.vdot(d_new, d_new), c.phi_p)
        phi_pp = jnp.where(advance, jnp.vdot(d_new, Hd_new), c.phi_pp)
        chol = jnp.where(advance, aset.chol, c.chol)
        return _CauchyCarry(s, fixed, chol, d, Hd, phi_p, phi_pp, at_min | interior_min)

    # Trip bound: one bound fixed per segment, at most n - m segments
    # (ref :615); tiny for the batched-small regime -> unrolled masked loop.
    out = run_bounded(cond, body, c0, max_trips=n - m, unroll_limit=unroll_limit)
    return out.s, ActiveSet(fixed=out.fixed, chol=out.chol)


def minor_iterate(
    x: Array,
    s: Array,
    g_minor: Array,
    H: AlHessian,
    poly: Polyhedron,
    aset: ActiveSet,
    delta: Array,
    kappa2: float,
    unroll_limit: int | None = None,
    axis: str | None = None,
) -> Tuple[Array, Array, Array]:
    """One minor iteration: projected-CG direction + model linesearch.

    Mirrors `minor_iterate` (ref `src/basic_tralcnlss.jl:649-675`) with the
    *intended* box semantics (SURVEY.md §2.3 quirk 3): the remaining
    trust-region/bound gap constrains the FREE variables,

        w ∈ [max(xl - x, -delta) - s,  min(xu - x, delta) - s],

    while fixed variables get w_i = 0 (already enforced by the projection).
    The reference inverts the mask, leaving ±inf boxes that never bind.
    """
    free = ~aset.fixed
    w_u = jnp.where(free, jnp.minimum(poly.xu - x, delta) - s, 0.0)
    w_l = jnp.where(free, jnp.maximum(poly.xl - x, -delta) - s, 0.0)
    # Roundoff guard: the box must contain 0 for CG started at w = 0.
    w_u = jnp.maximum(w_u, 0.0)
    w_l = jnp.minimum(w_l, 0.0)

    w, cg_status, cg_iters = projected_cg(
        g_minor, H, w_l, w_u, poly, aset, kappa2, unroll_limit=unroll_limit, axis=axis
    )

    # ref :669-672: linesearch unless negative curvature terminated CG.
    alpha = linesearch(g_minor, H, w, w_l, w_u, aset.fixed, axis=axis)
    w = jnp.where(cg_status != CG_NEGATIVE_CURVATURE, alpha * w, w)
    return w, cg_status, cg_iters


def cauchy_step_projected(
    x: Array,
    g: Array,
    H: AlHessian,
    poly: Polyhedron,
    delta: Array,
    atol: float,
    kappa1: float = 1e-2,
    gamma_c: float = 10.0,
    max_trials: int = 16,
    chol_reg: float = 0.0,
    axis: str | None = None,
) -> Tuple[Array, ActiveSet]:
    """Projected-search Cauchy step: backtracking along s(t) = P(x-t·g) - x.

    Rebuild of the reference's legacy 11-arg `cauchy_step`
    (ref `src/basic_tralcnlss.jl:462-527`): trial steps are exact
    projections onto {Av = 0, max(xl-x,-delta) ≤ s ≤ min(xu-x,delta)},
    accepted at the first t with q(s) ≤ kappa1·gᵀs (sufficient decrease,
    ref :488), shrinking t by gamma_c otherwise.  The reference abandoned
    this variant because each trial cost an Ipopt solve; with the jittable
    dual-Newton projection a trial is a handful of m×m solves, and —
    unlike the live breakpoint walk, which fixes ONE bound per sequential
    segment (ref :615-637) — a single projection activates any number of
    bounds at once.  This is the scalable path for instances with large
    active sets (BASELINE config 3); `inner_step` picks it when n is large.

    Returns (s_c, active_set_at(x+s_c)) like the breakpoint variant.
    """
    from ..ops.polyproject import projection_polyhedron

    dtype = x.dtype
    d_l = jnp.maximum(poly.xl - x, -delta)
    d_u = jnp.minimum(poly.xu - x, delta)
    seg = Polyhedron(A=poly.A, b=jnp.zeros_like(poly.b), xl=d_l, xu=d_u)

    # Initial scale: the unconstrained exact-linesearch step along -g.
    gHg = vhv(H, g, axis)
    gg = jnp.vdot(g, g)
    t0 = jnp.where(gHg > 0, gg / jnp.where(gHg > 0, gHg, 1.0), 1.0)

    def trial(t):
        s = projection_polyhedron(seg, -t * g)
        gts = jnp.vdot(g, s)
        qs = 0.5 * vhv(H, s, axis) + gts
        ok = qs <= kappa1 * gts  # sufficient decrease (ref :488)
        return s, ok

    def cond(c):
        t, s, ok, k = c
        return (~ok) & (k < max_trials)

    def body(c):
        t, s_prev, ok_prev, k = c
        s, ok = trial(t)
        return (t / gamma_c, s, ok, k + 1)

    s0, ok0 = trial(t0)
    t, s, ok, k = lax.while_loop(cond, body, (t0 / gamma_c, s0, ok0, jnp.asarray(1, jnp.int32)))
    # If no trial satisfied the decrease test (flat model), fall back to the
    # last (smallest) projected step — still feasible and descent-directed.
    fixed = step_active_bounds(poly, x, s, delta, atol)
    return s, make_active_set(poly, fixed, reg=chol_reg)


class _MinorCarry(NamedTuple):
    s: Array
    g_minor: Array
    fixed: Array
    chol: Array
    j: Array
    cg_total: Array
    approx_solved: Array
    cg_stop: Array


class InnerStats(NamedTuple):
    """Trip counts of one inner step (observability: the lockstep trip
    counts that set a batched chunk's wall)."""

    minor_iters: Array
    cg_iters: Array


def inner_step(
    x: Array,
    g: Array,
    H: AlHessian,
    poly: Polyhedron,
    delta: Array,
    opts,
    atol: float,
) -> Tuple[Array, Array, ActiveSet, InnerStats]:
    """Cauchy step + active-set refinement minor iterations.

    Mirrors `inner_step` (ref `src/basic_tralcnlss.jl:394-460`).  Fixes the
    no-op `max(n-m-nb_fix)` (quirk 1) as max(n-m-#fix, 0).  Returns
    (s, model_reduction, final_active_set); the model reduction
    pred = gᵀs + 1/2 sᵀHs is negative for improvement (ref :458, quirk 7).

    `opts` is the SolverOptions config contract (SURVEY.md §5): this is
    where kappa1/gamma_c/cauchy_max_trials (projected Cauchy),
    kappa2 (CG), kappa3/max_minor_iter (minor loop), chol_reg,
    projected_cauchy_threshold, and unroll_limit all bind.
    """
    n = x.shape[0]
    m = poly.A.shape[0]
    chol_reg = opts.chol_reg
    ul = opts.unroll_limit
    ax = opts.spmd_axis

    # Named scopes label the profiler timeline per solver phase
    # (SURVEY.md §5 tracing row; captured via bench_roofline.py --trace).
    if n - m > opts.projected_cauchy_threshold:
        with jax.named_scope("cauchy_projected"):
            s0, aset0 = cauchy_step_projected(
                x, g, H, poly, delta, atol,
                kappa1=opts.kappa1, gamma_c=opts.gamma_c,
                max_trials=opts.cauchy_max_trials, chol_reg=chol_reg, axis=ax,
            )
    else:
        with jax.named_scope("cauchy_breakpoint_walk"):
            s0, aset0 = cauchy_step(
                x, g, H, poly, delta, atol, chol_reg, unroll_limit=ul, axis=ax
            )
    g_minor0 = hv(H, s0, ax) + g

    nrg0 = norm_reduced_gradient(poly, aset0, g)
    nrgm0 = norm_reduced_gradient(poly, aset0, g_minor0)
    approx_solved0 = nrgm0 <= opts.kappa3 * nrg0

    # ref :425-426 with quirk-1 fix; computed once from the post-Cauchy set.
    allowed = jnp.maximum(n - m - nb_fix(aset0), 0)
    max_minor = jnp.minimum(opts.max_minor_iter, allowed)

    c0 = _MinorCarry(
        s=s0,
        g_minor=g_minor0,
        fixed=aset0.fixed,
        chol=aset0.chol,
        j=jnp.asarray(1, jnp.int32),
        cg_total=jnp.asarray(0, jnp.int32),
        approx_solved=approx_solved0,
        cg_stop=jnp.asarray(False),
    )

    def cond(c: _MinorCarry):
        return (c.j <= max_minor) & (~c.approx_solved) & (~c.cg_stop)

    def body(c: _MinorCarry):
        aset = ActiveSet(fixed=c.fixed, chol=c.chol)
        with jax.named_scope("minor_projected_cg"):
            w, cg_status, cg_iters = minor_iterate(
                x, c.s, c.g_minor, H, poly, aset, delta, opts.kappa2,
                unroll_limit=ul, axis=ax,
            )
        cg_stop = cg_status == CG_NEGATIVE_CURVATURE
        s = c.s + w
        g_minor = hv(H, s, ax) + g

        # New bounds hit by the cumulated step inside the TR box (ref :439).
        at_bound = step_active_bounds(poly, x, s, delta, atol)
        union_fixed = c.fixed | at_bound
        fits = m + jnp.sum(union_fixed.astype(jnp.int32)) <= n  # ref :441

        # ref :441-453: union branch vs "small step in a small trust region"
        # branch, which resets the active set to the bounds active at x + s.
        fixed = jnp.where(fits, union_fixed, active_bounds_at(poly, x + s, atol))
        aset_next = make_active_set(poly, fixed, reg=chol_reg)

        nrg = norm_reduced_gradient(poly, aset_next, g)
        nrgm = norm_reduced_gradient(poly, aset_next, g_minor)
        approx_solved = jnp.where(fits, nrgm <= opts.kappa3 * nrg, True)

        return _MinorCarry(
            s=s,
            g_minor=g_minor,
            fixed=fixed,
            chol=aset_next.chol,
            j=c.j + 1,
            cg_total=c.cg_total + cg_iters,
            approx_solved=approx_solved,
            cg_stop=cg_stop,
        )

    out = run_bounded(cond, body, c0, max_trips=min(opts.max_minor_iter, n - m), unroll_limit=ul)
    pred = jnp.vdot(g, out.s) + 0.5 * vhv(H, out.s, ax)  # ref :458
    stats = InnerStats(minor_iters=out.j - 1, cg_iters=out.cg_total)
    return out.s, pred, ActiveSet(fixed=out.fixed, chol=out.chol), stats
