"""Projected conjugate gradients on the active-set tangent space.

Re-design of `projected_cg` / `factor_to_boundary` / `linesearch`
(`/root/reference/src/basic_tralcnlss.jl:690-809`): approximately solve

    min_w 1/2 wᵀHw + wᵀg    s.t.  A w = 0,  w_i = 0 (i fixed),  w_l ≤ w ≤ w_u

with early exits on bound hits and negative curvature.  The reference's
scalar loop with data-dependent trip count becomes a `lax.while_loop` whose
carry holds an int32 status; all branches are arithmetic `where`-selects so
the loop vmaps cleanly over batched instances (divergent instances idle via
select, ref behavior preserved per SURVEY.md §7.3 hard-part 5).

Per iteration: one matrix-free H·p (two GEMV pairs, ref :722) and one masked
tangent projection (two m×m triangular solves + GEMV pair, ref :741) —
hot-loop #1 of the solver (SURVEY.md §3.3).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.al import AlHessian, hv, vhv
from ..ops.constraints import ActiveSet, Polyhedron, nb_fix
from ..ops.project import project_tangent
from .loops import run_bounded
from .status import CG_BOUND_HIT, CG_MAX_ITER, CG_NEGATIVE_CURVATURE, CG_RUNNING, CG_SOLVED

Array = jax.Array


def factor_to_boundary(p: Array, w: Array, w_l: Array, w_u: Array, atol: float = 1e-10) -> Array:
    """Largest gamma ≥ 0 with w + gamma·p inside [w_l, w_u].

    Vectorized `factor_to_boundary` (ref `src/basic_tralcnlss.jl:793-809`);
    components with |p_i| < atol don't bind (same atol default, ref :798).
    Clamped at 0 so roundoff on an active bound cannot produce a backward
    step (the reference's ±inf boxes made this unreachable — quirk 3).
    """
    lo = jnp.where(p <= -atol, (w_l - w) / p, jnp.inf)
    hi = jnp.where(p >= atol, (w_u - w) / p, jnp.inf)
    return jnp.maximum(jnp.minimum(jnp.min(lo), jnp.min(hi)), 0.0)


def linesearch(
    g_model: Array,
    H: AlHessian,
    w: Array,
    w_l: Array,
    w_u: Array,
    fixed: Array,
    axis: str | None = None,
) -> Array:
    """Exact model linesearch along w, capped by the free-variable box.

    Vectorized `linesearch` (ref `src/basic_tralcnlss.jl:766-791`):
    alpha = min(-gᵀw / wᵀHw, max feasible alpha).  Guarded against the
    inf·0 = nan case when both terms are unbounded.
    """
    wHw = vhv(H, w, axis)
    gw = jnp.vdot(g_model, w)
    alpha_opt = jnp.where(wHw > 0, -gw / jnp.where(wHw > 0, wHw, 1.0), jnp.inf)

    lo = jnp.where(~fixed & (w < 0), w_l / jnp.where(w < 0, w, 1.0), jnp.inf)
    hi = jnp.where(~fixed & (w > 0), w_u / jnp.where(w > 0, w, 1.0), jnp.inf)
    alpha_allowed = jnp.minimum(jnp.min(lo), jnp.min(hi))

    alpha = jnp.minimum(alpha_opt, alpha_allowed)
    return jnp.where(jnp.isfinite(alpha), alpha, 1.0)


class _CGCarry(NamedTuple):
    w: Array
    r: Array
    v: Array
    p: Array
    rtv: Array
    it: Array
    status: Array


def projected_cg(
    g_minor: Array,
    H: AlHessian,
    w_l: Array,
    w_u: Array,
    poly: Polyhedron,
    aset: ActiveSet,
    kappa2: float,
    atol: float | None = None,
    unroll_limit: int | None = None,
    axis: str | None = None,
) -> Tuple[Array, Array]:
    """Projected CG with bound-hit / negative-curvature early exits.

    Mirrors `projected_cg` (ref `src/basic_tralcnlss.jl:690-764`):
    start w = 0, r = g_minor, v = P r, p = -v; per iteration test curvature
    pᵀHp against atol = sqrt(eps) (ref :697), step to the boundary on a bound
    hit (ref :734-737), take the negative-curvature exit with a boundary step
    when curvature is nonzero (ref :725-730), otherwise standard CG with the
    residual re-projected each iteration (ref :738-748).  Iteration cap
    2·(n - m - #fixed) (ref :714); tolerance kappa2·‖v0‖ (ref :710).

    Returns (w, status, iters) with status one of the CG_* codes and
    iters the number of interior CG updates performed (observability:
    the per-TR-iteration trip counts that set the wall).
    """
    dtype = g_minor.dtype
    if atol is None:
        atol = float(jnp.finfo(dtype).eps) ** 0.5
    n = g_minor.shape[0]
    m = poly.A.shape[0]

    v0 = project_tangent(poly, aset, g_minor)
    # ref :710/:747 compares rᵀv = ‖Pr‖² (squared) against kappa2·‖v0‖
    # (unsquared) — a units mismatch that makes CG exit after ~1 iteration
    # once gradients fall below 1, stalling asymptotic convergence.  The
    # intended relative test is ‖Pr‖ ≤ kappa2·‖v0‖, i.e. rᵀv ≤ (kappa2‖v0‖)².
    # Floor: the projection computes v with absolute error ~eps·‖g_minor‖;
    # below that, v is pure roundoff and CG would iterate on noise that the
    # linesearch then amplifies into macroscopic constraint-violating steps.
    eps_ = jnp.finfo(dtype).eps
    noise_floor = (10.0 * eps_ * jnp.linalg.norm(g_minor)) ** 2
    tol_cg = jnp.maximum((kappa2 * jnp.linalg.norm(v0)) ** 2, noise_floor)
    tol_nc = jnp.asarray(atol, dtype)
    max_iter = 2 * (n - m - nb_fix(aset))

    def proj(r):
        return project_tangent(poly, aset, r)

    def cond(c: _CGCarry):
        return c.status == CG_RUNNING

    def body(c: _CGCarry):
        Hp = hv(H, c.p, axis)
        pHp = jnp.vdot(c.p, Hp)
        gamma = factor_to_boundary(c.p, c.w, w_l, w_u)
        gamma_safe = jnp.where(jnp.isfinite(gamma), gamma, 0.0)

        # ref :725 tests pᵀHp against the *absolute* tol sqrt(eps), which
        # misreads tiny-but-positive curvature as negative once ‖p‖ is small
        # (p scales with the gradient).  The intended, scale-invariant test
        # is on the Rayleigh quotient: pᵀHp ≤ tol·‖p‖².
        pp = jnp.vdot(c.p, c.p)
        neg = pHp <= tol_nc * pp
        nonzero_curv = jnp.abs(pHp) > tol_nc * pp
        alpha = c.rtv / jnp.where(neg, 1.0, pHp)
        outside = (~neg) & (alpha > gamma)
        interior = (~neg) & (~outside)

        step = jnp.where(
            neg,
            jnp.where(nonzero_curv, gamma_safe, 0.0),  # ref :727-730
            jnp.where(outside, gamma, alpha),          # ref :736-739
        )
        w = c.w + step * c.p

        # Interior CG update (ref :739-748); unselected lanes keep old state.
        # rᵀv = rᵀPr = ‖Pr‖² = vᵀv exactly (P symmetric idempotent); the vᵀv
        # form keeps the curvature/termination quantities nonnegative at
        # machine level where the raw dot cancels to projection roundoff.
        r_new = c.r + alpha * Hp
        v_new = proj(r_new)
        rtv_next = jnp.vdot(v_new, v_new)
        beta = rtv_next / jnp.where(c.rtv != 0, c.rtv, 1.0)
        p_new = -v_new + beta * c.p

        r = jnp.where(interior, r_new, c.r)
        v = jnp.where(interior, v_new, c.v)
        p = jnp.where(interior, p_new, c.p)
        rtv = jnp.where(interior, rtv_next, c.rtv)
        it = c.it + interior.astype(jnp.int32)

        approx_solved = interior & (jnp.abs(rtv_next) < tol_cg)
        status = jnp.where(
            neg,
            CG_NEGATIVE_CURVATURE,
            jnp.where(
                outside,
                CG_BOUND_HIT,
                jnp.where(
                    approx_solved,
                    CG_SOLVED,
                    jnp.where(it > max_iter, CG_MAX_ITER, CG_RUNNING),
                ),
            ),
        )
        return _CGCarry(w, r, v, p, rtv, it, status)

    c0 = _CGCarry(
        w=jnp.zeros((n,), dtype),
        r=g_minor,
        v=v0,
        p=-v0,
        rtv=jnp.vdot(v0, v0),  # = g_minorᵀv0 exactly; see body comment

        it=jnp.asarray(1, jnp.int32),
        # ref :714,720: with max_iter < 1 the loop never runs (status would be
        # `nothing` — quirk 4); here it is reported as CG_MAX_ITER with w = 0.
        # Additionally, a start already at tolerance (v0 ≈ 0, e.g. the Cauchy
        # point is tangent-space optimal) must return w = 0 immediately:
        # otherwise CG iterates on projection roundoff and the later
        # linesearch can amplify that noise into a macroscopic step.
        status=jnp.where(
            jnp.vdot(v0, v0) <= tol_cg,
            CG_SOLVED,
            jnp.where(max_iter >= 1, CG_RUNNING, CG_MAX_ITER),
        ),
    )
    # Static trip bound 2(n - m) ≥ the dynamic cap 2(n - m - #fix) (ref :714);
    # small problems run the CG fully unrolled with masked lanes.
    out = run_bounded(cond, body, c0, max_trips=2 * (n - m), unroll_limit=unroll_limit)
    return out.w, out.status, out.it - 1
