"""Trust-region subproblem solver (the AL minimization over the polyhedron).

Re-design of `solve_subproblem` + TR radius control
(`/root/reference/src/basic_tralcnlss.jl:303-378, 817-860`): approximately
minimize the augmented Lagrangian over {Ax=b, xl ≤ x ≤ xu} to criticality
tolerance omega, via trust-region steps from `inner_step`.

The data-dependent TR loop becomes a `lax.while_loop`; derivative refreshes
happen under `lax.cond` so a rejected step skips the Jacobian evaluations at
runtime (the reference evaluates Jacobians only on acceptance, ref :361-362;
under vmap the cond lowers to a select and both sides run — the batched
regime trades that for lockstep progress).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.al import (
    AlHessian,
    al_gradient,
    evaluate_al,
    new_point,
    with_gram,
    with_gram_rows,
    with_r_factor,
    with_r_factor_cholqr2,
)
from ..ops.constraints import ActiveSet, Polyhedron
from ..ops.polyproject import projection_polyhedron
from ..ops.project import norm_reduced_gradient
from .inner import inner_step
from .options import SolverOptions

Array = jax.Array


def initial_tr(g: Array, tr_factor: float = 0.1) -> Array:
    """Initial radius tr_factor·‖g‖ (ref `src/basic_tralcnlss.jl:817-819`)."""
    return tr_factor * jnp.linalg.norm(g)


def update_tr(delta: Array, rho: Array, eta1, eta2, gamma1, gamma2) -> Array:
    """Standard TR radius update (ref `src/basic_tralcnlss.jl:821-837`).

    NaN rho (0/0 predicted reduction) keeps the radius, matching Julia's
    NaN-comparison semantics in the reference's if/elseif chain.
    """
    return jnp.where(rho > eta2, gamma2 * delta, jnp.where(rho < eta1, gamma1 * delta, delta))


def reduced_gradient_measure(poly: Polyhedron, aset: ActiveSet, g: Array) -> Array:
    """‖P_T(-g)‖, the reference's live reduced-gradient measure
    (ref `src/basic_tralcnlss.jl:839-844` → :869-875).  Kept for parity and
    diagnostics; NOT used for termination — it understates criticality when
    the active set contains TR faces, and an active-set-free variant
    overstates it when bounds interact with Ax=b through the projection."""
    return norm_reduced_gradient(poly, aset, g)


def criticality_measure(poly: Polyhedron, x: Array, g: Array, lam0: Array | None = None):
    """pi(x) = ‖P_Ω(x - g) - x‖ with P_Ω the exact polyhedral projection —
    the reference's alternative 6-arg measure (ref :850-860) and its tests'
    KKT oracle (ref `test/problems/sphere_regression.jl:58-62`).  The only
    measure that is sound in every active-set configuration; here it is
    jittable in-framework (ops/polyproject.py), so the live loop can afford
    what the reference could not (an Ipopt call per iteration).  `lam0`
    warm-starts the projection's dual Newton with the previous TR
    iteration's multipliers (the point moves slowly, so warm converges in
    1-2 steps vs ~5-15 cold).  Round 3 cold-started on purpose — a stale
    warm dual parked the damped Newton at the f32 residual floor of the
    wrong face and spun it to its iteration cap; the
    projection's in-loop cold-restart rescue (ops/polyproject.py) removes
    that failure mode, so warm is now never worse than ~4 stalled steps +
    the cold solve.  Returns (pi, lam) so callers can thread the dual."""
    p, lam = projection_polyhedron(poly, x - g, lam0=lam0, return_lam=True)
    return jnp.linalg.norm(p - x), lam


class _TRCarry(NamedTuple):
    x: Array
    rx: Array
    cx: Array
    mx: Array
    g: Array
    H: AlHessian
    delta: Array
    pix: Array
    crit_lam: Array
    best_pix: Array
    stall: Array
    k: Array
    minor_total: Array
    cg_total: Array
    solved: Array


class SubproblemResult(NamedTuple):
    x: Array
    rx: Array
    cx: Array
    pix: Array
    inner_iters: Array
    minor_iters: Array
    cg_iters: Array


def resolve_operator_route(opts: SolverOptions, n: int, d_plus_p: int, dtype):
    """Static (shape/dtype-based) operator-route resolution, shared by the
    subproblem and the once-per-solve constant-J cache (`linear_gram_cache`).

    Returns (use_op, fact): whether an (n,n) operator is materialized, and
    the resolved gn_factorization ("normal"/"qr"/"cholqr2").
    """
    ax = opts.spmd_axis
    use_op = opts.gram_hessian == "on" or (
        opts.gram_hessian == "auto" and n >= 64 and d_plus_p >= 2 * n
    )
    fact = opts.gn_factorization
    if fact == "auto":
        if jnp.dtype(dtype) in (jnp.dtype(jnp.float32), jnp.dtype(jnp.bfloat16)):
            # κ² eats the f32/bf16 budget → orthogonal route.  At large n
            # (or distributed) the GEMM-shaped CholeskyQR2 replaces the
            # panel-serialized Householder; small batched instances keep
            # the batched Householder behind `qr_r`.
            fact = "cholqr2" if (ax is not None or n >= 64) else "qr"
        else:
            fact = "normal"
    if fact == "qr" and ax is not None:
        # No distributed Householder QR exists.  An explicit request must
        # not be silently downgraded — raised regardless of whether the
        # operator is materialized (no-silent-downgrade policy).
        raise ValueError(
            "gn_factorization='qr' (Householder) is unavailable under "
            "spmd_axis (shard_map blocked mode).  Use "
            "gn_factorization='cholqr2' — the GEMM-shaped orthogonal route, "
            "which reduces (n, n) Grams through the existing psum machinery "
            "and never gathers J — or leave gn_factorization='auto'."
        )
    return use_op, fact


def linear_gram_cache(fns, x0: Array, opts: SolverOptions) -> dict:
    """Constant-Jacobian JᵀJ cache, computed ONCE PER SOLVE.

    For `opts.linear_residuals` problems the outer driver calls this before
    its while_loop and threads the result into every subproblem — one 2dn²
    GEMM per solve instead of one per subproblem (per outer iteration).
    Returns {} when the option is off or the route has nothing to cache.
    """
    if not opts.linear_residuals:
        return {}
    ax = opts.spmd_axis
    J0 = fns.jac_res(x0)
    n = x0.shape[0]
    d_plus_p = J0.shape[0] + jax.eval_shape(fns.nlconstraints, x0).shape[0]
    use_op, fact = resolve_operator_route(opts, n, d_plus_p, x0.dtype)
    if not use_op or fact == "qr":
        return {}
    from ..ops.al import gram_j, gram_j_rows

    with jax.named_scope("gram_j_cache"):
        if fact != "cholqr2" and ax is not None and opts.gram_layout == "sharded":
            return {"Gj_rows": gram_j_rows(J0, ax, opts.reduce_schedule)}
        return {"Gj": gram_j(J0, ax)}


def solve_subproblem(
    fns,
    poly: Polyhedron,
    x0: Array,
    y: Array,
    mu: Array,
    omega_tol: Array,
    opts: SolverOptions,
    atol: float,
    Gj: Array | None = None,
    Gj_rows: Array | None = None,
) -> SubproblemResult:
    """Mirror of `solve_subproblem` (ref `src/basic_tralcnlss.jl:303-378`).

    `fns` holds the user callables (residuals, nlconstraints, jac_res,
    jac_nlcons); they are closed over statically.  Returns the final iterate,
    its residual/constraint values, the criticality measure pi, and the inner
    iteration count.
    """
    dtype = x0.dtype
    ax = opts.spmd_axis

    rx0, cx0, _, mx0, g0, H0 = new_point(
        x0, y, mu, fns.residuals, fns.nlconstraints, fns.jac_res, fns.jac_nlcons,
        axis=ax,
    )
    # Static (shape-based) decision: materialize an (n,n) operator when the
    # Jacobian is tall enough that streaming it per H·v dominates (see
    # SolverOptions.gram_hessian), built either as the Gram matrix or as
    # the QR factor R per SolverOptions.gn_factorization.  Both while-loop
    # branches below then carry the same pytree structure.
    n = x0.shape[0]
    use_op, fact = resolve_operator_route(opts, n, rx0.shape[0] + cx0.shape[0], dtype)
    # Constant-Jacobian cache (SolverOptions.linear_residuals): pay the
    # 2dn² JᵀJ GEMM once; refreshes rebuild only mu·CᵀC + the
    # factorization.  The outer driver precomputes it once per SOLVE and
    # passes it in (`linear_gram_cache`); a direct subproblem call without
    # one computes it here (once per subproblem).  No cache for matrix-free
    # ops or Householder QR (nothing reusable — see the option's docstring).
    lin = opts.linear_residuals and use_op and fact != "qr"
    if lin and Gj is None and Gj_rows is None:
        from ..ops.al import gram_j, gram_j_rows

        with jax.named_scope("gram_j_cache"):
            if fact != "cholqr2" and ax is not None and opts.gram_layout == "sharded":
                Gj_rows = gram_j_rows(H0.J, ax, opts.reduce_schedule)
            else:
                Gj = gram_j(H0.J, ax)
    if not lin:
        Gj = Gj_rows = None
    if not use_op:
        materialize = lambda H: H
    elif fact == "qr":
        materialize = lambda H: with_r_factor(H)
    elif fact == "cholqr2":
        layout = opts.gram_layout if ax is not None else "replicated"
        materialize = lambda H: with_r_factor_cholqr2(H, ax, layout, Gj=Gj)
    elif ax is not None and opts.gram_layout == "sharded":
        # Row-sharded Gram: reduce-scatter the refresh, all_gather per
        # matvec (ops/al.with_gram_rows; SolverOptions.gram_layout).
        materialize = lambda H: with_gram_rows(H, ax, opts.reduce_schedule, Gj_rows=Gj_rows)
    else:
        materialize = lambda H: with_gram(H, ax, Gj=Gj)
    with jax.named_scope("gn_refresh"):
        H0 = materialize(H0)
    delta0 = initial_tr(g0, opts.tr_factor)

    c0 = _TRCarry(
        x=x0,
        rx=rx0,
        cx=cx0,
        mx=mx0,
        g=g0,
        H=H0,
        delta=delta0,
        pix=jnp.asarray(jnp.inf, dtype),
        crit_lam=jnp.zeros((poly.A.shape[0],), dtype),
        best_pix=jnp.asarray(jnp.inf, dtype),
        stall=jnp.asarray(0, jnp.int32),
        k=jnp.asarray(1, jnp.int32),
        minor_total=jnp.asarray(0, jnp.int32),
        cg_total=jnp.asarray(0, jnp.int32),
        solved=jnp.asarray(False),
    )

    def cond(c: _TRCarry):
        # Stall exit: pi at its numerical floor cannot satisfy omega; keep
        # burning the cap and (batched) the whole lockstep chunk pays for it.
        return (~c.solved) & (c.k <= opts.max_inner_iter) & (c.stall < opts.stall_window)

    def body(c: _TRCarry):
        s, pred, aset, istats = inner_step(c.x, c.g, c.H, poly, c.delta, opts, atol)
        x_next = c.x + s
        rx_next, cx_next, mx_next = evaluate_al(
            x_next, y, mu, fns.residuals, fns.nlconstraints, axis=ax
        )
        ared = mx_next - c.mx                    # ref :353 (negative-good)
        rho = ared / pred                        # ref :354

        # Roundoff guard (Conn–Gould–Toint style): near the AL minimum the
        # actual reduction |ared| sinks below the f64 noise of mx and the
        # ratio test turns into a coin flip, collapsing the radius and
        # stalling pi above crit_tol (the reference stalls the same way —
        # its tests never push into this regime).  When both reductions are
        # noise-level, count the step as (plainly) successful and let the
        # criticality test terminate.
        noise = 10.0 * jnp.finfo(dtype).eps * jnp.maximum(jnp.abs(c.mx), jnp.abs(mx_next))
        rho_noisy = (jnp.abs(ared) <= noise) & (jnp.abs(-pred) <= noise)
        rho = jnp.where(rho_noisy, 0.5 * (opts.eta1 + opts.eta2), rho)

        accept = rho > opts.eta1                 # ref :358

        if opts.verbose:
            from ..harness.logging import emit_inner_iter

            # ref :356: print k, AL value, ‖s‖, Δ, ρ.
            jax.debug.callback(
                emit_inner_iter, c.k, c.mx, jnp.linalg.norm(s), c.delta, rho, ordered=True
            )

        def refresh(_):
            # ref :361-362: derivatives only on acceptance.
            with jax.named_scope("gn_refresh"):
                Jn = fns.jac_res(x_next)
                Cn = fns.jac_nlcons(x_next)
                y_bar = y + mu * cx_next
                gn = al_gradient(Jn, Cn, rx_next, y_bar, axis=ax)
                Hn = materialize(AlHessian(Jn, Cn, mu))
            return gn, Hn

        def keep(_):
            return c.g, c.H

        g, H = lax.cond(accept, refresh, keep, None)
        x = jnp.where(accept, x_next, c.x)
        rx = jnp.where(accept, rx_next, c.rx)
        cx = jnp.where(accept, cx_next, c.cx)
        mx = jnp.where(accept, mx_next, c.mx)

        delta = update_tr(c.delta, rho, opts.eta1, opts.eta2, opts.gamma1, opts.gamma2)
        # ref :369 measures pi with the active set as left by inner_step —
        # including TR-face hits, which can spuriously report criticality
        # (latent reference flaw).  Use the exact projected-gradient measure.
        with jax.named_scope("criticality_projection"):
            pix, crit_lam = criticality_measure(poly, x, g, lam0=c.crit_lam)
        solved = pix < omega_tol
        improved = pix < opts.stall_ratio * c.best_pix
        best_pix = jnp.minimum(pix, c.best_pix)
        stall = jnp.where(improved, 0, c.stall + 1)
        return _TRCarry(
            x, rx, cx, mx, g, H, delta, pix, crit_lam, best_pix, stall, c.k + 1,
            c.minor_total + istats.minor_iters, c.cg_total + istats.cg_iters, solved,
        )

    out = lax.while_loop(cond, body, c0)
    return SubproblemResult(
        x=out.x, rx=out.rx, cx=out.cx, pix=out.pix, inner_iters=out.k - 1,
        minor_iters=out.minor_total, cg_iters=out.cg_total,
    )
