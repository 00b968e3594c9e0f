"""Exact projection onto the polyhedron {v : Av = b, l ≤ v ≤ u}.

In-framework, jittable, batchable replacement for the reference's external
Ipopt QP solve (`projection_polyhedron`,
`/root/reference/src/polyhedral_constraints.jl:179-198`) — the single place
where the reference leaves Julia for a foreign solver (SURVEY.md §3.4).
Here no host callback is needed: the QP

    min_v 1/2 ‖v - x‖²  s.t.  A v = b,  l ≤ v ≤ u

is solved in its dual.  Eliminating v against the box gives the piecewise
affine-smooth concave dual in λ ∈ ℝᵐ (m is small):

    v*(λ) = clip(x - Aᵀλ, l, u),     F(λ) = A v*(λ) - b = 0 at the optimum.

F is solved by a damped semismooth Newton iteration: the generalized
Jacobian is -A D Aᵀ with D = diag(1{l < x - Aᵀλ < u}), so each step is one
m×m Cholesky solve + two GEMVs — the same kernel shapes as the active-set
projections, fully jittable (`lax.while_loop`, fixed caps) and vmappable
over batches of instances.  This finite active-set Newton typically
terminates in a handful of steps at machine precision, giving the
√eps-grade accuracy the reference gets from Ipopt.

Used by: the legacy Cauchy variant's path (ref `src/basic_tralcnlss.jl:478`),
the ‖P(x-g)-x‖ criticality measure (ref :850-860), and as the KKT oracle in
tests (ref `test/problems/sphere_regression.jl:58`) — mirroring the
reference, the live inner loop does *not* call it.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .cholesky import _chol_xla, cho_solve_lower
from .constraints import Polyhedron

Array = jax.Array


class _NewtonCarry(NamedTuple):
    lam: Array
    Fnorm: Array
    best: Array       # stall-detection reference ‖F‖ (reset on restart)
    fbest: Array      # smallest ‖F‖ ever seen (never reset)
    lam_best: Array   # the dual achieving `fbest` (cap-exit safety)
    stall: Array
    it: Array
    restarted: Array


def projection_polyhedron(
    poly: Polyhedron,
    x: Array,
    tol: float | None = None,
    max_iter: int = 100,
    reg: float | None = None,
    lam0: Array | None = None,
    return_lam: bool = False,
    return_iters: bool = False,
):
    """Project x onto {v : Av = b, l ≤ v ≤ u}. Jittable; vmap for batches.

    Replaces `projection_polyhedron` (ref
    `src/polyhedral_constraints.jl:179-198`).  `tol` defaults to
    sqrt(eps(dtype))·eps-grade stationarity on the dual residual ‖Av*-b‖;
    `reg` is the Tikhonov jitter on A D Aᵀ guarding degenerate active sets.
    `lam0` warm-starts the dual (callers projecting a slowly-moving point —
    the per-TR-iteration criticality measure — converge in 1-2 Newton steps
    warm vs ~5-15 cold).  A STALE warm start can park the damped Newton at
    the dual-residual floor of the wrong face (the round-3 root cause of
    the criticality slowdown that forced cold starts): the stall
    detector now spends its first trigger on an in-loop COLD RESTART
    (lam ← 0) instead of exiting, so a bad warm start costs ~4 stalled
    steps + the cold solve, and a good one keeps the 1-2-step fast path.
    `return_lam=True` also returns the final dual; `return_iters=True`
    additionally returns the Newton iteration count (diagnostics/tests).
    """
    dtype = x.dtype
    eps = jnp.finfo(dtype).eps
    if tol is None:
        tol = float(eps) ** 0.75  # tighter than sqrt(eps); Newton hits it fast
    if reg is None:
        reg = float(eps) ** 0.5
    # Root-finder geometry ~ mantissa bits: 16x shrink per section round.
    # (Round 4 tried f32 grid evaluations for f64 duals — the line search
    # only needs sign patterns — but near the root |phi| falls below f32
    # noise, the bracket wanders, and warm projections took 5x the
    # iterations: the grids must run at the dual's precision.)
    grow_pows = 40 if dtype == jnp.float32 else 60
    n_section = 6 if dtype == jnp.float32 else 14

    A, b, l, u = poly.A, poly.b, poly.xl, poly.xu
    m = A.shape[0]
    if m == 0:
        v = jnp.clip(x, l, u)
        out = (v,)
        if return_lam:
            out += (jnp.zeros((0,), dtype),)
        if return_iters:
            out += (jnp.zeros((), jnp.int32),)
        return out if len(out) > 1 else v

    eye = jnp.eye(m, dtype=dtype)
    tol_val = jnp.asarray(tol, dtype) * (1 + jnp.linalg.norm(b))

    def v_of(lam):
        return jnp.clip(x - A.T @ lam, l, u)

    def F_of(lam):
        return A @ v_of(lam) - b

    def q_of(lam):
        # Concave dual objective; F = ∇q, so damping on q (not on ‖F‖, which
        # is non-monotone along ascent directions) is globally convergent.
        v = v_of(lam)
        return 0.5 * jnp.vdot(v - x, v - x) + jnp.vdot(lam, A @ v - b)

    def cond(c: _NewtonCarry):
        # Stall exit: at the dtype's dual-residual floor (‖F‖ can sit just
        # above tol) further Newton steps are roundoff churn; without this
        # a lane spins to max_iter and, under vmap, drags the whole batch.
        # With a restart still in the budget (warm-started calls), the
        # first stall is consumed by the cold restart in `body` instead.
        return (c.Fnorm > tol_val) & (c.it < max_iter) & ((c.stall < 4) | ~c.restarted)

    # Residual of the cold start, used by the in-loop restart below;
    # computed ONCE here (F(0) does not depend on the loop state, and
    # evaluating it inside `body` would add a full dual-residual
    # evaluation to every Newton iteration of every call).
    fn_zero = jnp.linalg.norm(F_of(jnp.zeros((m,), dtype)))

    def body(c: _NewtonCarry):
        # Cold-restart rescue: a stale warm start can stall the damped
        # Newton on the wrong face; spend the first stall trigger on
        # lam <- 0 rather than an above-tolerance exit.  `best`/`lam_best`
        # deliberately survive the restart: if the cold trajectory ends
        # worse (max_iter cap), the pre-restart iterate is restored at
        # exit.
        do_restart = (c.stall >= 4) & ~c.restarted
        lam_r = jnp.where(do_restart, jnp.zeros_like(c.lam), c.lam)
        fr = jnp.where(do_restart, fn_zero, c.Fnorm)
        c = _NewtonCarry(
            lam_r, fr,
            # Stall reference resets so the cold trajectory gets its own
            # stall budget; the global (fbest, lam_best) pair survives.
            jnp.where(do_restart, fn_zero, c.best),
            c.fbest, c.lam_best,
            jnp.where(do_restart, 0, c.stall),
            c.it,
            c.restarted | do_restart,
        )
        lam = c.lam
        z = x - A.T @ lam
        inactive = (z > l) & (z < u)
        AD = A * inactive.astype(dtype)[None, :]
        K = AD @ A.T + jnp.asarray(reg, dtype) * eye
        F = F_of(lam)
        L = _chol_xla(K)  # bf16-safe (f32 round trip; no bf16 chol kernel)
        dlam = cho_solve_lower(L, F)

        # Exact linesearch: along lam + t·dlam the dual q is concave
        # piecewise-quadratic, so its slope
        #     phi(t) = dᵀ∇q = wᵀ clip(z0 - t·w, l, u) - dᵀb,   w = Aᵀ·dlam
        # is non-increasing; find its root.  K SPD ⇒ dlam is an ascent
        # direction (phi(0) = FᵀK⁻¹F > 0) even when K is nearly singular.
        # Root finding is VECTORIZED: each round evaluates phi on a whole
        # grid of t's as one (T, n) clip+reduce (sequential while-loop
        # doubling/bisection cost ~90 latency-bound steps per Newton
        # iteration and dominated the solver's criticality measure).
        z0 = x - A.T @ lam
        w = A.T @ dlam
        db = jnp.vdot(dlam, b)

        def phi_grid(ts):
            V = jnp.clip(z0[None, :] - ts[:, None] * w[None, :], l[None, :], u[None, :])
            return V @ w - db

        # Octave bracket: one evaluation over t = 2^0..2^grow_pows.
        ts = jnp.asarray(2.0, dtype) ** jnp.arange(0, grow_pows + 1, dtype=jnp.int32).astype(dtype)
        ph = phi_grid(ts)
        any_neg = jnp.any(ph <= 0)
        first_neg = jnp.argmax(ph <= 0)  # first index with phi ≤ 0
        t_hi = jnp.where(any_neg, ts[first_neg], ts[-1])
        t_lo = jnp.where(any_neg & (first_neg > 0), ts[jnp.maximum(first_neg - 1, 0)], 0.0)

        # K-way section: interval shrinks (K-1)x per round.
        K_SEC = 17

        def section(_, tlohi):
            lo, hi = tlohi
            grid = lo + (hi - lo) * jnp.linspace(0.0, 1.0, K_SEC).astype(dtype)
            pg = phi_grid(grid)
            pos = pg > 0
            # last grid point with phi > 0 (phi(lo) > 0 by bracket invariant)
            idx = jnp.maximum(jnp.sum(pos.astype(jnp.int32)) - 1, 0)
            new_lo = grid[idx]
            new_hi = grid[jnp.minimum(idx + 1, K_SEC - 1)]
            return (new_lo, jnp.where(new_hi > new_lo, new_hi, hi))

        t_lo, t_hi = lax.fori_loop(0, n_section, section, (t_lo, t_hi), unroll=True)
        t_star = 0.5 * (t_lo + t_hi)
        # Monotone safeguard (roundoff): never accept a dual decrease —
        # UNLESS the residual itself decreases.  Near the optimum the dual
        # improvement Δq ≈ ‖F‖² is far below the representability floor of
        # q ~ O(‖v-x‖²) (e.g. 1e-19 vs 1e-16 rounding noise at f64), so the
        # pure q-comparison rejects the final contraction steps and a
        # near-converged (warm) start churns at stall until the cold
        # restart — the round-3 warm-start slowdown.  ‖F‖ decrease is
        # the sound acceptance signal in exactly that regime.
        lam_try = lam + t_star * dlam
        fn_try = jnp.linalg.norm(F_of(lam_try))
        accept = (q_of(lam_try) >= q_of(lam)) | (fn_try < c.Fnorm)
        lam_new = jnp.where(accept, lam_try, lam)
        fn_new = jnp.where(accept, fn_try, c.Fnorm)
        improved = fn_new < 0.7 * c.best
        record = fn_new < c.fbest
        return _NewtonCarry(
            lam_new,
            fn_new,
            jnp.minimum(fn_new, c.best),
            jnp.minimum(fn_new, c.fbest),
            jnp.where(record, lam_new, c.lam_best),
            jnp.where(improved, 0, c.stall + 1),
            c.it + 1,
            c.restarted,
        )

    lam_init = jnp.zeros((m,), dtype) if lam0 is None else jnp.asarray(lam0, dtype)
    fn0 = jnp.linalg.norm(F_of(lam_init))
    # Cold starts have no restart budget (restarting to zeros from zeros
    # is a no-op); warm starts get one.
    c0 = _NewtonCarry(
        lam_init, fn0, fn0, fn0, lam_init,
        jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
        jnp.asarray(lam0 is None),
    )
    out = lax.while_loop(cond, body, c0)
    # Cap/stall exits can end on a post-restart iterate worse than the
    # best one seen; hand back the recorded best in that case.
    lam_fin = jnp.where(out.Fnorm <= out.fbest, out.lam, out.lam_best)
    ret = (v_of(lam_fin),)
    if return_lam:
        ret += (lam_fin,)
    if return_iters:
        ret += (out.it,)
    return ret if len(ret) > 1 else ret[0]


def criticality_measure_polyhedron(poly: Polyhedron, x: Array, g: Array) -> Array:
    """‖P(x - g) - x‖ with P the exact polyhedral projection.

    The reference's alternative 6-arg `criticality_measure`
    (ref `src/basic_tralcnlss.jl:850-860`), also the KKT measure used by its
    integration test (ref `test/problems/sphere_regression.jl:58-62`).
    """
    return jnp.linalg.norm(projection_polyhedron(poly, x - g) - x)
