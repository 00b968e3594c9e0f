"""Independent first-principles KKT oracle (VERDICT r3 item 6).

The framework certifies solutions with the exact-projection criticality
measure ‖P_Ω(x − ∇L) − x‖ (ops/polyproject.py), and its host C++ twin
(native/polyqp.cpp) implements the SAME dual semismooth-Newton algorithm —
they cross-validate each other but share any algorithmic blind spot.  The
reference avoids this by certifying with a third-party solver (Ipopt via
JuMP: `/root/reference/src/polyhedral_constraints.jl:185-197`, used as test
ground truth at `/root/reference/test/problems/sphere_regression.jl:58-62`).

This module is the rebuild's independent oracle: the KKT conditions of

    min ½‖r(x)‖²  s.t.  c(x) = 0,  Ax = b,  xl ≤ x ≤ xu

checked from first principles in numpy — multiplier estimation by LAPACK
least squares on the free coordinates, stationarity/sign/feasibility tests
directly on the definitions.  Nothing here touches the projection code
path: no dual Newton, no polyhedral projection, no shared kernels.

    L(x, y, ν, σ) = ½‖r‖² + yᵀc + νᵀ(Ax − b) − σ_loᵀ(x − xl) + σ_hiᵀ(x − xu)
    ∇ₓL = Jᵀr + Cᵀy + Aᵀν − σ_lo + σ_hi = 0
    σ_lo, σ_hi ≥ 0, complementary with the bound gaps.

On the free set F (strictly inside the box) the bound duals vanish, so
(y, ν) must solve the overdetermined system  [Cᵀ Aᵀ]_F μ = −(Jᵀr)_F ; the
oracle estimates μ by lstsq and checks the residual.  On active bounds the
implied dual σ = ±(Jᵀr + Eᵀμ)_i must carry the right sign.  Used by
bench.py (sampled per run) and tests/test_kkt_oracle.py.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def kkt_check_point(
    x: np.ndarray,
    r: np.ndarray,
    J: np.ndarray,
    c: Optional[np.ndarray],
    C: Optional[np.ndarray],
    A: Optional[np.ndarray],
    b: Optional[np.ndarray],
    xl: np.ndarray,
    xu: np.ndarray,
    stat_tol: float = 1.5e-8,
    feas_tol: float = 1.5e-8,
    active_atol: float = 1e-9,
) -> dict:
    """First-principles KKT check of one point; all inputs are numpy f64.

    Returns a dict with `ok` (bool) and the individual measures:
    `stat` (free-coordinate stationarity, scale-relative), `feas`
    (constraint violation), `bound_viol` (box violation), `sign_viol`
    (most negative implied bound dual, scale-relative).  Tolerances are
    scale-relative against 1 + ‖Jᵀr‖.
    """
    x = np.asarray(x, np.float64)
    r = np.asarray(r, np.float64)
    J = np.asarray(J, np.float64)
    n = x.shape[0]
    g = J.T @ r
    # Stationarity scales with the gradient; feasibility scales with the
    # CONSTRAINT data — gradient-scaled feasibility would certify gross
    # constraint violations on steep objectives (round-4 review finding).
    scale = 1.0 + float(np.linalg.norm(g))
    feas_scale = 1.0

    blocks = []
    feas2 = 0.0
    if C is not None and C.size:
        blocks.append(np.asarray(C, np.float64))
        feas2 += float(np.sum(np.asarray(c, np.float64) ** 2))
    if A is not None and A.size:
        blocks.append(np.asarray(A, np.float64))
        feas2 += float(np.sum((np.asarray(A, np.float64) @ x - np.asarray(b, np.float64)) ** 2))
        feas_scale += float(np.linalg.norm(np.asarray(b, np.float64)))
    E = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, n))
    feas = feas2 ** 0.5

    lo_gap = x - np.asarray(xl, np.float64)
    hi_gap = np.asarray(xu, np.float64) - x
    bound_viol = float(max(0.0, -min(lo_gap.min(initial=0.0), hi_gap.min(initial=0.0))))
    asc = active_atol * (1.0 + np.abs(x))
    on_lo = np.isfinite(xl) & (lo_gap <= asc)
    on_hi = np.isfinite(xu) & (hi_gap <= asc)
    free = ~(on_lo | on_hi)

    # Equality multipliers from the free stationarity rows (LAPACK lstsq —
    # min-norm for rank-deficient E, matching the solver's own convention).
    degenerate_all_active = False
    if E.shape[0] and free.any():
        mu, *_ = np.linalg.lstsq(E[:, free].T, -g[free], rcond=None)
    elif E.shape[0] and not free.any():
        # Fully-active box WITH equalities: there are no free stationarity
        # rows to pin mu, so mu=0 + a raw-gradient sign test can falsely
        # fail a genuine KKT point (round-4 advisor finding).  Estimate
        # (mu, sigma) jointly from the FULL stationarity rows with the
        # implied bound duals as sign-constrained slack:
        #     min ‖g + Eᵀmu − S sigma‖   s.t. sigma ≥ 0,
        # where S carries +e_i on lower-active and −e_i on upper-active
        # coords (both-bounds coords get an unsigned column).  A KKT point
        # has residual 0; the sign conditions hold by construction, so the
        # residual itself is the stationarity measure.
        both = on_lo & on_hi
        S_cols = []
        for i in range(n):
            col = np.zeros(n)
            col[i] = 1.0 if (on_lo[i] or both[i]) else -1.0
            S_cols.append(col)
        S = np.stack(S_cols, axis=1)  # (n, n): one dual column per coord
        try:
            from scipy.optimize import lsq_linear

            q = E.shape[0]
            M = np.concatenate([E.T, -S], axis=1)      # (n, q + n)
            lb = np.concatenate([np.full(q, -np.inf), np.zeros(n)])
            # Both-bounds coords carry either sign (degenerate box):
            lb[q:][np.asarray(both)] = -np.inf
            sol = lsq_linear(M, -g, bounds=(lb, np.full(q + n, np.inf)))
            mu = sol.x[:q]
            sigma = sol.x[q:]
            resid = g + E.T @ mu - S @ sigma
            return {
                "ok": bool(
                    float(np.linalg.norm(resid)) <= stat_tol * scale
                    and feas <= feas_tol * feas_scale
                    and bound_viol
                    <= feas_tol * (1.0 + float(np.max(np.abs(x), initial=0.0)))
                ),
                "stat": float(np.linalg.norm(resid)),
                "feas": feas,
                "bound_viol": bound_viol,
                "sign_viol": 0.0,  # enforced by the sigma >= 0 constraint
                "scale": scale,
                "n_free": 0,
                "n_eq": int(E.shape[0]),
                "degenerate_all_active": True,
            }
        except ImportError:  # pragma: no cover - scipy is present in-image
            mu = np.zeros((E.shape[0],))
            degenerate_all_active = True  # sign check unreliable; flag it
    else:
        mu = np.zeros((E.shape[0],))
    gL = g + (E.T @ mu if E.shape[0] else 0.0)

    stat = float(np.linalg.norm(gL[free])) if free.any() else 0.0
    # Implied bound duals: σ_lo = gL on lower-active (≥ 0), σ_hi = −gL on
    # upper-active (≥ 0).  Coordinates active at BOTH bounds (degenerate
    # box) carry either sign.
    both = on_lo & on_hi
    sign_viol = 0.0
    if not degenerate_all_active:
        if (on_lo & ~both).any():
            sign_viol = max(sign_viol, float(-(gL[on_lo & ~both]).min(initial=0.0)))
        if (on_hi & ~both).any():
            sign_viol = max(sign_viol, float((gL[on_hi & ~both]).max(initial=0.0)))

    bound_scale = 1.0 + float(np.max(np.abs(x), initial=0.0))
    ok = (
        stat <= stat_tol * scale
        and feas <= feas_tol * feas_scale
        and bound_viol <= feas_tol * bound_scale
        and sign_viol <= stat_tol * scale
    )
    out = {
        "ok": bool(ok),
        "stat": stat,
        "feas": feas,
        "bound_viol": bound_viol,
        "sign_viol": sign_viol,
        "scale": scale,
        "n_free": int(free.sum()),
        "n_eq": int(E.shape[0]),
    }
    if degenerate_all_active:  # scipy-less fallback: sign check skipped
        out["degenerate_all_active"] = True
    return out


def kkt_cross_check_batch(
    bp,
    theta,
    X,
    sample: int = 8,
    stat_tol: float = 1.5e-8,
    feas_tol: float = 1.5e-8,
    seed: int = 0,
) -> dict:
    """Cross-check `sample` instances of a batched solve with the
    independent oracle.  `bp` is a BatchedProblem, `theta` its batched
    data, `X` the claimed solutions (converged instances should pass).

    Returns {"oracle_checked": k, "oracle_agree": j, "oracle_agree_frac",
    "oracle_worst": worst-case measures}.  Evaluation happens on CPU via
    the family's own callables (cast to f64) — independent of every device
    code path.
    """
    import jax
    import jax.numpy as jnp

    from ..harness.devices import local_cpu

    B = int(np.asarray(X).shape[0])
    k = min(sample, B)
    idx = np.random.default_rng(seed).choice(B, size=k, replace=False)
    n = np.asarray(X).shape[-1]

    cpu = local_cpu()
    with jax.default_device(cpu):
        poly = bp.polyhedron(n, jnp.float64)
        agree = 0
        worst = None
        for i in idx:
            def take_leaf(a, i=i):
                # Slice only batched leaves (leading axis == B; the
                # package-wide theta convention); cast only floating
                # leaves — integer leaves (index arrays) pass through.
                ah = np.asarray(a)
                if ah.ndim and ah.shape[0] == B:
                    ah = ah[int(i)]
                return ah.astype(np.float64) if np.issubdtype(ah.dtype, np.floating) else ah

            th_i = jax.tree.map(take_leaf, theta)
            fns = bp.instance_fns(jax.tree.map(jnp.asarray, th_i))
            x = np.asarray(X, np.float64)[int(i)]
            xj = jnp.asarray(x)
            r = np.asarray(fns.residuals(xj), np.float64)
            J = np.asarray(fns.jac_res(xj), np.float64)
            c = np.asarray(fns.nlconstraints(xj), np.float64)
            C = np.asarray(fns.jac_nlcons(xj), np.float64)

            A_i = np.asarray(poly.A, np.float64)
            b_i = np.asarray(poly.b, np.float64)
            xl_i = np.asarray(poly.xl, np.float64)
            xu_i = np.asarray(poly.xu, np.float64)
            if A_i.ndim == 3:
                A_i = A_i[int(i)]
            if b_i.ndim == 2:
                b_i = b_i[int(i)]
            if xl_i.ndim == 2:
                xl_i = xl_i[int(i)]
            if xu_i.ndim == 2:
                xu_i = xu_i[int(i)]
            res = kkt_check_point(
                x, r, J, c if c.size else None, C if C.size else None,
                A_i if A_i.size else None, b_i if b_i.size else None,
                xl_i, xu_i, stat_tol=stat_tol, feas_tol=feas_tol,
            )
            agree += int(res["ok"])
            key = max(res["stat"], res["feas"], res["sign_viol"]) / res["scale"]
            if worst is None or key > worst[0]:
                worst = (key, res)
    return {
        "oracle_checked": k,
        "oracle_agree": agree,
        "oracle_agree_frac": round(agree / max(k, 1), 4),
        "oracle_worst_stat": round(worst[1]["stat"], 12) if worst else 0.0,
        "oracle_worst_feas": round(worst[1]["feas"], 12) if worst else 0.0,
    }


def kkt_check_blocked_hard(bp, theta, x, alpha: float = 1.5,
                           tol: float = 5e-4) -> dict:
    """Oracle check of a `problems.generators.blocked_hard_family` solution.

    The family is r(x) = J0 ψ(x) − y with ψ(x) = x + αx³, so J(x) =
    J0 diag(ψ'(x)); everything is rebuilt here in numpy f64 from the raw
    data.  `tol` is the stationarity/feasibility tolerance: 5e-4 is the
    f32 grade (≈ √eps(f32) with headroom) of an f32 blocked solve.
    Returns `kkt_check_point`'s dict plus `active_frac`.
    """
    xn = np.asarray(x, np.float64)
    J0 = np.asarray(theta["J"], np.float64)
    y = np.asarray(theta["y"], np.float64)
    xl = np.asarray(bp.xl, np.float64)
    xu = np.asarray(bp.xu, np.float64)
    r = J0 @ (xn + alpha * xn**3) - y
    J = J0 * (1.0 + 3.0 * alpha * xn * xn)[None, :]
    res = kkt_check_point(
        xn, r, J, None, None,
        np.asarray(bp.A, np.float64), np.asarray(bp.b, np.float64), xl, xu,
        stat_tol=tol, feas_tol=tol,
    )
    res["active_frac"] = float(((xn - xl < 1e-6) | (xu - xn < 1e-6)).mean())
    return res


def kkt_check_classic_battery(options=None) -> dict:
    """Solve every classic HS/MGH battery entry (problems/classic.py) on
    host and run the independent oracle on each solution.

    The reference oracle-checks its one integration fixture with Ipopt
    (`/root/reference/test/problems/sphere_regression.jl:58`); this sweeps
    the rebuild's whole battery through the zero-shared-code check.
    Returns {"battery_oracle_checked", "battery_oracle_agree",
    "battery_oracle_fail": [names]}.
    """
    import jax
    import jax.numpy as jnp

    from ..harness.devices import local_cpu
    from ..problems.classic import REGISTRY
    from ..solver.api import solve
    from ..solver.options import SolverOptions

    cpu = local_cpu()
    fails = []
    checked = 0
    with jax.default_device(cpu):
        for name in sorted(REGISTRY):
            rec = REGISTRY[name]
            problem = rec.make_problem()
            x0 = rec.x0()
            opts = options or (
                SolverOptions(max_outer_iter=100, **rec.options)
                if rec.options
                else SolverOptions(max_outer_iter=100, max_inner_iter=300)
            )
            x, y, info = solve(problem, x0, opts)
            fns, poly = problem.build(x0.shape[0], jnp.float64)
            xj = jnp.asarray(x)
            c = np.asarray(fns.nlconstraints(xj), np.float64)
            C = np.asarray(fns.jac_nlcons(xj), np.float64)
            A = np.asarray(poly.A, np.float64)
            res = kkt_check_point(
                np.asarray(x, np.float64),
                np.asarray(fns.residuals(xj), np.float64),
                np.asarray(fns.jac_res(xj), np.float64),
                c if c.size else None, C if C.size else None,
                A if A.size else None, np.asarray(poly.b, np.float64),
                np.asarray(poly.xl, np.float64), np.asarray(poly.xu, np.float64),
            )
            checked += 1
            if not (bool(info.converged) and res["ok"]):
                fails.append(name)
    return {
        "battery_oracle_checked": checked,
        "battery_oracle_agree": checked - len(fails),
        "battery_oracle_fail": fails,
    }
