"""Lagrange multiplier estimates.

Mirrors `least_squares_multipliers` / `first_order_multipliers`
(`/root/reference/src/basic_tralcnlss.jl:887-911`).  The p == 0 case (no
nonlinear constraints) returns an empty multiplier vector — the reference
unconditionally factorizes CCᵀ and crashes (SURVEY.md §2.3 quirk 6).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.cholesky import cho_solve_lower

Array = jax.Array


def least_squares_multipliers(
    x: Array, residuals, jac_res, jac_nlcons, method: str = "qr",
    axis: str | None = None,
) -> Array:
    """Initial estimate y = argmin_y ‖Cᵀ y + Jᵀ r‖ (the least-squares
    multipliers; ref `src/basic_tralcnlss.jl:887-903`).

    method="normal" is the reference's algebra — Cholesky of CCᵀ, i.e.
    y = -(CCᵀ)⁻¹ C (Jᵀ r) — which squares κ(C).  method="qr" (default;
    SolverOptions.gn_factorization) factors Cᵀ = QR (thin, p columns)
    and solves the
    triangular system R y = -Qᵀ(Jᵀ r): identical solution, κ(C)-accurate.
    """
    from ..ops.al import _psum

    g = _psum(jac_res(x).T @ residuals(x), axis)  # row-sharded contraction
    C = jac_nlcons(x)
    p = C.shape[0]
    if p == 0:
        return jnp.zeros((0,), dtype=x.dtype)
    if method == "normal":
        L = jnp.linalg.cholesky(C @ C.T)
        return cho_solve_lower(L, -(C @ g))
    from ..ops.qr import thin_qr

    Q, R = thin_qr(C.T)
    return jax.scipy.linalg.solve_triangular(R, -(Q.T @ g), lower=False)


def first_order_multipliers(y: Array, cx: Array, mu: Array) -> Array:
    """First-order update y ← y + mu·c (ref `src/basic_tralcnlss.jl:905-911`)."""
    return y + mu * cx
