"""Masked nullspace/subspace projections onto active linear constraints.

Re-design of the reference's projection layer
(`/root/reference/src/polyhedral_constraints.jl:72-170`): projection of a
vector r onto the tangent set

    T = {v : A v = 0,  v_i = 0 for i fixed}

via normal equations with the masked factorization chol(A Z Aᵀ) from
`ops/cholesky.py` (see there for equivalence with the reference's augmented
ÃÃᵀ formulation).  One projection = zero the fixed coords, two triangular
solves on an m×m factor, one GEMV pair — the per-CG-iteration hot path
(SURVEY.md §3.3 hot-loop ranking).

`left_mul` / `left_mul_tr` are the masked fixed-shape analogs of the
reference's implicit Ã operators (ref :72-98); the live solver path never
needs them (the projection inlines them), but they are part of the public
component inventory and serve the parity tests.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .cholesky import cho_solve_lower
from .constraints import ActiveSet, Polyhedron

Array = jax.Array


def left_mul(poly: Polyhedron, fixed: Array, x: Array) -> Array:
    """Ã x as a fixed-shape (m+n,) vector: [A x ; where(fixed, x, 0)].

    Masked analog of `left_mul` (ref `src/polyhedral_constraints.jl:86-98`):
    the reference packs only the p fixed entries; here inactive slots hold
    zeros so the shape is static.
    """
    return jnp.concatenate([poly.A @ x, jnp.where(fixed, x, 0)])


def left_mul_tr(poly: Polyhedron, fixed: Array, y: Array) -> Array:
    """Ãᵀ y for y = [y_lin (m,) ; y_bnd (n,)] in the fixed-shape layout.

    Masked analog of `left_mul_tr` (ref `src/polyhedral_constraints.jl:72-84`).
    """
    m = poly.A.shape[0]
    return poly.A.T @ y[:m] + jnp.where(fixed, y[m:], 0)


def project_tangent(poly: Polyhedron, aset: ActiveSet, r: Array) -> Array:
    """Orthogonal projection of r onto {v : Av = 0, v_i = 0 for i fixed}.

    Unifies `projection_nullspace!` / `projection_subspace!` / `projection`
    (ref `src/polyhedral_constraints.jl:104-170`) into one masked formula

        P r = Z r̃ - Z Aᵀ (A Z Aᵀ)⁻¹ A Z r̃,   Z = diag(¬fixed)

    which reduces to the pure nullspace projection when nothing is fixed and
    to Z r when m == 0 (a case the reference cannot express).
    """
    free = ~aset.fixed
    rz = jnp.where(free, r, 0)
    if poly.A.shape[0] == 0:
        return rz
    w = cho_solve_lower(aset.chol, poly.A @ rz)
    return rz - jnp.where(free, poly.A.T @ w, 0)


def norm_reduced_gradient(poly: Polyhedron, aset: ActiveSet, g: Array) -> Array:
    """‖P(-g)‖ — the reduced-gradient criticality measure.

    Mirrors `norm_reduced_gradient` (ref `src/basic_tralcnlss.jl:869-875`);
    the live `criticality_measure` (ref :839-844) is exactly this.
    """
    return jnp.linalg.norm(project_tangent(poly, aset, -g))
