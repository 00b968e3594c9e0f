"""Polyhedral constraint set and masked active-set machinery.

Re-design of the reference's `MixedConstraints`
(`/root/reference/src/polyhedral_constraints.jl:1-31, 203-262`).

The reference mutates a `BitVector fixvars` and incrementally refactorizes a
*growing* augmented matrix ÃÃᵀ (Ã = [A; e_iᵀ for i fixed]) on every
active-set change.  Growing shapes are incompatible with XLA's static-shape
compilation model, so here the active set is an immutable boolean mask
`fixed: bool[n]` and every projection factorization works on the *fixed-size*
m×m matrix

    A Z Aᵀ,   Z = diag(free),  free = ¬fixed,

which is exactly the Schur complement of the identity block in the
reference's ÃÃᵀ (see `ops/cholesky.py` for the proof/parity oracle).  A mask
update therefore costs one (batched, tiny) m×m Cholesky instead of a
data-dependent incremental update — fully jittable and vmappable over
instances whose active sets diverge.

Empty constraint blocks (m == 0 and/or no finite bounds) are supported; the
reference crashes on them (SURVEY.md §2.3 quirk 6).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .cholesky import factor_masked_aat

Array = jax.Array


def sqrt_eps(dtype) -> float:
    """The reference's default tolerance sqrt(eps(T)) (ref `src/basic_tralcnlss.jl:181-182`)."""
    return float(jnp.sqrt(jnp.finfo(dtype).eps))


class Polyhedron(NamedTuple):
    """The feasible polyhedron {x : Ax = b, xl ≤ x ≤ xu}.

    Immutable analog of the data half of `MixedConstraints`
    (ref `src/polyhedral_constraints.jl:1-7`: `lineq`, `xlow`, `xupp`).
    Bounds may be ±inf; A may have zero rows (m == 0).
    """

    A: Array   # (m, n) linear equality constraint matrix
    b: Array   # (m,)   right-hand side
    xl: Array  # (n,)   lower bounds (may be -inf)
    xu: Array  # (n,)   upper bounds (may be +inf)


class ActiveSet(NamedTuple):
    """Masked active-bound state + its projection factorization.

    Immutable analog of the (`fixvars`, `chol`) half of `MixedConstraints`
    (ref `src/polyhedral_constraints.jl:1-7`).  `chol` is the lower Cholesky
    factor of A Z Aᵀ (+ reg·I), Z = diag(¬fixed) — see module docstring.
    """

    fixed: Array  # bool (n,) — True where the bound on x_i is active
    chol: Array   # (m, m) lower-triangular factor of A Z Aᵀ


def nb_fix(aset: ActiveSet) -> Array:
    """Number of fixed variables (ref `src/polyhedral_constraints.jl:31`)."""
    return jnp.sum(aset.fixed.astype(jnp.int32))


def make_active_set(poly: Polyhedron, fixed: Array, reg: float = 0.0) -> ActiveSet:
    """Build an ActiveSet for mask `fixed`, refreshing the factorization.

    Fixed-shape analog of `update_chol!`/`cholesky_aug_aat`
    (ref `src/polyhedral_constraints.jl:35-68`).
    """
    return ActiveSet(fixed=fixed, chol=factor_masked_aat(poly.A, ~fixed, reg=reg))


def no_active_set(poly: Polyhedron, reg: float = 0.0) -> ActiveSet:
    """ActiveSet with no fixed variables (the reference's fresh `MixedConstraints`,
    ref `src/polyhedral_constraints.jl:9-18`)."""
    n = poly.A.shape[1]
    return make_active_set(poly, jnp.zeros((n,), dtype=bool), reg=reg)


def active_bounds_at(poly: Polyhedron, x: Array, atol) -> Array:
    """Mask of bounds active at x up to atol.

    Mirrors `active_bounds!` (ref `src/polyhedral_constraints.jl:203-215`):
    x_i - xl_i ≤ atol  or  xu_i - x_i ≤ atol.  Infinite bounds never activate.
    """
    return ((x - poly.xl) <= atol) | ((poly.xu - x) <= atol)


def step_active_bounds(poly: Polyhedron, x: Array, s: Array, delta, atol) -> Array:
    """Mask of bounds hit by step s from x inside the ∞-norm trust region.

    Mirrors `active_bounds` (ref `src/polyhedral_constraints.jl:219-237`):
    with s_l = max(xl - x, -delta), s_u = min(xu - x, delta), variable i is at
    a bound when s_i - s_l_i ≤ atol or s_u_i - s_i ≤ atol.  Returns a mask
    (the reference returns indices; callers union it into the active set,
    which is what `add_active!` at ref :252-261 does).
    """
    s_l = jnp.maximum(poly.xl - x, -delta)
    s_u = jnp.minimum(poly.xu - x, delta)
    return ((s - s_l) <= atol) | ((s_u - s) <= atol)


def binding_bounds_at(poly: Polyhedron, x: Array, g: Array, atol) -> Array:
    """Mask of bounds active at x AND binding for descent direction -g.

    A bound participates in the criticality test only when the negative
    gradient points out of the box: lower bound active with -g_i ≤ 0, or
    upper bound active with -g_i ≥ 0.  The reference measures criticality
    with whatever active set `inner_step` left — including trust-region-face
    hits (ref `src/basic_tralcnlss.jl:369, 439`), which can spuriously zero
    the reduced gradient (e.g. when every variable sits on a TR face on a
    bound-only problem).  This binding-aware mask is the intended
    first-order measure: it vanishes exactly when -g lies in the normal
    cone's bound-aligned part.
    """
    d = -g
    at_lo = (x - poly.xl) <= atol
    at_hi = (poly.xu - x) <= atol
    return (at_lo & (d <= 0)) | (at_hi & (d >= 0))


def binding_bounds_coupled(
    poly: Polyhedron, x: Array, g: Array, atol, reg: float = 0.0, passes: int = 2
) -> Array:
    """Binding active bounds under Ax = b coupling, via projection multipliers.

    The raw-sign test (`binding_bounds_at`) asks whether -g_i points out of
    the box — correct only when the equality constraints don't couple
    variables.  With Ax = b, whether an active bound blocks descent depends
    on the direction AFTER projecting -g through A: start with every active
    bound fixed, project, and release the bounds whose *candidate* freed
    component

        sigma_i = (-g - Aᵀ w)_i,    (A Z Aᵀ) w = A Z (-g)

    points back into the box (sigma_i > 0 at a lower bound, < 0 at an
    upper).  sigma_i is exactly the multiplier of the constraint v_i = 0 in
    the tangent projection, so this is the first-order KKT release rule;
    each release changes w, hence the small fixed number of passes
    (a one/two-pass approximation of the tangent-cone projection, standard
    in gradient-projection methods).  With m == 0 it reduces exactly to
    `binding_bounds_at`.

    Without this rule the solver stalls on faces where -g points out of the
    box for every active bound but a feasible descent direction exists
    through the A-coupling (measured: dense config-3 instances with ~2/3 of
    bounds active stall at pi ~ 3e-2 under the raw-sign test).
    """
    from .cholesky import cho_solve_lower, factor_masked_aat

    r = -g
    at_lo = jnp.isfinite(poly.xl) & ((x - poly.xl) <= atol)
    at_hi = jnp.isfinite(poly.xu) & ((poly.xu - x) <= atol)
    active = at_lo | at_hi
    # A pinched box (xl ~ xu within atol) pins the variable for ANY
    # gradient — releasing it would only burn theta = 0 breakpoints
    # re-fixing it (and `binding_bounds_at` never releases it either).
    pinned = at_lo & at_hi
    if poly.A.shape[0] == 0:
        release = ((at_lo & (r > 0)) | (at_hi & (r < 0))) & ~pinned
        return active & ~release

    fixed = active
    for _ in range(passes):
        free = ~fixed
        L = factor_masked_aat(poly.A, free, reg=reg)
        w = cho_solve_lower(L, poly.A @ jnp.where(free, r, 0))
        sigma = r - poly.A.T @ w
        # NaN guard: with every bound active the first pass can factor a
        # rank-deficient A Z Aᵀ (free count < m) and sigma goes NaN; a NaN
        # comparison is False, so requiring finiteness makes that case
        # degrade to "release nothing" (the pre-coupling behavior) instead
        # of acting on garbage.
        release = ((at_lo & (sigma > 0)) | (at_hi & (sigma < 0))) & jnp.isfinite(sigma)
        fixed = active & ~(release & ~pinned)
    return fixed


def add_active(poly: Polyhedron, aset: ActiveSet, mask_or_index, reg: float = 0.0) -> ActiveSet:
    """Union new active variables into the set and refresh the factorization.

    Masked analog of both `add_active!` overloads
    (ref `src/polyhedral_constraints.jl:240-261`).  Accepts either a boolean
    mask (unioned) or a traced integer index (single variable).
    """
    mask_or_index = jnp.asarray(mask_or_index)
    if mask_or_index.dtype == jnp.bool_:
        fixed = aset.fixed | mask_or_index
    else:
        fixed = aset.fixed.at[mask_or_index].set(True)
    return make_active_set(poly, fixed, reg=reg)


def is_feasible(poly: Polyhedron, x: Array, rtol: float = 1e-8) -> Array:
    """Feasibility check: Ax ≈ b and xl ≤ x ≤ xu.

    Mirrors `is_feasible` (ref `src/basic_tralcnlss.jl:142-150`), which uses
    `isapprox(A*x, b)` — i.e. ‖Ax - b‖ ≤ rtol·max(‖Ax‖, ‖b‖) — with one
    deliberate deviation: Julia's `isapprox` degenerates for homogeneous
    systems (b = 0 forces ‖Ax‖ ≤ rtol·‖Ax‖, i.e. exact zero — HS52/53-type
    problems always test "infeasible" in the reference).  The scale here
    adds the backward-error term ‖A‖_F·‖x‖, under which a point is feasible
    when the residual is explainable by rounding of the matvec itself.
    """
    ax = poly.A @ x
    scale = jnp.maximum(
        jnp.maximum(jnp.linalg.norm(ax), jnp.linalg.norm(poly.b)),
        jnp.linalg.norm(poly.A) * jnp.linalg.norm(x),
    )
    lin_ok = jnp.linalg.norm(ax - poly.b) <= rtol * scale + jnp.finfo(x.dtype).tiny
    bounds_ok = jnp.all(poly.xl <= x) & jnp.all(x <= poly.xu)
    if poly.A.shape[0] == 0:
        return bounds_ok
    return lin_ok & bounds_ok
