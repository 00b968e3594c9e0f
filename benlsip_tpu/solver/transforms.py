"""Problem transforms: inequality constraints via slack variables.

The reference solves only equality-constrained NLS with bounds — its
signature has no inequality block at all
(`/root/reference/src/basic_tralcnlss.jl:167-197`).  Real problem sets
(HS/MGH, curve fitting with shape constraints) routinely carry
inequalities; the classical reduction makes them solvable by the SAME
machinery with zero solver changes:

    g(x) ≥ 0        →   g(x) − s = 0,   s ≥ 0      (nonlinear, slack s)
    G x ≥ h         →   G x − t = h,    t ≥ 0      (linear, slack t)

The lifted variable z = [x; s; t] keeps every structural property the
batched design relies on: static shapes (q and ℓ are fixed), the polyhedron
stays {A_z z = b_z, l ≤ z ≤ u} (slack bounds are just more box bounds for
the existing masked active-set machinery), and the Jacobian blocks are
zero-padded — XLA fuses the padding away.  Slack columns add q+ℓ to n;
for the batched small-instance regime that is the usual active-set QP
trade and costs one more lane tile at most.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .api import Problem

Array = jax.Array


class LiftedProblem(NamedTuple):
    """Result of `with_inequalities`.

    problem: the equality-form `Problem` over z = [x; s; t].
    z0:      feasible-start lift of x0 (slacks initialized at
             max(g(x0), 0) / max(Gx0 − h, 0) — exactly on their bound
             whenever the inequality is active or violated at x0; the
             active-set machinery handles on-bound starts natively, so
             no interior push is applied).
    unlift:  z ↦ x (drops the slack block; works on batched z too).
    slacks:  z ↦ (s, t) — the inequality activities at a solution
             (g_i active ⟺ s_i = 0, same for t).
    """

    problem: Problem
    z0: Array
    unlift: Callable[[Array], Array]
    slacks: Callable[[Array], Tuple[Array, Array]]


def with_inequalities(
    problem: Problem,
    x0: Array,
    nl_ineq: Optional[Callable[[Array], Array]] = None,
    jac_ineq: Optional[Callable[[Array], Array]] = None,
    G: Optional[Array] = None,
    h: Optional[Array] = None,
) -> LiftedProblem:
    """Lift `problem` + inequalities into pure equality/bound form.

    nl_ineq: x ↦ g(x) ∈ ℝ^q enforced as g(x) ≥ 0 (autodiff Jacobian when
    jac_ineq is None); G, h: linear rows enforced as G x ≥ h.  Either or
    both may be given.  Returns a `LiftedProblem` whose `problem` solves
    with the standard `solve`/batched entries; `unlift` recovers x.

    At a KKT point of the lifted problem the multiplier of the i-th slack
    equality is the inequality's multiplier, and the slack's bound
    activity (s_i = 0) marks the inequality active — the standard
    correspondence, so certificates transfer unchanged.
    """
    if nl_ineq is None and G is None:
        raise ValueError("with_inequalities: give nl_ineq and/or (G, h)")
    if G is None and h is not None:
        raise ValueError(
            "with_inequalities: h given without G — the linear rows Gx ≥ h "
            "need both; a mis-keyed call would otherwise silently drop them"
        )
    if nl_ineq is None and jac_ineq is not None:
        raise ValueError("with_inequalities: jac_ineq given without nl_ineq")
    n = x0.shape[-1]
    dtype = x0.dtype
    if nl_ineq is not None:
        # Accept a scalar-returning single constraint (the natural way to
        # write one inequality) by promoting to a length-1 vector.
        user_g = nl_ineq
        nl_ineq = lambda x: jnp.atleast_1d(user_g(x))
        q = jax.eval_shape(nl_ineq, x0).shape[0]
    else:
        q = 0
    if G is not None:
        G = jnp.asarray(G, dtype)
        if h is None:
            raise ValueError("with_inequalities: G given without h")
        h = jnp.asarray(h, dtype)
        ell = G.shape[0]
    else:
        ell = 0
    nz = n + q + ell

    def split(z):
        return z[..., :n], z[..., n:n + q], z[..., n + q:]

    # Residuals see only x; their Jacobian gets q+ℓ zero columns.
    user_jr = problem.jac_res or jax.jacfwd(problem.residuals)

    def residuals_z(z):
        return problem.residuals(split(z)[0])

    def jac_res_z(z):
        Jr = user_jr(split(z)[0])
        return jnp.concatenate([Jr, jnp.zeros(Jr.shape[:-1] + (q + ell,), Jr.dtype)], axis=-1)

    # Equality block: [c(x); g(x) − s]  (t appears only in the linear rows).
    user_c = problem.nlconstraints or (lambda x: jnp.zeros((0,), dtype))
    user_jc = problem.jac_nlcons or jax.jacfwd(user_c)
    if nl_ineq is not None:
        # atleast_2d mirrors the scalar-constraint promotion above for a
        # hand-coded (n,)-shaped single-row Jacobian.
        user_jg = (
            (lambda x: jnp.atleast_2d(jac_ineq(x)))
            if jac_ineq is not None
            else jax.jacfwd(nl_ineq)
        )

    def nlconstraints_z(z):
        x, s, _ = split(z)
        parts = [user_c(x)]
        if nl_ineq is not None:
            parts.append(nl_ineq(x) - s)
        return jnp.concatenate(parts, axis=-1)

    def jac_nlcons_z(z):
        x, _, _ = split(z)
        C = user_jc(x)
        p = C.shape[0]
        top = jnp.concatenate([C, jnp.zeros((p, q + ell), C.dtype)], axis=-1)
        if nl_ineq is None:
            return top
        Jg = user_jg(x)
        mid = jnp.concatenate(
            [Jg, -jnp.eye(q, dtype=Jg.dtype), jnp.zeros((q, ell), Jg.dtype)], axis=-1
        )
        return jnp.concatenate([top, mid], axis=0)

    # Linear block: [A 0 0; G 0 −I] z = [b; h].
    A = problem.A if problem.A is not None else jnp.zeros((0, n), dtype)
    b = problem.b if problem.b is not None else jnp.zeros((A.shape[0],), dtype)
    m = A.shape[0]
    A_z = jnp.concatenate([jnp.asarray(A, dtype), jnp.zeros((m, q + ell), dtype)], axis=-1)
    b_z = jnp.asarray(b, dtype)
    if ell:
        G_row = jnp.concatenate([G, jnp.zeros((ell, q), dtype), -jnp.eye(ell, dtype=dtype)], axis=-1)
        A_z = jnp.concatenate([A_z, G_row], axis=0)
        b_z = jnp.concatenate([b_z, h], axis=-1)

    xl = problem.xl if problem.xl is not None else jnp.full((n,), -jnp.inf, dtype)
    xu = problem.xu if problem.xu is not None else jnp.full((n,), jnp.inf, dtype)
    zl = jnp.concatenate([jnp.asarray(xl, dtype), jnp.zeros((q + ell,), dtype)], axis=-1)
    zu = jnp.concatenate([jnp.asarray(xu, dtype), jnp.full((q + ell,), jnp.inf, dtype)], axis=-1)

    lifted = Problem(
        residuals=residuals_z,
        nlconstraints=nlconstraints_z,
        jac_res=jac_res_z,
        jac_nlcons=jac_nlcons_z,
        A=A_z,
        b=b_z,
        xl=zl,
        xu=zu,
    )

    # Feasible-start lift: slacks at their activities, floored at 0 so the
    # box holds; solve()'s project_x0 then restores A_z z = b_z exactly.
    s0 = jnp.maximum(nl_ineq(x0), 0.0) if nl_ineq is not None else jnp.zeros((0,), dtype)
    t0 = jnp.maximum(G @ x0 - h, 0.0) if ell else jnp.zeros((0,), dtype)
    z0 = jnp.concatenate([x0, s0.astype(dtype), t0.astype(dtype)], axis=-1)

    return LiftedProblem(
        problem=lifted,
        z0=z0,
        unlift=lambda z: z[..., :n],
        slacks=lambda z: (z[..., n:n + q], z[..., n + q:]),
    )
