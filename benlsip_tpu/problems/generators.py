"""Problem-family generators for the benchmark suite and batch tests.

The reference ships exactly one integration problem
(`/root/reference/test/problems/sphere_regression.jl`); the BASELINE
configs demand parameterized families at several scales (small batched,
medium dense, large single-instance).  Each generator returns a
(`BatchedProblem`, theta, X0) triple consumable by `batch.vmap_solve`.

All families are smooth NLS with known structure so convergence can be
asserted (residual norms, feasibility, KKT via the projection oracle).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..batch.vmap_solve import BatchedProblem

Array = jax.Array


def exp_fit_family(
    B: int,
    d: int = 32,
    seed: int = 0,
    dtype=jnp.float64,
    with_constraints: bool = True,
) -> Tuple[BatchedProblem, dict, Array]:
    """Batched exponential curve fitting (BASELINE config 2 workload).

    Per instance: fit y_j ≈ a·exp(-b t_j) + c over d samples; parameters
    x = (a, b, c) with bounds 0.05 ≤ b ≤ 5, -10 ≤ a, c ≤ 10, and (optionally)
    a linear equality a + c = y(0) pinning the intercept — exercising the
    full constraint stack on a classic parameter-estimation shape.
    """
    rng = np.random.default_rng(seed)
    n = 3
    t = np.linspace(0.0, 3.0, d)
    a = rng.uniform(0.5, 3.0, B)
    bb = rng.uniform(0.3, 2.0, B)
    c = rng.uniform(-1.0, 1.0, B)
    y = a[:, None] * np.exp(-bb[:, None] * t[None, :]) + c[:, None]
    y += 0.01 * rng.standard_normal((B, d))

    theta = {"t": jnp.asarray(np.broadcast_to(t, (B, d)), dtype), "y": jnp.asarray(y, dtype)}

    def residuals(x, th):
        return x[0] * jnp.exp(-x[1] * th["t"]) + x[2] - th["y"]

    A = b_rhs = None
    if with_constraints:
        # Pin the model value at t=0: a + c = y0 (per-instance rhs).
        A = jnp.asarray([[1.0, 0.0, 1.0]], dtype)
        b_rhs = jnp.asarray(y[:, :1], dtype)  # (B, 1) batched rhs

    bp = BatchedProblem(
        residuals=residuals,
        A=A,
        b=b_rhs,
        xl=jnp.asarray([-10.0, 0.05, -10.0], dtype),
        xu=jnp.asarray([10.0, 5.0, 10.0], dtype),
        poly_batched=with_constraints,
    )
    X0 = jnp.asarray(np.stack([np.ones(B), np.full(B, 1.0), np.zeros(B)], axis=1), dtype)
    if with_constraints:
        # Start feasible w.r.t. a + c = y0.
        X0 = X0.at[:, 2].set(theta["y"][:, 0] - X0[:, 0])
    return bp, theta, X0


def sphere_family(B: int, seed: int = 0, dtype=jnp.float64) -> Tuple[BatchedProblem, dict, Array]:
    """Batched perturbations of the reference's sphere-regression fixture
    (ref `test/problems/sphere_regression.jl:9-33`): per-instance shifts of
    the residual offsets and the sphere radius.  Shapes n=3, d=4, p=1, m=1.
    """
    rng = np.random.default_rng(seed)
    theta = {
        "off": jnp.asarray(rng.uniform(-0.1, 0.1, (B, 4)), dtype),
        "rad": jnp.asarray(3.0 + rng.uniform(-0.2, 0.2, B), dtype),
    }

    def residuals(x, th):
        base = jnp.stack(
            [
                x[0] ** 2 + x[1] ** 2 - 2 * x[0] + jnp.sin(x[0] + x[1]) - 1.5,
                x[0] * x[1] + 0.5 * jnp.cos(2 * x[0]) - 0.8,
                (x[0] - 1.0) ** 2 + (x[1] - 0.5) ** 2 - x[2],
                x[2] ** 2 - x[0] + 0.3 * jnp.sin(x[2]) - 0.2,
            ]
        )
        return base + th["off"]

    def nlconstraints(x, th):
        return jnp.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - th["rad"]])

    bp = BatchedProblem(
        residuals=residuals,
        nlconstraints=nlconstraints,
        A=jnp.asarray([[1.0, 2.0, -1.0]], dtype),
        b=jnp.asarray([0.5], dtype),
        xl=jnp.asarray([-2.0, -1.5, 0.0], dtype),
        xu=jnp.asarray([2.0, 1.5, 2.0], dtype),
    )
    X0 = jnp.broadcast_to(jnp.asarray([1.0, 0.5, 1.5], dtype), (B, 3))
    return bp, theta, X0


def dense_quadratic_family(
    B: int,
    n: int = 64,
    d: int = 256,
    m: int = 4,
    seed: int = 0,
    dtype=jnp.float64,
) -> Tuple[BatchedProblem, dict, Array]:
    """Medium dense linear-least-squares family with polyhedral constraints
    (BASELINE config 3 shape): r(x) = J x - y with shared random J, per-
    instance targets, linear equalities Ax=b and active-at-solution bounds,
    exercising the projection/active-set path at GEMM-friendly sizes.
    """
    rng = np.random.default_rng(seed)
    J = rng.standard_normal((d, n)) / np.sqrt(d)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = rng.standard_normal((B, n))
    y = x_true @ J.T + 0.01 * rng.standard_normal((B, d))
    b = x_true[0] @ A.T  # shared rhs; instances project onto the same plane

    theta = {"y": jnp.asarray(y, dtype)}
    Jj = jnp.asarray(J, dtype)

    # J is shared (closed over), not per-instance theta: cast it to the
    # working dtype in-graph so mixed-precision pipelines that cast theta
    # (batch/refine.py) see a consistent dtype — XLA constant-folds the
    # astype, so the compiled program holds a native-dtype constant.
    def residuals(x, th):
        return Jj.astype(x.dtype) @ x - th["y"]

    def jac_res(x, th):
        return Jj.astype(x.dtype)

    bp = BatchedProblem(
        residuals=residuals,
        jac_res=jac_res,
        A=jnp.asarray(A, dtype),
        b=jnp.asarray(b, dtype),
        xl=jnp.full((n,), -0.8, dtype),   # bounds bind for ~20% of coords
        xu=jnp.full((n,), 0.8, dtype),
    )
    # Feasible start: project zero onto {Ax=b} (bounds hold at 0).
    AAt = A @ A.T
    x0 = A.T @ np.linalg.solve(AAt, b)
    x0 = np.clip(x0, -0.79, 0.79)
    X0 = jnp.asarray(np.broadcast_to(x0, (B, n)).copy(), dtype)
    return bp, theta, X0


def ill_conditioned_family(
    B: int,
    n: int = 96,
    d: int = 384,
    m: int = 3,
    kappa: float = 1e4,
    seed: int = 0,
    dtype=jnp.float64,
) -> Tuple[BatchedProblem, dict, Array]:
    """Config-3 shape with a controlled Jacobian condition number.

    Same structure as `dense_quadratic_family` but J has geometrically
    decaying singular values sigma_i = kappa^{-i/(n-1)} — the regime where
    the normal-equations operator loses: forming JᵀJ (or CCᵀ) rounds away
    everything below kappa²·eps, so at kappa ≳ 3e3 an f32 Gram pass has no
    signal left while the QR route (gn_factorization="qr") keeps
    kappa·eps ≈ 1e-3 relative accuracy.  The targets are consistent
    (y = J x_true + small noise) so the GN step is well-posed despite the
    conditioning.
    """
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((d, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    sv = kappa ** (-np.arange(n) / (n - 1))
    J = (U * sv[None, :]) @ V.T
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = rng.standard_normal((B, n))
    y = x_true @ J.T + 1e-6 * rng.standard_normal((B, d))
    b = x_true[0] @ A.T

    theta = {"y": jnp.asarray(y, dtype)}
    Jj = jnp.asarray(J, dtype)

    def residuals(x, th):
        return Jj.astype(x.dtype) @ x - th["y"]

    def jac_res(x, th):
        return Jj.astype(x.dtype)

    bp = BatchedProblem(
        residuals=residuals,
        jac_res=jac_res,
        A=jnp.asarray(A, dtype),
        b=jnp.asarray(b, dtype),
        xl=jnp.full((n,), -3.0, dtype),
        xu=jnp.full((n,), 3.0, dtype),
    )
    AAt = A @ A.T
    x0 = A.T @ np.linalg.solve(AAt, b)
    X0 = jnp.asarray(np.broadcast_to(np.clip(x0, -2.9, 2.9), (B, n)).copy(), dtype)
    return bp, theta, X0


def blocked_hard_family(
    n: int = 10240,
    d: int = 20480,
    seed: int = 0,
    dtype=jnp.float32,
    alpha: float = 1.5,
    m: int = 8,
    bound: float = 0.8,
    spread: float = 1.6,
    noise: float = 1e-2,
):
    """Hardened BASELINE config-4 workload (VERDICT r4 #5): one large
    NONLINEAR bound-active instance for the blocked-Jacobian path.

        r(x) = J0 @ psi(x) - y,   psi(x) = x + alpha*x^3 (elementwise)
        J(x) = J0 * psi'(x)       (psi' = 1 + 3 alpha x^2, no (d,n)
                                   materialization beyond J0 itself)

    x_true ~ U(-spread, spread) with spread > bound, so ~1-bound/spread of
    the coordinates are ACTIVE at the solution; the cubic term plus the
    x0=0 cold start force a real trust-region schedule (10+ inner
    iterations with active-set churn and CG bound-hit exits — the round-4
    linear instance converged in 2 outer / 4 inner and exercised none of
    it).  A linear equality block Ax = b (b = A clip(x_true), feasible
    with the box by construction) keeps the full constraint stack live.

    Returns (bp, theta, x0) for `dist.sharded.solve_large_blocked_family`;
    theta = {"J": (d, n), "y": (d,)} so the data ships as traced sharded
    arguments, never compile-payload literals.
    """
    rng = np.random.default_rng(seed)
    J0 = (rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32)
    x_true = rng.uniform(-spread, spread, n).astype(np.float32)
    psi_true = x_true + alpha * x_true**3
    y = J0 @ psi_true + noise * rng.standard_normal(d).astype(np.float32)
    A = (rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32)
    x_feas = np.clip(x_true, -bound, bound)
    b = A @ x_feas

    theta = {"J": jnp.asarray(J0, dtype), "y": jnp.asarray(y, dtype)}
    al = jnp.asarray(alpha, dtype)

    def residuals(x, th):
        return th["J"] @ (x + al * x**3) - th["y"]

    def jac_res(x, th):
        return th["J"] * (1.0 + 3.0 * al * x**2)[None, :]

    bp = BatchedProblem(
        residuals=residuals,
        jac_res=jac_res,
        A=jnp.asarray(A, dtype),
        b=jnp.asarray(b, dtype),
        xl=jnp.full((n,), -bound, dtype),
        xu=jnp.full((n,), bound, dtype),
    )
    # Cold start: the min-norm feasible point of Ax=b (far from x_true).
    x0 = A.T @ np.linalg.solve(A @ A.T, b)
    x0 = jnp.asarray(np.clip(x0, -bound, bound), dtype)
    return bp, theta, x0
