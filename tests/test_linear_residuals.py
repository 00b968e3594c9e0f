"""Constant-Jacobian fast path (SolverOptions.linear_residuals).

For affine residuals r(x) = Jx - y the subproblem computes the JᵀJ Gram
block once (ops/al.gram_j) and every per-acceptance refresh rebuilds only
mu·CᵀC + the factorization — the 2dn² refresh GEMM is the largest device
cost of a config-4-shaped solve.  These tests pin exact
(bitwise-irrelevant, allclose-tight) parity between the cached and
uncached paths across the operator routes, single and sharded.

No reference anchor: the reference re-evaluates user Jacobians on every
acceptance unconditionally (`/root/reference/src/basic_tralcnlss.jl:361-362`)
— this is a capability it lacks.
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benlsip_tpu.batch.vmap_solve import solve_batched
from benlsip_tpu.dist.mesh import make_mesh
from benlsip_tpu.dist.sharded import solve_large_blocked_family, solve_large_blocked_shardmap
from benlsip_tpu.problems.generators import dense_quadratic_family
from benlsip_tpu.solver.options import SolverOptions


@pytest.mark.parametrize("fact,dtype", [
    ("normal", jnp.float64),
    ("cholqr2", jnp.float32),
])
def test_linear_flag_parity_batched(fact, dtype):
    """Cached-Gram solve matches the uncached one on a linear family."""
    bp, theta, X0 = dense_quadratic_family(4, n=96, d=384, m=3, seed=5, dtype=dtype)
    tol = 1e-3 if dtype == jnp.float32 else None
    sols = {}
    for lin in (False, True):
        opts = SolverOptions(
            max_outer_iter=10, max_inner_iter=60, gram_hessian="on",
            gn_factorization=fact, linear_residuals=lin,
            crit_tol=tol, feas_tol=tol,
        )
        X, Y, info = solve_batched(bp, theta, X0, opts)
        assert bool(jnp.all(info.converged)), (fact, lin)
        sols[lin] = np.asarray(X)
    # The cached JᵀJ changes the in-loop summation order, so the iterate
    # PATH differs at roundoff and the two certified solutions agree to
    # solution grade (the convergence tolerance), not bitwise — measured
    # max diff 4.7e-9 at f64 KKT tol 1.5e-8.
    tol = 2e-3 if dtype == jnp.float32 else 1e-6
    np.testing.assert_allclose(sols[True], sols[False], rtol=tol, atol=tol)


def _blocked_fixture(seed, n=64, d=256, m=3, dtype=jnp.float32):
    """Linear-LSQ instance with J in theta (the blocked runners row-shard
    theta leaves over 'block'; a closed-over J cannot be sharded)."""
    from benlsip_tpu.batch.vmap_solve import BatchedProblem

    rng = np.random.default_rng(seed)
    J = jnp.asarray((rng.standard_normal((d, n)) / np.sqrt(d)), dtype)
    A = jnp.asarray(rng.standard_normal((m, n)) / np.sqrt(n), dtype)
    x_true = rng.standard_normal(n)
    y = J @ jnp.asarray(x_true, dtype) + jnp.asarray(
        0.01 * rng.standard_normal(d), dtype)
    bp = BatchedProblem(
        residuals=lambda x, th: th["J"] @ x - th["y"],
        jac_res=lambda x, th: th["J"],
        A=A, b=A @ jnp.asarray(x_true, dtype),
        xl=jnp.full((n,), -3.0, dtype), xu=jnp.full((n,), 3.0, dtype),
    )
    return bp, {"J": J, "y": y}, jnp.zeros((n,), dtype)


@pytest.mark.parametrize("mode", ["pjit", "shardmap"])
def test_linear_flag_parity_blocked(mode):
    """Blocked-Jacobian (config-4 path) parity with the cache, 8-dev mesh."""
    bp, theta_i, x0 = _blocked_fixture(6)
    mesh = make_mesh(batch=1, block=8)
    sols = {}
    for lin in (False, True):
        opts = SolverOptions(
            max_outer_iter=5, max_inner_iter=25, gram_hessian="on",
            linear_residuals=lin, crit_tol=1e-4, feas_tol=1e-4,
        )
        runner = solve_large_blocked_family if mode == "pjit" else solve_large_blocked_shardmap
        x, y, info = runner(bp, theta_i, x0, opts, mesh)
        assert bool(info.converged), (mode, lin)
        sols[lin] = np.asarray(x)
    np.testing.assert_allclose(sols[True], sols[False], rtol=2e-3, atol=2e-3)


def test_linear_flag_sharded_gram_layout():
    """Row-sharded Gram layout with the cache (gram_j_rows path)."""
    bp, theta_i, x0 = _blocked_fixture(7)
    mesh = make_mesh(batch=1, block=8)
    sols = {}
    for lin in (False, True):
        opts = SolverOptions(
            max_outer_iter=5, max_inner_iter=25, gram_hessian="on",
            gn_factorization="normal", gram_layout="sharded",
            linear_residuals=lin, crit_tol=1e-4, feas_tol=1e-4,
        )
        x, y, info = solve_large_blocked_shardmap(bp, theta_i, x0, opts, mesh)
        assert bool(info.converged), lin
        sols[lin] = np.asarray(x)
    np.testing.assert_allclose(sols[True], sols[False], rtol=2e-3, atol=2e-3)
