"""Inequality-constrained fitting: the slack transform + the scipy surface.

Fit y ≈ a·exp(−b·t) + c with a shape constraint the reference (and
scipy.optimize.least_squares) cannot express: the fitted curve must stay
nonnegative at the sample points, enforced as g_i(x) = a·exp(−b·t_i) + c ≥ 0
through `with_inequalities`.  Also shows the scipy-compatible
`least_squares` one-liner for the unconstrained-but-bounded version.

Run: python examples/inequality_fit.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # repo-root run

import numpy as np
import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)  # reference-parity tolerances
# Small f64 parity solves run on the host — same choice as
# examples/basic_solve.py.
jax.config.update("jax_platforms", "cpu")

from benlsip_tpu import Problem, SolverOptions, least_squares, solve, with_inequalities

rng = np.random.default_rng(0)
t = jnp.linspace(0.0, 3.0, 24)
true = (1.4, 1.1, -0.12)  # negative offset: the unconstrained fit dips below 0
y = true[0] * jnp.exp(-true[1] * t) + true[2] + 0.01 * jnp.asarray(rng.standard_normal(24))


def model(x):
    return x[0] * jnp.exp(-x[1] * t) + x[2]


# 1) scipy-style bounded fit (no shape constraint).
res = least_squares(lambda x: model(x) - y, jnp.asarray([1.0, 1.0, 0.0]),
                    bounds=([0.0, 0.1, -1.0], [10.0, 10.0, 1.0]))
print(f"bounded fit:     x = {np.asarray(res.x)}  cost = {res.cost:.3e}  "
      f"min curve = {float(jnp.min(model(res.x))):+.4f}")

# 2) Same fit with the nonnegativity shape constraint via slacks.
prob = Problem(residuals=lambda x: model(x) - y,
               xl=jnp.asarray([0.0, 0.1, -1.0]), xu=jnp.asarray([10.0, 10.0, 1.0]))
lift = with_inequalities(prob, jnp.asarray([1.0, 1.0, 0.0]), nl_ineq=model)
z, lam, info = solve(lift.problem, lift.z0, SolverOptions(max_outer_iter=60, max_inner_iter=200))
x = lift.unlift(z)
s, _ = lift.slacks(z)
print(f"shape-constrained: x = {np.asarray(x)}  converged = {bool(info.converged)}  "
      f"min curve = {float(jnp.min(model(x))):+.4f}  active points = {int(jnp.sum(s < 1e-7))}")
assert bool(info.converged) and float(jnp.min(model(x))) >= -1e-8
