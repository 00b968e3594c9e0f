"""Basic usage: solve one constrained NLS problem.

The problem is the reference's own integration fixture (sphere regression:
3 parameters, 4 residuals, a nonlinear sphere constraint, one linear
equality, full box).  Run: python examples/basic_solve.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # repo-root run

import jax
import jax.numpy as jnp

jax.config.update("jax_enable_x64", True)  # reference-parity tolerances
# One small f64 instance gains nothing from a device: it runs on the host,
# as the reference does.  The device path is the batched mixed-precision
# pipeline — see examples/batched_fit.py.
jax.config.update("jax_platforms", "cpu")

from benlsip_tpu import Problem, SolverOptions, solve


def residuals(x):
    return jnp.stack(
        [
            x[0] ** 2 + x[1] ** 2 - 2 * x[0] + jnp.sin(x[0] + x[1]) - 1.5,
            x[0] * x[1] + 0.5 * jnp.cos(2 * x[0]) - 0.8,
            (x[0] - 1.0) ** 2 + (x[1] - 0.5) ** 2 - x[2],
            x[2] ** 2 - x[0] + 0.3 * jnp.sin(x[2]) - 0.2,
        ]
    )


def sphere(x):
    return jnp.stack([x[0] ** 2 + x[1] ** 2 + x[2] ** 2 - 3.0])


problem = Problem(
    residuals=residuals,          # Jacobians default to jax.jacfwd
    nlconstraints=sphere,
    A=jnp.asarray([[1.0, 2.0, -1.0]]),
    b=jnp.asarray([0.5]),
    xl=jnp.asarray([-2.0, -1.5, 0.0]),
    xu=jnp.asarray([2.0, 1.5, 2.0]),
)

x, y, info = solve(problem, jnp.asarray([1.0, 0.5, 1.5]), SolverOptions(verbose=False))
print("x*        =", x)
print("y*        =", y)
print("objective =", float(info.objective))
print("‖c(x*)‖   =", float(info.feas), " criticality =", float(info.pix))
print("converged =", bool(info.converged), f"({int(info.outer_iters)} outer / {int(info.inner_iters)} TR iterations)")
