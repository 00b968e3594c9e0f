"""scipy.optimize-compatible entry points.

`least_squares` mirrors the call surface of
`scipy.optimize.least_squares` (fun/x0/jac/bounds/tolerances) so
bound-constrained NLS code written against scipy ports by changing one
import — and gains everything underneath: jit compilation, accelerator
execution, equality constraints (`A_eq`/`b_eq` and `nl_eq` extensions),
and `jax.vmap` batchability of the returned solver core.

The reference package has no such compatibility surface (its only entry
is the positional `tralcnllss`, `/root/reference/src/basic_tralcnlss.jl:167`);
this is an adoption affordance, not a parity item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from .solver.api import Problem, solve
from .solver.options import SolverOptions
from .solver.outer import SolveInfo

Array = jax.Array


@dataclasses.dataclass
class OptimizeResult:
    """scipy-shaped result object (attribute-compatible subset).

    `status` follows scipy's sign convention (positive = converged,
    0 = iteration limit, negative = failure); the framework's native
    codes live on `info.status`.  `optimality` is the exact
    projected-gradient KKT measure pi(x) (the reference tests' oracle),
    stricter than scipy's first-order optimality for bound-only problems.
    """

    x: Array
    cost: float
    fun: Array
    jac: Array
    grad: Array
    optimality: float
    active_mask: Array
    nfev: int            # residual evaluations (one per inner TR candidate)
    njev: Optional[int]  # None: jacobian evals happen only on accepted steps
    nit: int
    status: int
    success: bool
    message: str
    info: SolveInfo

    def __repr__(self):  # compact, scipy-style
        return (
            f"OptimizeResult(success={self.success}, cost={self.cost:.6g}, "
            f"optimality={self.optimality:.3g}, nit={self.nit})"
        )


# OptimizeResult.status follows scipy's sign convention (status > 0 means
# convergence, 0 means the iteration limit, negative means failure) so
# ported code branching on `res.status > 0` keeps working.  The framework's
# own codes (solver/status.py: 1 converged, 2 max-outer, 3 stalled) remain
# available unchanged on `res.info.status`.
_STATUS_TO_SCIPY = {1: 1, 2: 0, 3: -2}
_MESSAGES = {
    1: "Convergence: KKT criticality and feasibility tolerances satisfied.",
    0: "Maximum number of outer iterations reached.",
    -2: "Stalled: criticality at its numerical floor above gtol.",
}


def least_squares(
    fun: Callable[..., Array],
    x0: Array,
    jac: Optional[Callable[..., Array]] = None,
    bounds: Tuple[Any, Any] | Sequence[Any] = (-jnp.inf, jnp.inf),
    args: Tuple = (),
    gtol: Optional[float] = None,
    max_nfev: Optional[int] = None,
    A_eq: Optional[Array] = None,
    b_eq: Optional[Array] = None,
    nl_eq: Optional[Callable[[Array], Array]] = None,
    options: Optional[SolverOptions] = None,
    jit: bool = True,
) -> OptimizeResult:
    """Solve min ½‖fun(x)‖² with bounds (+ optional equality constraints).

    scipy-compatible subset: `fun(x, *args)` returns the residual vector;
    `jac` its (d, n) Jacobian (autodiff when None — scipy's '2-point'
    finite differences have no reason to exist under jax); `bounds` is
    the scipy 2-tuple `(lb, ub)` of scalars or arrays; `gtol` maps to the
    KKT criticality tolerance; `max_nfev` caps TR iterations per AL
    subproblem AND the number of subproblems (an exact total-evaluation
    budget does not map onto the two-level AL method — the realized
    count is returned as `nfev`).

    Beyond scipy: `A_eq`/`b_eq` (linear equalities) and `nl_eq`
    (nonlinear equalities) pass straight through to the constrained
    solver — scipy's least_squares cannot express these at all.  For
    inequality constraints compose with
    `benlsip_tpu.with_inequalities` first.
    """
    x0 = jnp.atleast_1d(jnp.asarray(x0))
    if not jnp.issubdtype(x0.dtype, jnp.inexact):
        # scipy casts integer x0 to float; without this an int x0 crashes
        # broadcasting the infinite default bounds (and finfo downstream).
        x0 = x0.astype(jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    n = x0.shape[0]
    dtype = x0.dtype

    if hasattr(bounds, "lb") and hasattr(bounds, "ub"):
        # scipy.optimize.Bounds instance (scipy.least_squares accepts both
        # forms; without this unpacking, bounds[0] raises an opaque
        # TypeError).  `keep_feasible` has no meaning here: every iterate
        # is feasible by construction (projected steps).
        lb, ub = bounds.lb, bounds.ub
    else:
        lb, ub = bounds[0], bounds[1]
    xl = jnp.broadcast_to(jnp.asarray(lb, dtype), (n,))
    xu = jnp.broadcast_to(jnp.asarray(ub, dtype), (n,))

    residuals = (lambda x: fun(x, *args)) if args else fun
    jac_res = (lambda x: jac(x, *args)) if (jac and args) else jac

    opts = options or SolverOptions()
    updates = {}
    if gtol is not None:
        updates["crit_tol"] = gtol
    if max_nfev is not None:
        # Imperfect mapping onto a two-level AL method: this caps TR
        # candidates PER subproblem and the number of subproblems, so
        # total evaluations are bounded by the product, not by max_nfev
        # itself (scipy's single-loop TRF has no outer level).  The
        # actual count comes back as res.nfev.
        updates["max_inner_iter"] = int(max_nfev)
        updates["max_outer_iter"] = min(opts.max_outer_iter, int(max_nfev))
    if updates:
        opts = dataclasses.replace(opts, **updates)

    problem = Problem(
        residuals=residuals,
        jac_res=jac_res,
        nlconstraints=nl_eq,
        A=A_eq,
        b=b_eq,
        xl=xl,
        xu=xu,
    )
    x, y, info = solve(problem, x0, opts, jit=jit)

    fns, poly = problem.build(n, dtype)
    rx = fns.residuals(x)
    J = fns.jac_res(x)
    grad = J.T @ rx
    tol = jnp.finfo(dtype).eps ** 0.5
    active = jnp.where(
        x - poly.xl <= tol * (1 + jnp.abs(x)), -1,
        jnp.where(poly.xu - x <= tol * (1 + jnp.abs(x)), 1, 0),
    )
    status = _STATUS_TO_SCIPY.get(int(info.status), -int(info.status))
    return OptimizeResult(
        x=x,
        cost=float(0.5 * jnp.vdot(rx, rx).real),
        fun=rx,
        jac=J,
        grad=grad,
        optimality=float(info.pix),
        active_mask=active,
        nfev=int(info.inner_iters) + 1,
        njev=None,
        nit=int(info.inner_iters),
        status=status,
        success=bool(info.converged),
        message=_MESSAGES.get(status, f"status {status}"),
        info=info,
    )
