"""benlsip_tpu — a batched, accelerator-resident framework for constrained
nonlinear least squares.

From-scratch JAX/XLA re-design (not a port) with the capabilities of
the reference Julia package BEnlsip.jl (`/root/reference`): a trust-region
augmented-Lagrangian Gauss-Newton solver (TRALCNLLS) for

    min_x 1/2 ‖r(x)‖²   s.t.  c(x) = 0,  A x = b,  xl ≤ x ≤ xu,

built as jitted masked state machines — vmap-batched over thousands of
independent instances and mesh-sharded for large blocked-Jacobian instances.

Public surface: `tralcnllss` (reference-parity entry), `solve`/`Problem`
(idiomatic entry), `SolverOptions` (the reference's hyperparameter table),
plus the `ops` (constraint algebra), `solver`, `batch`, `dist`,
`problems`, and `harness` subpackages mapped 1:1 onto SURVEY.md §2's
component inventory.
"""

from . import batch, dist, harness, ops, problems, solver
from .ops.al import AlHessian, evaluate_al, first_derivatives, hv, new_point, second_derivatives, vhv
from .ops.constraints import ActiveSet, Polyhedron, is_feasible
from .ops.polyproject import projection_polyhedron
from .ops.project import project_tangent
from .solver.api import NLSFunctions, Problem, solve, tralcnllss
from .solver.options import SolverOptions
from .solver.qp import QPInfo, solve_qp
from .solver.transforms import LiftedProblem, with_inequalities
from .compat import OptimizeResult, least_squares
from .solver.outer import SolveInfo

__version__ = "0.1.0"

__all__ = [
    "AlHessian",
    "ActiveSet",
    "NLSFunctions",
    "Polyhedron",
    "Problem",
    "SolveInfo",
    "SolverOptions",
    "evaluate_al",
    "first_derivatives",
    "hv",
    "is_feasible",
    "new_point",
    "project_tangent",
    "projection_polyhedron",
    "LiftedProblem",
    "OptimizeResult",
    "least_squares",
    "with_inequalities",
    "second_derivatives",
    "solve",
    "solve_qp",
    "QPInfo",
    "tralcnllss",
    "vhv",
]
