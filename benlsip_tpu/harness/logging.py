"""Iteration logging with the reference's exact output schema.

Reproduces the three printers of `/root/reference/src/misc.jl` (solver
banner :1-45, per-outer-iteration table :47-68, per-inner-iteration row
:70-80).  The reference hard-wires `verbose = true` and a fixed output
file (`src/basic_tralcnlss.jl:3-4` — SURVEY.md quirk 5); here logging is
off by default, opt-in via `SolverOptions(verbose=True)`, and the sink is a
configurable stream set with `set_log_stream`.

Inside jitted code the solver calls these through `jax.debug.callback`
(host callback); they must therefore accept numpy scalars.
"""
from __future__ import annotations

import io
import sys
from typing import IO, Optional

_STREAM: Optional[IO] = None


def set_log_stream(stream: Optional[IO]) -> None:
    """Set the log sink (None -> stdout).  The reference's fixed
    '../test/benlsip.out' becomes an explicit user choice."""
    global _STREAM
    _STREAM = stream


def _out() -> IO:
    return _STREAM if _STREAM is not None else sys.stdout


def print_tralcnllss_header(
    n: int, d: int, p: int, m: int, n_lower: int, n_upper: int,
    crit_tol: float, feas_tol: float, tau: float,
    eta1: float, eta2: float, gamma1: float, gamma2: float,
) -> None:
    """Solver banner (ref `src/misc.jl:1-45`), same layout."""
    io_ = _out()
    print("\n", file=io_)
    print("*" * 64, file=io_)
    print("*" + " " * 62 + "*", file=io_)
    print("*" + " " * 23 + "benlsip_tpu v-DEV" + " " * 22 + "*", file=io_)
    print("*" + " " * 62 + "*", file=io_)
    print("*" + "Batched TRALCNLLS (BEnlsip.jl capability)".center(62) + "*", file=io_)
    print("*" + " " * 62 + "*", file=io_)
    print("*" * 64, file=io_)
    print("\nProblem dimensions", file=io_)
    print(f"Number of parameters.................: {n:5d}", file=io_)
    print(f"Number of residuals..................: {d:5d}", file=io_)
    print(f"Number of nonlinear constraints......: {p:5d}", file=io_)
    print(f"Number of linear constraints.........: {m:5d}", file=io_)
    print(f"Number of lower bounds...............: {n_lower:5d}", file=io_)
    print(f"Number of upper bounds...............: {n_upper:5d}", file=io_)
    print("\nAlgorithm parameters", file=io_)
    print(f"Optimality tolerance.................................: {crit_tol:.6e}", file=io_)
    print(f"Nonlinear constraints feasibility tolerance..........: {feas_tol:.6e}", file=io_)
    print(f"Increase penalty parameter factor....................: {tau:5f}", file=io_)
    print(f"Step acceptance treshold.............................: {eta1:5f}", file=io_)
    print(f"Great step acceptance treshold.......................: {eta2:5f}", file=io_)
    print(f"Trust region increase factor.........................: {gamma2:5f}", file=io_)
    print(f"Trust region decrease factor.........................: {gamma1:5f}", file=io_)
    print("\n", file=io_)


def emit_outer_iter(k, objective, nl_feas, mu, pix, omega, first: bool = False) -> None:
    """Per-outer-iteration table (ref `src/misc.jl:47-68`), same layout."""
    io_ = _out()
    print("\n" + "=" * 80, file=io_)
    print(f"                          Outer iter {int(k)}", file=io_)
    print("  objective    nl feasibility     μ      criticality   tolerance", file=io_)
    if first:
        print(
            f"{float(objective):.7e}   {float(nl_feas):.6e}  {float(mu):.2e}        -         {float(omega):.2e}",
            file=io_,
        )
    else:
        print(
            f"{float(objective):.7e}   {float(nl_feas):.6e}  {float(mu):.2e}     {float(pix):.2e}     {float(omega):.2e}",
            file=io_,
        )
    print("\n" + "=" * 80, file=io_)
    print("iter     AL value       ||s||        Δ          ρ", file=io_)


def emit_inner_iter(k, al_value, norm_step, radius, rho) -> None:
    """Per-inner-iteration row (ref `src/misc.jl:70-80`), same layout."""
    print(
        f"{int(k):4d}   {float(al_value):.6e}   {float(norm_step):.2e}   {float(radius):.2e}   {float(rho):.2e}",
        file=_out(),
    )
