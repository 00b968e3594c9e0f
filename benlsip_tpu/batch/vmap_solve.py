"""Batched solving of independent NLS instances via vmap.

The reference is strictly single-instance/single-threaded; batch
parallelism over thousands of independent instances is the headline
capability (SURVEY.md §2.5, BASELINE configs 2/5).  A batch is a
family of instances sharing shapes (n, d, p, m) but with per-instance data
theta (and optionally per-instance constraint sets); `vmap` turns the whole
TRALCNLLS state machine into batched linear algebra, and the
batch axis shards over a device mesh (`benlsip_tpu.dist`).

Divergent per-instance control flow (outer/TR/CG trip counts) runs in
lockstep under vmapped `lax.while_loop`s: finished instances idle via
masked selects until the slowest instance in the batch converges —
SURVEY.md §7.3 hard-part 3.  Bucketing by difficulty (`batch/buckets.py`)
mitigates the tail for large sweeps.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from ..harness.steps import dispatch
from ..ops.constraints import Polyhedron
from ..solver.api import NLSFunctions
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, solve_fixed_point

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class BatchedProblem:
    """A family of NLS instances parameterized by per-instance data theta.

    residuals/nlconstraints/jacobians take (x, theta); theta is a pytree
    whose leaves carry a leading batch axis.  Constraint data may be shared
    across the batch (unbatched arrays) or per-instance (leading batch axis)
    — declared via `poly_batched`.
    """

    residuals: Callable[[Array, Any], Array]
    nlconstraints: Optional[Callable[[Array, Any], Array]] = None
    jac_res: Optional[Callable[[Array, Any], Array]] = None
    jac_nlcons: Optional[Callable[[Array, Any], Array]] = None
    A: Optional[Array] = None
    b: Optional[Array] = None
    xl: Optional[Array] = None
    xu: Optional[Array] = None
    poly_batched: bool = False  # True if A/b/xl/xu carry a leading batch axis

    def instance_fns(self, theta) -> NLSFunctions:
        """Bind one instance's theta into single-instance callables."""
        res = lambda x: self.residuals(x, theta)
        nlc = (
            (lambda x: self.nlconstraints(x, theta))
            if self.nlconstraints is not None
            else (lambda x: jnp.zeros((0,), x.dtype))
        )
        jr = (lambda x: self.jac_res(x, theta)) if self.jac_res is not None else jax.jacfwd(res)
        jc = (
            (lambda x: self.jac_nlcons(x, theta))
            if self.jac_nlcons is not None
            else jax.jacfwd(nlc)
        )
        return NLSFunctions(residuals=res, nlconstraints=nlc, jac_res=jr, jac_nlcons=jc)

    def polyhedron(self, n: int, dtype) -> Polyhedron:
        A = self.A if self.A is not None else jnp.zeros((0, n), dtype)
        m = A.shape[-2]
        b = self.b if self.b is not None else jnp.zeros(A.shape[:-2] + (m,), dtype)
        xl = self.xl if self.xl is not None else jnp.full((n,), -jnp.inf, dtype)
        xu = self.xu if self.xu is not None else jnp.full((n,), jnp.inf, dtype)
        return Polyhedron(A=A, b=b, xl=xl, xu=xu)


import functools

# Base rank of each Polyhedron field; an extra leading axis marks it as
# per-instance (batched).
_POLY_BASE_RANK = Polyhedron(A=2, b=1, xl=1, xu=1)


def poly_batch_axes(poly: Polyhedron) -> tuple:
    """vmap in_axes for a Polyhedron with mixed shared/batched fields."""
    return tuple(
        0 if getattr(poly, f).ndim > getattr(_POLY_BASE_RANK, f) else None
        for f in Polyhedron._fields
    )


def map_poly_fields(bp: "BatchedProblem", fn) -> "BatchedProblem":
    """Apply fn to the constraint fields (A/b/xl/xu) that carry a batch
    axis; shared fields pass through.  THE single slicing helper for
    chunked/gathered sub-batches (used by the chunked solve, the
    mixed-precision pipeline, and the compaction driver)."""
    upd = {
        f: fn(getattr(bp, f))
        for f in ("A", "b", "xl", "xu")
        if getattr(bp, f) is not None
        and getattr(bp, f).ndim > getattr(_POLY_BASE_RANK, f)
    }
    return dataclasses.replace(bp, **upd) if upd else bp


@functools.lru_cache(maxsize=128)
def _batched_runner(fns_key, options: SolverOptions, poly_axes_key, jit: bool):
    """Build (and cache) the jitted vmapped solve for one problem family.

    Keyed on the family's callables + options + constraint batch axes so
    repeated solve_batched calls (chunked sweeps, warm benchmarks) reuse one
    traced/compiled program instead of re-tracing a fresh closure per call.
    """
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x0_i, poly_i):
        bp_i = BatchedProblem(
            residuals=residuals,
            nlconstraints=nlconstraints,
            jac_res=jac_res,
            jac_nlcons=jac_nlcons,
        )
        fns = bp_i.instance_fns(theta_i)
        return solve_fixed_point(fns, poly_i, x0_i, options)

    run = jax.vmap(one, in_axes=(0, 0, Polyhedron(*poly_axes_key)))
    return jax.jit(run) if jit else run


def solve_batched(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    jit: bool = True,
) -> Tuple[Array, Array, SolveInfo]:
    """Solve a batch of instances; returns batched (X, Y, SolveInfo).

    theta: pytree with leading batch axis B; X0: (B, n).  All instances run
    to their own convergence (per-instance masked schedules); the vmapped
    while_loops execute until the slowest instance finishes.
    """
    n = X0.shape[-1]
    dtype = X0.dtype
    poly = bp.polyhedron(n, dtype)

    # Per-field batch axes: a field is batched iff it carries an extra axis
    # beyond its base rank — mixed shared/per-instance constraint data is
    # allowed.
    poly_axes = poly_batch_axes(poly)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    run = _batched_runner(fns_key, options, poly_axes, jit)
    if not jit:  # traced inside the caller's program: nothing dispatched here
        return run(theta, X0, poly)
    return dispatch("bulk_chunk", run, theta, X0, poly)


def solve_batched_chunked(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
) -> Tuple[Array, Array, SolveInfo]:
    """Batched solve in fixed-size chunks sharing one compiled program.

    Bounds the lockstep tail (a chunk only waits for its own slowest
    instance) and any per-launch instance limit.  The 512 default cap
    came from the earlier accelerator, where wider programs faulted; it
    is not yet measured on the H100 (ROADMAP Speed item 3).  A ragged final chunk runs as its
    own program at the next power-of-two size (padded by repeating its
    first instance, trimmed after): a 100k-sweep tail of 17 instances then
    costs a 32-lane launch instead of a full chunk-width one, and the
    extra compiled sizes are bounded by log2(chunk) across any sweep.
    """
    B = X0.shape[0]
    chunk = min(chunk, B)
    tail = B % chunk
    n_full = B // chunk

    outs = []
    for i in range(n_full):
        sl = slice(i * chunk, (i + 1) * chunk)
        outs.append(
            solve_batched(
                map_poly_fields(bp, lambda a: a[sl]),
                jax.tree.map(lambda a: a[sl], theta),
                X0[sl],
                options,
            )
        )
    if tail:
        # Next power of two ≥ tail, but never above the caller's chunk cap:
        # `chunk` may be a per-launch instance limit, so a non-power-of-two
        # cap must not be rounded past.
        size = min(1 << (tail - 1).bit_length(), chunk)
        pad = size - tail
        sl = slice(n_full * chunk, B)
        grab = lambda a: a[sl]
        if pad:
            grab = lambda a: jnp.concatenate(
                [a[sl], jnp.repeat(a[sl][:1], pad, axis=0)], axis=0
            )
        tail_out = solve_batched(
            map_poly_fields(bp, grab),
            jax.tree.map(grab, theta),
            grab(X0),
            options,
        )
        outs.append(jax.tree.map(lambda a: a[:tail], tail_out))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)


def solve_sequential(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
) -> Tuple[Array, Array, SolveInfo]:
    """Loop-of-solves reference path (one jitted instance solve, re-run per
    instance).  Exists for batched-vs-loop parity tests and as the
    single-core baseline in the benchmark harness."""
    n = X0.shape[-1]
    poly = bp.polyhedron(n, X0.dtype)

    def one(theta_i, x0_i, poly_i):
        fns = bp.instance_fns(theta_i)
        return solve_fixed_point(fns, poly_i, x0_i, options)

    one_c = jax.jit(one)
    outs = []
    B = X0.shape[0]
    for i in range(B):
        theta_i = jax.tree.map(lambda a: a[i], theta)
        poly_i = Polyhedron(
            *[
                getattr(poly, f)[i]
                if getattr(poly, f).ndim > getattr(_POLY_BASE_RANK, f)
                else getattr(poly, f)
                for f in Polyhedron._fields
            ]
        )
        outs.append(one_c(theta_i, X0[i], poly_i))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *outs)
