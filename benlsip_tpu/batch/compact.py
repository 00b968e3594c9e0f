"""Converged-instance compaction for the bulk lockstep loop (SURVEY §7.3-3).

The batched bulk solve (`batch/vmap_solve.py`) runs each chunk's vmapped
`lax.while_loop` to its SLOWEST instance: measured on the config-2/5
families, outer-iteration need is p50 = 2 / p99 = 3 / max = 4 and
inner-iteration need p50 = 6 / max = 29, while every 512-wide chunk pays
its tail instance's full schedule in lockstep (VERDICT r4 weak #1).

This module splits the solve at a fixed outer-iteration horizon:

  stage A  — every chunk runs AT MOST `stage_outer` outer iterations
             (the carry's per-lane `outer` counter makes the cap one
             extra predicate term) and finalizes (X, Y, info) in the
             same dispatch — valid for the lanes that finished;
  compact  — survivor lanes (the p90+ tail, typically a few %) are
             gathered host-side into power-of-two buckets;
  stage B  — only the survivor buckets run the remaining schedule to
             their own convergence (one dispatch per bucket, finalize
             fused), and their results scatter back.

Because a vmapped `while_loop` freezes finished lanes with per-lane
selects, splitting the loop at any horizon is trajectory-transparent: the
compacted solve returns bit-identical results to the plain one (pinned by
tests/test_compact.py).  The win is wall-clock only: where the bulk
program is bound by issuing operations, not by arithmetic, a loop
iteration costs about the same wall at 512 lanes as at 64 — wide chunks
stopping at the horizon save (tail - horizon) iterations EACH, while the
tail is paid once in a narrow bucket instead of once per chunk.
Finalize is fused into both stages so compaction adds only the bucket
dispatches (~1) to the chunk count, not a second per-chunk pass (whose
dispatch floor would otherwise eat the win at sweep scale).

The reference has no analog (strictly one instance at a time); this is
batch scheduling for the batched regime the rebuild adds.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.constraints import Polyhedron
from ..solver.options import SolverOptions
from ..solver.outer import (
    OuterCarry,
    SolveInfo,
    carry_info,
    default_atol,
    outer_body,
    outer_done,
    outer_init,
)
from ..solver.subproblem import linear_gram_cache
from .vmap_solve import (_POLY_BASE_RANK, BatchedProblem, map_poly_fields,
                         poly_batch_axes)

Array = jax.Array


def _finalize(fns, carry: OuterCarry, opts):
    """(x, y_final, SolveInfo) from a carry — the same critical-exit
    multiplier correction and objective as solve_fixed_point."""
    y_final = jnp.where(carry.critical, carry.y + carry.mu * carry.cx, carry.y)
    rx = fns.residuals(carry.x)
    from ..ops.al import _psum

    obj = _psum(0.5 * jnp.vdot(rx, rx), opts.spmd_axis)
    return carry.x, y_final, carry_info(carry, opts, objective=obj)


def _stage_one(fns, poly, x0, opts, atol, stage_outer: int):
    """One instance: run at most `stage_outer` outer iterations, finalize.
    Returns (carry, x, y, info) — x/y/info valid iff the lane finished."""
    with jax.default_matmul_precision(opts.matmul_precision):
        c0 = outer_init(fns, poly, x0, opts)
        gram_cache = linear_gram_cache(fns, c0.x, opts)
        carry = lax.while_loop(
            lambda c: ~(outer_done(c, opts) | (c.outer > stage_outer)),
            lambda c: outer_body(fns, poly, opts, atol, c, gram_cache),
            c0,
        )
        return (carry,) + _finalize(fns, carry, opts)


def _continue_one(fns, poly, carry: OuterCarry, opts, atol):
    """One instance: resume from its carry to convergence, finalize."""
    with jax.default_matmul_precision(opts.matmul_precision):
        gram_cache = linear_gram_cache(fns, carry.x, opts)
        out = lax.while_loop(
            lambda c: ~outer_done(c, opts),
            lambda c: outer_body(fns, poly, opts, atol, c, gram_cache),
            carry,
        )
        return _finalize(fns, out, opts)


@functools.lru_cache(maxsize=128)
def _stage_runner(fns_key, opts: SolverOptions, poly_axes_key, stage_outer, atol):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, x0_i, poly_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        return _stage_one(fns, poly_i, x0_i, opts, atol, stage_outer)

    def run(theta, X0, poly):
        carry, X, Y, info = jax.vmap(
            one, in_axes=(0, 0, Polyhedron(*poly_axes_key))
        )(theta, X0, poly)
        # One in-program done predicate: the host pulls a single bool
        # array instead of three carry fields (each D2H pays the link's
        # latency).
        done = jax.vmap(lambda c: outer_done(c, opts))(carry)
        return carry, X, Y, info, done

    return jax.jit(run)


@functools.lru_cache(maxsize=128)
def _continue_runner(fns_key, opts: SolverOptions, poly_axes_key, atol):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key

    def one(theta_i, poly_i, carry_i):
        fns = BatchedProblem(
            residuals=residuals, nlconstraints=nlconstraints,
            jac_res=jac_res, jac_nlcons=jac_nlcons,
        ).instance_fns(theta_i)
        return _continue_one(fns, poly_i, carry_i, opts, atol)

    return jax.jit(jax.vmap(one, in_axes=(0, Polyhedron(*poly_axes_key), 0)))


@functools.lru_cache(maxsize=8)
def _gather_fn():
    """One jitted gather for a whole pytree: 1 dispatch instead of one
    eager device op per leaf."""
    return jax.jit(lambda tree, idx: jax.tree.map(lambda a: a[idx], tree))


@functools.lru_cache(maxsize=8)
def _scatter_fn():
    """One jitted scatter-merge for a whole pytree (see _gather_fn)."""
    return jax.jit(
        lambda full, part, idx: jax.tree.map(
            lambda f, p: f.at[idx].set(p), full, part
        )
    )


def _survivor_buckets(idx: np.ndarray, cap: int):
    """Pad survivor indices to a power-of-two bucket (≤ cap), then split
    into bucket-sized slices — the compile-shape discipline of
    batch/polish._gather_uncertified."""
    k = len(idx)
    bucket = 1
    while bucket < k:
        bucket *= 2
    bucket = min(bucket, cap)
    pad = (-k) % bucket
    idx_p = np.concatenate([idx, np.repeat(idx[:1], pad)]) if pad else idx
    return [idx_p[i : i + bucket] for i in range(0, len(idx_p), bucket)]


def solve_batched_compact(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    stage_outer: int = 2,
    survivor_chunk: Optional[int] = None,
) -> Tuple[Array, Array, SolveInfo]:
    """Batched solve with converged-instance compaction at a fixed outer
    horizon.  Drop-in for `solve_batched_chunked` (bit-identical results);
    see the module docstring for the cost model.

    stage_outer: outer-iteration horizon of the wide phase (the family's
    p90-p99 outer count is the right neighborhood — the measured exp-fit
    distribution is p50 = 2 / p99 = 3, so the default horizon 2 retires
    ~96% of lanes in stage A).  survivor_chunk caps the tail buckets
    (default: chunk).
    """
    B = X0.shape[0]
    chunk = min(chunk, B)
    cap = min(survivor_chunk or chunk, chunk)
    n = X0.shape[-1]
    dtype = X0.dtype
    opts = options.resolve_tols(jnp.dtype(dtype))
    atol = default_atol(dtype)
    poly = bp.polyhedron(n, dtype)
    poly_axes = poly_batch_axes(poly)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)

    stage = _stage_runner(fns_key, opts, poly_axes, int(stage_outer), atol)
    cont = _continue_runner(fns_key, opts, poly_axes, atol)

    # Stage A: wide chunks, horizon-capped, finalize fused.  Ragged tails
    # pad to the next power of two like solve_batched_chunked.
    outs = []
    i = 0
    while i < B:
        j = min(i + chunk, B)
        sl = slice(i, j)
        size = j - i
        psize = min(1 << (size - 1).bit_length(), chunk)
        grab = lambda a: a[sl]
        if psize != size:
            grab = lambda a: jnp.concatenate(
                [a[sl], jnp.repeat(a[sl][:1], psize - size, axis=0)], axis=0
            )
        poly_c = map_poly_fields(bp, grab).polyhedron(n, dtype)
        out = stage(jax.tree.map(grab, theta), grab(X0), poly_c)
        if psize != size:
            out = jax.tree.map(lambda a: a[:size], out)
        outs.append(out)
        i = j
    carry, X, Y, info, done_d = jax.tree.map(
        lambda *xs: jnp.concatenate(xs, axis=0), *outs
    )

    # Compact: survivors = lanes the full-schedule predicate still wants
    # (one packed D2H pull of the in-program done mask).
    idx = np.nonzero(~np.asarray(done_d))[0]

    # Stage B: survivor buckets resume to convergence; scatter back.  The
    # gathers/scatters run as ONE jitted call each — per-leaf eager ops
    # cost a dispatch apiece.
    gather, scatter = _gather_fn(), _scatter_fn()
    batched_poly = {
        f: getattr(poly, f)
        for f in Polyhedron._fields
        if getattr(poly, f).ndim > getattr(_POLY_BASE_RANK, f)
    }
    for bidx in _survivor_buckets(idx, cap):
        bidx_j = jnp.asarray(bidx)
        theta_b, carry_b, bpoly_b = gather((theta, carry, batched_poly), bidx_j)
        poly_b = Polyhedron(*[
            bpoly_b.get(f, getattr(poly, f)) for f in Polyhedron._fields
        ])
        Xb, Yb, ib = cont(theta_b, poly_b, carry_b)
        # Duplicate pad indices write identical values.
        X, Y, info = scatter((X, Y, info), (Xb, Yb, ib), bidx_j)
    return X, Y, info
