"""Sharded execution paths: data-parallel batched solves and the
blocked-Jacobian mode for one large instance.

DP (configs 2/5): `solve_batched_sharded` is the vmapped solver with its
batch axis laid out over the mesh — per-instance independence means XLA
partitions it with zero cross-chip traffic.

TP (config 4): `blocked_jacobian_fns` wraps a problem's callables so every
Jacobian the solver materializes is sharding-constrained to row blocks over
the 'block' axis.  The AL evaluation g = Jᵀr and the matrix-free products
Jᵀ(Jv) inside CG then partition as [row-sharded GEMV → psum] — the
ring/psum-accumulation pattern SURVEY.md §5 maps onto this domain — with
the collectives inserted by XLA's SPMD partitioner, not hand-written.
"""
from __future__ import annotations

import functools
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch.vmap_solve import (
    BatchedProblem,
    _batched_runner,
    poly_batch_axes,
    solve_batched,
)
from ..harness.steps import dispatch
from ..ops.constraints import Polyhedron
from ..solver.api import NLSFunctions, Problem
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, solve_fixed_point
from .mesh import batch_sharding, shard_batch

Array = jax.Array


def solve_batched_sharded(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions,
    mesh: Mesh,
) -> Tuple[Array, Array, SolveInfo]:
    """Data-parallel batched solve: batch axis sharded over mesh['batch'].

    The batch size must be divisible by the batch-axis size.  Inputs are
    placed sharded so the compiled computation runs SPMD without resharding.
    """
    theta = shard_batch(theta, mesh)
    X0 = jax.device_put(X0, batch_sharding(mesh, X0.ndim))
    return solve_batched(bp, theta, X0, options)


def solve_batched_shardmap(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions,
    mesh: Mesh,
) -> Tuple[Array, Array, SolveInfo]:
    """Data-parallel batched solve with PER-SHARD loop exit.

    `solve_batched_sharded` compiles ONE global program: the batched
    `lax.while_loop`'s predicate is an any-reduce over the whole batch, so
    under SPMD partitioning XLA inserts a scalar pred all-reduce across
    the ENTIRE mesh every solver iteration — over DCN on a multi-host
    batch axis, that cross-host latency sits on every iteration of every
    chip, and every shard spins until the globally slowest instance
    converges.

    Here the vmapped solve runs inside `shard_map`: each device traces its
    own while_loop over its local chunk, the predicate reduce is local,
    and a shard whose instances have all converged EXITS — no cross-mesh
    scalar on the per-iteration critical path, no waiting on other shards'
    stragglers.  Per-instance results are identical (instances are
    independent); tests/test_shardmap_dp.py pins parity and zero
    collectives in the compiled HLO.
    """
    B = X0.shape[0]
    n = X0.shape[-1]
    nshards = mesh.shape["batch"]
    if B % nshards:
        raise ValueError(f"batch {B} not divisible by mesh batch axis {nshards}")
    poly = bp.polyhedron(n, X0.dtype)
    poly_axes = poly_batch_axes(poly)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    # The local body is the plain (unjitted) vmapped runner over the shard's
    # chunk; shard_map replicates it per device with purely local shapes.
    local = _batched_runner(fns_key, options, poly_axes, jit=False)

    batch_spec = P("batch")

    def spec_for(a, axis):
        if axis == 0:
            return NamedSharding(mesh, P("batch", *([None] * (a.ndim - 1))))
        return NamedSharding(mesh, P())

    theta_specs = jax.tree.map(lambda a: spec_for(a, 0), theta)
    poly_specs = Polyhedron(
        *(spec_for(getattr(poly, f), ax) for f, ax in zip(Polyhedron._fields, poly_axes))
    )
    x_spec = NamedSharding(mesh, P("batch", None))
    out_specs = jax.tree.map(lambda _: batch_spec, jax.eval_shape(local, theta, X0, poly))

    run = jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(
                jax.tree.map(lambda _: batch_spec, theta),
                P("batch", None),
                Polyhedron(*(batch_spec if ax == 0 else P() for ax in poly_axes)),
            ),
            out_specs=out_specs,
            # The solver's while_loop carries mix shard-constant init values
            # (zeros, tolerances) with shard-varying updates; the static
            # varying-axes analysis rejects that even though the program is
            # purely local.  Disable the check — there are no collectives
            # for it to validate (pinned by tests/test_shardmap_dp.py).
            check_vma=False,
        )
    )
    theta = jax.tree.map(lambda a, s: jax.device_put(a, s), theta, theta_specs)
    X0 = jax.device_put(X0, x_spec)
    poly = Polyhedron(*(
        jax.device_put(getattr(poly, f), s)
        for f, s in zip(Polyhedron._fields, poly_specs)
    ))
    return run(theta, X0, poly)


def blocked_jacobian_fns(fns: NLSFunctions, mesh: Mesh) -> NLSFunctions:
    """Constrain every Jacobian evaluation to row-block sharding.

    The residual dimension d (and constraint dimension p) shard over
    'block'; variables stay replicated.  All downstream contractions
    (Jᵀr, Jᵀ(Jv), ‖Jv‖²) become partial products + psum over ICI.
    """
    j_spec = NamedSharding(mesh, P("block", None))

    def constrain(jac):
        def wrapped(x):
            return jax.lax.with_sharding_constraint(jac(x), j_spec)

        return wrapped

    r_spec = NamedSharding(mesh, P("block"))

    def constrain_vec(fn):
        def wrapped(x):
            return jax.lax.with_sharding_constraint(fn(x), r_spec)

        return wrapped

    return NLSFunctions(
        residuals=constrain_vec(fns.residuals),
        nlconstraints=fns.nlconstraints,
        jac_res=constrain(fns.jac_res),
        jac_nlcons=fns.jac_nlcons,
    )


def _resolve_blocked_options(options: SolverOptions) -> SolverOptions:
    """Blocked mode resolves gn_factorization="auto" to "normal".

    XLA has no distributed Householder QR: with J row-sharded over
    'block', the "qr" route would all-gather the full (d, n) Jacobian
    every operator refresh (measured: 16.8 MB/iter at n=2048/d=8192/
    block=2 vs ~4 KB/iter for the Gram path, whose JᵀJ partial products
    psum only (n,n) — and XLA reuses the local GEMM).  "cholqr2" IS
    distributable (one psummed Gram pass, J stays local; the implicit
    refinement is collective-free, ops/qr.cholqr2i_r) and is the route
    to force when κ-grade accuracy matters in the blocked f32 bulk; it is
    not the auto default here because its refresh costs more than the
    one Gram GEMM (three GEMM-class passes) and the blocked pipeline
    already defends conditioning with matmul_precision="highest" plus the
    f64 certify phases — the config-4 wall is refresh-heavy, so auto
    keeps the cheapest refresh (chosen on the earlier accelerator; not
    yet measured on the H100, ROADMAP Speed item 6).
    """
    import dataclasses

    if options.gn_factorization == "auto":
        return dataclasses.replace(options, gn_factorization="normal")
    return options


def solve_large_blocked(
    problem: Problem,
    x0: Array,
    options: SolverOptions,
    mesh: Mesh,
) -> Tuple[Array, Array, SolveInfo]:
    """Solve one large instance with the residual/Jacobian row-sharded
    (BASELINE config 4).  d should be divisible by mesh['block'].

    Note: arrays closed over by the problem callables become program
    literals; for data at HBM scale use `solve_large_blocked_family`, which
    threads the data through as traced (sharded) arguments.
    """
    x0 = jnp.asarray(x0)
    options = _resolve_blocked_options(options)
    fns, poly = problem.build(x0.shape[0], x0.dtype)
    fns = blocked_jacobian_fns(fns, mesh)

    run = jax.jit(lambda p, x: solve_fixed_point(fns, p, x, options))
    return run(poly, x0)


def solve_large_blocked_family(
    bp,
    theta,
    x0: Array,
    options: SolverOptions,
    mesh: Mesh,
) -> Tuple[Array, Array, SolveInfo]:
    """Config-4 path with instance data as traced arguments.

    `bp` is a BatchedProblem-style family (callables take (x, theta));
    theta holds the large per-instance data (e.g. the Jacobian blocks and
    targets) and is placed row-sharded over 'block' before the call, so the
    compile payload contains no data literals (a closure-captured n≈10k
    Jacobian overflows the remote-compile transport) and the data lives
    sharded in HBM.
    """
    x0 = jnp.asarray(x0)
    options = _resolve_blocked_options(options)
    n = x0.shape[0]
    poly = bp.polyhedron(n, x0.dtype)
    # Row-shard every theta leaf whose leading axis matches the residual
    # dimension structure (leaves with a d-divisible leading axis).
    block = mesh.shape["block"]

    def place(a):
        if a.ndim >= 1 and a.shape[0] % block == 0:
            return jax.device_put(a, NamedSharding(mesh, P("block", *([None] * (a.ndim - 1)))))
        return jax.device_put(a, NamedSharding(mesh, P()))

    theta = jax.tree.map(place, theta)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    return dispatch("blocked_solve", _blocked_runner(fns_key, options, mesh), poly, x0, theta)


def solve_large_blocked_shardmap(
    bp,
    theta,
    x0: Array,
    options: SolverOptions,
    mesh: Mesh,
) -> Tuple[Array, Array, SolveInfo]:
    """Config-4 blocked solve with EXPLICIT collectives under shard_map.

    The pjit path (`solve_large_blocked_family`) lets XLA's partitioner
    insert the collectives from sharding constraints; this path is the
    hand-scheduled twin: the whole solver runs inside `shard_map` with the
    residual dimension sharded over 'block', each device sees only its
    LOCAL Jacobian/residual rows, and every d-contraction — rᵀr, Jᵀr, the
    Gram build JᵀJ, ‖Jv‖² — carries one explicit `psum` through
    `dist/collectives.py` (SolverOptions.spmd_axis plumbing in ops/al.py).
    Everything else (constraint algebra, projections, active sets, the
    whole TR state machine) is replicated arithmetic on n-vectors.

    Use this path to control the communication schedule directly (e.g. to
    overlap or batch reductions); numerically it is the same algorithm —
    tests pin parity with the pjit path on the virtual mesh.

    Communication/memory layout knobs (SolverOptions):

    * ``gram_layout="sharded"`` keeps the materialized Gram operator
      row-sharded across 'block' (reduce-scatter refresh at half the psum
      traffic, n²/D memory per device, one tiled n-vector all_gather per
      matvec) — required once the replicated (n, n) operator outgrows HBM
      (n=40k ⇒ 6.4 GB f32 per device replicated).  Requires n divisible
      by the 'block' axis size.
    * ``reduce_schedule="ring"`` swaps the reduce-scatter for the
      hand-scheduled D−1-hop ppermute ring (dist/collectives.py), the
      schedule to reach for when overlapping the refresh GEMM with the
      hops matters (pod-scale ICI).
    """
    import dataclasses

    x0 = jnp.asarray(x0)
    block = mesh.shape["block"]
    options = dataclasses.replace(
        _resolve_blocked_options(options),
        spmd_axis="block",
        # The matrix-free Hv/vhv forms also psum correctly via spmd_axis,
        # but the Gram operator pays one n² reduce per refresh instead of
        # one n-vector psum per CG iteration — the right trade at blocked
        # scale, where CG runs many iterations per refresh.  Only the "auto" default is resolved:
        # an explicit "off" (e.g. n so large even the n²/D sharded rows
        # don't fit HBM) stays matrix-free.
        gram_hessian="on" if options.gram_hessian == "auto" else options.gram_hessian,
    )
    n = x0.shape[0]
    poly = bp.polyhedron(n, x0.dtype)
    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    runner = _blocked_shardmap_runner(fns_key, options, mesh)

    def place(a):
        if a.ndim >= 1 and a.shape[0] % block == 0:
            return jax.device_put(a, NamedSharding(mesh, P("block", *([None] * (a.ndim - 1)))))
        return jax.device_put(a, NamedSharding(mesh, P()))

    theta = jax.tree.map(place, theta)
    return runner(poly, x0, theta)


@functools.lru_cache(maxsize=32)
def _blocked_shardmap_runner(fns_key, options: SolverOptions, mesh: Mesh):
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key
    bp = BatchedProblem(
        residuals=residuals, nlconstraints=nlconstraints,
        jac_res=jac_res, jac_nlcons=jac_nlcons,
    )
    block = mesh.shape["block"]

    def local(poly_, x0_, theta_):
        fns = bp.instance_fns(theta_)
        return solve_fixed_point(fns, poly_, x0_, options)

    def theta_spec(a):
        # Row-sharded iff the leading axis splits over 'block' (mirrors
        # `place` in the caller); replicated otherwise.
        return P("block") if a.ndim >= 1 and a.shape[0] % block == 0 else P()

    def run(poly_, x0_, theta_):
        specs = jax.tree.map(theta_spec, theta_)
        fn = jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), specs),
            # Replicated outputs: every device computes identical psum-fed
            # values, so the results carry no 'block' component.
            out_specs=P(),
            check_vma=False,
        )
        return fn(poly_, x0_, theta_)

    return jax.jit(run)


@functools.lru_cache(maxsize=32)
def _blocked_runner(fns_key, options: SolverOptions, mesh: Mesh):
    """Cached jitted runner for the blocked-family solve.

    Re-jitting a fresh closure per call retraces the whole solver program
    every solve — seconds of host-side tracing per config-4 call, more
    than the device wall (the round-1 `jax.jit(run)(...)` pattern).  Cache key = (family callables, options, mesh), mirroring
    batch.vmap_solve._batched_runner.
    """
    residuals, nlconstraints, jac_res, jac_nlcons = fns_key
    bp = BatchedProblem(
        residuals=residuals, nlconstraints=nlconstraints,
        jac_res=jac_res, jac_nlcons=jac_nlcons,
    )

    def run(poly_, x0_, theta_):
        fns = blocked_jacobian_fns(bp.instance_fns(theta_), mesh)
        return solve_fixed_point(fns, poly_, x0_, options)

    return jax.jit(run)
