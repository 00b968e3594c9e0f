"""Whole-pipeline fusion for small-instance families: ONE dispatch from
f32 bulk to certified f64 results.

The standard mixed-precision pipeline (`batch/refine.solve_mixed_precision`
with certify="device") already keeps every phase on the device, but still
pays one dispatch per bulk chunk plus one for the fused certification,
with the host Python driving the sequence and syncing in between — at
config-2 scale (B=1024, a wall of a fraction of a second) that overhead
is a large part of the wall.

This module stages the ENTIRE pipeline as one jitted program:

    for each chunk of at most `chunk` lanes (static Python loop; the
    512 default bounds each chunk's lockstep tail):
        f32 TRALCNLLS bulk solve (loosened crit_tol, lockstep cap)
    concat -> full-width fused certification (f32 QR factors + f64
    chord + exact-projection certify + bucketed straggler re-polish,
    batch/polish._fused_polish_core)

One H2D of the packed working set, one dispatch, one D2H of results.
The CPU full-refine fallback for uncertified lanes is the same shared
`fallback_full_refine` the standard path uses (stall-restart rescue
included), so accuracy semantics are identical.

Reference note: the reference solves one instance at a time on a single
core (`/root/reference/src/basic_tralcnlss.jl:167`); this whole module is
batch scheduling with no counterpart there.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..harness.devices import local_cpu
from ..harness.steps import dispatch
from ..ops.constraints import Polyhedron
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo, solve_fixed_point
from ..solver.status import SOLVE_CONVERGED, SOLVE_MAX_OUTER
from .polish import _fused_polish_core, fallback_full_refine
from .vmap_solve import _POLY_BASE_RANK, BatchedProblem, poly_batch_axes

Array = jax.Array


@functools.lru_cache(maxsize=64)
def _pipeline_runner(fns_key32, fns_key64, poly_axes_key, bulk_opts: SolverOptions,
                     chunk: int, polish_key):
    """Jitted whole-pipeline program: chunked f32 bulk + fused f64 certify."""
    r32, nl32, jr32, jn32 = fns_key32
    axes = Polyhedron(*poly_axes_key)
    certify = _fused_polish_core(fns_key32, fns_key64, poly_axes_key, *polish_key)

    def bulk_one(theta_i, x0_i, poly_i):
        fns = BatchedProblem(
            residuals=r32, nlconstraints=nl32, jac_res=jr32, jac_nlcons=jn32,
        ).instance_fns(theta_i)
        x, y, info = solve_fixed_point(fns, poly_i, x0_i, bulk_opts)
        return x

    vbulk = jax.vmap(bulk_one, in_axes=(0, 0, axes))

    def run(theta32, X0_32, poly32, theta64, poly64):
        B = X0_32.shape[0]
        outs = []
        for i in range(0, B, chunk):  # static unroll over chunks
            sl = slice(i, min(i + chunk, B))
            th_c = jax.tree.map(lambda a: a[sl], theta32)
            poly_c = Polyhedron(*[
                f if ax is None else f[sl] for f, ax in zip(poly32, axes)
            ])
            outs.append(vbulk(th_c, X0_32[sl], poly_c))
        X32 = outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)
        return certify(theta32, X32, poly32, theta64, poly64)

    return jax.jit(run)


def solve_small_fused(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    polish_steps: int = 5,
    bulk_crit_tol: float = 1e-2,
    bulk_max_inner: Optional[int] = 8,
    bulk_device: Optional[jax.Device] = None,
    active_tol: float = 1e-4,
    refactor_steps: int = 2,
    rounds: int = 2,
    straggler_bucket: int = 64,
    fallback_pad: int = 64,
    fallback_device: Optional[object] = "cpu",
) -> Tuple[Array, Array, SolveInfo]:
    """One-dispatch mixed-precision solve for small-n families; returns
    f64 (X, Y, SolveInfo) certified at f64 KKT grade.

    Semantics match `solve_mixed_precision(..., certify="device")` with
    the bulk lockstep cap applied; only the scheduling differs (single
    program, so a few chunks' worth of dispatch overhead and the
    intermediate host syncs disappear).  B must stay modest (the fused
    certification is batch-wide; the certify="auto" device threshold,
    B <= 8192, bounds it).
    """
    from .refine import _cast_tree
    from ..harness.transfer import pack_device_put

    n = X0.shape[-1]
    cpu = local_cpu()
    bulk_dev = bulk_device
    if bulk_dev is None:
        cfg_dev = jax.config.jax_default_device
        bulk_dev = cfg_dev if cfg_dev is not None else jax.local_devices()[0]
    if isinstance(bulk_dev, str):
        # Platform-name strings are legal default_device values; normalize.
        bulk_dev = jax.local_devices(backend=bulk_dev)[0]

    # Host-side f32/f64 master prep (same discipline as
    # solve_mixed_precision: cast on host, ship packed).
    with jax.default_device(cpu):
        put_h = lambda t: jax.tree.map(lambda a: jax.device_put(a, cpu), t)
        theta_h = put_h(theta)
        poly_fields = {
            f: getattr(bp, f) for f in ("A", "b", "xl", "xu")
            if getattr(bp, f) is not None
        }
        poly_h = put_h(poly_fields)
        theta64_h = _cast_tree(theta_h, jnp.float64)
        poly64_h = _cast_tree(poly_h, jnp.float64)
        theta32_h = _cast_tree(theta_h, jnp.float32)
        poly32_h = _cast_tree(poly_h, jnp.float32)
        X0_32h = put_h(X0).astype(jnp.float32)
    if bulk_dev != cpu:
        theta32_d, X0_32, poly32_f, theta64_d, poly64_f = pack_device_put(
            (theta32_h, X0_32h, poly32_h, theta64_h, poly64_h), bulk_dev
        )
    else:
        theta32_d, X0_32, poly32_f, theta64_d, poly64_f = (
            theta32_h, X0_32h, poly32_h, theta64_h, poly64_h
        )
    bp64 = dataclasses.replace(bp, **poly64_f)
    bp32 = dataclasses.replace(bp, **poly32_f)
    poly32 = bp32.polyhedron(n, jnp.float32)
    poly64 = bp64.polyhedron(n, jnp.float64)

    opts64 = options.resolve_tols(jnp.dtype(jnp.float64))
    # Same bulk knobs as solve_mixed_precision: loosened crit_tol (the
    # bulk only needs the polish's Newton basin) + the lockstep cap.
    bulk_opts = dataclasses.replace(
        options,
        crit_tol=bulk_crit_tol,
        max_inner_iter=(
            min(bulk_max_inner, options.max_inner_iter)
            if bulk_max_inner is not None else options.max_inner_iter
        ),
    )

    fns_key = (bp.residuals, bp.nlconstraints, bp.jac_res, bp.jac_nlcons)
    fns0 = bp64.instance_fns(jax.tree.map(lambda a: a[:1][0], theta64_d))
    p = jax.eval_shape(
        fns0.nlconstraints, jax.ShapeDtypeStruct((n,), jnp.float64)
    ).shape[0]
    polish_key = (
        polish_steps, active_tol, 0.0, float(opts64.crit_tol),
        float(opts64.feas_tol), refactor_steps, rounds, p, straggler_bucket,
    )
    run = _pipeline_runner(
        fns_key, fns_key, poly_batch_axes(poly32),
        bulk_opts, min(chunk, X0.shape[0]), polish_key,
    )
    with jax.default_device(bulk_dev):
        X, Y, ok, pix, feas, obj = dispatch(
            "fused_pipeline", run, theta32_d, X0_32, poly32, theta64_d, poly64)
        B = X.shape[0]
        info = SolveInfo(
            converged=ok,
            status=jnp.where(ok, SOLVE_CONVERGED, SOLVE_MAX_OUTER),
            outer_iters=jnp.zeros((B,), jnp.int32),
            inner_iters=jnp.full((B,), polish_steps, jnp.int32),
            pix=pix,
            feas=feas,
            mu=jnp.full((B,), opts64.mu0, X.dtype),
            objective=obj,
            minor_iters=jnp.zeros((B,), jnp.int32),
            cg_iters=jnp.zeros((B,), jnp.int32),
        )
        import numpy as np

        if np.asarray(ok).all():
            return X, Y, info
        return fallback_full_refine(
            bp64, theta64_d, X, Y, info, options, fallback_pad, chunk,
            fallback_device, migrate_to_host=bulk_dev.platform != "cpu",
        )
