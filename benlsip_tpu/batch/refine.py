"""Mixed-precision pipeline: f32 bulk solve + f64 refinement.

The BASELINE metric demands KKT-tolerance 1e-8 solutions ("bit-comparable"
with the f64 Julia reference), but sqrt(eps(f32)) ≈ 3.5e-4 bounds what a
pure-f32 solve can certify.  The pipeline here:

1. bulk phase — the full TRALCNLLS iteration in f32 on the device, run to
   the f32 criticality floor;
2. refinement — restart the same iteration in f64 from the f32 solution.
   Warm-started this takes O(1) outer iterations per instance.  The f64
   phase runs on the configured refinement backend: CPU by default (a
   placement chosen on the earlier accelerator, whose f64 was emulated;
   pass device=None to stay on-device — ROADMAP Speed item 5 measures it
   on the H100).

Accuracy: the f32 point is within ~1e-4 of the solution; f64 Gauss-Newton
contraction from there reaches the 1e-8 KKT region in 1-3 accepted steps.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..harness.devices import local_cpu
from ..solver.options import SolverOptions
from ..solver.outer import SolveInfo
from .vmap_solve import BatchedProblem, solve_batched_chunked

Array = jax.Array


def _cast_tree(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, tree
    )


def refine_f64(
    bp: BatchedProblem,
    theta,
    X: Array,
    options: SolverOptions = SolverOptions(),
    device: Optional[jax.Device] = "cpu",
    max_outer: int = 10,
    chunk: int = 512,
) -> Tuple[Array, Array, SolveInfo]:
    """Polish batched f32 solutions X to f64 KKT grade.

    Returns (X64, Y64, info) with f64 tolerances (sqrt(eps(f64)) ≈ 1.5e-8
    by default).  `device='cpu'` places the refinement on host; pass
    device=None to keep the ambient backend.
    """
    if not jax.config.jax_enable_x64:
        raise RuntimeError(
            "refine_f64 requires jax_enable_x64 (set jax.config.update('jax_enable_x64', True))"
        )
    opts = dataclasses.replace(
        options,
        max_outer_iter=max_outer,
        # Warm start: x0 is essentially feasible already; keep projection on
        # (cheap) to clean up f32-level bound violations.
    )
    # Transfer FIRST, cast on the target device: casting first would run
    # the f64 astype on the source device and move double the bytes.
    # device=None gathers everything onto X's device (inputs can
    # arrive with mixed commitments — host problem data, device-resident X).
    if device == "cpu":
        dev = local_cpu()
    elif device is None:
        dev = next(iter(X.devices()))
    else:
        dev = device
    put = lambda a: jax.device_put(a, dev)
    bp64 = dataclasses.replace(
        bp,
        A=None if bp.A is None else put(bp.A).astype(jnp.float64),
        b=None if bp.b is None else put(bp.b).astype(jnp.float64),
        xl=None if bp.xl is None else put(bp.xl).astype(jnp.float64),
        xu=None if bp.xu is None else put(bp.xu).astype(jnp.float64),
    )
    theta64 = _cast_tree(jax.tree.map(put, theta), jnp.float64)
    X64 = put(X).astype(jnp.float64)
    with jax.default_device(dev):
        return solve_batched_chunked(bp64, theta64, X64, opts, chunk=chunk)


def _resolve_certify(certify: str, B: int, n: int, bulk_platform: str) -> str:
    """Resolve certify="auto" to "device" or "host" (VERDICT r4 #3).

    Device certification (the fused one-dispatch program) keeps the
    factor and solution transfers off the host link, and its bucketed
    re-polish rounds pay no batch-global pass at large B.  On a CPU bulk
    device there is nothing to keep resident — host is the same thing
    without the extra plumbing.  The B <= 8192 threshold was chosen on
    the earlier accelerator, where the B=16k f64 chord ran emulated; it
    is not yet measured on the H100 (ROADMAP Speed item 4), where f64
    is native.
    """
    if certify != "auto":
        return certify
    if bulk_platform == "cpu":
        return "host"
    return "device" if B <= 8192 else "host"


def _resolve_bulk_max_inner(bulk_max_inner, n: int, polish: bool):
    """Resolve bulk_max_inner="auto": cap 8 for small instances (n <= 8),
    off otherwise (VERDICT r4 #3).

    The cap is the lockstep-tail fix for the tiny-instance families:
    their subproblems are cheap and certification absorbs the slack
    (certified fraction unchanged); mid-size families (config 3) need
    their inner iterations — capping them there trades bulk quality for
    fallback time.  Chosen on the earlier accelerator; not yet measured
    on the H100 (ROADMAP Speed item 3).  Requires polish=True like every
    bulk-degrading knob.
    """
    if bulk_max_inner != "auto":
        return bulk_max_inner
    return 8 if (polish and n <= 8) else None


def _resolve_bulk_compact(bulk_compact, B: int, chunk: int, polish: bool,
                          sort_by_difficulty: bool = False):
    """Resolve bulk_compact="auto": OFF.

    Converged-instance compaction (batch/compact.py) structurally saves
    lockstep iterations at sweep scale, but adds host sync points (the
    done-mask transfer + bucket dispatches).  OFF was chosen on the
    earlier accelerator, whose host link made those sync points costly
    and noisy; it is not yet measured on the H100 (ROADMAP Speed item 7).
    The mechanism stays available as an explicit horizon
    (`bulk_compact=2`).
    """
    if bulk_compact != "auto":
        return bulk_compact
    return None


def _resolve_fuse(fuse, n, polish, sort_by_difficulty, pipeline_overlap,
                  bulk_dtype, bulk_matmul_precision, bulk_compact,
                  bulk_crit_tol):
    """Resolve fuse="auto": whole-pipeline fusion (batch/fused_small.py —
    ONE dispatch from f32 bulk to certified f64) saves dispatches and
    host syncs, which dominate the tiny-instance families; at n=192 the
    bulk is compute-heavy and the mega-program scheduled worse.  So
    "auto" engages it only for n <= 8, where the device certification is
    the resolved fast path and every bulk knob sits at a fused-covered
    default.  The n <= 8 line was chosen on the earlier accelerator; not
    yet measured on the H100 (ROADMAP Speed item 7)."""
    if fuse != "auto":
        return fuse
    return (
        polish
        and n <= 8
        and not sort_by_difficulty
        and not pipeline_overlap
        and jnp.dtype(bulk_dtype) == jnp.dtype(jnp.float32)
        and bulk_matmul_precision is None
        and bulk_compact is None
        and bulk_crit_tol is not None
    )


def solve_mixed_precision(
    bp: BatchedProblem,
    theta,
    X0: Array,
    options: SolverOptions = SolverOptions(),
    chunk: int = 512,
    refine_device: Optional[jax.Device] = "cpu",
    sort_by_difficulty: bool = False,
    sort_chunk: int = 128,
    polish: bool = True,
    polish_steps: int = 5,
    bulk_crit_tol: Optional[float] = 1e-2,
    bulk_device: Optional[jax.Device] = None,
    certify: str = "auto",
    pipeline_overlap: bool = False,
    bulk_dtype=jnp.float32,
    bulk_matmul_precision: Optional[str] = None,
    bulk_max_inner="auto",
    bulk_compact="auto",
    fuse: str = "auto",
) -> Tuple[Array, Array, SolveInfo]:
    """f32 bulk solve (ambient device) + f64 refinement; returns f64 results.

    certify="auto" (default) picks the certification path per regime
    (`_resolve_certify`): "device" keeps the certification ON the bulk
    device — the f64 polish runs there through the range-space QR
    factorization and the only D2H traffic left is the final results;
    "host" pulls the f32 solutions to CPU for the f64 polish.  The
    full-refine fallback for uncertified stragglers runs on CPU either
    way.

    With `polish=True` (default) the f64 phase is the warm-start SQP polish
    (batch/polish.py): fixed-active-set Gauss-Newton KKT steps, ~20x cheaper
    than restarting the full solver, with exact-projection certification and
    automatic fallback to the full refine for uncertified instances.
    `polish=False` forces the full-TRALCNLLS refine for every instance.

    `bulk_crit_tol` relaxes the f32 phase's criticality tolerance: the bulk
    solve only needs to identify the active set and land in the Newton
    basin of the polish, not grind to the f32 floor; `polish_steps=5`
    absorbs the looser start.
    Pass None to run the bulk phase to the f32 floor (and with
    polish=False, where the full refine restarts cold anyway, None is used
    regardless).

    sort_by_difficulty runs the bulk phase in pilot-ranked chunks
    (batch.buckets.solve_batched_sorted): each lockstep chunk waits only
    for peers of similar cost.

    pipeline_overlap=True dispatches EVERY bulk chunk asynchronously up
    front, then certifies chunk i on the host while the device still
    executes chunks i+1…; per-instance results are identical to the
    default path (certification is per-instance).  Default False: chosen
    on the earlier accelerator, whose host link serialized the D2H pull
    behind queued executions; not yet measured on the H100 (ROADMAP
    Speed item 7), where the overlap can hide the host certify leg
    behind device compute.

    bulk_dtype sets the bulk phase's working dtype (f32 default; bf16
    runs the bulk's products at bf16 tensor-core rates).  The certification phases
    are unaffected — a bf16 bulk result is promoted to f32 before the
    polish factor phase, and the warm start just needs to land in the
    polish's Newton basin (bulk_crit_tol already loosens the bulk to
    1e-2 for the same reason).

    bulk_matmul_precision overrides the bulk phase's matmul precision
    (e.g. "default", which lets f32 products run in TF32 on the GPU).
    Applies only with polish=True — same rationale as the other
    bulk-degrading knobs below.

    bulk_max_inner caps the bulk phase's per-subproblem TR iterations
    (the lockstep-tail cap: each chunk's while_loop runs to its slowest
    instance; certified fraction unchanged).  "auto" (default) applies the
    heuristic
    (`_resolve_bulk_max_inner`: cap 8 for n <= 8 families, off
    otherwise); pass an int to force a cap or None to disable.  Like
    bulk_crit_tol it applies only with polish=True — these knobs trade
    bulk accuracy against the polish phase absorbing the slack, and with
    polish=False the full refine restarts cold from whatever the bulk
    produced, so the cap is ignored there rather than silently degrading
    the only accurate phase.

    bulk_compact names an outer-iteration horizon (int): the bulk phase
    then runs `batch.compact.solve_batched_compact` — wide chunks stop at
    the horizon and only the unconverged tail (gathered into power-of-two
    buckets) runs the rest of the schedule.  Bit-identical bulk results;
    pure scheduling.  "auto" (default) enables horizon 2 for many-chunk
    sweeps (`_resolve_bulk_compact`, OFF today); None disables.
    """
    bulk_max_inner = _resolve_bulk_max_inner(bulk_max_inner, X0.shape[-1], polish)
    bulk_compact = _resolve_bulk_compact(
        bulk_compact, X0.shape[0], min(chunk, X0.shape[0]), polish,
        sort_by_difficulty,
    )
    fuse = _resolve_fuse(
        fuse, X0.shape[-1], polish, sort_by_difficulty, pipeline_overlap,
        bulk_dtype, bulk_matmul_precision, bulk_compact, bulk_crit_tol,
    )
    # Build the f32 working copy on HOST, then ship it to the bulk device in
    # one explicit transfer.  Casting uncommitted f64 arrays directly would
    # dispatch the astype to the default device and move double-width
    # data; master f64 data belongs on host (where the host certification
    # and fallback phases read it anyway).
    cpu = local_cpu()
    # Bulk device: explicit argument > ambient default_device > first LOCAL
    # device (jax.devices()[0] is the global list's first — under
    # jax.distributed that is process 0's device and non-addressable from
    # every other process).
    bulk_dev = bulk_device
    if bulk_dev is None:
        cfg_dev = jax.config.jax_default_device
        bulk_dev = cfg_dev if cfg_dev is not None else jax.local_devices()[0]
    if isinstance(bulk_dev, str):
        # jax.default_device accepts platform-name strings; normalize to a
        # Device so .platform and device comparisons below are valid.
        bulk_dev = jax.local_devices(backend=bulk_dev)[0]
    certify = _resolve_certify(
        certify, X0.shape[0], X0.shape[-1], bulk_dev.platform
    )
    if fuse is True and certify == "device":
        from .fused_small import solve_small_fused

        return solve_small_fused(
            bp, theta, X0, options, chunk=chunk, polish_steps=polish_steps,
            bulk_crit_tol=bulk_crit_tol, bulk_max_inner=bulk_max_inner,
            bulk_device=bulk_dev, fallback_device=refine_device,
        )
    with jax.default_device(cpu):
        put_h = lambda t: jax.tree.map(lambda a: jax.device_put(a, cpu), t)
        theta_h = put_h(theta)       # host master copy, reused by the f64 phase
        bp_h = dataclasses.replace(
            bp,
            A=None if bp.A is None else put_h(bp.A),
            b=None if bp.b is None else put_h(bp.b),
            xl=None if bp.xl is None else put_h(bp.xl),
            xu=None if bp.xu is None else put_h(bp.xu),
        )
        theta32 = _cast_tree(theta_h, jnp.float32)
        bp32 = dataclasses.replace(
            bp_h,
            A=None if bp_h.A is None else bp_h.A.astype(jnp.float32),
            b=None if bp_h.b is None else bp_h.b.astype(jnp.float32),
            xl=None if bp_h.xl is None else bp_h.xl.astype(jnp.float32),
            xu=None if bp_h.xu is None else bp_h.xu.astype(jnp.float32),
        )
        X0_32 = put_h(X0).astype(jnp.float32)
    if bulk_dev != cpu:
        # One packed transfer for the whole f32 working set: per-leaf
        # device_puts each pay the link's round-trip latency.
        from ..harness.transfer import pack_device_put

        poly_fields = {
            f: getattr(bp32, f)
            for f in ("A", "b", "xl", "xu")
            if getattr(bp32, f) is not None
        }
        theta32, X0_32, poly_fields = pack_device_put(
            (theta32, X0_32, poly_fields), bulk_dev
        )
        bp32 = dataclasses.replace(bp32, **poly_fields)
    bulk_opts = options
    if polish and bulk_crit_tol is not None:
        bulk_opts = dataclasses.replace(options, crit_tol=bulk_crit_tol)
    if polish and bulk_matmul_precision is not None:
        # Cheaper-bulk experiment knob (VERDICT r3 #8): run the f32 bulk
        # phase at a lower matmul precision ("default" = TF32 on the GPU).  The
        # certification phase catches any instance the cheaper bulk fails
        # to land in the polish's Newton basin — wrong answers cost
        # fallback time, never accuracy.  Gated on polish=True like
        # bulk_crit_tol/bulk_max_inner: all three knobs trade bulk accuracy
        # against the polish absorbing the slack, and with polish=False the
        # full refine restarts cold from the bulk point, so a degraded bulk
        # would silently cost refine iterations with nothing absorbing it.
        bulk_opts = dataclasses.replace(bulk_opts, matmul_precision=bulk_matmul_precision)
    if polish and bulk_max_inner is not None:
        # Lockstep-tail cap: the batched inner TR loop runs each chunk to
        # its slowest instance's subproblem (config 5: p50=6 / max=29 inner
        # iterations, so every chunk pays the max).  Capping the bulk
        # phase's per-subproblem iterations bounds that tail; AL theory
        # tolerates inexact subproblem solves, and the certification phase
        # (not affected by this knob) absorbs or falls back on the rare
        # instance that lands short.
        bulk_opts = dataclasses.replace(
            bulk_opts, max_inner_iter=min(bulk_max_inner, options.max_inner_iter)
        )
    if pipeline_overlap and polish:
        return _overlapped_pipeline(
            bp_h, theta_h, bp32, theta32, X0_32, options, bulk_opts,
            chunk=chunk, polish_steps=polish_steps,
            refine_device=refine_device, certify=certify,
        )
    bp_b, theta_b, X0_b = bp32, theta32, X0_32
    if jnp.dtype(bulk_dtype) != jnp.dtype(jnp.float32):
        # Cast the already-device-resident f32 working set in-graph (no
        # second host transfer); the f32 copy stays for the polish factors.
        theta_b = _cast_tree(theta32, bulk_dtype)
        bp_b = dataclasses.replace(
            bp32,
            A=None if bp32.A is None else bp32.A.astype(bulk_dtype),
            b=None if bp32.b is None else bp32.b.astype(bulk_dtype),
            xl=None if bp32.xl is None else bp32.xl.astype(bulk_dtype),
            xu=None if bp32.xu is None else bp32.xu.astype(bulk_dtype),
        )
        X0_b = X0_32.astype(bulk_dtype)
    if bulk_compact is not None:
        # Converged-instance compaction (SURVEY §7.3-3 / VERDICT r4 #1):
        # wide chunks stop at the `bulk_compact` outer horizon; the
        # unconverged tail finishes in narrow power-of-two buckets.
        from .compact import solve_batched_compact

        X32, _, _ = solve_batched_compact(
            bp_b, theta_b, X0_b, bulk_opts, chunk=chunk,
            stage_outer=bulk_compact,
        )
    elif sort_by_difficulty:
        from .buckets import solve_batched_sorted

        X32, _, _ = solve_batched_sorted(
            bp_b, theta_b, X0_b, bulk_opts, chunk=sort_chunk
        )
    else:
        X32, _, _ = solve_batched_chunked(bp_b, theta_b, X0_b, bulk_opts, chunk=chunk)
    X32 = X32.astype(jnp.float32)
    if polish:
        from .polish import polish_then_refine

        return polish_then_refine(
            bp_h, theta_h, X32, options, num_steps=polish_steps, chunk=chunk,
            device=None if certify == "device" else refine_device,
            # Hand the device-resident f32 working set to the polish so it
            # can factor the KKT systems on the bulk device (split polish;
            # auto-enabled for n >= 64).
            bp32=bp32, theta32=theta32,
        )
    return refine_f64(bp_h, theta_h, X32, options, device=refine_device, chunk=chunk)


def _slice_batched(bp: BatchedProblem, theta, sl):
    """Slice theta and any per-instance polyhedron fields to a chunk."""
    from .vmap_solve import map_poly_fields

    return map_poly_fields(bp, lambda a: a[sl]), jax.tree.map(lambda a: a[sl], theta)


def _overlapped_pipeline(
    bp_h, theta_h, bp32, theta32, X0_32, options, bulk_opts,
    chunk, polish_steps, refine_device, certify,
):
    """Chunk-pipelined bulk/certify: dispatch every bulk chunk up front
    (JAX async dispatch queues them device-side), then certify chunk i on
    the host while the device executes chunks i+1….  See
    `solve_mixed_precision(pipeline_overlap=...)` for when this wins.
    """
    from .polish import polish_then_refine
    from .vmap_solve import solve_batched_chunked

    B = X0_32.shape[0]
    csz = min(chunk, B)
    slices = [slice(i, min(i + csz, B)) for i in range(0, B, csz)]

    # Phase 1: launch all bulk chunks without blocking.
    bulk_out = []
    for sl in slices:
        bp_c, th_c = _slice_batched(bp32, theta32, sl)
        Xc, _, _ = solve_batched_chunked(bp_c, th_c, X0_32[sl], bulk_opts, chunk=csz)
        bulk_out.append((bp_c, th_c, Xc))

    # Phase 2: certify chunk i (pulls Xc — blocks only on that chunk's
    # completion) while later chunks still run on the device.
    cpu = local_cpu()
    parts = []
    for sl, (bp32_c, th32_c, Xc) in zip(slices, bulk_out):
        bp_hc, th_hc = _slice_batched(bp_h, theta_h, sl)
        Xp, Yp, ip = polish_then_refine(
            bp_hc, th_hc, Xc, options, num_steps=polish_steps, chunk=csz,
            device=None if certify == "device" else refine_device,
            bp32=bp32_c, theta32=th32_c,
        )
        # Normalize commitments: the device-certify path returns
        # device-committed arrays UNLESS its CPU fallback ran (then CPU);
        # mixed commitments across chunks would make the concatenates
        # below cross-device errors.
        parts.append(jax.tree.map(lambda a: jax.device_put(a, cpu), (Xp, Yp, ip)))
    X = jnp.concatenate([p[0] for p in parts], axis=0)
    Y = jnp.concatenate([p[1] for p in parts], axis=0)
    info = SolveInfo(*[
        jnp.concatenate([getattr(p[2], f) for p in parts], axis=0)
        for f in SolveInfo._fields
    ])
    return X, Y, info
