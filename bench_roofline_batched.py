"""Roofline microbench for the BATCHED-SMALL pipeline (config 2).

VERDICT r3 #5: no MFU/bandwidth row existed for the headline workload
(B=1024 exponential fits, n=3, d=32, box + 1 linear equality).  At this
shape the per-instance linear algebra is a few hundred FLOPs — the chip is
never FLOP-bound; the measured quantities that matter are

  * HBM bandwidth utilization of the batched working set (all tensors are
    (B, d, n)-class; one solver iteration streams them a handful of times),
  * the batched small factorizations (Cholesky, thin QR) XLA runs over
    the instance axis,
  * the per-op overhead floor of the compiled while_loop program: with
    ~hundreds of HLO ops per solver iteration and sub-microsecond
    per-op compute, wall ≈ ops × issue-overhead, not FLOPs/peak.

One JSON line per phase (config: "roofline-batched") on stdout, each with
the device record; also appended to --out when given.  Optionally captures
a jax.profiler trace of one bulk chunk (--trace DIR) — the solver's
named_scope annotations (cauchy/minor-cg/refresh/criticality) label it.
Fails without a GPU.

  python bench_roofline_batched.py [--B 1024] [--trace DIR] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from bench_roofline import _time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=1024)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--out", default=None, help="also append the rows to this JSONL file")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    B, d, n = args.B, args.d, 3
    fsz = 4

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu
    from benlsip_tpu.harness.roofline import RooflineRow, peaks_for

    device = require_gpu()
    enable_compile_cache()
    peaks = peaks_for(device["kind"])

    rng = np.random.default_rng(0)
    dtype = jnp.float32
    J = jnp.asarray(rng.standard_normal((B, d, n)).astype(np.float32))
    r = jnp.asarray(rng.standard_normal((B, d)).astype(np.float32))
    G = jnp.einsum("bdi,bdj->bij", J, J) + 0.1 * jnp.eye(n, dtype=dtype)

    rows = []

    def add(phase, flops, nbytes, wall, note=""):
        row = RooflineRow(phase, flops, nbytes, wall, peaks, "float32")
        rec = row.as_dict()
        if note:
            rec["note"] = note
        rows.append(rec)

    hp = jax.default_matmul_precision("highest")
    with hp:
        # Batched Gram build: the per-accept operator refresh of the bulk
        # loop — (B, n, d) x (B, d, n) batched GEMM with a 3x3 output per
        # instance at n=3.
        wall, _ = _time(jax.jit(lambda j: jnp.einsum("bdi,bdj->bij", j, j)), J,
                        reps=args.reps)
        add("batched_gram JtJ", 2.0 * B * d * n * n, B * (d * n + n * n) * fsz, wall)

        # Batched gradient Jᵀr: per candidate evaluation.
        wall, _ = _time(jax.jit(lambda j, x: jnp.einsum("bdi,bd->bi", j, x)), J, r,
                        reps=args.reps)
        add("batched_grad Jtr", 2.0 * B * d * n, B * (d * n + d) * fsz, wall)

        # The (B, 3, 3) factorizations of the bulk loop's KKT/TR systems,
        # and the thin QR of the gn_factorization="qr" route.
        from benlsip_tpu.ops.cholesky import _chol_xla

        wall, _ = _time(jax.jit(_chol_xla), G, reps=args.reps)
        add("batched_chol (B,3,3)", B * n**3 / 3.0, 2 * B * n * n * fsz, wall)
        S = jnp.asarray(rng.standard_normal((B, d, n)).astype(np.float32))
        wall, _ = _time(jax.jit(lambda s: jnp.linalg.qr(s, mode="r")), S, reps=args.reps)
        add("batched_qr (B,32,3)", 2.0 * B * d * n * n, B * d * n * fsz, wall)

        # Batched exact projection (criticality measure, once per TR iter;
        # round-4 warm-start cut its Newton count to ~2 — solver-level).
        from benlsip_tpu.ops.constraints import Polyhedron
        from benlsip_tpu.ops.polyproject import projection_polyhedron

        A1 = jnp.asarray(rng.standard_normal((B, 1, n)).astype(np.float32))
        b1 = jnp.zeros((B, 1), dtype)
        Z = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32))

        def proj(a, b, z):
            poly = Polyhedron(A=a, b=b, xl=jnp.full(n, -10.0, dtype),
                              xu=jnp.full(n, 10.0, dtype))
            return projection_polyhedron(poly, z)

        wall, _ = _time(jax.jit(jax.vmap(proj)), A1, b1, Z, reps=args.reps)
        add("batched_poly_project", 5 * B * (2 * n + 50 * n), 5 * 52 * B * n * fsz, wall,
            note="~5 cold Newton iters x vectorized line-search grids")

    # End-to-end bulk phase: wall per solver outer iteration, and the
    # instance-iteration throughput.  Uses the bench workload itself.
    import dataclasses

    from benlsip_tpu.batch.refine import _cast_tree
    from benlsip_tpu.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(B, d=d, seed=42, dtype=jnp.float64)
    theta32 = _cast_tree(theta, jnp.float32)
    bp32 = dataclasses.replace(
        bp,
        A=None if bp.A is None else bp.A.astype(jnp.float32),
        b=None if bp.b is None else bp.b.astype(jnp.float32),
        xl=None if bp.xl is None else bp.xl.astype(jnp.float32),
        xu=None if bp.xu is None else bp.xu.astype(jnp.float32),
    )
    X032 = X0.astype(jnp.float32)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120, crit_tol=1e-2)

    # chunk=512: the production chunk cap (batch/vmap_solve.py).
    def bulk():
        X, Y, info = solve_batched_chunked(bp32, theta32, X032, opts,
                                           chunk=min(B, 512))
        return X, info

    (X, info) = bulk()
    jax.block_until_ready(X)
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        X, info = bulk()
        jax.block_until_ready(X)
        walls.append(time.perf_counter() - t0)
    bulk_wall = min(walls)
    outer = int(jnp.max(info.outer_iters))
    inner = int(jnp.sum(info.inner_iters))
    summary = {
        "config": "roofline-batched",
        "phase": "bulk_phase_end_to_end",
        "B": B, "d": d, "n": n,
        "wall_s": bulk_wall,
        "max_outer_iters": outer,
        "total_inner_iters": inner,
        "instance_inner_iters_per_sec": inner / bulk_wall,
        "wall_per_lockstep_inner_iter_us":
            bulk_wall / max(int(jnp.max(info.inner_iters)), 1) * 1e6,
    }

    if args.trace:
        from benlsip_tpu.harness.profile import trace

        with trace(args.trace):
            X, info = bulk()
            jax.block_until_ready(X)
        print(f"# trace written to {args.trace}", flush=True)

    from benlsip_tpu.harness.metrics import MetricsWriter

    w = MetricsWriter(args.out) if args.out else None
    summary["device"] = device
    for out in [{"config": "roofline-batched", **rec, "B": B, "d": d, "device": device}
                for rec in rows] + [summary]:
        if w:
            w.write(out)
        print(json.dumps(out), flush=True)
    if w:
        w.close()


if __name__ == "__main__":
    main()
