"""Roofline microbench: the config-4 hot kernels vs the GPU's peaks.

The north star asks for the per-iteration step at "speed-of-light per
chip" (round-1 VERDICT item 4).  This script times each hot phase of the
blocked-Jacobian inner iteration AT config-4 shapes on the ambient device,
counts its FLOPs/HBM bytes analytically, and reports achieved vs roofline
(harness/roofline.py, peaks keyed by device kind).  Given a measured
config-4 row in --out, it also compares the solver's per-inner-iteration
wall with the phase-mix floor.

  python bench_roofline.py [--n 4096 --d 16384] [--trace DIR] [--out FILE]

One JSON line per phase (config: "roofline") on stdout, each with the
device record; also appended to --out when given.  Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def _time(fn, *args, reps=5, queue=40):
    """Steady-state per-execution seconds: queue `queue` executions, wait
    with `block_until_ready`, divide; min over `reps` rounds."""
    out = fn(*args)
    jax.block_until_ready(out)
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(queue):
            out = fn(*args)
        jax.block_until_ready(out)
        walls.append((time.perf_counter() - t0) / queue)
    return min(walls), out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=16384)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--trace", default=None, help="capture a jax.profiler trace dir")
    ap.add_argument("--linear", action="store_true",
                    help="trace with SolverOptions.linear_residuals=True "
                    "(the constant-J cache; the traced family is linear LSQ)")
    ap.add_argument("--out", default=None, help="also append the rows to this JSONL file")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if args.linear and not args.trace:
        # The phase microbenches time raw kernels (no solver), so --linear
        # only affects the traced solve; without --trace it would be a
        # silent no-op recorded as if it changed the numbers.
        ap.error("--linear only affects the traced solve; pass --trace DIR with it")
    n, d, m = args.n, args.d, args.m

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu
    from benlsip_tpu.harness.roofline import RooflineRow, peaks_for

    device = require_gpu()
    enable_compile_cache()
    peaks = peaks_for(device["kind"])

    rng = np.random.default_rng(0)
    dtype = jnp.float32
    J = jnp.asarray((rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal(n).astype(np.float32))
    r = jnp.asarray(rng.standard_normal(d).astype(np.float32))
    A = jnp.asarray((rng.standard_normal((m, n)) / np.sqrt(n)).astype(np.float32))
    fsz = 4

    hp = jax.default_matmul_precision("highest")

    rows = []

    def add(phase, flops, nbytes, wall, precision="float32"):
        rows.append(RooflineRow(phase, flops, nbytes, wall, peaks, precision))

    with hp:
        # Gram build G = JᵀJ: once per accepted TR step (the operator refresh).
        wall, G = _time(jax.jit(lambda j: j.T @ j), J, reps=args.reps)
        add("gram_build JtJ", 2.0 * d * n * n, (d * n + n * n) * fsz, wall)

        # Gram H·v: the CG-iteration matvec in gram mode.
        wall, _ = _time(jax.jit(lambda g, x: g @ x), G, v, reps=args.reps)
        add("gram_hv Gv", 2.0 * n * n, n * n * fsz, wall)

        # Matrix-free H·v = Jᵀ(Jv): the CG matvec without the Gram operator.
        wall, _ = _time(jax.jit(lambda j, x: j.T @ (j @ x)), J, v, reps=args.reps)
        add("matfree_hv Jt(Jv)", 4.0 * d * n, 2 * d * n * fsz, wall)

        # AL gradient g = Jᵀr: once per candidate evaluation.
        wall, _ = _time(jax.jit(lambda j, x: j.T @ x), J, r, reps=args.reps)
        add("al_grad Jtr", 2.0 * d * n, d * n * fsz, wall)

        # Thin QR of J: the gn_factorization="qr" refresh (blocked Householder).
        wall, _ = _time(
            jax.jit(lambda j: jnp.linalg.qr(j, mode="r")), J, reps=args.reps
        )
        add("thin_qr R(J)", 2.0 * d * n * n - 2.0 * n**3 / 3.0, 2 * d * n * fsz, wall)

        # CholeskyQR2 R factor: the gn_factorization="cholqr2" refresh —
        # three GEMM-class passes (G = SᵀS, W = S R₁⁻¹, G₂ = WᵀW) + two
        # small chols + one triangular-triangular product.  Same R as
        # Householder from GEMM-shaped work (ops/qr.cholqr2_r).
        from benlsip_tpu.ops.qr import cholqr2_r

        wall, _ = _time(jax.jit(cholqr2_r), J, reps=args.reps)
        add(
            "cholqr2 R(J)",
            5.0 * d * n * n + n**3,          # 2dn² + dn² + 2dn² GEMM-class + ~n³ tri ops
            (3 * d * n + 4 * n * n) * fsz,   # S streamed thrice + (n,n) factors
            wall,
        )

        # CholeskyQR2 with the implicit refinement (the operator-build
        # route, ops/qr.cholqr2i_r): ONE pass over S (the Gram) + n³-class
        # triangular work on the (n,n) factors — S is never re-touched.
        from benlsip_tpu.ops.qr import cholqr2i_r

        wall, _ = _time(jax.jit(cholqr2i_r), J, reps=args.reps)
        add(
            "cholqr2i R(J)",
            2.0 * d * n * n + 3.0 * n**3,    # Gram GEMM + 2 (n,n) trisolves + chols/trimul
            (d * n + 6 * n * n) * fsz,       # S streamed once + (n,n) factors
            wall,
        )

        # Exact polyhedral projection (criticality measure, once per TR iter).
        from benlsip_tpu.ops.constraints import Polyhedron
        from benlsip_tpu.ops.polyproject import projection_polyhedron

        poly = Polyhedron(
            A=A, b=jnp.zeros(m, dtype), xl=jnp.full(n, -3.0, dtype), xu=jnp.full(n, 3.0, dtype)
        )
        wall, _ = _time(
            jax.jit(lambda p, z: projection_polyhedron(p, z)), poly, v, reps=args.reps
        )
        # ~10 Newton iters x (phi grids (58, n) + AAt m^2 n): bandwidth model.
        add("poly_project P(x)", 10 * (2 * m * m * n + 60 * n), 10 * 62 * n * fsz, wall)

        # Masked tangent projection (two m-solves + two GEMVs), per CG iter.
        from benlsip_tpu.ops.constraints import make_active_set
        from benlsip_tpu.ops.project import project_tangent

        aset = make_active_set(poly, jnp.zeros(n, bool))
        wall, _ = _time(
            jax.jit(lambda p, a, z: project_tangent(p, a, z)), poly, aset, v,
            reps=args.reps,
        )
        add("tangent_proj Pv", 4.0 * m * n, (2 * m * n + 2 * n) * fsz, wall)

    # End-to-end: the solver's measured per-inner-iteration wall for the
    # same shapes (a config-4 row in --out, if present), plus the measured
    # CG/inner mix so the floor models what one inner iteration executes.
    iter_s = None
    cg_per_inner = 2.0  # fallback estimate if the config-4 row lacks counters
    try:
        for line in open(args.out) if args.out else ():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("config") == 4 and "sec_per_inner_iter" in rec:
                iter_s = rec["sec_per_inner_iter"]
                if rec.get("cg_iters") and rec.get("inner"):
                    cg_per_inner = rec["cg_iters"] / max(rec["inner"], 1)
    except FileNotFoundError:
        pass

    if args.trace:
        # Trace a REAL blocked solve (config-4 shape) so the per-phase
        # jax.named_scope annotations (cauchy/minor-cg/gn-refresh/
        # criticality; see harness/profile.py) label the captured timeline.
        from benlsip_tpu.batch.vmap_solve import BatchedProblem
        from benlsip_tpu.dist.mesh import make_mesh
        from benlsip_tpu.dist.sharded import solve_large_blocked_family
        from benlsip_tpu.harness.profile import trace
        from benlsip_tpu.solver.options import SolverOptions

        x_true = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        y = J @ x_true + 0.01 * jnp.asarray(rng.standard_normal(d).astype(np.float32))
        bp = BatchedProblem(
            residuals=lambda x, th: th["J"] @ x - th["y"],
            jac_res=lambda x, th: th["J"],
            A=A, b=A @ x_true,
            xl=jnp.full(n, -3.0, dtype), xu=jnp.full(n, 3.0, dtype),
        )
        mesh = make_mesh(batch=1, block=len(jax.devices()))
        t_opts = SolverOptions(
            max_outer_iter=2, max_inner_iter=6, linear_residuals=args.linear
        )
        # Warm (compile) OUTSIDE the trace; trace one warm solve.
        out = solve_large_blocked_family(bp, {"J": J, "y": y}, jnp.zeros(n, dtype), t_opts, mesh)
        jax.block_until_ready(out)
        with trace(args.trace):
            out = solve_large_blocked_family(bp, {"J": J, "y": y}, jnp.zeros(n, dtype), t_opts, mesh)
            jax.block_until_ready(out)
        print(f"# trace written to {args.trace}", flush=True)

    from benlsip_tpu.harness.metrics import MetricsWriter

    w = MetricsWriter(args.out) if args.out else None

    def emit(rec):
        if w:
            w.write(rec)
        print(json.dumps(rec), flush=True)

    for row in rows:
        emit({"config": "roofline", **row.as_dict(), "n": n, "d": d, "device": device})
    if iter_s:
        # Roofline floor of ONE inner iteration of the gram-mode solver,
        # built from the phases that iteration actually executes (the
        # alternative factorization routes — thin_qr/cholqr2 — and the
        # matrix-free matvec are benchmarked above but are NOT part of
        # this mix): one operator refresh (gram_build, jac is refreshed
        # on accept; accept fraction ~1 at this well-conditioned shape),
        # two Jᵀ-GEMVs (candidate AL eval + gradient on accept),
        # cg_per_inner × (gram matvec + tangent projection), plus the
        # per-TR-iteration criticality measure (one tangent projection
        # and one exact polyhedral projection).
        by = {r.phase.split()[0]: r for r in rows}

        def fl(name):
            return by[name].floor_s

        floor = (
            fl("gram_build")
            + 2 * fl("al_grad")
            + cg_per_inner * (fl("gram_hv") + fl("tangent_proj"))
            + fl("tangent_proj")
            + fl("poly_project")
        )
        rec = {
            "config": "roofline",
            "phase": "solver_inner_iter (measured vs phase-mix floor)",
            "wall_s": iter_s,
            "phase_floor_sum_s": round(floor, 5),
            "gap_x": round(iter_s / floor, 1),
            "cg_per_inner": round(cg_per_inner, 2),
            "mix": "gram_build + 2*al_grad + cg*(gram_hv+tangent_proj) + tangent_proj + poly_project",
            "n": n,
            "d": d,
            "device": device,
        }
        emit(rec)
    if w:
        w.close()


if __name__ == "__main__":
    main()
