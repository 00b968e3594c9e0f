"""Full BASELINE config suite: measured numbers for all five configurations.

Prints one JSON row per config, each with the device record, and appends
the rows to --out when given.  Sizes default to values that complete in
minutes on one card; --full scales config 5 to the sweep size.

  1. single small problem (bounded Rosenbrock NLS + sphere regression)
  2. 1k batched small instances (curve fits, box+linear constraints)
  3. medium dense (n=192, d=1024) with active bounds at the solution
  4. large single instance, blocked-Jacobian mode
  5. large sweep, chunked (+ mixed-precision to f64 KKT grade)

Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def _bench(fn, *args):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter() - t0, out


def config1(results):
    from benlsip_tpu import SolverOptions, solve
    from benlsip_tpu.problems import rosenbrock, sphere_regression as sr

    opts = SolverOptions(max_outer_iter=100, max_inner_iter=250)
    # f64 single-instance parity solves run on the host, as the reference
    # does (one instance, one core).
    cpu = jax.devices("cpu")[0]
    for name, problem, x0 in [
        ("rosenbrock_bounded", rosenbrock.make_problem(dtype=jnp.float64), rosenbrock.x0()),
        ("sphere_regression", sr.make_problem(), sr.x0()),
    ]:
        with jax.default_device(cpu):
            dt, (x, y, info) = _bench(lambda p=problem, z=x0: solve(p, z, opts))
        results.append(
            {
                "config": 1,
                "case": name,
                "wall_s": round(dt, 4),
                "converged": bool(info.converged),
                "outer": int(info.outer_iters),
                "inner": int(info.inner_iters),
                "pix": float(info.pix),
            }
        )

    # Classic HS/MGH battery through the independent first-principles KKT
    # oracle (VERDICT r4 #6): every entry solved on host, every solution
    # checked by the zero-shared-code numpy oracle.
    from benlsip_tpu.baselines.kkt_oracle import kkt_check_classic_battery

    t0 = time.perf_counter()
    batt = kkt_check_classic_battery()
    results.append(
        {
            "config": 1,
            "case": "classic_battery_oracle",
            "wall_s": round(time.perf_counter() - t0, 2),
            **batt,
        }
    )


def config2(results, B=1024):
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=jnp.float64)
    dt, (X, Y, info) = _bench(lambda: solve_mixed_precision(bp, theta, X0, opts))
    conv = int(jnp.sum(info.converged))
    results.append(
        {
            "config": 2,
            "case": f"exp_fit_B{B}",
            "wall_s": round(dt, 4),
            "problems_per_sec_kkt1e-8": round(conv / dt, 1),
            "converged_frac": round(conv / B, 4),
        }
    )


def config3(results, B=64, n=192, d=1024):
    from benlsip_tpu.batch.vmap_solve import solve_batched
    from benlsip_tpu.problems.generators import dense_quadratic_family
    from benlsip_tpu.solver.options import SolverOptions

    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp, theta, X0 = dense_quadratic_family(B, n=n, d=d, m=6, seed=3)

    # Measured single-core numpy baseline on the SAME workload (BASELINE.md
    # measurement contract: no comparison without a measured reference-model
    # rate).  A sample amortizes: per-instance cost is iid across targets.
    from benlsip_tpu.baselines.numpy_ref import solve_dense_lsq_numpy

    k = min(16, B)
    t0 = time.perf_counter()
    _, conv_np = solve_dense_lsq_numpy(
        np.asarray(bp.jac_res(X0[0], jax.tree.map(lambda a: a[0], theta))),
        np.asarray(theta["y"][:k]),
        np.asarray(bp.A), np.asarray(bp.b),
        np.asarray(bp.xl), np.asarray(bp.xu), np.asarray(X0[:k]),
    )
    np_dt = time.perf_counter() - t0
    np_rate = conv_np / np_dt if conv_np else float("nan")
    results.append(
        {
            "config": 3,
            "case": f"dense_n{n}_d{d}_numpy_baseline_k{k}",
            "wall_s": round(np_dt, 4),
            "problems_per_sec": round(np_rate, 3),
            "converged_frac": round(conv_np / k, 4),
        }
    )
    # Reference-model path: f64 batched solve on host.
    with jax.default_device(jax.devices("cpu")[0]):
        dt, (X, Y, info) = _bench(lambda: solve_batched(bp, theta, X0, opts))
    conv = int(jnp.sum(info.converged))
    # Active-set share at the solutions (the path this config exercises).
    act = float(jnp.mean((jnp.abs(jnp.abs(X) - 0.8) < 1e-6).astype(jnp.float64)))
    results.append(
        {
            "config": 3,
            "case": f"dense_n{n}_d{d}_B{B}_cpu_f64",
            "wall_s": round(dt, 4),
            "problems_per_sec": round(conv / dt, 2),
            "converged_frac": round(conv / B, 4),
            "active_bound_frac": round(act, 3),
        }
    )
    # Device path: mixed-precision pipeline (f32 bulk on the card at full
    # matmul precision + f64 SQP-polish certification).
    from benlsip_tpu.batch.refine import solve_mixed_precision

    dt, (X, Y, info) = _bench(
        lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=B)
    )
    conv = int(jnp.sum(info.converged))
    results.append(
        {
            "config": 3,
            "case": f"dense_n{n}_d{d}_B{B}_pipeline",
            "wall_s": round(dt, 4),
            "problems_per_sec_kkt1e-8": round(conv / dt, 2),
            "converged_frac": round(conv / B, 4),
            "vs_baseline": round((conv / dt) / np_rate, 2),
        }
    )
    # Device-resident certification (round 4): fused f32-factor/f64-chord
    # program, no factor D2H — the config-3 fast path.
    dt, (X, Y, info) = _bench(
        lambda: solve_mixed_precision(bp, theta, X0, opts, chunk=B, certify="device")
    )
    conv = int(jnp.sum(info.converged))
    results.append(
        {
            "config": 3,
            "case": f"dense_n{n}_d{d}_B{B}_pipeline_device_certify",
            "wall_s": round(dt, 4),
            "problems_per_sec_kkt1e-8": round(conv / dt, 2),
            "converged_frac": round(conv / B, 4),
            "vs_baseline": round((conv / dt) / np_rate, 2),
        }
    )
    # Constant-Jacobian cache (the family is linear LSQ): bulk-phase
    # refreshes skip the per-accept JᵀJ GEMM (SolverOptions docstring).
    import dataclasses

    opts_lin = dataclasses.replace(opts, linear_residuals=True)
    dt, (X, Y, info) = _bench(
        lambda: solve_mixed_precision(bp, theta, X0, opts_lin, chunk=B)
    )
    conv = int(jnp.sum(info.converged))
    results.append(
        {
            "config": 3,
            "case": f"dense_n{n}_d{d}_B{B}_pipeline_linearJ",
            "wall_s": round(dt, 4),
            "problems_per_sec_kkt1e-8": round(conv / dt, 2),
            "converged_frac": round(conv / B, 4),
            "vs_baseline": round((conv / dt) / np_rate, 2),
        }
    )


def config4(results, n=4096, d=16384):
    from benlsip_tpu.batch.vmap_solve import BatchedProblem
    from benlsip_tpu.dist.mesh import make_mesh
    from benlsip_tpu.dist.sharded import solve_large_blocked_family
    from benlsip_tpu.solver.options import SolverOptions

    ndev = len(jax.devices())
    block = ndev  # all chips on the residual-block axis
    rng = np.random.default_rng(1)
    dtype = jnp.float32
    J = jnp.asarray((rng.standard_normal((d, n)) / np.sqrt(d)).astype(np.float32))
    x_true = rng.standard_normal(n).astype(np.float32)
    y = J @ jnp.asarray(x_true) + 0.01 * jnp.asarray(rng.standard_normal(d).astype(np.float32))
    A = jnp.asarray((rng.standard_normal((8, n)) / np.sqrt(n)).astype(np.float32))
    theta = {"J": J, "y": y}
    bp = BatchedProblem(
        residuals=lambda x, th: th["J"] @ x - th["y"],
        jac_res=lambda x, th: th["J"],
        A=A,
        b=A @ jnp.asarray(x_true),
        xl=jnp.full(n, -3.0, dtype),
        xu=jnp.full(n, 3.0, dtype),
    )
    mesh = make_mesh(batch=1, block=block)
    opts = SolverOptions(max_outer_iter=8, max_inner_iter=40)
    dt, (x, yl, info) = _bench(
        lambda: solve_large_blocked_family(bp, theta, jnp.zeros(n, dtype), opts, mesh)
    )
    results.append(
        {
            "config": 4,
            "case": f"blocked_n{n}_d{d}_x{block}chips",
            "wall_s": round(dt, 4),
            "converged": bool(info.converged),
            "outer": int(info.outer_iters),
            "inner": int(info.inner_iters),
            "minor_iters": int(info.minor_iters),
            "cg_iters": int(info.cg_iters),
            "sec_per_inner_iter": round(dt / max(int(info.inner_iters), 1), 4),
        }
    )

    # Same instance with the constant-Jacobian cache (the workload IS
    # linear LSQ): the 2dn² refresh GEMM — 88% of device time in the
    # profiler trace — is paid once per subproblem instead of per accept.
    opts_lin = SolverOptions(
        max_outer_iter=8, max_inner_iter=40, linear_residuals=True
    )
    dt, (x, yl, info) = _bench(
        lambda: solve_large_blocked_family(bp, theta, jnp.zeros(n, dtype), opts_lin, mesh)
    )
    results.append(
        {
            "config": 4,
            "case": f"blocked_n{n}_d{d}_x{block}chips_linearJ",
            "wall_s": round(dt, 4),
            "converged": bool(info.converged),
            "outer": int(info.outer_iters),
            "inner": int(info.inner_iters),
            "sec_per_inner_iter": round(dt / max(int(info.inner_iters), 1), 4),
        }
    )


def config5(results, B=16384, full=False):
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    if full:
        B = 102400
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=7, dtype=jnp.float64)

    # Measured single-core numpy baseline on a sample of THIS sweep's
    # instances (seed 7 — not the config-2 seed): per-instance cost is iid,
    # so the sampled rate is the sweep's single-core rate.
    from benlsip_tpu.baselines.numpy_ref import solve_exp_fit_numpy

    k = min(128, B)
    t0 = time.perf_counter()
    _, conv_np = solve_exp_fit_numpy(
        np.asarray(theta["t"][:k]), np.asarray(theta["y"][:k]),
        np.asarray(bp.A), np.asarray(bp.b[:k]),
        np.asarray(bp.xl), np.asarray(bp.xu), np.asarray(X0[:k]),
    )
    np_dt = time.perf_counter() - t0
    np_rate = conv_np / np_dt if conv_np else float("nan")
    results.append(
        {
            "config": 5,
            "case": f"sweep_numpy_baseline_k{k}",
            "wall_s": round(np_dt, 4),
            "problems_per_sec": round(np_rate, 1),
            "converged_frac": round(conv_np / k, 4),
        }
    )

    dt, (X, Y, info) = _bench(lambda: solve_mixed_precision(bp, theta, X0, opts))
    conv = int(jnp.sum(info.converged))
    results.append(
        {
            "config": 5,
            "case": f"sweep_B{B}",
            "wall_s": round(dt, 4),
            "problems_per_sec_kkt1e-8": round(conv / dt, 1),
            "converged_frac": round(conv / B, 4),
            "vs_baseline": round((conv / dt) / np_rate, 1),
        }
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also append the rows to this JSONL file")
    ap.add_argument("--full", action="store_true", help="sweep-scale config 5")
    ap.add_argument("--configs", default="1,2,3,4,5")
    args = ap.parse_args()

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu
    from benlsip_tpu.harness.metrics import MetricsWriter

    device = require_gpu()
    enable_compile_cache()
    wanted = {int(c) for c in args.configs.split(",")}
    w = MetricsWriter(args.out) if args.out else None
    t0 = time.time()
    runners = {1: config1, 2: config2, 3: config3, 4: config4}
    for c in sorted(wanted):
        results = []
        try:
            if c == 5:
                config5(results, full=args.full)
            else:
                runners[c](results)
        except Exception as e:  # keep the suite going; record the failure
            results.append({"config": c, "error": repr(e)[:300]})
        for r in results:
            r["device"] = device
            if w:
                w.write(r)
            print(json.dumps(r), flush=True)
    if w:
        w.close()
    print(f"# suite wall {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
