"""Benchmark harness: batched constrained-NLS throughput to f64 KKT grade,
vs a tight single-core CPU baseline standing in for the reference's
execution model.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "problems/sec", "vs_baseline": N, ...}

Workload: BASELINE config 2 — a batch of independent small NLS instances
(n=3 exponential curve fits, box bounds + a per-instance linear equality).
The timed pipeline is the mixed-precision solve: f32 bulk phase on the
GPU + f64 certification (on the GPU or the host, per
`certify="auto"`; see batch/refine.py), counting instances that
converge to the f64 tolerance sqrt(eps) ≈ 1.49e-8 — the reference's own
"solved" definition, making the comparison KKT-comparable.

The reference (BEnlsip.jl) publishes no numbers and Julia is not installed
in this image (BASELINE.md), so `vs_baseline` is measured against a tight
hand-coded single-core numpy solver of the same workload certified by the
same exact-projection KKT oracle (benlsip_tpu/baselines/numpy_ref.py) —
dense direct linear algebra, dynamic shapes, zero framework dispatch: the
way a performance-aware user of the reference would write it.  Two
secondary ratios are co-reported per VERDICT round 1: the same JAX solver
run sequentially one instance at a time (the round-1 "baseline", now
demoted), and this framework's own CPU-batched pipeline (the strongest
single-host alternative).

Fails without a GPU; the JSON line carries the device record.
"""
from __future__ import annotations

import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp


def _time_pipeline(bp, theta, X0, opts, device, chunk=512, certify="auto",
                   bulk_max_inner="auto", bulk_compact="auto", fuse="auto"):
    """Mixed-precision pipeline: f32 bulk on `device`, f64 certification.

    Master f64 data stays host-resident (the production layout); the
    pipeline ships the f32 working copy to the chip and pulls back only the
    f32 solutions — that data movement is inside the timed region.
    """
    from benlsip_tpu.batch.refine import solve_mixed_precision

    # Warmup (compile both phases).  No difficulty sorting here: the pilot
    # run is a second compiled program.
    X, Y, info = solve_mixed_precision(
        bp, theta, X0, opts, chunk=chunk, bulk_device=device, certify=certify,
        bulk_max_inner=bulk_max_inner, bulk_compact=bulk_compact, fuse=fuse,
    )
    jax.block_until_ready((X, Y, info))
    # Best of 3 timed reps: min-wall is the noise-robust estimator of the
    # pipeline's cost.
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        X, Y, info = solve_mixed_precision(
            bp, theta, X0, opts, chunk=chunk, bulk_device=device, certify=certify,
            bulk_max_inner=bulk_max_inner, bulk_compact=bulk_compact, fuse=fuse,
        )
        jax.block_until_ready((X, Y, info))
        walls.append(time.perf_counter() - t0)
    conv = int(jnp.sum(info.converged))
    return min(walls), conv, walls, X


def _time_numpy_baseline(bp, theta, X0, k):
    """Tight single-core numpy solve of k instances (the measured baseline).

    numpy is single-threaded here for small (32x3) shapes (OpenBLAS kicks in
    threads only far above this size), matching "single-core Julia" in
    BASELINE.md's target definition.
    """
    import numpy as np

    from benlsip_tpu.baselines.numpy_ref import solve_exp_fit_numpy

    t_np = np.asarray(theta["t"][:k])
    y_np = np.asarray(theta["y"][:k])
    b_np = np.asarray(bp.b[:k])
    X0_np = np.asarray(X0[:k])
    # Constraint data comes from the SAME family the pipeline solves — a
    # hand-retyped copy here would silently decouple the baseline problem
    # from the benchmarked one if exp_fit_family ever changes.
    A_np = np.asarray(bp.A)
    xl = np.asarray(bp.xl)
    xu = np.asarray(bp.xu)
    # Best of 3, like the pipeline timing: min() on BOTH sides is
    # symmetric — and conservative for the ratio, since it credits the
    # baseline its fastest run too.
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, conv = solve_exp_fit_numpy(t_np, y_np, A_np, b_np, xl, xu, X0_np)
        walls.append(time.perf_counter() - t0)
    return min(walls), conv


def _time_sequential_cpu(bp, theta, X0, opts, k):
    """Sequential per-instance solves on CPU (the reference's model)."""
    from benlsip_tpu.batch.vmap_solve import solve_sequential

    cpu = jax.devices("cpu")[0]
    sub = jax.tree.map(lambda a: jax.device_put(a[:k], cpu), theta)
    X0s = jax.device_put(X0[:k], cpu)
    with jax.default_device(cpu):
        # Warmup: one instance compiles the single-solve program.
        solve_sequential(bp, jax.tree.map(lambda a: a[:1], sub), X0s[:1], opts)
        t0 = time.perf_counter()
        X, Y, info = solve_sequential(bp, sub, X0s, opts)
        jax.block_until_ready(X)
        dt = time.perf_counter() - t0
    conv = int(jnp.sum(info.converged))
    return dt, conv


def _config3_summary(dev):
    """Config-3 (dense n=192, d=1024, B=64) rate + measured numpy baseline.

    Grounds the mid-size regime's vs_baseline in the SAME headline JSON
    line the driver records (VERDICT r2 item 1): the baseline is the
    single-core numpy active-set solver on a sample of the same workload.
    """
    import numpy as np

    from benlsip_tpu.baselines.numpy_ref import solve_dense_lsq_numpy
    from benlsip_tpu.problems.generators import dense_quadratic_family
    from benlsip_tpu.solver.options import SolverOptions

    B, n, d = 64, 192, 1024
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    bp, theta, X0 = dense_quadratic_family(B, n=n, d=d, m=6, seed=3)
    # certify="auto" resolves to the device path here (fused
    # f32-factor/f64-chord, no factor D2H).  The explicit host row stays
    # as the comparison.
    dt, conv, _, X3 = _time_pipeline(bp, theta, X0, opts, dev, chunk=B)
    rate = conv / dt
    dt_h, conv_h, _, _ = _time_pipeline(bp, theta, X0, opts, dev, chunk=B, certify="host")

    k = 8
    J_np = np.asarray(bp.jac_res(X0[0], jax.tree.map(lambda a: a[0], theta)))
    np_walls = []
    for _ in range(3):  # best-of-3, symmetric with the pipeline timing
        t0 = time.perf_counter()
        _, conv_np = solve_dense_lsq_numpy(
            J_np, np.asarray(theta["y"][:k]), np.asarray(bp.A), np.asarray(bp.b),
            np.asarray(bp.xl), np.asarray(bp.xu), np.asarray(X0[:k]),
        )
        np_walls.append(time.perf_counter() - t0)
    np_dt = min(np_walls)
    np_rate = max(conv_np, 1) / np_dt
    from benlsip_tpu.baselines.kkt_oracle import kkt_cross_check_batch

    orc = kkt_cross_check_batch(bp, theta, X3, sample=64, seed=3)  # all 64
    return {
        "config3_rate": round(rate, 2),
        "config3_wall_s": round(dt, 3),
        "config3_converged_frac": round(conv / B, 4),
        "config3_baseline_rate": round(np_rate, 3),
        "config3_baseline_converged_frac": round(conv_np / k, 4),
        "config3_vs_baseline": round(rate / np_rate, 1),
        "config3_certify": "auto(device)",
        "config3_host_rate": round(conv_h / dt_h, 2),
        "config3_oracle_agree_frac": orc["oracle_agree_frac"],
    }


def _config4_summary(dev, n=10240, d=20480):
    """Config-4 hardened workload (VERDICT r4 #5): one large NONLINEAR
    bound-active instance (r(x) = J0·psi(x) − y, psi cubic, ~50% of
    coordinates active at the solution, 10+ TR iterations with Cauchy
    breakpoints / minor-loop churn / CG bound-hits — the round-4 linear
    instance converged in 2 outer / 4 inner and exercised none of that).

    Framework numbers are measured every run; the single-core numpy
    baseline's FULL-solve wall (20+ min at this scale) is measured by the
    one-off protocol recorded in BASELINE.md, while a budget-capped
    baseline run here grounds the per-inner-iteration comparison in the
    same session.
    """
    import numpy as np

    from benlsip_tpu.baselines.kkt_oracle import kkt_check_blocked_hard
    from benlsip_tpu.baselines.numpy_ref import solve_blocked_numpy
    from benlsip_tpu.dist.mesh import make_mesh
    from benlsip_tpu.dist.sharded import solve_large_blocked_family
    from benlsip_tpu.problems.generators import blocked_hard_family
    from benlsip_tpu.solver.options import SolverOptions

    alpha = 1.5
    bp, theta, x0 = blocked_hard_family(n=n, d=d, seed=0, dtype=jnp.float32)
    mesh = make_mesh(batch=1, block=1)
    opts = SolverOptions(max_outer_iter=20, max_inner_iter=60)

    def run():
        x, yl, info = solve_large_blocked_family(bp, theta, x0, opts, mesh)
        jax.block_until_ready((x, yl, info))
        return x, info

    x, info = run()  # warmup/compile
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        x, info = run()
        walls.append(time.perf_counter() - t0)
    wall = min(walls)
    inner = int(info.inner_iters)

    # Independent oracle at f32 grade: config 4 solves in f32.
    orc = kkt_check_blocked_hard(bp, theta, x, alpha=alpha, tol=5e-4)
    act = orc["active_frac"]
    J0 = np.asarray(theta["J"], np.float64)
    y64 = np.asarray(theta["y"], np.float64)

    # Budget-capped single-core baseline on the SAME instance: per-inner
    # cost measured live (full-solve wall: BASELINE.md one-off protocol).
    t0 = time.perf_counter()
    _, st = solve_blocked_numpy(
        J0, y64, np.asarray(bp.A, np.float64), np.asarray(bp.b, np.float64),
        np.asarray(bp.xl, np.float64), np.asarray(bp.xu, np.float64),
        np.asarray(x0, np.float64), alpha=alpha, max_outer=1, max_inner=5,
    )
    np_wall = time.perf_counter() - t0
    return {
        "config4_case": f"blocked_hard_n{n}_d{d}",
        "config4_wall_s": round(wall, 2),
        "config4_converged": bool(info.converged),
        "config4_outer": int(info.outer_iters),
        "config4_inner": inner,
        "config4_minor": int(info.minor_iters),
        "config4_cg": int(info.cg_iters),
        "config4_sec_per_inner_iter": round(wall / max(inner, 1), 4),
        "config4_pix": float(info.pix),
        "config4_active_frac": round(act, 3),
        "config4_oracle_ok": bool(orc["ok"]),
        "config4_oracle_grade": "f32 (5e-4 tolerances: the blocked solve runs in f32)",
        "config4_baseline_sec_per_inner_iter": round(np_wall / max(st["inner"], 1), 3),
        "config4_vs_baseline_per_inner": round(
            (np_wall / max(st["inner"], 1)) / (wall / max(inner, 1)), 1
        ),
        # Full-solve baseline wall from the one-off protocol (same
        # instance/seed, solve_blocked_numpy to f64 KKT grade on the
        # earlier benchmark host: 181.0 s, 6 outer / 55 inner / 539 CG,
        # BASELINE.md).  Not re-measured on this host (ROADMAP Speed 2).
        "config4_baseline_full_wall_s_recorded": 181.0,
        "config4_vs_baseline": round(181.0 / wall, 1),
    }


def _config5_summary(dev, B=16384):
    """Config-5 sweep rate + measured numpy baseline on ITS instances."""
    import numpy as np

    from benlsip_tpu.baselines.numpy_ref import solve_exp_fit_numpy
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=7, dtype=jnp.float64)
    # All-auto policies: bulk_max_inner resolves to the measured cap 8
    # (n=3 family), certify resolves per the B-threshold rule.
    dt, conv, _, X5 = _time_pipeline(bp, theta, X0, opts, dev)
    rate = conv / dt
    # Comparative row: the fused device certification with the round-5
    # straggler-bucket compaction at sweep scale (the pre-compaction
    # device path lost 3x here; this row measures whether the fix flips
    # the auto threshold).
    dt_d, conv_d, _, _ = _time_pipeline(bp, theta, X0, opts, dev, certify="device",
                                        fuse=False)
    # Explicit compaction row (auto keeps it OFF: see
    # _resolve_bulk_compact).
    dt_k, conv_k, _, _ = _time_pipeline(bp, theta, X0, opts, dev, bulk_compact=2)

    k = 64
    np_walls = []
    for _ in range(3):  # best-of-3, symmetric with the pipeline timing
        t0 = time.perf_counter()
        _, conv_np = solve_exp_fit_numpy(
            np.asarray(theta["t"][:k]), np.asarray(theta["y"][:k]),
            np.asarray(bp.A), np.asarray(bp.b[:k]),
            np.asarray(bp.xl), np.asarray(bp.xu), np.asarray(X0[:k]),
        )
        np_walls.append(time.perf_counter() - t0)
    np_dt = min(np_walls)
    np_rate = max(conv_np, 1) / np_dt
    from benlsip_tpu.baselines.kkt_oracle import kkt_cross_check_batch

    orc = kkt_cross_check_batch(bp, theta, X5, sample=256, seed=5)
    return {
        "config5_rate": round(rate, 1),
        "config5_batch": B,
        "config5_converged_frac": round(conv / B, 4),
        "config5_baseline_rate": round(np_rate, 1),
        "config5_vs_baseline": round(rate / np_rate, 1),
        "config5_device_certify_rate": round(conv_d / dt_d, 1),
        "config5_device_converged_frac": round(conv_d / B, 4),
        "config5_compact_rate": round(conv_k / dt_k, 1),
        "config5_compact_converged_frac": round(conv_k / B, 4),
        "config5_oracle_agree_frac": orc["oracle_agree_frac"],
    }


def main():
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    B = 1024
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu

    device = require_gpu()
    enable_compile_cache()
    # f64 master data; the pipeline casts to f32 for the bulk phase.
    bp, theta, X0 = exp_fit_family(B, d=32, seed=42, dtype=jnp.float64)
    dev = jax.devices()[0]

    # All-auto policies (VERDICT r4 #3): bulk_max_inner="auto" resolves to
    # the measured cap 8 on this n=3 family; certify="auto" resolves to
    # device at B=1024.  Explicit host row kept as the comparison.
    dt_b, conv_b, walls, X_d = _time_pipeline(bp, theta, X0, opts, dev,
                                              certify="host")
    rate = conv_b / dt_b

    # certify="auto" resolves to device here, and fuse="auto" engages the
    # whole-pipeline fusion (batch/fused_small.py: ONE dispatch from f32
    # bulk to certified f64).
    dt_d, conv_d, _, _ = _time_pipeline(bp, theta, X0, opts, dev)
    rate_dev = conv_d / dt_d
    # Unfused device-certify comparison row.
    dt_u, conv_u, _, _ = _time_pipeline(bp, theta, X0, opts, dev,
                                        certify="device", fuse=False)

    # Converged-instance compaction (VERDICT r4 #1): wide chunks stop at
    # the outer horizon 2 (p99 of the family's outer distribution is 3);
    # the tail finishes in narrow buckets.  Auto keeps it OFF; this row
    # forces horizon 2 and disables fusion, which auto would otherwise
    # route around the compaction knob.
    compact_row = {}
    try:
        dt_k, conv_k, _, _ = _time_pipeline(bp, theta, X0, opts, dev,
                                            bulk_compact=2, fuse=False,
                                            certify="host")
        compact_row = {
            "compact_rate": round(conv_k / dt_k, 2),
            "compact_converged_frac": round(conv_k / B, 4),
        }
    except Exception as e:  # pragma: no cover
        compact_row = {"compact_error": repr(e)[:200]}

    # Primary baseline: tight single-core numpy (the reference's execution
    # model, measured — VERDICT round 1 item 3).
    k_np = 64
    dt_np, conv_np = _time_numpy_baseline(bp, theta, X0, k_np)
    np_rate = max(conv_np, 1) / dt_np

    # Secondary: this framework's own pipeline with the bulk phase on CPU —
    # the strongest single-host alternative actually available.
    cpu = jax.devices("cpu")[0]
    dt_c, conv_c, _, _ = _time_pipeline(bp, theta, X0, opts, cpu)
    cpu_rate = conv_c / dt_c

    # Secondary: the round-1 strawman (JAX solver one instance at a time).
    k = 8
    dt_s, conv_s = _time_sequential_cpu(bp, theta, X0, opts, k)
    seq_rate = max(conv_s, 1) / dt_s

    # Independent first-principles KKT oracle on a sample of the certified
    # solutions (VERDICT r3 #6, widened per r4 #6): numpy-lstsq KKT
    # conditions, sharing no code with the exact-projection certificate.
    oracle = {}
    try:
        from benlsip_tpu.baselines.kkt_oracle import (
            kkt_check_classic_battery,
            kkt_cross_check_batch,
        )

        oracle = kkt_cross_check_batch(bp, theta, X_d, sample=128)
        # The classic HS/MGH battery through the same zero-shared-code
        # oracle (host numpy; ~10 s warm-cache).
        oracle.update(kkt_check_classic_battery())
    except Exception as e:  # pragma: no cover - keep the headline alive
        oracle = {"oracle_error": repr(e)[:200]}

    # Configs 3 and 5 with their own measured baselines, folded into the
    # headline line so the driver-recorded BENCH json carries all three
    # grounded ratios.
    extra = {}
    try:
        extra.update(_config3_summary(dev))
    except Exception as e:  # pragma: no cover - keep the headline alive
        extra["config3_error"] = repr(e)[:200]
    try:
        extra.update(_config5_summary(dev))
    except Exception as e:  # pragma: no cover
        extra["config5_error"] = repr(e)[:200]
    try:
        extra.update(_config4_summary(dev))
    except Exception as e:  # pragma: no cover
        extra["config4_error"] = repr(e)[:200]

    # Headline = the faster of the two certification pipelines (same
    # workload, same f64 KKT certification either way); both are reported.
    best_rate, best_conv = (rate, conv_b) if rate >= rate_dev else (rate_dev, conv_d)
    print(
        json.dumps(
            {
                "metric": "constrained-NLS problems solved/sec to f64 KKT tol 1.5e-8 (config-2 suite; f32 bulk + f64 certify)",
                "value": round(best_rate, 2),
                "unit": "problems/sec",
                "vs_baseline": round(best_rate / np_rate, 2),
                "pipeline": "host" if rate >= rate_dev else "device",
                "host_certify_rate": round(rate, 2),
                "batch": B,
                "converged_frac": round(best_conv / B, 4),
                "pipeline_wall_s": round(dt_b, 3),
                "pipeline_walls_all_reps_s": [round(w, 3) for w in walls],
                "device_certify_rate": round(rate_dev, 2),
                "device_certify_wall_s": round(dt_d, 3),
                "device_certify_converged_frac": round(conv_d / B, 4),
                "device_certify_path": "fused (one-dispatch bulk+certify)",
                "device_unfused_rate": round(conv_u / dt_u, 2),
                **compact_row,
                "baseline": "tight single-core numpy AL-LM solver, same workload + KKT oracle (Julia unavailable; see BASELINE.md)",
                "baseline_rate": round(np_rate, 2),
                "baseline_converged_frac": round(conv_np / k_np, 4),
                "self_cpu_batched_rate": round(cpu_rate, 2),
                "vs_self_cpu_batched": round(rate / cpu_rate, 2),
                "sequential_jax_rate": round(seq_rate, 3),
                "vs_sequential_jax": round(rate / seq_rate, 2),
                "device": device,
                **oracle,
                **extra,
            }
        )
    )


if __name__ == "__main__":
    main()
