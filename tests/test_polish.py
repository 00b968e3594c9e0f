"""Warm-start SQP polish (batch/polish.py): certification soundness,
agreement with the full f64 refine, and the fallback path for bad warm
starts.  The polish replaces the full-TRALCNLLS f64 refine as the default
certification phase of the mixed-precision pipeline."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from benlsip_tpu.batch.polish import polish_then_refine, sqp_polish
from benlsip_tpu.batch.refine import refine_f64, solve_mixed_precision
from benlsip_tpu.batch.vmap_solve import solve_batched
from benlsip_tpu.problems.generators import exp_fit_family, sphere_family
from benlsip_tpu.solver.options import SolverOptions

from test_refine import kkt_measures


def _bulk_f32(bp, theta, X0, opts):
    bp32 = dataclasses.replace(
        bp,
        A=None if bp.A is None else bp.A.astype(jnp.float32),
        b=None if bp.b is None else bp.b.astype(jnp.float32),
        xl=None if bp.xl is None else bp.xl.astype(jnp.float32),
        xu=None if bp.xu is None else bp.xu.astype(jnp.float32),
    )
    th32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        theta,
    )
    X32, _, _ = solve_batched(bp32, th32, X0.astype(jnp.float32), opts)
    return X32


def test_polish_certifies_f64_kkt():
    B = 32
    bp, theta, X0 = exp_fit_family(B, d=16, seed=7, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X32 = _bulk_f32(bp, theta, X0, opts)
    X, Y, info = polish_then_refine(bp, theta, X32, opts)
    assert X.dtype == jnp.float64
    assert bool(jnp.all(info.converged))
    # The certification is the exact-projection KKT oracle: re-check it
    # independently, plus feasibility of every constraint block.
    kkt = np.asarray(kkt_measures(bp, theta, X, Y))
    assert np.all(kkt < 1.5e-8), kkt.max()
    poly = bp.polyhedron(X.shape[-1], jnp.float64)
    assert np.all(np.asarray(X) >= np.asarray(poly.xl) - 1e-12)
    assert np.all(np.asarray(X) <= np.asarray(poly.xu) + 1e-12)


def test_polish_matches_full_refine():
    B = 16
    bp, theta, X0 = sphere_family(B, seed=3)
    opts = SolverOptions(max_outer_iter=100, max_inner_iter=300)
    X32 = _bulk_f32(bp, theta, X0, opts)
    Xp, Yp, ip = polish_then_refine(bp, theta, X32, opts)
    Xr, Yr, ir = refine_f64(bp, theta, X32, opts)
    ok = np.asarray(ip.converged) & np.asarray(ir.converged)
    assert ok.mean() >= 0.9
    # Both certify KKT ≤ 1.5e-8; the solutions agree to the x-space
    # resolution that tolerance implies.
    assert np.max(np.abs(np.asarray(Xp - Xr))[ok]) < 1e-5


def test_polish_fallback_on_cold_start():
    # A cold start defeats the fixed-active-set Newton polish; the
    # certification must catch it and the fallback (full refine) must still
    # deliver converged f64 results.
    B = 8
    bp, theta, X0 = exp_fit_family(B, d=16, seed=11, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=60, max_inner_iter=200)
    X_cold = X0 + 0.5  # far from any solution
    X, Y, info = polish_then_refine(
        bp, theta, X_cold.astype(jnp.float32), opts, fallback_pad=4
    )
    conv = float(jnp.mean(info.converged.astype(jnp.float64)))
    assert conv >= 0.9
    kkt = np.asarray(kkt_measures(bp, theta, X, Y))
    ok = np.asarray(info.converged)
    assert np.all(kkt[ok] < 1.5e-8)


def test_mixed_precision_polish_default():
    # solve_mixed_precision uses the polish path by default and still
    # certifies every instance of the smooth family.
    B = 16
    bp, theta, X0 = exp_fit_family(B, d=16, seed=5, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts, chunk=16)
    assert bool(jnp.all(info.converged))
    assert float(jnp.max(info.pix)) < 1.5e-8


def test_sqp_polish_active_bounds():
    # Instances whose solution sits ON a bound: the active-set
    # identification must fix the right variables and the polished point
    # must stay exactly on the bound.
    B = 8
    bp, theta, X0 = exp_fit_family(B, d=16, seed=19, dtype=jnp.float64)
    # Tighten the upper bound below the unconstrained optimum of x_0.
    opts = SolverOptions(max_outer_iter=60, max_inner_iter=200)
    Xfree, _, _ = solve_batched(bp, theta, X0, opts)
    xu = np.asarray(bp.xu).copy()
    xu[0] = float(np.median(np.asarray(Xfree[:, 0]))) - 1e-3
    bp2 = dataclasses.replace(bp, xu=jnp.asarray(xu))
    X32 = _bulk_f32(bp2, theta, X0, opts)
    X, Y, info = polish_then_refine(bp2, theta, X32, opts, fallback_pad=4)
    conv = np.asarray(info.converged)
    assert conv.mean() >= 0.9
    at_bound = np.abs(np.asarray(X[:, 0]) - xu[0]) < 1e-12
    # Converged instances whose free optimum exceeded the new bound sit
    # exactly on it.
    exceeded = np.asarray(Xfree[:, 0]) > xu[0]
    assert np.all(at_bound[exceeded & conv])
    kkt = np.asarray(kkt_measures(bp2, theta, X, Y))
    assert np.all(kkt[conv] < 1.5e-8)


def test_mixed_precision_dense_family():
    # Regression: dense_quadratic_family closes over a shared J; the f32
    # bulk phase must see a consistent dtype (J used to stay f64 and broke
    # the lax.cond branches in the TR body).
    B = 8
    from benlsip_tpu.problems.generators import dense_quadratic_family

    bp, theta, X0 = dense_quadratic_family(B, n=24, d=64, m=3, seed=2)
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts, chunk=8)
    assert float(jnp.mean(info.converged.astype(jnp.float64))) >= 0.9


def test_polish_frozen_lu_matches_per_step_refactor():
    # refactor_steps >= num_steps reproduces the rebuild-every-step polish;
    # the default frozen-LU path (refactor_steps=2) must certify the same
    # instances and land within the KKT tolerance's x-resolution of it.
    B = 24
    bp, theta, X0 = exp_fit_family(B, d=16, seed=11, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X32 = _bulk_f32(bp, theta, X0, opts)
    X64 = X32.astype(jnp.float64)
    Xf, Yf, okf, pixf, _, _ = sqp_polish(bp, theta, X64, opts, num_steps=5,
                                         refactor_steps=2)
    Xe, Ye, oke, pixe, _, _ = sqp_polish(bp, theta, X64, opts, num_steps=5,
                                         refactor_steps=5)
    assert bool(jnp.all(okf)) and bool(jnp.all(oke))
    assert np.max(np.abs(np.asarray(Xf - Xe))) < 1e-6
    assert float(jnp.max(pixf)) < 1.5e-8


def test_split_polish_matches_host_polish():
    # sqp_polish_split (f32 factor phase + f64 chord/certification with the
    # promoted factors — mixed-precision iterative refinement of the KKT
    # system) must certify the same instances as the all-f64 host polish
    # and land within the KKT tolerance's x-resolution of it.
    from benlsip_tpu.batch.polish import sqp_polish_split
    from benlsip_tpu.problems.generators import dense_quadratic_family

    B = 8
    bp, theta, X0 = dense_quadratic_family(B, n=96, d=384, m=3, seed=9)
    opts = SolverOptions(max_outer_iter=20, max_inner_iter=80)
    bulk = SolverOptions(max_outer_iter=20, max_inner_iter=80, crit_tol=1e-2)
    X32 = _bulk_f32(bp, theta, X0, bulk)
    bp32 = dataclasses.replace(
        bp,
        A=bp.A.astype(jnp.float32), b=bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32), xu=bp.xu.astype(jnp.float32),
    )
    th32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        theta,
    )
    Xs, Ys, oks, pixs, feass, _ = sqp_polish_split(
        bp32, th32, X32, bp, theta, opts, num_steps=5
    )
    Xh, Yh, okh, pixh, _, _ = sqp_polish(bp, theta, X32.astype(jnp.float64), opts,
                                         num_steps=5)
    assert Xs.dtype == jnp.float64
    assert bool(jnp.all(oks)), np.asarray(pixs)
    assert bool(jnp.all(okh))
    assert float(jnp.max(pixs)) < 1.5e-8
    assert np.max(np.abs(np.asarray(Xs - Xh))) < 1e-6


def test_fused_polish_parity_with_plain():
    """The one-dispatch fused certification (f32 QR factors + f64 mixed
    chord, batch/polish.sqp_polish_fused — the device path) certifies the
    same instances to the same X/Y as the all-f64 sqp_polish on CPU."""
    from benlsip_tpu.batch.polish import sqp_polish_fused
    from benlsip_tpu.batch.refine import _cast_tree
    from benlsip_tpu.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu.problems.generators import dense_quadratic_family

    B, n, d = 16, 96, 256
    bp, theta, X0 = dense_quadratic_family(B, n=n, d=d, m=4, seed=5)
    opts = SolverOptions(max_outer_iter=30, max_inner_iter=100)
    theta32 = _cast_tree(theta, jnp.float32)
    bp32 = dataclasses.replace(
        bp, A=bp.A.astype(jnp.float32), b=bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32), xu=bp.xu.astype(jnp.float32))
    X32, _, _ = solve_batched_chunked(
        bp32, theta32, X0.astype(jnp.float32),
        dataclasses.replace(opts, crit_tol=1e-2), chunk=B)
    Xf, Yf, okf, pixf, feasf, _ = sqp_polish_fused(
        bp32, theta32, X32, bp, theta, opts, num_steps=5, rounds=2)
    assert bool(jnp.all(okf)), (int(okf.sum()), float(pixf.max()))
    Xp, Yp, okp, *_ = sqp_polish(bp, theta, X32.astype(jnp.float64), opts, num_steps=5)
    both = okf & okp
    np.testing.assert_allclose(
        np.asarray(Xf)[np.asarray(both)], np.asarray(Xp)[np.asarray(both)],
        rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(Yf)[np.asarray(both)], np.asarray(Yp)[np.asarray(both)],
        rtol=1e-6, atol=1e-8)


def test_bulk_matmul_precision_knob_end_to_end():
    """bulk_matmul_precision="default" (TF32 products on the GPU) still certifies
    through the pipeline — wrong bulk answers cost fallback time, never
    accuracy (on CPU the knob is a no-op numerically; this pins the
    plumbing end-to-end)."""
    bp, theta, X0 = exp_fit_family(32, d=32, seed=9, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X, Y, info = solve_mixed_precision(
        bp, theta, X0, opts, chunk=32, bulk_matmul_precision="default")
    assert int(jnp.sum(info.converged)) == 32


def test_fused_straggler_bucket_compaction():
    """The fused path's re-polish passes gather at most straggler_bucket
    lanes (VERDICT r4 #4): with a bucket smaller than the straggler count,
    round-robin bucketed passes must still serve every straggler, and the
    result must match a full-width-bucket run."""
    from benlsip_tpu.batch.polish import sqp_polish_fused
    from benlsip_tpu.batch.refine import _cast_tree
    from benlsip_tpu.problems.generators import exp_fit_family

    B = 32
    bp, theta, X0 = exp_fit_family(B, d=32, seed=13, dtype=jnp.float64)
    theta32 = _cast_tree(theta, jnp.float32)
    bp32 = dataclasses.replace(
        bp, A=bp.A.astype(jnp.float32), b=bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32), xu=bp.xu.astype(jnp.float32))
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    # Cold start far from the solution with a thin step budget: pass 1
    # leaves a real straggler population for the bucketed passes.
    X32 = X0.astype(jnp.float32)
    kw = dict(num_steps=3, refactor_steps=2, rounds=4)
    X_small, Y_small, ok_small, *_ = sqp_polish_fused(
        bp32, theta32, X32, bp, theta, opts, straggler_bucket=4, **kw)
    X_full, Y_full, ok_full, *_ = sqp_polish_fused(
        bp32, theta32, X32, bp, theta, opts, straggler_bucket=B, **kw)
    # The bucketed run must not certify FEWER lanes than the full-width
    # run (every straggler gets its rounds-1 re-polishes either way,
    # albeit over more passes).
    assert int(ok_small.sum()) >= int(ok_full.sum()) > 0, (
        int(ok_small.sum()), int(ok_full.sum()))
    both = np.asarray(ok_small & ok_full)
    np.testing.assert_allclose(
        np.asarray(X_small)[both], np.asarray(X_full)[both],
        rtol=1e-7, atol=1e-9)


def test_fallback_stall_restart_rescue():
    """Config-5 uncertified-tail fixture (round 5, instance 9996 of the
    seed-7 sweep): a near-degenerate exponential (slow decay => a/b/c
    collinearity) whose f32 bulk stalls on a wrong point, whose polish
    chord Newton diverges to a box corner, and whose fallback refine then
    stalls with an over-escalated penalty.  The one-shot stall-restart
    rescue in polish_then_refine must certify it."""
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family

    # Reconstruct the exact instance from the family (cheap) rather than
    # a transcribed-constant fixture that could drift from the generator.
    bp, theta, X0 = exp_fit_family(16384, d=32, seed=7, dtype=jnp.float64)
    i = 9996
    bp_i = dataclasses.replace(bp, b=bp.b[i : i + 1])
    th_i = jax.tree.map(lambda a: a[i : i + 1], theta)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X, Y, info = solve_mixed_precision(bp_i, th_i, X0[i : i + 1], opts, chunk=1)
    assert bool(info.converged[0]), (float(info.pix[0]), int(info.status[0]))
    assert float(info.pix[0]) <= 1.5e-8


def test_whole_pipeline_fusion_parity():
    """solve_small_fused (one-dispatch bulk+certify, batch/fused_small.py)
    certifies the config-2 family end-to-end and matches the standard
    device-certify pipeline's solutions."""
    from benlsip_tpu.batch.fused_small import solve_small_fused
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family

    B = 48
    bp, theta, X0 = exp_fit_family(B, d=32, seed=17, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    Xf, Yf, inf_f = solve_small_fused(bp, theta, X0, opts, chunk=16)
    assert int(inf_f.converged.sum()) == B, (
        int(inf_f.converged.sum()), float(inf_f.pix.max()))
    assert float(inf_f.pix.max()) <= 1.5e-8
    X, Y, info = solve_mixed_precision(
        bp, theta, X0, opts, chunk=16, certify="device", bulk_max_inner=8,
        fuse=False)
    np.testing.assert_allclose(np.asarray(Xf), np.asarray(X), rtol=1e-6, atol=1e-8)
