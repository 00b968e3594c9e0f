"""Mixed-precision pipeline: f32 bulk + f64 refinement reaches the f64 KKT
grade (the BASELINE 1e-8 tolerance) that pure f32 cannot certify."""
import numpy as np
import jax
import jax.numpy as jnp

from benlsip_tpu.batch.refine import refine_f64, solve_mixed_precision
from benlsip_tpu.batch.vmap_solve import solve_batched
from benlsip_tpu.ops.polyproject import projection_polyhedron
from benlsip_tpu.problems.generators import exp_fit_family, sphere_family
from benlsip_tpu.solver.options import SolverOptions


def kkt_measures(bp, theta, X, Y):
    """Exact projected-gradient KKT measure per instance (f64)."""
    n = X.shape[-1]
    poly = bp.polyhedron(n, jnp.float64)

    def one(theta_i, x, y, poly_i):
        fns = bp.instance_fns(theta_i)
        g = fns.jac_res(x).T @ fns.residuals(x) + fns.jac_nlcons(x).T @ y
        p = projection_polyhedron(poly_i, x - g)
        return jnp.linalg.norm(x - p)

    from benlsip_tpu.ops.constraints import Polyhedron

    base = Polyhedron(A=2, b=1, xl=1, xu=1)
    axes = Polyhedron(
        *[0 if getattr(poly, f).ndim > getattr(base, f) else None for f in Polyhedron._fields]
    )
    return jax.vmap(one, in_axes=(0, 0, 0, axes))(theta, X, Y, poly)


def test_mixed_precision_reaches_f64_kkt():
    B = 32
    bp, theta, X0 = sphere_family(B, seed=21)
    opts = SolverOptions(max_outer_iter=100, max_inner_iter=300)
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts, chunk=32)
    assert X.dtype == jnp.float64
    conv = float(jnp.mean(info.converged.astype(jnp.float64)))
    assert conv >= 0.9
    kkt = np.asarray(kkt_measures(bp, theta, X, Y))
    ok = np.asarray(info.converged)
    # Converged instances certify the f64-grade KKT tolerance.
    assert np.all(kkt[ok] < 1e-7), kkt[ok].max()


def test_refinement_is_cheap_warm():
    # From an f32 solution the f64 phase needs very few outer iterations.
    B = 16
    bp, theta, X0 = exp_fit_family(B, d=16, seed=13)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    import dataclasses

    bp32 = dataclasses.replace(
        bp,
        A=None if bp.A is None else bp.A.astype(jnp.float32),
        b=None if bp.b is None else bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32),
        xu=bp.xu.astype(jnp.float32),
    )
    th32 = jax.tree.map(lambda a: a.astype(jnp.float32), theta)
    X32, _, i32 = solve_batched(bp32, th32, X0.astype(jnp.float32), opts)
    X64, Y64, i64 = refine_f64(bp, theta, X32, opts)
    assert float(jnp.mean(i64.converged.astype(jnp.float64))) >= 0.9
    # Refinement outer iterations are few (warm start).
    assert float(jnp.median(i64.outer_iters.astype(jnp.float64))) <= 5


def test_certify_device_plumbing_matches_host():
    # On CPU both certify modes collapse to the same device, but the
    # plumbing (device=None routing + QR auto-selection off-CPU) must
    # produce identical certified results through the public pipeline.
    import jax.numpy as jnp
    import numpy as np

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    B = 32
    bp, theta, X0 = exp_fit_family(B, d=16, seed=13, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    Xh, Yh, ih = solve_mixed_precision(bp, theta, X0, opts, chunk=B, certify="host")
    Xd, Yd, id_ = solve_mixed_precision(bp, theta, X0, opts, chunk=B, certify="device")
    assert bool(np.all(np.asarray(ih.converged)))
    assert bool(np.all(np.asarray(id_.converged)))
    np.testing.assert_allclose(np.asarray(Xd), np.asarray(Xh), rtol=1e-9, atol=1e-11)


def test_pipeline_overlap_matches_default():
    """pipeline_overlap=True (chunk-pipelined bulk/certify, VERDICT r2 #8)
    must be bit-identical to the default path — certification is
    per-instance, so chunking it differently cannot change results.
    Exercises a ragged final chunk (300 = 2*128 + 44)."""
    import jax.numpy as jnp
    import numpy as np

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(300, d=32, seed=5, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X1, Y1, i1 = solve_mixed_precision(bp, theta, X0, opts, chunk=128)
    X2, Y2, i2 = solve_mixed_precision(
        bp, theta, X0, opts, chunk=128, pipeline_overlap=True
    )
    np.testing.assert_array_equal(np.asarray(X1), np.asarray(X2))
    np.testing.assert_array_equal(np.asarray(Y1), np.asarray(Y2))
    np.testing.assert_array_equal(np.asarray(i1.converged), np.asarray(i2.converged))


def test_bf16_bulk_certifies_to_f64_grade():
    """bulk_dtype=bf16 (VERDICT r2 #9): the bulk phase runs its products
    in bf16; certification is unchanged, so the pipeline must still deliver
    f64-KKT-grade results (the bf16 point only needs to land in the
    polish's Newton basin)."""
    import jax.numpy as jnp
    import numpy as np

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(96, d=32, seed=21, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    Xb, Yb, ib = solve_mixed_precision(
        bp, theta, X0, opts, chunk=96, bulk_dtype=jnp.bfloat16
    )
    assert bool(np.all(np.asarray(ib.converged)))
    Xf, Yf, if_ = solve_mixed_precision(bp, theta, X0, opts, chunk=96)
    np.testing.assert_allclose(np.asarray(Xb), np.asarray(Xf), rtol=1e-7, atol=1e-8)


def test_bulk_max_inner_cap_certifies():
    """The lockstep-tail cap (bulk_max_inner) must not change certified
    results — the certification phase absorbs looser bulk solves."""
    import jax.numpy as jnp

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(32, d=32, seed=13, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts, chunk=32, bulk_max_inner=6)
    assert int(jnp.sum(info.converged)) == 32
    X2, Y2, info2 = solve_mixed_precision(bp, theta, X0, opts, chunk=32)
    np.testing.assert_allclose(np.asarray(X), np.asarray(X2), rtol=1e-7, atol=1e-9)


def test_auto_policy_resolution():
    """The measured per-regime policies live in the LIBRARY (VERDICT r4
    #3), not in bench drivers: pin the certify="auto" and
    bulk_max_inner="auto" resolution rules."""
    from benlsip_tpu.batch.refine import (
        _resolve_bulk_max_inner,
        _resolve_certify,
    )

    # certify: accelerator bulk device -> device up to the crossover
    # batch, host beyond it; CPU bulk device -> host always.
    assert _resolve_certify("auto", 1024, 3, "gpu") == "device"    # config 2
    assert _resolve_certify("auto", 64, 192, "gpu") == "device"    # config 3
    assert _resolve_certify("auto", 16384, 3, "gpu") == "host"     # config 5
    assert _resolve_certify("auto", 1024, 3, "cpu") == "host"
    # Explicit choices pass through untouched.
    assert _resolve_certify("host", 64, 192, "gpu") == "host"
    assert _resolve_certify("device", 16384, 3, "gpu") == "device"

    # bulk_max_inner: cap 8 for tiny instances, off for mid-size
    # (config-3 families need their inner iterations), polish-gated.
    assert _resolve_bulk_max_inner("auto", 3, True) == 8
    assert _resolve_bulk_max_inner("auto", 192, True) is None
    assert _resolve_bulk_max_inner("auto", 3, False) is None
    assert _resolve_bulk_max_inner(12, 3, True) == 12
    assert _resolve_bulk_max_inner(None, 3, True) is None


def test_auto_policy_end_to_end_cpu():
    """solve_mixed_precision with all-default (auto) policies certifies
    the config-2 family end-to-end on CPU."""
    import jax.numpy as jnp

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    B = 32
    bp, theta, X0 = exp_fit_family(B, d=32, seed=21, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    X, Y, info = solve_mixed_precision(bp, theta, X0, opts, chunk=B)
    assert int(jnp.sum(info.converged)) == B


def test_auto_bulk_compact_policy():
    """auto stays OFF (chosen on the earlier accelerator; ROADMAP Speed
    item 7 re-measures it); the explicit horizon knob passes through
    untouched."""
    from benlsip_tpu.batch.refine import _resolve_bulk_compact

    assert _resolve_bulk_compact("auto", 16384, 512, True) is None
    assert _resolve_bulk_compact("auto", 1024, 512, True) is None
    assert _resolve_bulk_compact(3, 1024, 512, True) == 3
    assert _resolve_bulk_compact(2, 16384, 512, True) == 2
    assert _resolve_bulk_compact(None, 16384, 512, True) is None


def test_auto_fuse_policy():
    """fuse='auto' engages the whole-pipeline fusion only when device
    certification is the resolved path and every bulk knob is at a
    fused-covered default (round 5: +36% measured at config-2)."""
    import jax.numpy as jnp

    from benlsip_tpu.batch.refine import _resolve_fuse

    base = dict(n=3, polish=True, sort_by_difficulty=False,
                pipeline_overlap=False, bulk_dtype=jnp.float32,
                bulk_matmul_precision=None, bulk_compact=None,
                bulk_crit_tol=1e-2)
    assert _resolve_fuse("auto", **base) is True
    assert _resolve_fuse("auto", **{**base, "n": 192}) is False  # config 3: measured loss
    assert _resolve_fuse("auto", **{**base, "polish": False}) is False
    assert _resolve_fuse("auto", **{**base, "bulk_compact": 2}) is False
    assert _resolve_fuse("auto", **{**base, "bulk_matmul_precision": "default"}) is False
    assert _resolve_fuse("auto", **{**base, "bulk_crit_tol": None}) is False
    assert _resolve_fuse(False, **base) is False
    assert _resolve_fuse(True, **{**base, "polish": False}) is True
