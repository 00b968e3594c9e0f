"""The QR-based Gauss-Newton path (BASELINE north-star "QR+PCG"):

* ops/qr.py dispatchers (thin_qr / qr_r) vs numpy ground truth,
* the R-factor Hessian operator (`with_r_factor`) vs the Gram operator
  and the dense materialization,
* QR vs Cholesky least-squares multipliers,
* end-to-end solver parity gn_factorization="qr" vs "normal",
* the payoff case: the range-space QR polish factorization certifying
  ill-conditioned instances the assembled-KKT LU cannot (f32 factors,
  kappa(J) = 1e4).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from benlsip_tpu.ops.al import AlHessian, hv, vhv, with_gram, with_r_factor
from benlsip_tpu.ops.qr import qr_r, thin_qr
from benlsip_tpu.solver.multipliers import least_squares_multipliers
from benlsip_tpu.solver.options import SolverOptions


def test_thin_qr_matches_numpy():
    rng = np.random.default_rng(0)
    S = rng.standard_normal((24, 5))
    Q, R = thin_qr(jnp.asarray(S))
    np.testing.assert_allclose(np.asarray(Q) @ np.asarray(R), S, atol=1e-12)
    np.testing.assert_allclose(np.asarray(Q).T @ np.asarray(Q), np.eye(5), atol=1e-12)
    Ronly = qr_r(jnp.asarray(S))
    np.testing.assert_allclose(
        np.asarray(Ronly).T @ np.asarray(Ronly), S.T @ S, atol=1e-10
    )


def test_thin_qr_vmap_parity():
    # The batched factorization XLA runs under vmap must agree with a
    # per-instance loop.
    rng = np.random.default_rng(1)
    S = jnp.asarray(rng.standard_normal((7, 16, 3)))
    Qb, Rb = jax.vmap(thin_qr)(S)
    for i in range(7):
        Qi, Ri = thin_qr(S[i])
        # QR is unique up to column signs; compare the products.
        np.testing.assert_allclose(np.asarray(Qb[i] @ Rb[i]), np.asarray(Qi @ Ri), atol=1e-12)
        np.testing.assert_allclose(
            np.asarray(Rb[i].T @ Rb[i]), np.asarray(Ri.T @ Ri), atol=1e-12
        )
    Rb2 = jax.vmap(qr_r)(S)
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("bkn,bkm->bnm", Rb2, Rb2)),
        np.asarray(jnp.einsum("bdn,bdm->bnm", S, S)),
        atol=1e-10,
    )


def test_r_factor_operator_matches_dense():
    # hv/vhv through R (QR of [J; sqrt(mu) C]) vs the dense JᵀJ + mu CᵀC —
    # the reference's operator-identity test pattern
    # (ref /root/reference/test/structures.jl:1-16) on the QR route.
    rng = np.random.default_rng(2)
    J = jnp.asarray(rng.standard_normal((9, 5)))
    C = jnp.asarray(rng.standard_normal((2, 5)))
    mu = jnp.asarray(3.5)
    v = jnp.asarray(rng.standard_normal(5))
    dense = np.asarray(J.T @ J + mu * (C.T @ C))
    H = with_r_factor(AlHessian(J, C, mu))
    assert H.R is not None and H.G is None
    np.testing.assert_allclose(np.asarray(hv(H, v)), dense @ np.asarray(v), atol=1e-10)
    np.testing.assert_allclose(
        float(vhv(H, v)), float(np.asarray(v) @ dense @ np.asarray(v)), atol=1e-10
    )
    # And against the Gram route.
    Hg = with_gram(AlHessian(J, C, mu))
    np.testing.assert_allclose(np.asarray(hv(H, v)), np.asarray(hv(Hg, v)), atol=1e-10)
    # vhv through R is nonnegative by construction even at v ≈ null(H).
    assert float(vhv(H, jnp.zeros(5))) == 0.0


def test_r_factor_empty_constraints():
    rng = np.random.default_rng(3)
    J = jnp.asarray(rng.standard_normal((6, 4)))
    C = jnp.zeros((0, 4))
    H = with_r_factor(AlHessian(J, C, jnp.asarray(2.0)))
    v = jnp.asarray(rng.standard_normal(4))
    np.testing.assert_allclose(
        np.asarray(hv(H, v)), np.asarray(J.T @ (J @ v)), atol=1e-10
    )


def test_ls_multipliers_qr_matches_normal():
    # Same estimate through both algebras (ref src/basic_tralcnlss.jl:887-903).
    rng = np.random.default_rng(4)
    n, d, p = 6, 10, 2
    Jm = jnp.asarray(rng.standard_normal((d, n)))
    Cm = jnp.asarray(rng.standard_normal((p, n)))
    r0 = jnp.asarray(rng.standard_normal(d))
    x = jnp.asarray(rng.standard_normal(n))
    fns = dict(
        residuals=lambda x: Jm @ x + r0,
        jac_res=lambda x: Jm,
        jac_nlcons=lambda x: Cm,
    )
    y_qr = least_squares_multipliers(x, fns["residuals"], fns["jac_res"], fns["jac_nlcons"], method="qr")
    y_ne = least_squares_multipliers(x, fns["residuals"], fns["jac_res"], fns["jac_nlcons"], method="normal")
    np.testing.assert_allclose(np.asarray(y_qr), np.asarray(y_ne), atol=1e-10)


def test_solver_qr_matches_normal_e2e():
    # Full batched solve, gn_factorization="qr" vs "normal" with the
    # operator materialized: same certified solutions in f64.
    from benlsip_tpu.batch.vmap_solve import solve_batched
    from benlsip_tpu.problems.generators import dense_quadratic_family

    B = 8
    bp, theta, X0 = dense_quadratic_family(B, n=24, d=64, m=3, seed=5)
    base = dict(max_outer_iter=30, max_inner_iter=100, gram_hessian="on")
    Xq, Yq, iq = solve_batched(bp, theta, X0, SolverOptions(**base, gn_factorization="qr"))
    Xn, Yn, in_ = solve_batched(bp, theta, X0, SolverOptions(**base, gn_factorization="normal"))
    ok = np.asarray(iq.converged) & np.asarray(in_.converged)
    assert ok.mean() >= 0.9
    assert np.max(np.abs(np.asarray(Xq - Xn))[ok]) < 1e-6


def test_split_polish_qr_beats_lu_ill_conditioned():
    # The payoff: f32-factored split polish on the kappa=1e4 family.  The
    # assembled-KKT LU contains JᵀJ, so its f32 factor has O(kappa²·eps)
    # error and iterative refinement diverges (0/8 certified); the
    # range-space QR factorization is O(kappa·eps) and matches the
    # all-f64 host polish instance-for-instance.
    from benlsip_tpu.batch.polish import sqp_polish, sqp_polish_split
    from benlsip_tpu.batch.vmap_solve import solve_batched
    from benlsip_tpu.problems.generators import ill_conditioned_family

    B = 8
    bp, theta, X0 = ill_conditioned_family(B, kappa=1e4, seed=9)
    bp32 = dataclasses.replace(
        bp,
        A=bp.A.astype(jnp.float32), b=bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32), xu=bp.xu.astype(jnp.float32),
    )
    th32 = jax.tree.map(
        lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a,
        theta,
    )
    bulk = SolverOptions(max_outer_iter=20, max_inner_iter=80, crit_tol=1e-2)
    opts = SolverOptions(max_outer_iter=20, max_inner_iter=80)
    X32, _, _ = solve_batched(bp32, th32, X0.astype(jnp.float32), bulk)

    _, _, ok_lu, pix_lu, _, _ = sqp_polish_split(
        bp32, th32, X32, bp, theta, opts, num_steps=8, kkt_factorization="lu"
    )
    _, _, ok_qr, pix_qr, _, _ = sqp_polish_split(
        bp32, th32, X32, bp, theta, opts, num_steps=8, kkt_factorization="qr"
    )
    _, _, ok_h, pix_h, _, _ = sqp_polish(
        bp, theta, X32.astype(jnp.float64), opts, num_steps=8
    )
    ok_lu, ok_qr, ok_h = (np.asarray(a) for a in (ok_lu, ok_qr, ok_h))
    # LU diverges under iterative refinement at this conditioning.
    assert ok_lu.sum() < ok_h.sum()
    # QR matches the f64 certification set.
    assert (ok_qr == ok_h).all()
    assert ok_qr.sum() >= 4


def test_qr_bf16_batched_cpu_fallback():
    """No backend has a bf16 QR kernel: the batched paths must round-trip
    through f32 instead of crashing."""
    import numpy as np

    from benlsip_tpu.ops.qr import qr_r, thin_qr

    rng = np.random.default_rng(5)
    S = jnp.asarray(rng.standard_normal((4, 16, 3)), jnp.bfloat16)
    R = jax.vmap(qr_r)(S)                       # crashed before the fix
    Q, R2 = jax.vmap(thin_qr)(S)
    assert R.dtype == jnp.bfloat16 and Q.dtype == jnp.bfloat16
    # RtR == StS to bf16 grade.
    StS = jnp.einsum("bdi,bdj->bij", S.astype(jnp.float32), S.astype(jnp.float32))
    RtR = jnp.einsum("bki,bkj->bij", R.astype(jnp.float32), R.astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(RtR), np.asarray(StS), rtol=0.1, atol=0.1)
    # Large N.
    S2 = jnp.asarray(rng.standard_normal((2, 64, 32)), jnp.bfloat16)
    assert jax.vmap(qr_r)(S2).shape == (2, 32, 32)
