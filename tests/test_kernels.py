"""The batched small factorizations of the projections and the Gauss-Newton
algebra vs numpy ground truth (the reference's fancy-kernel-vs-naive-
recompute oracle pattern, SURVEY.md §4(b)).

The solver runs them per instance under `vmap` — `factor_masked_aat` /
`cho_solve_lower` (ops/cholesky.py) and `thin_qr` / `qr_r` (ops/qr.py) —
and XLA batches each into one factorization over the instance axis.  The
cases run in f32, the bulk phase's dtype, with batch sizes that are not
multiples of any block width.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from benlsip_tpu.ops.cholesky import cho_solve_lower, factor_masked_aat
from benlsip_tpu.ops.qr import qr_r, thin_qr

rng = np.random.default_rng(3)


def masked_block(B, M, dtype=np.float32):
    """(A, free, K): B constraint blocks (M, 3M + 1) with one variable fixed
    per instance, and K = A Z Aᵀ in f64."""
    n = 3 * M + 1
    A = rng.standard_normal((B, M, n)).astype(dtype)
    free = np.ones((B, n), bool)
    free[np.arange(B), rng.integers(0, n, B)] = False
    A64 = A.astype(np.float64)
    K = (A64 * free[:, None, :]) @ np.swapaxes(A64, 1, 2)
    return A, free, K


@pytest.mark.parametrize("M", [1, 2, 3, 5, 8])
def test_batched_masked_cholesky_matches_numpy(M):
    B = 200
    A, free, K = masked_block(B, M)
    L = np.asarray(jax.jit(jax.vmap(factor_masked_aat))(jnp.asarray(A), jnp.asarray(free)))
    assert L.shape == (B, M, M) and L.dtype == np.float32
    np.testing.assert_allclose(L, np.linalg.cholesky(K), rtol=2e-4, atol=2e-4)
    assert np.all(np.triu(L, 1) == 0)


@pytest.mark.parametrize("M", [1, 3, 6])
def test_batched_cho_solve_matches_numpy(M):
    B = 130
    A, free, K = masked_block(B, M)
    L = np.linalg.cholesky(K).astype(np.float32)
    b = rng.standard_normal((B, M)).astype(np.float32)
    x = np.asarray(jax.jit(jax.vmap(cho_solve_lower))(jnp.asarray(L), jnp.asarray(b)))
    x_ref = np.linalg.solve(K, b.astype(np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(x, x_ref, rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("D,N", [(8, 3), (32, 3), (16, 8)])
def test_batched_thin_qr(D, N):
    B = 140
    A = rng.standard_normal((B, D, N)).astype(np.float32)
    Q, R = jax.jit(jax.vmap(thin_qr))(jnp.asarray(A))
    Q, R = np.asarray(Q), np.asarray(R)
    # QR reproduces A, Q orthonormal, R upper-triangular; qr_r gives the
    # same R (both are one Householder factorization).
    np.testing.assert_allclose(Q @ R, A, rtol=1e-4, atol=1e-4)
    eye = np.eye(N, dtype=np.float32)
    gram = np.transpose(Q, (0, 2, 1)) @ Q
    np.testing.assert_allclose(gram, np.broadcast_to(eye, (B, N, N)), atol=2e-4)
    assert np.all(np.tril(R, -1) == 0)
    R_only = np.asarray(jax.jit(jax.vmap(qr_r))(jnp.asarray(A)))
    np.testing.assert_allclose(np.abs(R_only), np.abs(R), rtol=1e-4, atol=1e-4)


def test_empty_and_degenerate_batches():
    assert jax.vmap(factor_masked_aat)(jnp.zeros((4, 0, 3)), jnp.ones((4, 3), bool)).shape == (4, 0, 0)
    assert jax.vmap(factor_masked_aat)(jnp.zeros((0, 2, 3)), jnp.ones((0, 3), bool)).shape == (0, 2, 2)
    assert jax.vmap(cho_solve_lower)(jnp.zeros((4, 0, 0)), jnp.zeros((4, 0))).shape == (4, 0)
    # A non-SPD pivot reports NaN, as LAPACK does, instead of a finite
    # factor: callers read the NaN as the breakdown signal.
    L = jax.vmap(factor_masked_aat)(jnp.zeros((2, 1, 3)), jnp.ones((2, 3), bool))
    assert np.isnan(np.asarray(L)).all()
