"""Cholesky factorizations for masked active-set projections.

Replacement for the reference's augmented-Cholesky machinery
(`/root/reference/src/polyhedral_constraints.jl:35-68`) and its LAPACK
backend (dpotrf/dtrsm via Julia `cholesky` / `\\`).

Mathematical background
-----------------------
The reference projects onto {v : Av = 0, v_i = 0 for i fixed} via the normal
equations of Ã = [A; E], E = rows e_iᵀ of fixed variables, factorizing

    ÃÃᵀ = [AAᵀ  AEᵀ]      with the block trick  L = [L_A      0  ]
          [EAᵀ   I ]                                [Gᵀ   chol(I-GᵀG)]

where G = L_A⁻¹ A Eᵀ (ref :35-59).  The Schur complement of the identity
block is  AAᵀ - AEᵀEAᵀ = A (I - EᵀE) Aᵀ = A Z Aᵀ  with Z = diag(free mask).
Hence ÃÃᵀ is SPD iff A Z Aᵀ is SPD, and the subspace projection

    P r = Z r - Z Aᵀ (A Z Aᵀ)⁻¹ A Z r

is *identical* to the reference's augmented normal-equations projection but
needs only a fixed-size m×m factorization — no growing shapes, so it jits,
vmaps over instances with divergent active sets, and (for the sharded
large-instance mode) A Z Aᵀ is a row-sharded GEMM + psum.

`cholesky_aug_aat_dense` below reproduces the reference's dynamic-shape
block factorization with numpy for use as a host-side parity oracle in tests
(the reference's own unit test compares against a greedy chol(BBᵀ),
`/root/reference/test/structures.jl:18-35`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

_BF16 = jnp.dtype(jnp.bfloat16)


def _chol_xla(K: Array) -> Array:
    """bf16-safe Cholesky: no backend ships a bf16 factorization (LAPACK on
    CPU, cuSOLVER on the GPU are f32/f64 only), so bf16 inputs factor in
    f32 and round back (the bf16-bulk pipeline's dtype story).  Batch dims
    broadcast natively, so `vmap` over instances is one batched call."""
    if K.dtype == _BF16:
        return jnp.linalg.cholesky(K.astype(jnp.float32)).astype(K.dtype)
    return jnp.linalg.cholesky(K)


def _tri_solve_xla(L: Array, b: Array, **kw) -> Array:
    """bf16-safe triangular solve (same reasoning as `_chol_xla`)."""
    if L.dtype == _BF16:
        return jax.scipy.linalg.solve_triangular(
            L.astype(jnp.float32), b.astype(jnp.float32), **kw
        ).astype(L.dtype)
    return jax.scipy.linalg.solve_triangular(L, b, **kw)


def masked_aat(A: Array, free: Array) -> Array:
    """A Z Aᵀ with Z = diag(free). Shape (m, m)."""
    Af = A * free.astype(A.dtype)[None, :]
    return Af @ A.T


def factor_masked_aat(A: Array, free: Array, reg: float = 0.0) -> Array:
    """Lower Cholesky factor of A Z Aᵀ (+ reg·I).

    Fixed-shape replacement for `cholesky_aug_aat` + `update_chol!`
    (ref `src/polyhedral_constraints.jl:35-68`).  m is small in the batched
    regime (m ≤ n ≤ ~20), so the O(m²n) re-formation + O(m³) factorization
    under a fixed shape beats a data-dependent incremental update, which
    would not batch.

    reg > 0 adds Tikhonov jitter for near-rank-deficient masked rows; the
    reference simply crashes in that case (LAPACK PosDefException).
    """
    m = A.shape[0]
    if m == 0:
        return jnp.zeros((0, 0), dtype=A.dtype)
    K = masked_aat(A, free)
    if reg:
        K = K + jnp.asarray(reg, A.dtype) * jnp.eye(m, dtype=A.dtype)
    return _chol_xla(K)


def cho_solve_lower(L: Array, b: Array) -> Array:
    """Solve (L Lᵀ) x = b given the lower factor L.

    The reference's pair of triangular solves `chol.L \\ b; chol.U \\ v`
    (e.g. ref `src/basic_tralcnlss.jl:897-901`,
    `src/polyhedral_constraints.jl:114-116`).
    """
    y = _tri_solve_xla(L, b, lower=True)
    return _tri_solve_xla(L.T, y, lower=False)


def cholesky_aug_aat_dense(A: np.ndarray, fixed: np.ndarray, L_aat: np.ndarray) -> np.ndarray:
    """Host-side (numpy, dynamic-shape) reproduction of the reference's
    blocked augmented factorization, for parity tests only.

    Mirrors `cholesky_aug_aat` (ref `src/polyhedral_constraints.jl:35-59`):
    given L_aat = chol(AAᵀ).L, returns the lower factor of ÃÃᵀ where
    Ã = [A; e_iᵀ for i fixed], via  G = L_aat⁻¹ A[:, fixed] and the Schur
    block chol(I - GᵀG).
    """
    A = np.asarray(A)
    fixed = np.asarray(fixed, dtype=bool)
    m = A.shape[0]
    p = int(fixed.sum())
    L = np.zeros((m + p, m + p), dtype=A.dtype)
    G = np.linalg.solve(L_aat, A[:, fixed]) if p else np.zeros((m, 0), dtype=A.dtype)
    L[:m, :m] = L_aat
    L[m:, :m] = G.T
    if p:
        H = np.eye(p, dtype=A.dtype) - G.T @ G
        L[m:, m:] = np.linalg.cholesky(H)
    return L
