"""QR factorizations for the Gauss-Newton algebra.

Replacement for the half of the reference's LAPACK surface the
normal equations hide: the reference factorizes CCᵀ (Cholesky) for the
least-squares multipliers (`/root/reference/src/basic_tralcnlss.jl:897-901`)
and applies JᵀJ + mu·CᵀC matrix-free everywhere else — both of which square
the Jacobian's condition number.  The f32 bulk phase of the
mixed-precision pipeline has no κ² headroom (see SolverOptions), so the
framework offers the orthogonal route: thin QR of the stacked factor, with
R replacing the Gram matrix (RᵀR = SᵀS exactly, but R is accurate to
κ(S)·eps instead of κ(S)²·eps).

Batch dims broadcast natively through XLA's `jnp.linalg.qr`, so `vmap`
over instances is one batched factorization.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

Array = jax.Array


def _xla_qr(S: Array, mode: str):
    """jnp.linalg.qr with bf16 handled by an f32 round trip.

    No backend ships a bf16 QR kernel (LAPACK on CPU, cuSOLVER on the GPU
    are f32/f64 only) — a bf16 input crashes at trace time.
    """
    S32 = S.astype(jnp.float32) if S.dtype == jnp.dtype(jnp.bfloat16) else S
    out = jnp.linalg.qr(S32, mode=mode)
    if mode == "r":
        return out.astype(S.dtype)
    return out[0].astype(S.dtype), out[1].astype(S.dtype)


def thin_qr(S: Array):
    """Thin QR of a (..., D, N) matrix -> (Q (..., D, K), R (..., K, N)),
    K = min(D, N)."""
    return _xla_qr(S, "reduced")


def qr_r(S: Array) -> Array:
    """R factor only of a (..., D, N) matrix -> (..., K, N), K = min(D, N).

    RᵀR = SᵀS: the orthogonal-factorization route to the Gram operator.
    """
    return _xla_qr(S, "r")


def _chol_upper(G: Array) -> Array:
    """Upper-triangular R with RᵀR = G (transpose of the lower Cholesky)."""
    return jnp.swapaxes(jnp.linalg.cholesky(G), -1, -2)


def _rescued_chol_upper(G: Array) -> Array:
    """Cholesky of a Gram matrix with a shift rescue for κ(S) ≳ 1/√eps.

    Unshifted Cholesky of G = SᵀS breaks down (NaN factor) once
    κ(S)² · eps ≳ 1.  The rescue refactors G + σI with a scale-relative
    shift σ = 2 n eps tr(G) (the shifted-CholeskyQR recipe of Fukaya et
    al. 2020, with tr(G) as a cheap upper bound on ‖G‖₂); the shift only
    perturbs the *conditioning* of the CholeskyQR2 transforms, never the
    final product — R = R₂R₁ satisfies RᵀR = R₁ᵀR₁⁻ᵀ G R₁⁻¹ R₁ = G in
    exact arithmetic for any σ.  Both factorizations are computed and
    selected with `where` so the rescue stays vmap/jit-compatible.
    """
    n = G.shape[-1]
    R = _chol_upper(G)
    bad = jnp.any(jnp.isnan(R), axis=(-2, -1), keepdims=True)
    tr = jnp.trace(G, axis1=-2, axis2=-1)[..., None, None]
    sigma = 2.0 * n * jnp.finfo(G.dtype).eps * tr
    eye = jnp.eye(n, dtype=G.dtype)
    R_shifted = _chol_upper(G + sigma * eye)
    return jnp.where(bad, R_shifted, R)


def cholqr2_r(S: Array) -> Array:
    """R factor of S via CholeskyQR2 — the GEMM-shaped thin QR.

    Blocked-Householder QR serializes on its panel factorizations;
    CholeskyQR2 replaces it with three GEMM-class passes:

        G  = SᵀS;  R₁ = chol(G)          (one (d,n)×(n,n) GEMM + small chol)
        W  = S R₁⁻¹                       (triangular solve, GEMM-shaped)
        R₂ = chol(WᵀW);  R = R₂ R₁        (second GEMM pass restores
                                           κ(S)·eps accuracy where a single
                                           CholeskyQR is only κ(S)²-grade)

    RᵀR = SᵀS to working precision; the implicit Q = W R₂⁻¹ is never
    formed (the solver consumes R only, ops/al.with_r_factor).  Valid for
    any κ via the shift rescue in `_rescued_chol_upper`.  Batch dims
    broadcast natively (every op is a batched GEMM or batched chol).
    bf16 inputs compute in f32 like `_xla_qr`.

    Replaces the same LAPACK factorization surface as `qr_r`
    (ref `/root/reference/src/basic_tralcnlss.jl:206, 897-901`).
    """
    dtype = S.dtype
    Sc = S.astype(jnp.float32) if dtype == jnp.dtype(jnp.bfloat16) else S
    G = jnp.swapaxes(Sc, -1, -2) @ Sc
    R1 = _rescued_chol_upper(G)
    # W = S R₁⁻¹: right-side triangular solve, batched over leading dims.
    W = lax.linalg.triangular_solve(R1, Sc, left_side=False, lower=False)
    G2 = jnp.swapaxes(W, -1, -2) @ W
    R2 = _rescued_chol_upper(G2)
    return (R2 @ R1).astype(dtype)


def _implicit_refine_r2(G: Array, R1: Array):
    """Implicit second-pass factor: (R₂ with R₂ᵀR₂ ≈ R₁⁻ᵀ G R₁⁻¹, bad).

    `bad` flags instances whose refinement Cholesky broke down (NaN);
    their R₂ is already replaced by I (R = R₁, the shifted
    single-CholeskyQR factor).  See `_implicit_refine_upper`.
    """
    T = lax.linalg.triangular_solve(R1, G, left_side=True, lower=False, transpose_a=True)
    G2 = lax.linalg.triangular_solve(R1, T, left_side=False, lower=False)
    G2 = 0.5 * (G2 + jnp.swapaxes(G2, -1, -2))
    R2 = _chol_upper(G2)
    bad = jnp.any(jnp.isnan(R2), axis=(-2, -1), keepdims=True)
    eye = jnp.eye(G.shape[-1], dtype=G.dtype)
    return jnp.where(bad, eye, R2), bad


def _implicit_refine_upper(G: Array, R1: Array) -> Array:
    """Second CholeskyQR2 pass from the ALREADY-FORMED Gram: R with RᵀR = G.

    The explicit refinement pass re-touches S twice (W = S R₁⁻¹, G₂ = WᵀW:
    3dn² FLOPs).  But in exact arithmetic G₂ = R₁⁻ᵀ G R₁⁻¹ — computable
    from the (n, n) Gram alone with two triangular solves (2n³ FLOPs, no S
    traffic).  At config-4 shapes (d ≥ 2n) that is the cheaper pass, and
    in the row-sharded build the second psum of an (n, n) partial
    disappears — the refinement is purely local once G is reduced.

    Robustness differs from the explicit pass in one way: explicit G₂=WᵀW
    is a Gram, PSD by construction at any κ; the implicit congruence goes
    indefinite once κ(S)²·eps ≳ 1 — in f32 that is κ(S) ≈ 1e4, an ORDINARY
    condition number, not an extreme event (measured: refine chol NaNs at
    κ=1e4 f32 / κ=1e10 f64; a shift-rescued chol of G₂ does not help —
    measured WORSE than R₂=I at κ=1e4 and NaN from 1e5).  A failed
    refinement chol therefore falls back to R₂ = I, i.e. R = R₁ — the
    shifted single-CholeskyQR factor (RᵀR error ~3e-4 relative at κ≥1e4
    f32), which still satisfies the operator contract (`ops/al.hv`
    consumes RᵀRv only; multiplier solves use their own QR of Cᵀ,
    solver/multipliers.py).  Callers that can re-touch S recover full
    κ·eps accuracy instead via the explicit-pass rescue
    (`cholqr2i_r`, `ops/al.with_r_factor_cholqr2`); this Gram-only
    entry is for the row-sharded path, where the explicit pass would
    reintroduce a second psum.
    """
    R2, _ = _implicit_refine_r2(G, R1)
    return R2 @ R1


def cholqr2i_r(S: Array) -> Array:
    """R factor of S via CholeskyQR2 with the implicit refinement pass.

    One GEMM pass over S (the Gram), then n³-class work only — see
    `_implicit_refine_upper` for the algebra and cost.  When the implicit
    refinement Cholesky breaks down (κ(S)²·eps ≳ 1: κ ≈ 1e4 in f32), a
    `lax.cond` rescues accuracy through the explicit pass W = S R₁⁻¹,
    G₂ = WᵀW (PSD by construction at any κ) instead of settling for the
    shift-grade R = R₁ — measured RᵀR relative error 3e-7 vs 3.2e-4 at
    κ=1e4 f32.  The rescue re-touches S (3dn² FLOPs) only on breakdown;
    under vmap the cond lowers to a select that pays the explicit branch
    always, which is the batched-small regime where 3dn² is trivial.
    The operator build (`ops/al.with_r_factor_cholqr2`) applies the same
    rescue; same LAPACK-surface replacement as `cholqr2_r`
    (ref `/root/reference/src/basic_tralcnlss.jl:206, 897-901`).
    """
    dtype = S.dtype
    Sc = S.astype(jnp.float32) if dtype == jnp.dtype(jnp.bfloat16) else S
    G = jnp.swapaxes(Sc, -1, -2) @ Sc
    R1 = _rescued_chol_upper(G)
    R2, bad = _implicit_refine_r2(G, R1)

    def _explicit(_):
        W = lax.linalg.triangular_solve(R1, Sc, left_side=False, lower=False)
        G2 = jnp.swapaxes(W, -1, -2) @ W
        return _rescued_chol_upper(G2)

    R2 = lax.cond(jnp.any(bad), _explicit, lambda _: R2, None)
    return (R2 @ R1).astype(dtype)
