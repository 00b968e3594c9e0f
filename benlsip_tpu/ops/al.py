"""Augmented-Lagrangian evaluation and the matrix-free Gauss-Newton Hessian.

Re-design of the reference's AL evaluation layer
(`/root/reference/src/basic_tralcnlss.jl:6-137`):

* the augmented Lagrangian  m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc   (ref :44)
* its gradient              g(x) = Jᵀr + Cᵀ(y + mu c)          (ref :45)
* the Gauss-Newton Hessian  H    = JᵀJ + mu CᵀC, held matrix-free as the
  triple (J, C, mu) — the reference's `AlHessian` struct (ref :6-10).

Everything here is pure jnp: shapes are static, no Python control flow on
traced values, so these functions jit, vmap (batch axis over independent
instances) and shard (J/C row-blocked over a mesh axis; the reductions in
`hv`/`vhv` then become `psum`s inserted by XLA under `shard_map`).

The empty-constraint case p == 0 (no nonlinear constraints) is fully
supported via zero-row C: `C @ v` is a (0,)-vector and all dot products are
zero.  The reference crashes on this case (SURVEY.md §2.3 quirk 6).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


class AlHessian(NamedTuple):
    """Matrix-free Gauss-Newton Hessian of the augmented Lagrangian.

    H = JᵀJ + mu CᵀC, stored as its factors — never materialized.
    Mirrors `AlHessian` (ref `src/basic_tralcnlss.jl:6-10`).

    Optionally carries the materialized Gram matrix G = JᵀJ + mu CᵀC
    (see `with_gram`): when the residual dimension d dominates n, every
    H·v otherwise streams the (d, n) Jacobian from HBM twice per CG
    iteration; paying O(d n²) GEMM flops once per Jacobian refresh buys an
    (n, n) operator whose per-iteration HBM traffic is ~2(d+p)/n times
    smaller — the dominant cost at config-3/4 scale where CG is
    bandwidth-bound, not flop-bound.

    Alternatively carries the triangular factor R from a thin QR of the
    stacked matrix S = [J; sqrt(mu)·C] (see `with_r_factor`): RᵀR = SᵀS
    = H exactly, same (n, n) per-iteration traffic as the Gram mode, but
    R is accurate to κ(S)·eps where forming G rounds away everything
    below κ(S)²·eps — the difference between converging and stalling for
    the f32 bulk phase on ill-conditioned Jacobians (the BASELINE
    north-star "QR+PCG" path).
    """

    J: Array    # (d, n) residual Jacobian
    C: Array    # (p, n) nonlinear-constraint Jacobian (p may be 0)
    mu: Array   # scalar penalty parameter
    G: Array | None = None   # optional (n, n) Gram matrix JᵀJ + mu CᵀC
    R: Array | None = None   # optional (k, n) QR factor of [J; sqrt(mu)·C]
    G_rows: Array | None = None  # optional (n/D, n) row shard of G (see
                                 # `with_gram_rows`): this device's rows of
                                 # the reduced Gram, under shard_map only
    R_rows: Array | None = None  # optional (n/D, n) row shard of the
                                 # CholeskyQR2 factor R (see
                                 # `with_r_factor_cholqr2` layout="sharded"):
                                 # H·v = Σ_shards R_rowsᵀ(R_rows v) via one
                                 # n-vector psum, n²/D persistent per device


def _psum(x, axis):
    if axis is None:
        return x
    from ..dist.collectives import psum

    return psum(x, axis)


def al_value(rx: Array, cx: Array, y: Array, mu: Array, axis: str | None = None) -> Array:
    """m(x) = 1/2 rᵀr + yᵀc + mu/2 cᵀc  (ref `src/basic_tralcnlss.jl:44`).

    `axis` names the mesh axis the residual dimension is sharded over in
    the explicit-collectives blocked mode (shard_map): rᵀr is then a local
    partial + one scalar psum.  None (default) = unsharded/pjit modes.
    """
    return _psum(0.5 * jnp.vdot(rx, rx), axis) + jnp.vdot(y, cx) + 0.5 * mu * jnp.vdot(cx, cx)


def al_gradient(J: Array, C: Array, rx: Array, y_bar: Array, axis: str | None = None) -> Array:
    """g = Jᵀ rx + Cᵀ y_bar with y_bar = y + mu c  (ref `src/basic_tralcnlss.jl:45`).

    With `axis`, Jᵀrx is a local row-block contraction + one n-vector psum
    (the blockwise-accumulation pattern of SURVEY.md §5's long-context row).
    """
    return _psum(J.T @ rx, axis) + C.T @ y_bar


def gram_j(J: Array, axis: str | None = None) -> Array:
    """The (already-reduced) JᵀJ block of the Gram operator.

    Split out so affine-residual problems (constant J — see
    SolverOptions.linear_residuals) can pay the 2dn² GEMM ONCE and hand
    the result to the `Gj=` parameter of the operator builders below on
    every refresh; only the cheap mu·CᵀC term (p ≪ n) is then rebuilt.
    bf16 J accumulates in f32 (the builders' compute precision).
    """
    Jc = J.astype(jnp.float32) if J.dtype == jnp.dtype(jnp.bfloat16) else J
    return _psum(Jc.T @ Jc, axis)


def with_gram(H: AlHessian, axis: str | None = None, Gj: Array | None = None) -> AlHessian:
    """Materialize G = JᵀJ + mu CᵀC into the operator (one (n,d)×(d,n) GEMM).

    In the row-sharded blocked-Jacobian mode J is sharded over its d axis, so
    JᵀJ is a per-chip partial product + one all-reduce of n² — paid once per
    Jacobian refresh instead of two psums per CG iteration (`axis` makes the
    reduce explicit under shard_map; under pjit XLA inserts it).
    `Gj` (see `gram_j`) skips the GEMM and the psum for constant-J problems.
    """
    jtj = _psum(H.J.T @ H.J, axis) if Gj is None else Gj.astype(H.J.dtype)
    # Static p==0 short-circuit: with no nonlinear constraints C is a
    # (0, n) array and CᵀC a degenerate (n, n) zero dot — XLA can spend
    # seconds constant-folding it per occurrence at highest precision,
    # for a term that is identically zero.
    G = jtj if H.C.shape[0] == 0 else jtj + H.mu * (H.C.T @ H.C)
    return AlHessian(H.J, H.C, H.mu, G)


def gram_j_rows(J: Array, axis: str, schedule: str = "xla") -> Array:
    """This device's n/D rows of the reduced JᵀJ (see `with_gram_rows`).

    The constant-J cache for the row-sharded layout: computed once via
    reduce-scatter (or the lazy ring), handed to `with_gram_rows(Gj_rows=)`
    on every refresh.  bf16 J accumulates in f32, mirroring `gram_j` (the
    consumer casts back to its compute dtype via `Gj_rows.astype`).
    """
    from ..dist.collectives import psum_scatter, ring_psum_scatter_lazy

    if J.dtype == jnp.dtype(jnp.bfloat16):
        J = J.astype(jnp.float32)
    n = J.shape[1]
    D = jax.lax.axis_size(axis)
    if n % D:
        raise ValueError(f"n={n} not divisible by mesh axis size {D} for the sharded Gram layout")
    rows_per = n // D
    if schedule == "ring":
        # J rides through the ring as the barrier operand so each chunk
        # GEMM is scheduled after the hop that needs it — without this the
        # build transient silently regrows to the full n² (see
        # dist/collectives.ring_psum_scatter_lazy).
        def chunk(c, J_t):
            Jc = jax.lax.dynamic_slice_in_dim(J_t, c * rows_per, rows_per, axis=1)
            return Jc.T @ J_t

        return ring_psum_scatter_lazy(chunk, axis, operand=J)
    return psum_scatter(J.T @ J, axis)


def with_gram_rows(
    H: AlHessian, axis: str, schedule: str = "xla", Gj_rows: Array | None = None
) -> AlHessian:
    """Materialize the Gram operator ROW-SHARDED across `axis` (shard_map only).

    The replicated `with_gram` all-reduces the full (n, n) partial product
    onto every device (2(D−1)/D·n² wire bytes each) and stores n² per
    device.  Here each device keeps only its n/D rows of the reduced Gram:

    * build:  reduce-scatter of the local partial JᵀJ — (D−1)/D·n² traffic,
      half the psum, via `lax.psum_scatter` (schedule="xla") or the
      hand-scheduled `ppermute` ring (schedule="ring",
      dist/collectives.ring_psum_scatter_lazy);
    * memory: n²/D *persistent* per device — the layout that keeps
      config-4-scale operators (n=40k ⇒ 6.4 GB f32 replicated) inside HBM.
      The build *transient* differs by schedule: "xla" materializes the
      full (n, n) local partial JᵀJ before the fused collective (peak ~n²,
      so it shrinks only the persistent footprint), while "ring" never
      forms it — each of the D ring hops computes one (n/D, n) row-chunk
      Jᵀ[:, chunk] J on the fly and adds it into the travelling buffer
      (peak ~2n²/D, at the cost of re-reading J once per hop).  At the
      n=40k scale where the layout is mandatory, "ring" is therefore the
      only schedule whose *build* also fits;
    * H·v:    local (n/D, n) GEMV + one tiled n-vector `all_gather`
      ((D−1)/D·n per matvec; the replicated layout's matvec is free, so
      this trades one small gather per CG iteration for the halved refresh
      and the D× memory headroom — the right side of the trade whenever
      n² ≫ (CG iters per refresh)·n).

    The μCᵀC term is added locally on this device's row block (C is
    replicated and p is small: slice C's columns, no (n, n) temporary).
    """
    from ..dist.collectives import axis_index

    n = H.J.shape[1]
    D = jax.lax.axis_size(axis)
    if n % D:
        raise ValueError(f"n={n} not divisible by mesh axis size {D} for the sharded Gram layout")
    rows_per = n // D
    # Both branches cast back to the operator dtype: gram_j_rows
    # accumulates bf16 in f32 (its contract), but the operator must keep
    # the input dtype — an f32 G_rows from a bf16 J would double the
    # persistent n²/D footprint AND change the CG carry dtype mid-loop.
    rows = (gram_j_rows(H.J, axis, schedule) if Gj_rows is None else Gj_rows).astype(H.J.dtype)
    if H.C.shape[0]:  # p==0: skip the degenerate zero term (see with_gram)
        start = axis_index(axis) * rows_per
        C_loc = jax.lax.dynamic_slice_in_dim(H.C, start, rows_per, axis=1)  # (p, n/D)
        rows = rows + H.mu * (C_loc.T @ H.C)
    return AlHessian(H.J, H.C, H.mu, None, None, rows)


def with_r_factor(H: AlHessian) -> AlHessian:
    """Materialize R from a thin QR of S = [J; sqrt(mu)·C] into the operator.

    The orthogonal-factorization alternative to `with_gram` (BASELINE
    north-star "batched QR/Gauss-Newton factorizations"): H = RᵀR with R
    computed by QR, so no intermediate ever carries κ(S)².  Costs ~2-4x
    the Gram GEMM per Jacobian refresh (blocked Householder vs one
    matmul) — amortized over the CG iterations that reuse the operator.
    Under vmap, XLA batches the QR over instances (ops/qr.py).
    """
    dtype = H.J.dtype
    S = jnp.concatenate([H.J, jnp.sqrt(H.mu).astype(dtype) * H.C], axis=0)
    from .qr import qr_r

    return AlHessian(H.J, H.C, H.mu, None, qr_r(S))


def with_r_factor_cholqr2(
    H: AlHessian,
    axis: str | None = None,
    layout: str = "replicated",
    Gj: Array | None = None,
) -> AlHessian:
    """Materialize R with RᵀR = JᵀJ + mu CᵀC via CholeskyQR2 (ops/qr.cholqr2_r).

    The GEMM-shaped route to the orthogonal factor: three GEMM-class passes
    (Gram build, right-triangular solve, refinement Gram) instead of a
    panel-serialized Householder QR — the same accuracy class (κ·eps after
    the second pass; any κ via the shift rescue).

    Unlike the Householder route this *distributes*: with J row-sharded
    over `axis` the Gram pass reduces (n, n) partials with the existing
    psum machinery — no all-gather of J, which is what made Householder
    QR unavailable under shard_map (solver/subproblem.py).  The
    refinement pass is the *implicit* one (ops/qr._implicit_refine_upper):
    G₂ = R₁⁻ᵀ G R₁⁻¹ from the already-reduced Gram, two (n, n) triangular
    solves computed locally on every device — so the whole refresh
    carries exactly ONE psum (the explicit pass would need a second one
    for WᵀW).  The μ CᵀC term is added locally (C replicated, p small),
    mirroring `with_gram`.

    Breakdown rescue: the implicit refinement chol goes indefinite once
    κ(S)²·eps ≳ 1 — κ(S) ≈ 1e4 in f32, an ordinary condition number.
    With `axis=None` (replicated; the auto-selected f32 n≥64 route) a
    `lax.cond` then recovers full κ·eps accuracy through the explicit
    pass W = [J; √μ C] R₁⁻¹ — S is reconstructable here, and the 3dn²
    rescue runs only on breakdown.  Under `axis` (shard_map) the explicit
    pass would need a second psum inside a cond branch, so the sharded
    layout keeps the R = R₁ fallback: shift-grade accuracy (RᵀR relative
    error ~3e-4 at κ≥1e4 f32), which the operator contract tolerates
    (hv consumes RᵀRv only) and the solver's f64 certification phase
    checks behind.

    layout="sharded" (requires `axis`) keeps only this device's n/D rows
    of R: H·v then costs one n-vector psum (hv below) and the persistent
    footprint is n²/D — matching the sharded-Gram layout's memory story.
    The build transient is still n² (the replicated chol); a fully
    distributed factorization is out of scope, same as chol(G) itself.

    Same LAPACK-surface replacement as `with_r_factor`
    (ref `/root/reference/src/basic_tralcnlss.jl:206, 897-901`).
    """
    from .qr import _implicit_refine_r2, _implicit_refine_upper, _rescued_chol_upper

    dtype = H.J.dtype
    compute = jnp.float32 if dtype == jnp.dtype(jnp.bfloat16) else dtype
    C = H.C.astype(compute)
    mu = H.mu.astype(compute)
    if Gj is None:
        J = H.J.astype(compute)
        Gj = _psum(J.T @ J, axis)
    G = Gj.astype(compute)
    if C.shape[0]:  # p==0: skip the degenerate zero term (see with_gram)
        G = G + mu * (C.T @ C)
    R1 = _rescued_chol_upper(G)
    if axis is None:
        # Replicated: rescue a broken implicit refinement through the
        # explicit pass (see docstring; S = [J; sqrt(mu) C] is local here).
        R2, bad = _implicit_refine_r2(G, R1)

        def _explicit(_):
            Jc = H.J.astype(compute)
            S = Jc if C.shape[0] == 0 else jnp.concatenate(
                [Jc, jnp.sqrt(mu) * C], axis=0
            )
            W = jax.lax.linalg.triangular_solve(R1, S, left_side=False, lower=False)
            return _rescued_chol_upper(W.T @ W)

        R2 = jax.lax.cond(jnp.any(bad), _explicit, lambda _: R2, None)
        R = (R2 @ R1).astype(dtype)
    else:
        R = _implicit_refine_upper(G, R1).astype(dtype)
    if axis is not None and layout == "sharded":
        from ..dist.collectives import axis_index

        n = R.shape[0]
        D = jax.lax.axis_size(axis)
        if n % D:
            raise ValueError(
                f"n={n} not divisible by mesh axis size {D} for the sharded R layout"
            )
        rows_per = n // D
        R_rows = jax.lax.dynamic_slice_in_dim(R, axis_index(axis) * rows_per, rows_per, axis=0)
        return AlHessian(H.J, H.C, H.mu, None, None, None, R_rows)
    return AlHessian(H.J, H.C, H.mu, None, R)


def hv(H: AlHessian, v: Array, axis: str | None = None) -> Array:
    """Matrix-free H @ v = Jᵀ(Jv) + mu Cᵀ(Cv)  (ref `src/basic_tralcnlss.jl:102-106`).

    Two GEMV pairs; under vmap these become batched GEMMs, and in
    the row-sharded large-instance mode the Jᵀ(Jv) contraction carries a psum
    (explicit via `axis` under shard_map, XLA-inserted under pjit).
    With a materialized Gram matrix (see `with_gram`), one (n,n) GEMV on the
    already-reduced operator; with a QR factor (see `with_r_factor`), the
    pair Rᵀ(Rv) — same traffic, κ instead of κ² rounding.
    """
    if H.R_rows is not None:
        # Row-sharded CholeskyQR2 factor (see `with_r_factor_cholqr2`):
        # RᵀRv = Σ_shards R_rowsᵀ(R_rows v) — one n-vector psum, no gather.
        return _psum(H.R_rows.T @ (H.R_rows @ v), axis)
    if H.G_rows is not None:
        # Row-sharded Gram (see `with_gram_rows`): this device computes its
        # n/D rows of Gv, one tiled all_gather assembles the full vector.
        from ..dist.collectives import all_gather

        return all_gather(H.G_rows @ v, axis)
    if H.R is not None:
        return H.R.T @ (H.R @ v)
    if H.G is not None:
        return H.G @ v
    jv = _psum(H.J.T @ (H.J @ v), axis)
    return jv if H.C.shape[0] == 0 else jv + H.mu * (H.C.T @ (H.C @ v))


def vhv(H: AlHessian, v: Array, axis: str | None = None) -> Array:
    """Quadratic form vᵀHv = ‖Jv‖² + mu ‖Cv‖²  (ref `src/basic_tralcnlss.jl:92-96`).

    The factored and QR forms are nonnegative by construction; the Gram
    form vᵀ(Gv) can round to a tiny negative near vᵀHv ≈ 0, so consumers
    test curvature against scale-relative tolerances (solver/cg.py), never
    against exact zero.
    """
    if H.R_rows is not None:
        # ‖Rv‖² = Σ_shards ‖R_rows v‖²: local GEMV + one scalar psum.
        Rv_loc = H.R_rows @ v
        return _psum(jnp.vdot(Rv_loc, Rv_loc), axis)
    if H.G_rows is not None:
        # Local partial vᵀ(Gv): this shard's rows of Gv dotted with the
        # matching slice of the replicated v, then one scalar psum — the
        # full-vector all_gather in hv() is unnecessary for a scalar.
        from ..dist.collectives import axis_index

        rows_per = H.G_rows.shape[0]
        start = axis_index(axis) * rows_per
        v_loc = jax.lax.dynamic_slice_in_dim(v, start, rows_per)
        return _psum(jnp.vdot(v_loc, H.G_rows @ v), axis)
    if H.R is not None:
        Rv = H.R @ v
        return jnp.vdot(Rv, Rv)
    if H.G is not None:
        return jnp.vdot(v, H.G @ v)
    Jv = H.J @ v
    Cv = H.C @ v
    return _psum(jnp.vdot(Jv, Jv), axis) + H.mu * jnp.vdot(Cv, Cv)


def new_point(
    x: Array,
    y: Array,
    mu: Array,
    residuals: Callable[[Array], Array],
    nlconstraints: Callable[[Array], Array],
    jac_res: Callable[[Array], Array],
    jac_nlcons: Callable[[Array], Array],
    axis: str | None = None,
) -> Tuple[Array, Array, Array, Array, Array, AlHessian]:
    """Full evaluation at x: (rx, cx, y_bar, mx, g, H).

    Mirrors `new_point` (ref `src/basic_tralcnlss.jl:32-49`).
    """
    rx = residuals(x)
    cx = nlconstraints(x)
    Jx = jac_res(x)
    Cx = jac_nlcons(x)
    y_bar = y + mu * cx
    mx = al_value(rx, cx, y, mu, axis)
    g = al_gradient(Jx, Cx, rx, y_bar, axis)
    return rx, cx, y_bar, mx, g, AlHessian(Jx, Cx, mu)


def evaluate_al(
    x: Array,
    y: Array,
    mu: Array,
    residuals: Callable[[Array], Array],
    nlconstraints: Callable[[Array], Array],
    axis: str | None = None,
) -> Tuple[Array, Array, Array]:
    """Value-only evaluation (no Jacobians): (rx, cx, mx).

    Mirrors `evaluate_al` (ref `src/basic_tralcnlss.jl:51-61`) — used for the
    trust-region ratio test, where Jacobians are only needed on acceptance.
    """
    rx = residuals(x)
    cx = nlconstraints(x)
    return rx, cx, al_value(rx, cx, y, mu, axis)


def first_derivatives(
    x: Array,
    y: Array,
    mu: Array,
    rx: Array,
    cx: Array,
    jac_res: Callable[[Array], Array],
    jac_nlcons: Callable[[Array], Array],
) -> Tuple[Array, Array, Array, Array]:
    """(y_bar, Jx, Cx, g) at x given already-computed rx, cx.

    Mirrors `first_derivatives` (ref `src/basic_tralcnlss.jl:63-77`).
    """
    Jx = jac_res(x)
    Cx = jac_nlcons(x)
    y_bar = y + mu * cx
    g = al_gradient(Jx, Cx, rx, y_bar)
    return y_bar, Jx, Cx, g


def second_derivatives(Jx: Array, Cx: Array, mu: Array) -> AlHessian:
    """Package the GN Hessian (ref `src/basic_tralcnlss.jl:79-85`)."""
    return AlHessian(Jx, Cx, mu)
