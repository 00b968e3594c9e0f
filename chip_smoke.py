"""Smoke test of the solver's main path on the GPU, at the sizes of bench.py.

    python chip_smoke.py              # one card
    python chip_smoke.py --cards 4    # the multi-card paths only

Everything runs in this one process.  With one card the phases are:

1. device report: JAX's platform, device kind and count, and the card's
   name and power limit as nvidia-smi reports them;
2. factorizations: the batched Cholesky, triangular solve and thin QR the
   solver runs under `vmap`, compared with numpy in f64, and the check that
   f32 products under matmul precision "highest" stay out of TF32;
3. the deployments: configs 2, 3 and 5 through `solve_mixed_precision`
   (the certified mixed-precision pipeline, default policies), config 4
   through `dist.sharded.solve_large_blocked_family`.  Each prints its
   compile seconds, warm wall (fenced with `block_until_ready`), certified
   fraction, host fallback lanes, oracle result and the memory analysis of
   each device program the solve dispatched.

`--cards N` runs only the multi-card phases, each beside its one-card
comparison: the data-parallel `solve_batched_shardmap` over a ('batch',)
mesh of N, and config 4 over a ('block',) mesh of N.

The last line of standard output is one JSON object,
{"ok": ..., "device": {"platform": ..., "kind": ..., "count": ...}}.
The script exits nonzero, with "ok": false, when JAX finds no GPU or any
phase fails.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

# √eps(f64): the reference's KKT tolerance, the grade every batched
# deployment certifies to.
F64_KKT_TOL = float(np.sqrt(np.finfo(np.float64).eps))
# f32 factorizations against numpy in f64 (rtol = atol).
FACTOR_TOL = 2e-4
# X on the card against the same pipeline on the host CPU (f64 results).
X_VS_CPU_ATOL = 1e-7
# Config 4's oracle at f32 grade: bench.py's tolerance.
CONFIG4_ORACLE_TOL = 5e-4
# DP mesh against one card: the same per-shard f64 computation, which the
# two programs may fuse, and so round, differently.
DP_X_ATOL = 1e-8
# Config 4 mesh against one card: f32 psums add in another order than the
# one-card GEMMs.
CONFIG4_MESH_X_ATOL = 1e-3

# bench.py's deployments: (family, kwargs, SolverOptions kwargs, oracle sample).
BATCHED_CONFIGS = {
    "config2": ("exp_fit_family", dict(B=1024, d=32, seed=42),
                dict(max_outer_iter=40, max_inner_iter=120), 128),
    "config3": ("dense_quadratic_family", dict(B=64, n=192, d=1024, m=6, seed=3),
                dict(max_outer_iter=30, max_inner_iter=100), 64),
    "config5": ("exp_fit_family", dict(B=16384, d=32, seed=7),
                dict(max_outer_iter=40, max_inner_iter=120), 128),
}
CONFIG4 = dict(n=10240, d=20480, seed=0)
CONFIG4_OPTS = dict(max_outer_iter=20, max_inner_iter=60)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_report() -> str:
    """The card's name and power limit, read by nvidia-smi (not JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def memory_report(compiled) -> dict:
    """The byte counts of `compiled.memory_analysis()`."""
    ma = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}


def step_memory(steps) -> dict:
    """`memory_report` of each program a solve dispatched to the default
    backend, by name, read from its `harness.steps.record_steps()` record:
    the programs that ran, lowered again with their own arguments.  The
    first of each name stands for the rest (further chunks are the same
    program or its power-of-two tail); programs of the host fallback are
    left out."""
    import jax

    platform = jax.default_backend()
    out = {}
    for name, program, args in steps.programs:
        devices = {d for a in jax.tree.leaves(args) if isinstance(a, jax.Array)
                   for d in a.devices()}
        if name not in out and all(d.platform == platform for d in devices):
            out[name] = memory_report(program.lower(*args).compile())
    return out


def check_factorizations(B: int = 512, ms=(1, 3, 6), qr_shape=(32, 3),
                         seed: int = 0) -> dict:
    """The solver's batched factorizations in f32 on the default device
    against numpy in f64, at rtol = atol = `FACTOR_TOL`.

    Cholesky and the triangular solves run as the projections run them:
    `vmap` of `factor_masked_aat` / `cho_solve_lower` over B instances of
    an (m, 4m) constraint block with one variable fixed, under the
    solver's matmul precision "highest" (A Z Aᵀ is a product; TF32 would
    cost it three digits).  QR is `vmap` of
    `thin_qr` over B (D, N) blocks; R is compared up to the sign of each
    row, the freedom QR leaves.
    """
    import jax
    import jax.numpy as jnp

    from benlsip_tpu.ops.cholesky import cho_solve_lower, factor_masked_aat
    from benlsip_tpu.ops.qr import thin_qr

    rng = np.random.default_rng(seed)
    out = {}
    for m in ms:
        n = 4 * m
        A = rng.standard_normal((B, m, n)).astype(np.float32)
        free = np.ones((B, n), bool)
        free[:, 0] = False
        rhs = rng.standard_normal((B, m)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            L = jax.jit(jax.vmap(factor_masked_aat))(jnp.asarray(A), jnp.asarray(free))
            x = jax.jit(jax.vmap(cho_solve_lower))(L, jnp.asarray(rhs))
        A64 = A.astype(np.float64) * free[:, None, :]
        K = A64 @ np.swapaxes(A.astype(np.float64), 1, 2)
        np.testing.assert_allclose(np.asarray(L), np.linalg.cholesky(K), rtol=FACTOR_TOL, atol=FACTOR_TOL)
        np.testing.assert_allclose(
            np.asarray(x), np.linalg.solve(K, rhs.astype(np.float64)[..., None])[..., 0],
            rtol=FACTOR_TOL, atol=FACTOR_TOL,
        )
        out[f"chol_m{m}_max_err"] = float(np.max(np.abs(np.asarray(L) - np.linalg.cholesky(K))))
    D, N = qr_shape
    S = rng.standard_normal((B, D, N)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        Q, R = jax.jit(jax.vmap(thin_qr))(jnp.asarray(S))
    Q, R = np.asarray(Q, np.float64), np.asarray(R, np.float64)
    R_ref = np.linalg.qr(S.astype(np.float64), mode="r")
    sign = np.sign(np.diagonal(R, axis1=1, axis2=2)) * np.sign(np.diagonal(R_ref, axis1=1, axis2=2))
    np.testing.assert_allclose(R * sign[..., None], R_ref, rtol=FACTOR_TOL, atol=FACTOR_TOL)
    np.testing.assert_allclose(Q @ R, S, rtol=FACTOR_TOL, atol=FACTOR_TOL)
    out["qr_max_err"] = float(np.max(np.abs(R * sign[..., None] - R_ref)))
    return out


def check_matmul_precision(d: int = 1024, n: int = 192, seed: int = 0) -> dict:
    """JᵀJ at the config-3 shape under `jax.default_matmul_precision`
    "highest" (the solver's `SolverOptions.matmul_precision` and the
    polish's setting) and "default", each against numpy in f64.

    On the GPU "default" lets f32 products run in TF32 (~3 decimal
    digits); "highest" must not, so the two results must differ and
    "highest" must hold f32 accuracy.
    """
    import jax
    import jax.numpy as jnp

    J = np.random.default_rng(seed).standard_normal((d, n)).astype(np.float32)
    G64 = J.astype(np.float64).T @ J.astype(np.float64)
    res = {}
    for prec in ("highest", "default"):
        with jax.default_matmul_precision(prec):
            G = np.asarray(jax.jit(lambda j: j.T @ j)(jnp.asarray(J)), np.float64)
        res[prec] = G
    scale = float(np.max(np.abs(G64)))
    return {
        "highest_rel_err": float(np.max(np.abs(res["highest"] - G64)) / scale),
        "default_rel_err": float(np.max(np.abs(res["default"] - G64)) / scale),
        "differ": bool(np.any(res["highest"] != res["default"])),
    }


def _family(name: str, kw: dict):
    import jax.numpy as jnp

    from benlsip_tpu.problems import generators

    kw = dict(kw)
    B = kw.pop("B")
    return getattr(generators, name)(B, dtype=jnp.float64, **kw)


def run_batched_config(name: str, family: str, fam_kw: dict, opt_kw: dict,
                       oracle_sample: int, cpu_sample: int = 0) -> dict:
    """One batched deployment through `solve_mixed_precision` with its
    default policies, on the default device.

    Checks: every lane certified to √eps(f64), the independent oracle
    agrees on `oracle_sample` lanes, and — when `cpu_sample` > 0 — X on the
    default device matches the same pipeline run on the host CPU for the
    first `cpu_sample` lanes at `X_VS_CPU_ATOL` (instances are independent,
    so a prefix of the family is the same problems).  The host fallback's
    lanes and the memory of the programs that ran come from the warm
    solve's `record_steps()` record.
    """
    import jax

    from benlsip_tpu.baselines.kkt_oracle import kkt_cross_check_batch
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.harness.devices import local_cpu
    from benlsip_tpu.harness.steps import record_steps
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = _family(family, fam_kw)
    B = X0.shape[0]
    opts = SolverOptions(**opt_kw)

    def solve():
        with record_steps() as steps:
            t0 = time.perf_counter()
            X, Y, info = solve_mixed_precision(bp, theta, X0, opts)
            jax.block_until_ready((X, Y, info))
            return X, info, time.perf_counter() - t0, steps

    _, _, cold, _ = solve()
    X, info, warm, steps = solve()
    conv = np.asarray(info.converged)
    pix = np.asarray(info.pix)
    feas = np.asarray(info.feas)
    rec = {
        "config": name, "B": B,
        "compile_s": round(cold - warm, 3), "cold_wall_s": cold, "warm_wall_s": warm,
        "certified_frac": float(conv.mean()),
        "max_pix": float(pix.max()), "max_feas": float(feas.max()),
        "fallback_lanes": steps.fallback_lanes,
    }
    orc = kkt_cross_check_batch(bp, theta, X, sample=oracle_sample, seed=1)
    rec.update(orc)
    rec["step_memory"] = step_memory(steps)
    if cpu_sample:
        cpu = local_cpu()
        k = min(cpu_sample, B)
        sub = lambda a: a[:k] if getattr(a, "ndim", 0) and a.shape[0] == B else a
        bp_k = _replace_poly(bp, sub)
        with jax.default_device(cpu):
            Xc, _, info_c = solve_mixed_precision(
                bp_k, jax.tree.map(sub, theta), X0[:k], opts, bulk_device=cpu)
        rec["cpu_lanes"] = k
        rec["cpu_certified_frac"] = float(np.asarray(info_c.converged).mean())
        rec["x_max_diff_vs_cpu"] = float(np.max(np.abs(np.asarray(X)[:k] - np.asarray(Xc))))
    failures = []
    if rec["certified_frac"] != 1.0:
        failures.append(f"certified {rec['certified_frac']} of lanes, want 1.0")
    if rec["max_pix"] > F64_KKT_TOL or rec["max_feas"] > F64_KKT_TOL:
        failures.append(f"pix/feas {rec['max_pix']}/{rec['max_feas']} above {F64_KKT_TOL}")
    if rec["oracle_agree"] != rec["oracle_checked"]:
        failures.append(f"oracle agrees on {rec['oracle_agree']}/{rec['oracle_checked']}")
    if cpu_sample and rec["cpu_certified_frac"] != 1.0:
        failures.append(f"CPU pipeline certified {rec['cpu_certified_frac']}")
    if cpu_sample and not rec["x_max_diff_vs_cpu"] <= X_VS_CPU_ATOL:
        failures.append(f"|X - X_cpu| = {rec['x_max_diff_vs_cpu']} above {X_VS_CPU_ATOL}")
    rec["failures"] = failures
    return rec


def _replace_poly(bp, fn):
    """`bp` with `fn` applied to its constraint fields (A, b, xl, xu)."""
    import dataclasses

    return dataclasses.replace(bp, **{
        f: fn(getattr(bp, f)) for f in ("A", "b", "xl", "xu") if getattr(bp, f) is not None
    })


def run_config4(n: int, d: int, seed: int = 0, opt_kw=None, block: int = 1) -> dict:
    """Config 4: one large bound-active instance, f32, J row-sharded over a
    (1, `block`) mesh of the first `block` devices, checked by the oracle
    at f32 grade (`CONFIG4_ORACLE_TOL`)."""
    import jax
    import jax.numpy as jnp

    from benlsip_tpu.baselines.kkt_oracle import kkt_check_blocked_hard
    from benlsip_tpu.dist.mesh import make_mesh
    from benlsip_tpu.dist.sharded import solve_large_blocked_family
    from benlsip_tpu.harness.steps import record_steps
    from benlsip_tpu.problems.generators import blocked_hard_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, x0 = blocked_hard_family(n=n, d=d, seed=seed, dtype=jnp.float32)
    mesh = make_mesh(batch=1, block=block, devices=jax.devices()[:block])
    opts = SolverOptions(**(opt_kw or CONFIG4_OPTS))

    def solve():
        with record_steps() as steps:
            t0 = time.perf_counter()
            out = solve_large_blocked_family(bp, theta, x0, opts, mesh)
            jax.block_until_ready(out)
            return out, time.perf_counter() - t0, steps

    _, cold, _ = solve()
    (x, _, info), warm, steps = solve()
    orc = kkt_check_blocked_hard(bp, theta, x, tol=CONFIG4_ORACLE_TOL)
    rec = {
        "config": "config4", "n": n, "d": d, "block": block,
        "compile_s": round(cold - warm, 3), "cold_wall_s": cold, "warm_wall_s": warm,
        "converged": bool(info.converged), "outer": int(info.outer_iters),
        "inner": int(info.inner_iters), "pix": float(info.pix),
        "oracle_ok": bool(orc["ok"]), "oracle_stat": float(orc["stat"]),
        "oracle_feas": float(orc["feas"]), "active_frac": orc["active_frac"],
        "step_memory": step_memory(steps),
    }
    rec["failures"] = [
        msg for bad, msg in ((not rec["converged"], "not converged"),
                             (not rec["oracle_ok"], "oracle disagrees")) if bad
    ]
    rec["x"] = np.asarray(x)
    return rec


def run_dp_shardmap(cards: int, B: int = 16384, seed: int = 7, opt_kw=None) -> dict:
    """Data-parallel `solve_batched_shardmap` over a ('batch',) mesh of
    `cards` against the one-card chunked solve of the same family in
    chunks of B / cards — the same per-shard computation, so the same
    lanes converge and X agrees to `DP_X_ATOL`, well inside the √eps(f64)
    certification grade.  f64 throughout: the GPU runs it natively."""
    import jax
    import jax.numpy as jnp

    from benlsip_tpu.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu.dist.mesh import make_mesh
    from benlsip_tpu.dist.sharded import solve_batched_shardmap
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = _family("exp_fit_family", dict(B=B, d=32, seed=seed))
    opts = SolverOptions(**(opt_kw or BATCHED_CONFIGS["config5"][2]))
    mesh = make_mesh(batch=cards, block=1, devices=jax.devices()[:cards])
    dev0 = jax.devices()[0]

    def timed(fn):
        fn()
        t0 = time.perf_counter()
        out = fn()
        jax.block_until_ready(out)
        return out, time.perf_counter() - t0

    (Xm, _, im), wall_m = timed(lambda: solve_batched_shardmap(bp, theta, X0, opts, mesh))
    put = lambda t: jax.tree.map(lambda a: jax.device_put(a, dev0), t)
    bp1 = _replace_poly(bp, lambda a: jax.device_put(a, dev0))
    (X1, _, i1), wall_1 = timed(
        lambda: solve_batched_chunked(bp1, put(theta), put(X0), opts, chunk=B // cards))
    conv_m, conv_1 = np.asarray(im.converged), np.asarray(i1.converged)
    diff = float(np.max(np.abs(np.asarray(Xm) - np.asarray(X1))))
    rec = {
        "phase": "dp_shardmap", "cards": cards, "B": B,
        "wall_mesh_s": wall_m, "wall_one_card_s": wall_1,
        "converged_mesh": int(conv_m.sum()), "converged_one_card": int(conv_1.sum()),
        "x_max_diff": diff,
    }
    rec["failures"] = [
        msg for bad, msg in (
            (not np.array_equal(conv_m, conv_1), "converged lanes differ"),
            (not diff <= DP_X_ATOL, f"|X_mesh - X_one| = {diff} above {DP_X_ATOL}"),
        ) if bad
    ]
    return rec


def run_config4_mesh(cards: int, n: int, d: int, seed: int = 0, opt_kw=None) -> dict:
    """Config 4 on a ('block',) mesh of `cards` against the one-card blocked
    solve; the two solutions agree to `CONFIG4_MESH_X_ATOL`, the f32
    solve's grade, not bit for bit."""
    one = run_config4(n, d, seed, opt_kw, block=1)
    mesh = run_config4(n, d, seed, opt_kw, block=cards)
    diff = float(np.max(np.abs(one.pop("x") - mesh.pop("x"))))
    rec = {"phase": "config4_mesh", "cards": cards, "one_card": one, "mesh": mesh,
           "x_max_diff": diff}
    rec["failures"] = (
        [f"one card: {f}" for f in one["failures"]]
        + [f"mesh: {f}" for f in mesh["failures"]]
        + ([f"|x_mesh - x_one| = {diff} above {CONFIG4_MESH_X_ATOL}"]
           if not diff <= CONFIG4_MESH_X_ATOL else [])
    )
    return rec


def _emit(rec: dict) -> None:
    log(json.dumps(rec, default=str))
    if rec.get("failures"):
        raise AssertionError(f"{rec.get('config', rec.get('phase'))}: {rec['failures']}")


def one_card_phases() -> None:
    log(json.dumps({"phase": "factorizations", **check_factorizations()}))
    prec = check_matmul_precision()
    log(json.dumps({"phase": "matmul_precision", **prec}))
    if not (prec["differ"] and prec["highest_rel_err"] < 1e-5):
        raise AssertionError(f"matmul precision 'highest' is not full f32: {prec}")
    cpu_sample = {"config2": 1024, "config3": 64, "config5": 1024}
    for name, (family, fam_kw, opt_kw, sample) in BATCHED_CONFIGS.items():
        _emit(run_batched_config(name, family, fam_kw, opt_kw, sample,
                                 cpu_sample=cpu_sample[name]))
    rec = run_config4(**CONFIG4)
    rec.pop("x")
    _emit(rec)


def multi_card_phases(cards: int) -> None:
    _emit(run_dp_shardmap(cards))
    _emit(run_config4_mesh(cards, **CONFIG4))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="1: the one-card phases; N > 1: only the N-card phases")
    args = ap.parse_args(argv)
    device = None
    ok = False
    try:
        import jax

        jax.config.update("jax_enable_x64", True)
        from benlsip_tpu.harness.cache import enable_compile_cache
        from benlsip_tpu.harness.devices import device_record, require_gpu

        device = device_record()
        require_gpu()
        log(json.dumps({"phase": "device", **device}))
        log(f"card: {card_report()}")
        enable_compile_cache()
        if args.cards > 1:
            if device["count"] < args.cards:
                raise RuntimeError(f"--cards {args.cards} but JAX sees {device['count']}")
            multi_card_phases(args.cards)
        else:
            one_card_phases()
        ok = True
    except Exception:
        traceback.print_exc()
    print(json.dumps({"ok": ok, "device": device}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
