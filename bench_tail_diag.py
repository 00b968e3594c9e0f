"""Config-5 uncertified-tail root-cause diagnostic (VERDICT r4 #2).

The B=16,384 sweep certifies 99.99% — ~2 instances resist even the full
`refine_f64` fallback.  This script reproduces the tail and classifies
each resistant instance:

  1. run the standard pipeline on the config-5 family (seed 7);
  2. for every uncertified instance, rerun through
     (a) the full all-f64 solver from the ORIGINAL X0 with extended caps,
     (b) `refine_f64` from the pipeline's point with extended caps,
     (c) an all-f64 polish (`sqp_polish`) from the pipeline's point;
  3. run BOTH oracles (exact-projection certificate via the solve paths +
     the independent numpy KKT oracle) on every candidate point;
  4. print a per-instance classification:
       cap-exhaustion    — extended caps certify: the sweep's caps were
                           simply too small for this instance;
       polish-basin      — full solver certifies but the polish path
                           doesn't: the f32 point is outside the Newton
                           basin (pipeline fallback should have caught
                           it — solver defect if seen);
       degenerate        — nothing certifies: the instance itself is
                           ill-posed (report its data and the oracle's
                           stationarity floor).

Usage:  python bench_tail_diag.py [--B 16384]
The failing instance data is printed ready to paste into a test fixture.
Fails without a GPU.
"""
from __future__ import annotations

import argparse
import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=16384)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()

    from benlsip_tpu.baselines.kkt_oracle import kkt_check_point
    from benlsip_tpu.batch.refine import refine_f64, solve_mixed_precision
    from benlsip_tpu.batch.polish import sqp_polish
    from benlsip_tpu.batch.vmap_solve import solve_batched
    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    print(json.dumps({"device": require_gpu()}))
    enable_compile_cache()
    B = args.B
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=args.seed, dtype=jnp.float64)

    X, Y, info = solve_mixed_precision(bp, theta, X0, opts)
    conv = np.asarray(info.converged)
    bad = np.nonzero(~conv)[0]
    print(f"pipeline: {int(conv.sum())}/{B} certified; uncertified idx = {bad.tolist()}")
    if not len(bad):
        print(json.dumps({"tail": "empty", "B": B, "seed": args.seed}))
        return

    cpu = jax.devices("cpu")[0]
    ext = SolverOptions(max_outer_iter=200, max_inner_iter=500, max_minor_iter=50)

    def oracle(x, i):
        fns = bp.instance_fns(jax.tree.map(lambda a: a[i], theta))
        xj = jnp.asarray(x)
        return kkt_check_point(
            np.asarray(x, np.float64),
            np.asarray(fns.residuals(xj), np.float64),
            np.asarray(fns.jac_res(xj), np.float64),
            None, None,
            np.asarray(bp.A, np.float64), np.asarray(bp.b[i], np.float64),
            np.asarray(bp.xl, np.float64), np.asarray(bp.xu, np.float64),
        )

    def sub(i):
        import dataclasses

        bp_i = dataclasses.replace(bp, b=bp.b[i : i + 1])
        th_i = jax.tree.map(lambda a: a[i : i + 1], theta)
        return bp_i, th_i

    with jax.default_device(cpu):
        for i in bad:
            i = int(i)
            bp_i, th_i = sub(i)
            report = {
                "idx": i,
                "pipeline_pix": float(info.pix[i]),
                "pipeline_feas": float(info.feas[i]),
                "pipeline_status": int(info.status[i]),
            }
            # (a) full all-f64 solve from the ORIGINAL X0, extended caps
            Xa, Ya, ia = solve_batched(bp_i, th_i, X0[i : i + 1], ext)
            report["full_f64_ext_converged"] = bool(ia.converged[0])
            report["full_f64_ext_pix"] = float(ia.pix[0])
            report["full_f64_ext_outer"] = int(ia.outer_iters[0])
            report["full_f64_oracle"] = oracle(np.asarray(Xa[0]), i)["ok"]
            # (b) extended-cap refine from the pipeline's point
            Xb, Yb, ib = refine_f64(bp_i, th_i, X[i : i + 1], ext, max_outer=200)
            report["refine_ext_converged"] = bool(ib.converged[0])
            report["refine_ext_pix"] = float(ib.pix[0])
            report["refine_ext_oracle"] = oracle(np.asarray(Xb[0]), i)["ok"]
            # (c) all-f64 polish from the pipeline's point
            Xc, Yc, okc, pixc, feasc, _ = sqp_polish(
                bp_i, th_i, X[i : i + 1], opts, num_steps=8
            )
            report["polish_f64_certified"] = bool(okc[0])
            report["polish_f64_pix"] = float(pixc[0])

            if report["full_f64_ext_converged"] or report["refine_ext_converged"]:
                report["classification"] = "cap-exhaustion"
            elif report["full_f64_oracle"] or report["refine_ext_oracle"]:
                report["classification"] = "certificate-vs-oracle-disagreement"
            else:
                report["classification"] = "degenerate-instance"
                orc = oracle(np.asarray(Xb[0]), i)
                report["oracle_detail"] = {
                    k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in orc.items()
                }
            # Fixture data for a committed reproduction test.
            report["fixture"] = {
                "y": np.asarray(theta["y"][i]).tolist(),
                "t_first_last": [float(theta["t"][i][0]), float(theta["t"][i][-1])],
                "b_rhs": float(bp.b[i][0]),
                "x0": np.asarray(X0[i]).tolist(),
                "x_pipeline": np.asarray(X[i]).tolist(),
            }
            print(json.dumps(report))


if __name__ == "__main__":
    main()
