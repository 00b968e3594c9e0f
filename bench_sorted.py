"""Measured lockstep-tail experiment: difficulty-sorted vs unsorted chunks.

VERDICT r2 #3: the N-shard efficiency argument leans on difficulty-sorted
chunking to bound tail imbalance, but no recorded bench had sorting
enabled.  This script measures the config-5 sweep's f32 bulk
phase (the lockstep-bound part; the f64 certify leg is per-instance host
work) chunk by chunk, unsorted and pilot-sorted, and records

  * per-chunk walls + their spread (max-min)/max — the tail-imbalance
    statistic the multi-shard efficiency model needs,
  * total bulk walls for both orders, with the pilot's cost included on
    the sorted side (it must amortize to win).

  python bench_sorted.py [--B 102400 --chunk 512] [--out FILE]

One JSON row per order + a comparison row on stdout, each with the device
record; also appended to --out when given.  Fails without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=102400)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--out", default=None, help="also append the rows to this JSONL file")
    args = ap.parse_args()
    B, chunk = args.B, args.chunk

    from benlsip_tpu.batch.buckets import difficulty_order, reorder
    from benlsip_tpu.batch.refine import _cast_tree
    from benlsip_tpu.batch.vmap_solve import solve_batched_chunked
    from benlsip_tpu.harness.metrics import MetricsWriter
    from benlsip_tpu.harness.transfer import pack_device_put
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    from benlsip_tpu.harness.cache import enable_compile_cache
    from benlsip_tpu.harness.devices import require_gpu

    device = require_gpu()
    enable_compile_cache()
    dev = jax.devices()[0]
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120, crit_tol=1e-2)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=7, dtype=jnp.float64)
    theta32 = _cast_tree(theta, jnp.float32)
    bp32 = dataclasses.replace(
        bp,
        A=bp.A.astype(jnp.float32), b=bp.b.astype(jnp.float32),
        xl=bp.xl.astype(jnp.float32), xu=bp.xu.astype(jnp.float32),
    )
    X032 = X0.astype(jnp.float32)
    theta32, X032, b32 = pack_device_put((theta32, X032, bp32.b), dev)
    bp32 = dataclasses.replace(bp32, b=b32)

    def chunk_walls(th, x0, bpp, label):
        walls = []
        # Warm: first chunk compiles; run it once untimed.
        sl0 = slice(0, chunk)
        bc = dataclasses.replace(bpp, b=bpp.b[sl0])
        Xw, _, _ = solve_batched_chunked(bc, jax.tree.map(lambda a: a[sl0], th), x0[sl0], opts, chunk=chunk)
        jax.block_until_ready(Xw)
        conv = 0
        for k in range(0, B, chunk):
            sl = slice(k, min(k + chunk, B))
            bc = dataclasses.replace(bpp, b=bpp.b[sl])
            t0 = time.perf_counter()
            Xc, _, ic = solve_batched_chunked(
                bc, jax.tree.map(lambda a: a[sl], th), x0[sl], opts, chunk=chunk
            )
            jax.block_until_ready(Xc)
            walls.append(time.perf_counter() - t0)
            conv += int(jnp.sum(ic.converged))
        return walls, conv

    # --- unsorted ---
    walls_u, conv_u = chunk_walls(theta32, X032, bp32, "unsorted")

    # --- pilot + sort ---
    t0 = time.perf_counter()
    pilot_opts = dataclasses.replace(opts, max_outer_iter=2, max_inner_iter=8)
    _, _, pinfo = solve_batched_chunked(bp32, theta32, X032, pilot_opts, chunk=chunk)
    jax.block_until_ready(pinfo.inner_iters.astype(jnp.float32))
    cost = np.asarray(pinfo.inner_iters) + 1000 * (~np.asarray(pinfo.converged))
    order = np.argsort(cost, kind="stable")
    jorder = jnp.asarray(order)
    theta_s = reorder(theta32, order)
    X0_s = X032[jorder]
    bp_s = dataclasses.replace(bp32, b=bp32.b[jorder])
    pilot_s = time.perf_counter() - t0

    walls_s, conv_s = chunk_walls(theta_s, X0_s, bp_s, "sorted")

    def stats(walls):
        w = np.asarray(walls)
        return {
            "total_s": round(float(w.sum()), 3),
            "chunk_mean_s": round(float(w.mean()), 4),
            "chunk_max_s": round(float(w.max()), 4),
            "chunk_min_s": round(float(w.min()), 4),
            "chunk_spread": round(float((w.max() - w.min()) / w.max()), 4),
            "mean_over_max": round(float(w.mean() / w.max()), 4),
        }

    w = MetricsWriter(args.out) if args.out else None
    rows = [
        {"config": "sorted-chunks", "order": "unsorted", "B": B, "chunk": chunk,
         "converged": conv_u, **stats(walls_u), "device": device},
        {"config": "sorted-chunks", "order": "sorted", "B": B, "chunk": chunk,
         "converged": conv_s, "pilot_s": round(pilot_s, 3), **stats(walls_s),
         "device": device},
        {"config": "sorted-chunks", "order": "comparison", "B": B, "chunk": chunk,
         "sorted_total_incl_pilot_s": round(sum(walls_s) + pilot_s, 3),
         "unsorted_total_s": round(sum(walls_u), 3),
         "speedup_x": round(sum(walls_u) / (sum(walls_s) + pilot_s), 3),
         "device": device},
    ]
    for r in rows:
        if w:
            w.write(r)
        print(json.dumps(r), flush=True)
    if w:
        w.close()


if __name__ == "__main__":
    main()
