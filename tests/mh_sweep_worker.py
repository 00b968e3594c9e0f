"""Worker for the 2-process sweep-efficiency measurement (VERDICT r2 #5).

Config-5's multi-host execution model: each host solves chunks of its OWN
local batch shard as independent programs (the per-shard exit path), so
the N-host efficiency loss is the spread
of chunk walls across hosts, not communication.  This worker measures that
spread for real: it initializes the 2-process jax.distributed runtime
(bring-up parity with a pod), takes its process's slice of the config-5
family, runs it chunk by chunk, and reports per-chunk walls as JSON for
the parent (tests/test_multihost.py, bench_scaling.py --multihost) to
reduce into mean/max efficiency.

CLI: <pid> <nprocs> <port> <B> <chunk>
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
B, chunk = int(sys.argv[4]), int(sys.argv[5])
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid
)

import numpy as np
import jax.numpy as jnp

from benlsip_tpu.batch.vmap_solve import solve_batched_chunked
from benlsip_tpu.problems.generators import exp_fit_family
from benlsip_tpu.solver.options import SolverOptions

# The SAME deterministic family on every process (seed 7 = the config-5
# sweep); this process solves its contiguous local shard.
bp, theta, X0 = exp_fit_family(B, d=32, seed=7, dtype=jnp.float64)
lo, hi = pid * B // nprocs, (pid + 1) * B // nprocs
theta_l = jax.tree.map(lambda a: a[lo:hi], theta)
import dataclasses

bp_l = dataclasses.replace(bp, b=bp.b[lo:hi]) if bp.b is not None and bp.b.ndim > 1 else bp
X0_l = X0[lo:hi]
opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)

# Compile once on the first chunk shape (excluded from the timed walls).
warm = jax.tree.map(lambda a: a[:chunk], theta_l)
bp_w = dataclasses.replace(bp_l, b=bp_l.b[:chunk]) if bp_l.b is not None and bp_l.b.ndim > 1 else bp_l
solve_batched_chunked(bp_w, warm, X0_l[:chunk], opts, chunk=chunk)

walls = []
conv = 0
n_local = hi - lo
for k in range(0, n_local, chunk):
    sl = slice(k, min(k + chunk, n_local))
    th_c = jax.tree.map(lambda a: a[sl], theta_l)
    bp_c = dataclasses.replace(bp_l, b=bp_l.b[sl]) if bp_l.b is not None and bp_l.b.ndim > 1 else bp_l
    t0 = time.perf_counter()
    X, Y, info = solve_batched_chunked(bp_c, th_c, X0_l[sl], opts, chunk=chunk)
    jax.block_until_ready(X)
    walls.append(time.perf_counter() - t0)
    conv += int(jnp.sum(info.converged))

print(
    "MHSWEEP " + json.dumps({
        "pid": pid,
        "chunk_walls_s": [round(w, 4) for w in walls],
        "total_wall_s": round(sum(walls), 4),
        "converged": conv,
        "local_B": n_local,
    }),
    flush=True,
)
