"""Multi-host sweep recipe: config-5 at pod scale.

Each host solves chunks of its OWN batch shard as independent programs
(the per-shard-exit execution model): no collective ever crosses hosts,
so N-host efficiency is bounded only by the spread of per-host chunk-wall
sums (tests/test_multihost.py runs it with two CPU processes).

Under a cluster launcher that `jax.distributed` can discover (SLURM, Open
MPI) each host runs THIS script unmodified; otherwise launch N processes
with explicit coordinator args, e.g.:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python examples/multihost_sweep.py --pid 0 --nprocs 2 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python examples/multihost_sweep.py --pid 1 --nprocs 2

Checkpoint/resume for long sweeps: harness/sweep.py adds chunk-grain
checkpointing with SIGKILL-safe bit-identical resume on top of exactly
this loop (tests/test_sweep_ckpt.py).
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

ap = argparse.ArgumentParser()
ap.add_argument("--pid", type=int, default=None, help="process id (local rehearsal)")
ap.add_argument("--nprocs", type=int, default=None)
ap.add_argument("--port", default="12399")
ap.add_argument("--B", type=int, default=4096, help="GLOBAL batch size")
ap.add_argument("--chunk", type=int, default=512)
args = ap.parse_args()

# Distributed init must precede ANY backend-touching work — including the
# benlsip_tpu package import (module setup touches the backend), so this
# uses jax.distributed directly; benlsip_tpu.dist.collectives
# .initialize_distributed is the same passthrough for programs that
# initialize before importing the package.
# x64 BEFORE any array exists — the f64 master data and certification
# phase depend on it in both modes.
jax.config.update("jax_enable_x64", True)
if args.pid is not None:
    # Explicit coordinator.  Under a cluster launcher, call with no args —
    # jax.distributed.initialize() discovers the cluster itself.
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.nprocs,
        process_id=args.pid,
    )
else:
    jax.distributed.initialize()  # cluster-launcher discovery

import jax.numpy as jnp

from benlsip_tpu.batch.refine import solve_mixed_precision
from benlsip_tpu.problems.generators import exp_fit_family
from benlsip_tpu.solver.options import SolverOptions

pid, nprocs = jax.process_index(), jax.process_count()
assert args.B % nprocs == 0, f"B={args.B} must divide evenly over {nprocs} hosts"
B_local = args.B // nprocs
lo = pid * B_local

# Every process builds the SAME deterministic family and takes its slice —
# on a real sweep each host would load its shard of the dataset instead.
# _slice_batched handles every per-instance polyhedron field generically.
from benlsip_tpu.batch.refine import _slice_batched

bp, theta, X0 = exp_fit_family(args.B, d=32, seed=7, dtype=jnp.float64)
bp_l, theta_l = _slice_batched(bp, theta, slice(lo, lo + B_local))
X0_l = X0[lo:lo + B_local]

opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
t0 = time.perf_counter()
X, Y, info = solve_mixed_precision(
    bp_l, theta_l, X0_l, opts, chunk=args.chunk, bulk_max_inner=8
)
jax.block_until_ready(X)
wall = time.perf_counter() - t0
conv = int(jnp.sum(info.converged))
print(f"[host {pid}/{nprocs}] {conv}/{B_local} certified in {wall:.2f}s "
      f"({conv/wall:.0f}/s local)")
