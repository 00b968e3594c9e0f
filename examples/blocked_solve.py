"""Large single instance with the Jacobian row-blocked across the mesh.

BASELINE config 4: one constrained linear-least-squares instance whose
(d, n) Jacobian is too large for one device's HBM at production scale, so
its rows shard over the mesh's 'block' axis.  Two equivalent drivers:

* `solve_large_blocked_family` — declarative: sharding constraints on the
  Jacobian, XLA's SPMD partitioner inserts the psums (the default).
* `solve_large_blocked_shardmap` — explicit collectives under shard_map,
  with the communication layout under your control: here the row-sharded
  Gram operator (`gram_layout="sharded"`, reduce-scatter refresh at half
  the all-reduce traffic and n²/D operator memory per device) on the
  hand-scheduled ppermute ring (`reduce_schedule="ring"`).

On one card the mesh is trivial; run on CPU with a virtual mesh to see
the multi-device program:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/blocked_solve.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # repo-root run

import dataclasses
import time

import jax

import jax.numpy as jnp
import numpy as np

from benlsip_tpu.batch.vmap_solve import BatchedProblem
from benlsip_tpu.dist.mesh import make_mesh
from benlsip_tpu.dist.sharded import (
    solve_large_blocked_family,
    solve_large_blocked_shardmap,
)
from benlsip_tpu.solver.options import SolverOptions

n_dev = len(jax.devices())
mesh = make_mesh(batch=1, block=n_dev)
n, d, m = 512, 4096, 8
assert d % n_dev == 0 and n % n_dev == 0

rng = np.random.default_rng(0)
J = jnp.asarray(rng.standard_normal((d, n)).astype(np.float32) / np.sqrt(d))
x_true = rng.standard_normal(n).astype(np.float32)
y = J @ jnp.asarray(x_true) + 0.01 * jnp.asarray(rng.standard_normal(d).astype(np.float32))
A = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32) / np.sqrt(n))
theta = {"J": J, "y": y}
bp = BatchedProblem(
    residuals=lambda x, th: th["J"] @ x - th["y"],
    jac_res=lambda x, th: th["J"],
    A=A,
    b=A @ jnp.asarray(x_true),
    xl=jnp.full(n, -3.0, jnp.float32),
    xu=jnp.full(n, 3.0, jnp.float32),
)
# The family is linear LSQ (constant J), so the J^T J Gram block is paid
# once per solve instead of per accepted step.
opts = SolverOptions(max_outer_iter=10, max_inner_iter=60, linear_residuals=True)
x0 = jnp.zeros(n, jnp.float32)

for name, run in [
    ("pjit (XLA-inserted collectives)", lambda o: solve_large_blocked_family(bp, theta, x0, o, mesh)),
    (
        "shard_map + sharded Gram + ring",
        lambda o: solve_large_blocked_shardmap(
            bp,
            theta,
            x0,
            dataclasses.replace(o, gram_layout="sharded", reduce_schedule="ring"),
            mesh,
        ),
    ),
]:
    x, lam, info = run(opts)          # compile + first solve
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    x, lam, info = run(opts)          # warm
    jax.block_until_ready(x)
    dt = time.perf_counter() - t0
    print(
        f"{name:34s} devices={n_dev} converged={bool(info.converged)} "
        f"outer={int(info.outer_iters)} inner={int(info.inner_iters)} "
        f"warm={dt:.3f}s  ‖x−x*‖∞={float(jnp.max(jnp.abs(x - jnp.asarray(x_true)))):.2e}"
    )
