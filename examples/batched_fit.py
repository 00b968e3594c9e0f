"""Batched parameter estimation: fit 4096 exponential-decay curves at once.

Each instance fits y ≈ a·exp(-b t) + c with bounds and a pinned intercept
(a + c = y(0), a per-instance linear equality).  The f32 bulk phase runs on
the default device (the GPU when there is one); the f64 refinement certifies
every fit to the 1.5e-8 KKT tolerance.  Run: python examples/batched_fit.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))  # repo-root run

import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp

from benlsip_tpu.batch.refine import solve_mixed_precision
from benlsip_tpu.harness.metrics import batch_summary
from benlsip_tpu.problems.generators import exp_fit_family
from benlsip_tpu.solver.options import SolverOptions

B = 4096
bp, theta, X0 = exp_fit_family(B, d=32, seed=0, dtype=jnp.float64)
opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)

t0 = time.time()
X, Y, info = solve_mixed_precision(bp, theta, X0, opts)
jax.block_until_ready(X)
wall = time.time() - t0

summary = batch_summary(info)
print(f"{B} fits in {wall:.2f}s  ->  {summary['converged_frac']*100:.1f}% to KKT 1.5e-8")
print("criticality quantiles:", summary["pix"])
print("sample (a, b, c):", X[:3])
