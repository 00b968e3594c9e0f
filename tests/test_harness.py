"""Harness tests: logging schema, metrics summaries, checkpoint/resume."""
import io
import os
import re

import numpy as np
import jax
import jax.numpy as jnp

from benlsip_tpu import SolverOptions, solve
from benlsip_tpu.harness.logging import set_log_stream
from benlsip_tpu.harness.metrics import MetricsWriter, batch_summary
from benlsip_tpu.problems import sphere_regression as sr


def test_verbose_logging_schema(tmp_path):
    # The reference's always-on log (quirk 5) becomes opt-in with the same
    # schema: banner, outer-iteration tables, inner-iteration rows.
    buf = io.StringIO()
    set_log_stream(buf)
    try:
        opts = SolverOptions(max_outer_iter=100, max_inner_iter=250, verbose=True)
        x, y, info = solve(sr.make_problem(), sr.x0(), opts)
        jax.effects_barrier()
    finally:
        set_log_stream(None)
    out = buf.getvalue()
    assert "Problem dimensions" in out
    assert "Number of parameters.................:     3" in out
    assert "Number of residuals..................:     4" in out
    assert re.search(r"Outer iter \d+", out)
    # inner rows: "   k   x.xxxxxxe+xx   x.xxe..."
    assert re.search(r"^\s+\d+\s+\d\.\d{6}e[+-]\d+\s+\d\.\d{2}e", out, re.M)
    assert bool(info.converged)


def test_metrics_batch_summary(tmp_path):
    from benlsip_tpu.batch.vmap_solve import solve_batched
    from benlsip_tpu.problems.generators import sphere_family

    bp, theta, X0 = sphere_family(8, seed=1)
    X, Y, info = solve_batched(bp, theta, X0, SolverOptions(max_outer_iter=100, max_inner_iter=300))
    s = batch_summary(info)
    assert s["batch"] == 8
    assert 0.0 <= s["converged_frac"] <= 1.0
    assert s["pix"]["p100"] >= s["pix"]["p50"]

    path = tmp_path / "metrics.jsonl"
    w = MetricsWriter(str(path))
    w.write(s, phase="test")
    w.close()
    import json

    row = json.loads(path.read_text().splitlines()[0])
    assert row["phase"] == "test" and row["batch"] == 8


def test_checkpoint_resume(tmp_path):
    from benlsip_tpu.harness.checkpoint import CheckpointedSolve
    from benlsip_tpu.problems.generators import sphere_family
    from benlsip_tpu.batch.vmap_solve import solve_batched

    bp, theta, X0 = sphere_family(4, seed=2)
    opts = SolverOptions(max_outer_iter=100, max_inner_iter=300)

    # Straight-through result for comparison.
    X_ref, Y_ref, i_ref = solve_batched(bp, theta, X0, opts)

    cdir = str(tmp_path / "ckpt")
    cs = CheckpointedSolve(bp, opts, cdir, batched=True, save_every=2)
    X1, Y1, info1 = cs.run(theta, X0, max_steps=3)  # interrupted early
    assert os.path.isdir(cdir)

    cs2 = CheckpointedSolve(bp, opts, cdir, batched=True, save_every=2)
    X2, Y2, info2 = cs2.run(theta, X0)  # resumes from step 3, runs to done
    assert bool(jnp.all(info2.converged))
    np.testing.assert_allclose(np.asarray(X2), np.asarray(X_ref), rtol=1e-6, atol=1e-8)
    # Multiplier parity with the fused path: the checkpointed runner must
    # apply the same critical-exit correction y_bar = y + mu*c as
    # solve_fixed_point, else Y comes back one first-order update stale.
    np.testing.assert_allclose(np.asarray(Y2), np.asarray(Y_ref), rtol=1e-6, atol=1e-8)


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    from benlsip_tpu.harness import cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from pathlib import Path

    from benlsip_tpu.harness import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = Path(__file__).resolve().parents[1]
    assert cache.compile_cache_dir() == str(root / ".jax_cache")
    # The path is part of the cache key: it must not move between calls.
    assert cache.compile_cache_dir() == cache.compile_cache_dir()
    assert ".jax_cache/" in (root / ".gitignore").read_text().split()


def test_peak_table_h100_row():
    from benlsip_tpu.harness.roofline import RooflineRow, peaks_for

    p = peaks_for("NVIDIA H100 80GB HBM3")
    assert p.tflops == {"float32": 67.0, "tf32": 495.0, "bfloat16": 989.0, "float64": 67.0}
    assert p.hbm_gbps == 3350.0
    # A precision maps to its peak directly; the floor is the larger bound.
    row = RooflineRow("gemm", flops=67e12, bytes_moved=1.0, wall_s=2.0, peaks=p)
    assert row.peak_tflops == 67.0 and row.bound == "compute"
    assert abs(row.sol_frac - 0.5) < 1e-12
    row_bw = RooflineRow("copy", flops=1.0, bytes_moved=3.35e12, wall_s=1.0, peaks=p,
                         precision="bfloat16")
    assert row_bw.bound == "bandwidth" and abs(row_bw.sol_frac - 1.0) < 1e-12


def test_peak_table_unknown_kind_raises():
    import pytest

    from benlsip_tpu.harness.roofline import peaks_for

    with pytest.raises(KeyError):
        peaks_for("cpu")


def test_require_gpu_refuses_cpu():
    import pytest

    from benlsip_tpu.harness.devices import require_gpu

    with pytest.raises(RuntimeError, match="no GPU"):
        require_gpu()


def test_step_record_collects_dispatches_and_fallback_lanes():
    from benlsip_tpu.harness.steps import dispatch, note_fallback, record_steps

    double = jax.jit(lambda x: 2 * x)
    x = jnp.arange(3.0)
    with record_steps() as rec:
        y = dispatch("double", double, x)
        note_fallback(2)
        note_fallback(3)
    np.testing.assert_array_equal(np.asarray(y), [0.0, 2.0, 4.0])
    assert [(name, prog) for name, prog, _ in rec.programs] == [("double", double)]
    assert rec.programs[0][2][0] is x and rec.fallback_lanes == 5
    # Outside the block nothing is kept, and the program still runs.
    np.testing.assert_array_equal(np.asarray(dispatch("double", double, x)), np.asarray(y))
    note_fallback(7)
    assert len(rec.programs) == 1 and rec.fallback_lanes == 5


def test_step_records_nest_without_sharing():
    from benlsip_tpu.harness.steps import note_fallback, record_steps

    with record_steps() as outer:
        note_fallback(1)
        with record_steps() as inner:
            note_fallback(4)
        note_fallback(2)
    assert outer.fallback_lanes == 3 and inner.fallback_lanes == 4
