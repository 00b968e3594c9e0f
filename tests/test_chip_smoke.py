"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusal to run
without a GPU.  The full sizes run on the card (`python chip_smoke.py`)."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_factorization_phase_tiny():
    errs = chip_smoke.check_factorizations(B=8, ms=(1, 3), qr_shape=(8, 3))
    assert set(errs) == {"chol_m1_max_err", "chol_m3_max_err", "qr_max_err"}
    assert max(errs.values()) < 2e-4


def test_matmul_precision_phase_tiny():
    res = chip_smoke.check_matmul_precision(d=32, n=8)
    # The CPU has no TF32, so the two precisions agree here; both are f32.
    assert res["highest_rel_err"] < 1e-5 and res["default_rel_err"] < 1e-5


def test_batched_config_phase_tiny():
    rec = chip_smoke.run_batched_config(
        "tiny", "exp_fit_family", dict(B=16, d=16, seed=1),
        dict(max_outer_iter=40, max_inner_iter=120), oracle_sample=4, cpu_sample=8,
    )
    assert rec["failures"] == [], rec
    assert rec["certified_frac"] == 1.0 and rec["oracle_agree"] == 4
    assert rec["fallback_lanes"] >= 0 and rec["x_max_diff_vs_cpu"] <= 1e-7
    # On the CPU certify="auto" resolves to host: the device program is the
    # chunked bulk solve.
    assert set(rec["step_memory"]) == {"bulk_chunk"}
    assert rec["step_memory"]["bulk_chunk"]["argument_size_in_bytes"] > 0


def test_batched_config_counts_real_fallback(monkeypatch):
    # No polish steps: the bulk point (crit_tol 1e-2) cannot certify at
    # √eps(f64), so the library's own full-refine fallback takes lanes.
    import functools

    from benlsip_tpu.batch import refine

    monkeypatch.setattr(refine, "solve_mixed_precision",
                        functools.partial(refine.solve_mixed_precision, polish_steps=0))
    rec = chip_smoke.run_batched_config(
        "tiny", "exp_fit_family", dict(B=8, d=16, seed=1),
        dict(max_outer_iter=40, max_inner_iter=120), oracle_sample=2,
    )
    assert rec["fallback_lanes"] > 0, rec
    assert rec["certified_frac"] == 1.0


def test_step_memory_reads_the_fused_program():
    # certify="device" sends a small-n family through the one-program fused
    # pipeline; its memory is what the step record reports, not a chunk
    # program that never ran.
    import jax.numpy as jnp

    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.harness.steps import record_steps
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    bp, theta, X0 = exp_fit_family(8, d=16, seed=1, dtype=jnp.float64)
    with record_steps() as steps:
        solve_mixed_precision(bp, theta, X0, SolverOptions(), certify="device")
    assert [name for name, _, _ in steps.programs] == ["fused_pipeline"]
    mem = chip_smoke.step_memory(steps)
    assert set(mem) == {"fused_pipeline"} and mem["fused_pipeline"]["output_size_in_bytes"] > 0


def test_config4_phase_tiny():
    rec = chip_smoke.run_config4(n=256, d=1024)
    assert rec["failures"] == [], rec
    assert rec["converged"] and rec["oracle_ok"] and rec["x"].shape == (256,)
    assert set(rec["step_memory"]) == {"blocked_solve"}


def test_multi_card_phases_tiny():
    # The tests' 8 virtual CPU devices stand in for the cards.
    dp = chip_smoke.run_dp_shardmap(4, B=16)
    assert dp["failures"] == [] and dp["x_max_diff"] == 0.0
    c4 = chip_smoke.run_config4_mesh(2, n=256, d=1024)
    assert c4["failures"] == [], c4


def _run_script(cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update({"JAX_PLATFORMS": "cpu", **(env_extra or {})})
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    return out.returncode, out.stdout.strip().splitlines()


def test_script_fails_without_gpu():
    rc, lines = _run_script(ROOT)
    assert rc != 0
    last = json.loads(lines[-1])
    assert last["ok"] is False and last["device"]["platform"] == "cpu"


def test_script_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    rc, lines = _run_script(tmp_path)
    assert rc != 0
    assert json.loads(lines[-1])["ok"] is False
