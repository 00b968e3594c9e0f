"""Tests that need the card: the compiled GPU programs, not the CPU ones.

The CPU suite compiles every program for XLA:CPU, so a GPU-only failure
(cuSOLVER/cuBLAS lowering, TF32 products, device memory) first shows on
the card.  These tests skip without a GPU; on the card run

    BENLSIP_GPU_TESTS=1 python -m pytest tests/ -m gpu -q

(conftest.py leaves the platform alone when BENLSIP_GPU_TESTS=1).  The
whole main path at full size is `python chip_smoke.py`.
"""
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    """The first GPU, or a skip: decided when a test runs, never at import."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("no GPU; on the card: BENLSIP_GPU_TESTS=1 python -m pytest tests/ -m gpu")
    return devs[0]


def test_factorizations_compiled_on_gpu(gpu):
    with jax.default_device(gpu):
        errs = chip_smoke.check_factorizations(B=256)
    assert max(errs.values()) < 2e-4


def test_highest_precision_stays_out_of_tf32(gpu):
    with jax.default_device(gpu):
        res = chip_smoke.check_matmul_precision()
    assert res["differ"] and res["highest_rel_err"] < 1e-5, res


def test_solver_f32_end_to_end_on_gpu(gpu):
    # The whole jitted solve (while_loops, masked factors, projections) as
    # one compiled GPU program.
    from benlsip_tpu import SolverOptions, solve
    from benlsip_tpu.problems import sphere_regression as sr

    with jax.default_device(gpu):
        x, y, info = solve(
            sr.make_problem(dtype=jnp.float32),
            sr.x0(dtype=jnp.float32),
            SolverOptions(max_outer_iter=40, max_inner_iter=120),
        )
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x), [1.3747, 0.0876, 1.0500], atol=2e-3)


def test_certify_device_on_gpu_matches_host_grade(gpu):
    # certify="device": the f64 certification runs on the card; solutions
    # must certify to the same f64 KKT grade as the host path.
    from benlsip_tpu.batch.refine import solve_mixed_precision
    from benlsip_tpu.problems.generators import exp_fit_family
    from benlsip_tpu.solver.options import SolverOptions

    B = 128
    bp, theta, X0 = exp_fit_family(B, d=32, seed=21, dtype=jnp.float64)
    opts = SolverOptions(max_outer_iter=40, max_inner_iter=120)
    Xd, _, id_ = solve_mixed_precision(bp, theta, X0, opts, chunk=B, bulk_device=gpu,
                                       certify="device")
    Xh, _, ih = solve_mixed_precision(bp, theta, X0, opts, chunk=B, bulk_device=gpu,
                                      certify="host")
    assert np.asarray(id_.converged).mean() == 1.0
    assert np.asarray(ih.converged).mean() == 1.0
    np.testing.assert_allclose(np.asarray(Xd), np.asarray(Xh), atol=1e-7)
