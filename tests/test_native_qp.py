"""Native C++ QP oracle: cross-validate against the jittable on-device
projection and scipy (three independent implementations of the Ipopt-role
capability, SURVEY.md §2.4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from benlsip_tpu.ops.constraints import Polyhedron
from benlsip_tpu.ops.native_qp import available, projection_polyhedron_host
from benlsip_tpu.ops.polyproject import projection_polyhedron


@pytest.fixture(autouse=True)
def _native_toolchain():
    """Skip without a C++ toolchain: decided when a test runs, never at
    import, so every test worker collects the same tests."""
    if not available():
        pytest.skip("no native toolchain")


rng = np.random.default_rng(9)


def test_native_matches_device_and_feasible():
    for trial in range(6):
        m, n = int(rng.integers(0, 4)), 10
        A = rng.standard_normal((m, n))
        v_feas = rng.standard_normal(n)
        l = v_feas - rng.random(n) * 2
        u = v_feas + rng.random(n) * 2
        b = A @ v_feas
        x = rng.standard_normal(n) * 3

        v_host = projection_polyhedron_host(x, A, b, l, u)
        assert np.all(v_host >= l - 1e-10) and np.all(v_host <= u + 1e-10)
        if m:
            np.testing.assert_allclose(A @ v_host, b, atol=1e-9)

        poly = Polyhedron(A=jnp.asarray(A), b=jnp.asarray(b), xl=jnp.asarray(l), xu=jnp.asarray(u))
        v_dev = np.asarray(projection_polyhedron(poly, jnp.asarray(x)))
        np.testing.assert_allclose(v_host, v_dev, atol=1e-8)


def test_native_batch():
    m, n, B = 2, 6, 64
    A = rng.standard_normal((m, n))
    vf = rng.standard_normal(n)
    l, u = vf - 1, vf + 1
    b = A @ vf
    X = rng.standard_normal((B, n)) * 2
    V = projection_polyhedron_host(X, A, b, l, u)
    assert V.shape == (B, n)
    np.testing.assert_allclose(V @ A.T, np.broadcast_to(b, (B, m)), atol=1e-9)
    # Spot-check one instance against the single-call path.
    np.testing.assert_allclose(V[7], projection_polyhedron_host(X[7], A, b, l, u), atol=1e-12)


def test_native_hs48_fixture():
    # Same fixture as the reference's Ipopt check (test/structures.jl:37-58).
    A = np.array([[1.0, 1, 1, 1, 1], [0, 0, 1, -2, -2]])
    b = np.array([5.0, -3])
    x = np.array([3.0, 5, -3, 2, -2])
    l = np.full(5, -1e6)
    u = np.full(5, 1e6)
    v = projection_polyhedron_host(x, A, b, l, u)
    np.testing.assert_allclose(v, x, atol=1e-9)  # x already feasible


@pytest.mark.skipif(not available(), reason="native toolchain unavailable")
def test_native_degenerate_rows_match_jittable():
    """Degenerate-A parity: the native dual Newton's escalating
    scale-relative shift must deliver the same projection as the jittable
    twin on rank-deficient consistent systems (VERDICT r2 #6)."""
    n = 8
    r = np.random.default_rng(11)
    A1 = r.standard_normal((2, n))
    A = np.vstack([A1, 2.0 * A1[0:1], np.zeros((1, n))])
    xt = r.standard_normal(n)
    b1 = A1 @ xt
    b = np.concatenate([b1, [2.0 * b1[0]], [0.0]])
    l, u = np.full(n, -2.0), np.full(n, 2.0)
    for seed in range(4):
        z = np.random.default_rng(seed).standard_normal(n) * 3
        v_host = projection_polyhedron_host(z, A, b, l, u)
        poly = Polyhedron(A=jnp.asarray(A), b=jnp.asarray(b),
                          xl=jnp.asarray(l), xu=jnp.asarray(u))
        v_dev = np.asarray(projection_polyhedron(poly, jnp.asarray(z)))
        assert np.all(np.isfinite(v_host))
        np.testing.assert_allclose(A @ v_host, b, atol=1e-8)
        np.testing.assert_allclose(v_host, v_dev, atol=1e-7)
