"""ctypes bindings to the native (C++) polyhedral-projection QP solver.

The reference's only foreign-solver boundary is the JuMP→Ipopt call for
exact polyhedral projection (`/root/reference/src/polyhedral_constraints.jl:185-197`,
SURVEY.md §3.4).  `native/polyqp.cpp` is this framework's native
equivalent — a dependency-free dual active-set Newton solver — exposed
here through ctypes (no pybind11 in the image).  It serves as the
host-side ground-truth oracle in tests and as a fast CPU path for callers
outside jit; the on-device jittable twin lives in `ops/polyproject.py`.

The shared library is built on demand with g++ (cached next to the
source); `available()` reports whether a toolchain/library is present so
callers can skip gracefully.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.abspath(os.path.join(_HERE, "..", "..", "native"))
_SRC = os.path.join(_NATIVE_DIR, "polyqp.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libpolyqp.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # Build to a private file, then rename: processes that build at once
    # (test workers) never load a half-written library.
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        if not _build():
            return None
    lib = ctypes.CDLL(_LIB)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.polyqp_project.restype = ctypes.c_int
    lib.polyqp_project.argtypes = [ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, ctypes.c_double, ctypes.c_int]
    lib.polyqp_project_batch.restype = ctypes.c_int
    lib.polyqp_project_batch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, dp, dp, dp, dp, dp, dp, ctypes.c_double, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _as_c(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def projection_polyhedron_host(
    x: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    l: np.ndarray,
    u: np.ndarray,
    tol: float = 1e-12,
    max_iter: int = 200,
) -> np.ndarray:
    """Project x (n,) or (batch, n) onto {v : Av=b, l ≤ v ≤ u} on the host.

    Raises RuntimeError if the native library is unavailable or the solve
    does not reach tol.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native polyqp library unavailable (no g++?)")
    x = np.ascontiguousarray(x, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64)
    l = np.ascontiguousarray(l, dtype=np.float64)
    u = np.ascontiguousarray(u, dtype=np.float64)
    m, n = A.shape if A.size else (0, x.shape[-1])

    if x.ndim == 1:
        v = np.empty_like(x)
        rc = lib.polyqp_project(n, m, _as_c(x), _as_c(A), _as_c(b), _as_c(l), _as_c(u), _as_c(v), tol, max_iter)
        if rc < 0:
            raise RuntimeError("polyqp_project failed to converge")
        return v
    batch = x.shape[0]
    v = np.empty_like(x)
    rc = lib.polyqp_project_batch(batch, n, m, _as_c(x), _as_c(A), _as_c(b), _as_c(l), _as_c(u), _as_c(v), tol, max_iter)
    if rc < 0:
        raise RuntimeError(f"polyqp_project_batch failed at instance {-rc - 1}")
    return v
