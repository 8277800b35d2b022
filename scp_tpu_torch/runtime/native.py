"""ctypes binding to the native host QP solver (counterpart of
``scp_tpu/runtime/native.py``).

``solve_qp_native`` calls the C++ dense IPM QP solver of
``runtime/qp_ipm.cpp`` (``runtime/libscpqp.so``), the in-tree replacement
for the original controller's Gurobi dependency: a host-side oracle for the
port's solver. Where ``runtime/libscpqp.so`` is missing, the library is
built from ``runtime/qp_ipm.cpp`` into the git-ignored ``build/`` directory
of the repository (never into ``runtime/``); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_RUNTIME_DIR = _REPO / "runtime"
_LIB_PATH = _RUNTIME_DIR / "libscpqp.so"
_BUILD_DIR = _REPO / "build"
# the flags of runtime/Makefile
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-Wextra")
_lib = None


class NativeQPSolution(NamedTuple):
    x: np.ndarray
    obj: float
    gap: float
    primal_residual: float
    iters: int
    converged: bool


def _library_path() -> Path:
    """The shared library: the one in ``runtime/`` where it exists, else one
    built from the source into ``build/``."""
    if _LIB_PATH.exists():
        return _LIB_PATH
    out = _BUILD_DIR / "libscpqp.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-shared", "-o",
               str(out), str(_RUNTIME_DIR / "qp_ipm.cpp")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native QP solver failed: "
                               f"{' '.join(cmd)}\n{proc.stderr}")
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_library_path()))
    dptr = ctypes.POINTER(ctypes.c_double)
    lib.scp_qp_solve.restype = ctypes.c_int
    lib.scp_qp_solve.argtypes = [
        ctypes.c_int, ctypes.c_int, dptr, dptr, dptr, dptr, dptr, dptr,
        ctypes.c_int, ctypes.c_double, dptr, dptr,
    ]
    _lib = lib
    return lib


def _host(a) -> np.ndarray:
    """float64 numpy copy of an array-like or a tensor on any device."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float64)


def _as_c(a):
    a = _host(a)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def solve_qp_native(P, q, G, h, lb, ub, max_iter: int = 50,
                    tol: float = 1e-10) -> NativeQPSolution:
    """Solve min 0.5 x'Px + q'x  s.t. Gx <= h, lb <= x <= ub on the host
    (one unbatched QP; numpy arrays or tensors)."""
    lib = _load()
    q = _host(q).reshape(-1)
    h = _host(h).reshape(-1)
    n = len(q)
    m = len(h)
    P_, Pp = _as_c(_host(P).reshape(n, n))
    q_, qp_ = _as_c(q)
    G_, Gp = _as_c(_host(G).reshape(m, n) if m else np.zeros((0, n)))
    h_, hp_ = _as_c(h if m else np.zeros(0))
    lb_, lbp = _as_c(_host(lb).reshape(n))
    ub_, ubp = _as_c(_host(ub).reshape(n))
    x = np.zeros(n, np.float64)
    info = np.zeros(3, np.float64)
    xp = x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    ip = info.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    rc = lib.scp_qp_solve(n, m, Pp, qp_, Gp, hp_, lbp, ubp, max_iter,
                          tol, xp, ip)
    if rc == -2:
        raise RuntimeError("native QP solver: numerical failure")
    return NativeQPSolution(x=x, obj=float(info[0]), gap=float(info[1]),
                            primal_residual=float(info[2]),
                            iters=abs(rc), converged=rc >= 0)
