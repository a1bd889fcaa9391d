"""CPU-exact eigen solve driven by the native C++ assembly engine.

Numerically equivalent to the reference binary (assembly matches to machine
roundoff -- see tests/test_native.py) but ~2.5x faster than the reference's
thread pool on the same cores, and with no external binary dependency.
Used for f64 golden generation/validation and as the no-accelerator
fallback; the device path lives in ``eigen.py``.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..ops.singularity import singularity_coeff_matrix
from .pic import RK_COEF  # noqa: F401  (re-exported convenience)


def _qr_secant_delta(M, dM):
    """The reference's QRSecant update (solver.h:210-383) with the SAME
    LAPACK kernel it calls: scipy.linalg.qr(pivoting=True) wraps zgeqp3, so
    pivots and phases match the reference bit-for-bit.  M P = Q R;
    v = P [-R_11^{-1} r; 1]; d_omega = -R_nn / (Q^H dM v)_n."""
    import scipy.linalg as sla

    n = M.shape[0]
    Q, R, perm = sla.qr(M, pivoting=True)
    w = sla.solve_triangular(R[: n - 1, : n - 1], R[: n - 1, n - 1])
    v = np.zeros(n, dtype=M.dtype)
    v[perm[: n - 1]] = -w
    v[perm[n - 1]] = 1.0
    u = Q.conj().T @ (dM @ v)
    return -R[n - 1, n - 1] / u[n - 1]


def solve(p, omega_init: complex, tol: float = 1e-6, callback=None,
          n_threads=None, method: str = "TraceSecant"):
    """Newton secant iteration (solver.h:113-160 TraceSecant /
    solver.h:210-383 QRSecant semantics) with native assembly and
    LAPACK-backed numpy/scipy linear algebra."""
    import scipy.linalg as sla

    coeff = np.asarray(singularity_coeff_matrix(p.npoints, dtype=np.float64))

    omega = 0.99 * complex(omega_init)
    d_omega = 0.01 * complex(omega_init)
    M_old = native.assemble(p, coeff, omega, n_threads)
    omega = omega + d_omega
    M = native.assemble(p, coeff, omega, n_threads)
    dM = (M - M_old) / d_omega

    n_steps = 0
    for j in range(p.iteration_step_limit + 1):
        if method == "QRSecant":
            d_omega = _qr_secant_delta(M, dM)
        else:
            X = sla.lu_solve(sla.lu_factor(M), dM)
            d_omega = -1.0 / np.trace(X)
        omega = omega + d_omega
        M_new = native.assemble(p, coeff, omega, n_threads)
        dM = (M_new - M) / d_omega
        M = M_new
        n_steps = j + 1
        if callback is not None:
            callback(j, omega, d_omega)
        if abs(d_omega) < tol * abs(omega):
            break

    _, _, vh = np.linalg.svd(M)
    vec = np.conj(vh[-1, :])
    return omega, vec, n_steps, M
