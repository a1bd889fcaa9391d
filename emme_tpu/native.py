"""ctypes bindings for the native C++ assembly engine (native/emme_native.cpp).

The native engine is the CPU-exact counterpart of the device path: adaptive
Gauss-Kronrod quadrature in f64 with the same physics kernels, multithreaded
over matrix entries.  Used for self-validation goldens and as a fast CPU f64
assembly backend.  Built on demand with the toolchain in native/Makefile.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libemme_native.so"

_GEOMETRY_IDS = {
    "tokamak": 0,
    "stellarator": 1,
    "cylinder": 2,
    "cylinder old": 3,
    "taloyMagneticDrift": 4,
}


class _Phys(ctypes.Structure):
    _fields_ = [
        ("q", ctypes.c_double), ("shat", ctypes.c_double),
        ("tau", ctypes.c_double), ("epsilon_n", ctypes.c_double),
        ("epsilon_r", ctypes.c_double), ("eta_i", ctypes.c_double),
        ("eta_e", ctypes.c_double), ("b_theta", ctypes.c_double),
        ("beta_e", ctypes.c_double), ("R", ctypes.c_double),
        ("vt", ctypes.c_double), ("omega_d_coeff", ctypes.c_double),
        ("length", ctypes.c_double), ("theta", ctypes.c_double),
        ("arc_coeff", ctypes.c_double),
        ("eta_k", ctypes.c_double), ("lh", ctypes.c_double),
        ("mh", ctypes.c_double), ("epsilon_h_t", ctypes.c_double),
        ("alpha_0", ctypes.c_double), ("r_over_R", ctypes.c_double),
        ("geometry", ctypes.c_int32), ("gk_order", ctypes.c_int32),
        ("integration_rel_tol", ctypes.c_double),
        ("precision_goal", ctypes.c_double),
        ("max_subdivide", ctypes.c_int32),
        ("cylinder_shat_coeff", ctypes.c_double),
    ]


_lib = None


def build(force: bool = False) -> pathlib.Path:
    """Compile the shared library if missing/stale."""
    src = _NATIVE_DIR / "emme_native.cpp"
    if force or not _LIB_PATH.exists() or \
            _LIB_PATH.stat().st_mtime < src.stat().st_mtime:
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True)
    return _LIB_PATH


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def load():
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.emme_kappa_batch.argtypes = [
        ctypes.POINTER(_Phys), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
    lib.emme_assemble.argtypes = [
        ctypes.POINTER(_Phys), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_double)]
    lib.emme_g_bi.argtypes = [
        ctypes.POINTER(_Phys), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def phys_from_params(p) -> _Phys:
    ph = _Phys()
    for name in ("q", "shat", "tau", "epsilon_n", "epsilon_r", "eta_i",
                 "eta_e", "b_theta", "beta_e", "R", "vt", "omega_d_coeff",
                 "length", "theta", "arc_coeff", "eta_k", "lh", "mh",
                 "epsilon_h_t", "alpha_0", "r_over_R"):
        setattr(ph, name, float(getattr(p, name)))
    ph.geometry = _GEOMETRY_IDS[p.conf]
    ph.gk_order = int(p.integration_start_points)
    ph.integration_rel_tol = float(p.integration_precision)
    ph.precision_goal = float(p.integration_accuracy)
    ph.max_subdivide = int(p.integration_iteration_limit)
    ph.cylinder_shat_coeff = float(p.cyl_shat_coeff) \
        if p.conf == "cylinder" else 0.0
    return ph


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def kappa_batch(p, m, eta, eta_p, omega, with_electron=False,
                n_threads=None):
    """Native adaptive-quadrature kappa for arrays of (m, eta, eta_p)."""
    lib = load()
    ph = phys_from_params(p)
    m = np.ascontiguousarray(np.broadcast_to(m, np.shape(eta)), np.int32)
    eta = np.ascontiguousarray(eta, np.float64)
    eta_p = np.ascontiguousarray(eta_p, np.float64)
    out = np.empty(2 * eta.size, np.float64)
    n_threads = n_threads or os.cpu_count() or 1
    lib.emme_kappa_batch(
        ctypes.byref(ph), m.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _dptr(eta), _dptr(eta_p), float(np.real(omega)), float(np.imag(omega)),
        eta.size, int(bool(with_electron)), int(n_threads), _dptr(out))
    return out[0::2] + 1j * out[1::2]


def assemble(p, coeff, omega, n_threads=None):
    """Native dense assembly; returns complex128 (dim, dim)."""
    lib = load()
    ph = phys_from_params(p)
    n = int(p.npoints)
    dim = 2 * n if p.electromagnetic else n
    coeff = np.ascontiguousarray(coeff, np.float64)
    out = np.empty(2 * dim * dim, np.float64)
    n_threads = n_threads or os.cpu_count() or 1
    lib.emme_assemble(
        ctypes.byref(ph), n, _dptr(coeff), float(np.real(omega)),
        float(np.imag(omega)), int(bool(p.electromagnetic)), int(n_threads),
        _dptr(out))
    return (out[0::2] + 1j * out[1::2]).reshape(dim, dim)


def g_bi(p, eta):
    lib = load()
    ph = phys_from_params(p)
    eta = np.ascontiguousarray(eta, np.float64)
    g = np.empty_like(eta)
    bi = np.empty_like(eta)
    lib.emme_g_bi(ctypes.byref(ph), _dptr(eta), eta.size, _dptr(g), _dptr(bi))
    return g, bi
