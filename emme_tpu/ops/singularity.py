"""Quadrature-correction coefficient matrix for the |eta - eta'| kernel
singularity (reference src/singularity_handler.cpp:3-24): a band of 6
Lagrange-type coefficients by |i-j|, 1.0 elsewhere, and a -0.5 trapezoid
end-correction on the first/last columns."""
import functools

import numpy as np
import jax.numpy as jnp

_COEFF = np.array([
    0.0,
    2.951388888888883,
    -2.4305555555555305,
    4.166666666667441,
    -0.3472222222224549,
    1.159722222222284,
])

# half-width of the correction band (|i-j| <= 5 gets non-unit coefficients)
SINGULAR_BAND_HALF_WIDTH = 5


@functools.lru_cache(maxsize=8)
def _coeff_matrix_cached(n: int, dtype_name: str):
    dtype = jnp.dtype(dtype_name)

    def build():
        i = jnp.arange(n)
        diff = jnp.abs(i[:, None] - i[None, :])
        mat = jnp.where(diff <= 5,
                        jnp.asarray(_COEFF, dtype)[jnp.minimum(diff, 5)],
                        jnp.asarray(1.0, dtype))
        edge = (i[None, :] == 0) | (i[None, :] == n - 1)
        return (mat - 0.5 * edge.astype(dtype)).astype(dtype)

    import jax
    return jax.jit(build)()


def singularity_coeff_matrix(n: int, dtype=jnp.float64):
    """Dense (n, n) coefficient matrix, built ON DEVICE and cached per
    shape (the n=4096 matrix is 67 MB; building it on the host and
    transferring it would cost time on every solve)."""
    return _coeff_matrix_cached(int(n), jnp.dtype(dtype).name)


@functools.lru_cache(maxsize=16)
def _coeff_band_cached(n: int, h_el: int, dtype_name: str):
    """Device-side construction (iota + where): the band at n=8192 is
    (8192, 4351) = 142 MB, too large to build in numpy and transfer on
    every solve.  jax arrays are immutable, so caching per shape is safe;
    scans re-solving at every point hit the cache."""
    dtype = jnp.dtype(dtype_name)

    def build():
        dj = jnp.arange(-h_el, h_el + 1)
        adj = jnp.abs(dj)
        base = jnp.where(adj <= 5,
                         jnp.asarray(_COEFF, dtype)[jnp.minimum(adj, 5)],
                         jnp.asarray(1.0, dtype))
        j = jnp.arange(n)[:, None] + dj[None, :]
        corr = 0.5 * ((j == 0) | (j == n - 1)).astype(dtype)
        return (jnp.broadcast_to(base[None, :], (n, 2 * h_el + 1))
                - corr).astype(dtype)

    # one jitted program instead of one dispatch per eager op
    import jax
    return jax.jit(build)()


def singularity_coeff_band(n: int, h_el: int, dtype=jnp.float64):
    """Banded storage of the same coefficients: (n, 2*h_el+1) with
    band[i, dj + h_el] = coeff[i, i + dj].  O(n * band) memory -- the dense
    (n, n) matrix never exists (used by the direct-to-sparse assembly)."""
    return _coeff_band_cached(int(n), int(h_el), jnp.dtype(dtype).name)
