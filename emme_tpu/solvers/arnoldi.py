"""Batched shift-invert Arnoldi for the nonlinear eigenproblem M(omega)x = 0.

The BASELINE north star's alternative eigensolve path: linearize about a
shift sigma,

    M(omega) ~ M(sigma) + (omega - sigma) M'(sigma),

so nontrivial null vectors satisfy  B x = mu x  with B = M(sigma)^{-1}
M'(sigma) and omega = sigma - 1/mu.  The factor M(sigma)^{-1} is the
"shift-invert" spectral transform: eigenvalues of the pencil closest to
sigma map to the LARGEST |mu|, which plain Arnoldi finds first.  M'(sigma)
comes from the same secant difference the reference Newton uses
(solver.h:54-57).

The whole pipeline is vmappable over a batch of shifts (the parameter-scan /
multi-mode use case: 16 shifts sharded across hosts over the mesh's ``scan``
axis), and each converged estimate can be polished by a couple of
Newton-trace-secant steps to the reference tolerance.

Inner products and basis updates run on (re, im) real planes; the small
Hessenberg eigenproblem is solved on host with numpy.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..grid import Grid
from ..ops import linalg
from ..ops.singularity import singularity_coeff_matrix
from . import eigen as eigen_mod


def _cdot(ar, ai, br, bi):
    """<a, b> = conj(a)^T b on planes -> (re, im)."""
    return (jnp.sum(ar * br) + jnp.sum(ai * bi),
            jnp.sum(ar * bi) - jnp.sum(ai * br))


def arnoldi_factorization(solve_B, n, m_krylov: int, dtype=jnp.float64,
                          seed_vec=None):
    """m-step Arnoldi on the operator x -> B x given as ``solve_B(xr, xi)``
    -> (yr, yi).  Returns (Vr, Vi) of shape (m+1, n) and H (m+1, m) as
    (Hr, Hi) planes.  Modified Gram-Schmidt on real planes."""
    if seed_vec is None:
        vr = jnp.ones((n,), dtype)
        vi = 0.3 * jnp.arange(n, dtype=dtype) / n
    else:
        vr, vi = seed_vec
    nrm = jnp.sqrt(jnp.sum(vr * vr + vi * vi))
    vr, vi = vr / nrm, vi / nrm

    Vr = jnp.zeros((m_krylov + 1, n), dtype).at[0].set(vr)
    Vi = jnp.zeros((m_krylov + 1, n), dtype).at[0].set(vi)
    Hr = jnp.zeros((m_krylov + 1, m_krylov), dtype)
    Hi = jnp.zeros((m_krylov + 1, m_krylov), dtype)

    def body(j, carry):
        Vr, Vi, Hr, Hi = carry
        wr, wi = solve_B(Vr[j], Vi[j])

        def mgs(i, c):
            wr, wi, Hr, Hi = c
            hr, hi = _cdot(Vr[i], Vi[i], wr, wi)
            # mask out basis vectors beyond j
            valid = i <= j
            hr = jnp.where(valid, hr, 0.0)
            hi = jnp.where(valid, hi, 0.0)
            wr = wr - (hr * Vr[i] - hi * Vi[i])
            wi = wi - (hr * Vi[i] + hi * Vr[i])
            Hr = Hr.at[i, j].set(hr)
            Hi = Hi.at[i, j].set(hi)
            return wr, wi, Hr, Hi

        wr, wi, Hr, Hi = jax.lax.fori_loop(0, m_krylov + 1, mgs,
                                           (wr, wi, Hr, Hi))
        beta = jnp.sqrt(jnp.sum(wr * wr + wi * wi))
        Hr = Hr.at[j + 1, j].set(beta)
        safe = jnp.maximum(beta, 1e-300)
        Vr = Vr.at[j + 1].set(wr / safe)
        Vi = Vi.at[j + 1].set(wi / safe)
        return Vr, Vi, Hr, Hi

    Vr, Vi, Hr, Hi = jax.lax.fori_loop(0, m_krylov, body, (Vr, Vi, Hr, Hi))
    return (Vr, Vi), (Hr, Hi)


def shift_invert_factorization(p, grid, coeff, sigma, m_krylov: int,
                               quad=None, chunk: int = 2048,
                               d_sigma_frac: float = 0.01):
    """Assemble M(sigma), M'(sigma) (secant), LU-factor the real embedding
    once, and run the Arnoldi factorization of B = M^{-1} M'."""
    dtype = grid.eta.dtype
    n_dim = 2 * grid.npoints if p.electromagnetic else grid.npoints
    d_sigma = d_sigma_frac * sigma
    M = eigen_mod.assemble_matrix(p, grid, coeff, sigma, quad, chunk)
    M2 = eigen_mod.assemble_matrix(p, grid, coeff, sigma + d_sigma, quad, chunk)
    dM = (M2 - M) / d_sigma

    R = linalg.real_embedding(M)
    lu, piv = jax.scipy.linalg.lu_factor(R)
    dMr = jnp.real(dM)
    dMi = jnp.imag(dM)

    def solve_B(xr, xi):
        # w = M'(sigma) x   (on planes)
        wr = dMr @ xr - dMi @ xi
        wi = dMr @ xi + dMi @ xr
        z = jax.scipy.linalg.lu_solve((lu, piv), jnp.concatenate([wr, wi]))
        return z[:n_dim], z[n_dim:]

    V, H = arnoldi_factorization(solve_B, n_dim, m_krylov, dtype)
    return V, H, (lu, piv)


def ritz_from_hessenberg(H_planes, sigma, m_krylov):
    """Host-side: eig of the small Hessenberg -> omega estimates sorted by
    |mu| descending (closest to sigma first).  Returns (omegas, eigvecs)."""
    Hr, Hi = (np.asarray(h) for h in H_planes)
    H = (Hr + 1j * Hi)[:m_krylov, :m_krylov]
    mu, Y = np.linalg.eig(H)
    order = np.argsort(-np.abs(mu))
    mu, Y = mu[order], Y[:, order]
    with np.errstate(divide="ignore", invalid="ignore"):
        omegas = sigma - 1.0 / mu
    return omegas, Y


def solve_one_shift(p, grid, coeff, sigma, m_krylov: int = 24, quad=None,
                    chunk: int = 2048):
    """Arnoldi estimate for the eigenvalue nearest sigma.  Returns
    (omega_estimate, ritz_vector (complex, host), residual_h)."""
    fact = jax.jit(partial(shift_invert_factorization, m_krylov=m_krylov,
                           quad=quad, chunk=chunk))
    (Vr, Vi), (Hr, Hi), _ = fact(p, grid, coeff, sigma)
    omegas, Y = ritz_from_hessenberg((Hr, Hi), complex(sigma), m_krylov)
    y = Y[:, 0]
    Vrh = np.asarray(Vr)[:m_krylov]
    Vih = np.asarray(Vi)[:m_krylov]
    vec = (Vrh + 1j * Vih).T @ y
    vec = vec / np.linalg.norm(vec)
    return complex(omegas[0]), vec, None


def solve(p, sigma, m_krylov: int = 24, newton_polish: int = 3,
          tol: float = 1e-6, quad=None, chunk: int = 2048, dtype=None):
    """Full alternative eigensolve: shift-invert Arnoldi estimate + Newton
    polish to the reference convergence criterion."""
    dtype = dtype if dtype is not None else jnp.asarray(p.length).dtype
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    coeff = singularity_coeff_matrix(p.npoints, dtype=dtype)
    sig = jnp.asarray(sigma, cdtype)
    omega_est, vec, _ = solve_one_shift(p, grid, coeff, sig, m_krylov,
                                        quad, chunk)

    if newton_polish <= 0:
        return omega_est, vec, 0

    state = eigen_mod.init_state(p, grid, coeff,
                                 jnp.asarray(omega_est, cdtype), quad, chunk)
    step = jax.jit(partial(eigen_mod.newton_trace_step, quad=quad, chunk=chunk))
    steps = 0
    for _ in range(newton_polish):
        state = step(p, grid, coeff, state)
        steps += 1
        if abs(eigen_mod.fetch_complex(state.d_omega)) < \
                tol * abs(eigen_mod.fetch_complex(state.omega)):
            break
    vec = eigen_mod.null_space(state.M)
    return eigen_mod.fetch_complex(state.omega), vec, steps


def solve_shifts_batched(p, sigmas, m_krylov: int = 24, quad=None,
                         chunk: int = 2048, mesh=None, dtype=None):
    """Batched multi-shift Arnoldi: vmap over shifts; when ``mesh`` is given
    the shift axis is sharded over its ``scan`` axis (BASELINE config 5:
    16 shifts across N >= 2 hosts).  Returns per-shift omega estimates."""
    dtype = dtype if dtype is not None else jnp.asarray(p.length).dtype
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    coeff = singularity_coeff_matrix(p.npoints, dtype=dtype)
    # ship shifts as (re, im) planes (the code base's real-plane convention)
    sig_np = np.asarray(sigmas)
    sig_re = jnp.asarray(sig_np.real.astype(jnp.dtype(dtype).name))
    sig_im = jnp.asarray(sig_np.imag.astype(jnp.dtype(dtype).name))

    def one(sre, sim):
        sig = (sre + 1j * sim).astype(cdtype)
        (Vr, Vi), (Hr, Hi), _ = shift_invert_factorization(
            p, grid, coeff, sig, m_krylov, quad, chunk)
        return Hr, Hi

    fn = jax.jit(jax.vmap(one))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        sharding = NamedSharding(mesh, P("scan"))
        sig_re = jax.device_put(sig_re, sharding)
        sig_im = jax.device_put(sig_im, sharding)
    Hr, Hi = fn(sig_re, sig_im)
    out = []
    for k in range(len(np.asarray(sigmas))):
        omegas, _ = ritz_from_hessenberg(
            (Hr[k], Hi[k]), complex(np.asarray(sigmas)[k]), m_krylov)
        out.append(complex(omegas[0]))
    return np.array(out)
