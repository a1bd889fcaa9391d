"""Complex dense linear algebra.

The reference leans on complex LAPACK (zsysv/zgesdd/zgeqp3,
``solver.h:113-383``).  On the CPU and the GPU XLA provides the direct
complex ops, which are used by default.  The real 2n x 2n embedding

    M = A + iB   ->   R = [[A, -B], [B, A]],   M v = c  <->  R [x; y] = [re c; im c]

preserves norms and null spaces, so solve / nullspace can also run in real
arithmetic (``force_real_embedding=True``, kept as a cross-check).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _backend_supports_complex_linalg() -> bool:
    return jax.default_backend() in ("cpu", "gpu")


def real_embedding(M):
    """[[A, -B], [B, A]] for M = A + iB."""
    A = jnp.real(M)
    B = jnp.imag(M)
    return jnp.block([[A, -B], [B, A]])


def complex_solve(M, C, force_real_embedding: bool = False):
    """Solve M X = C for complex square M, complex RHS C (matrix or vector)."""
    if _backend_supports_complex_linalg() and not force_real_embedding:
        return jnp.linalg.solve(M, C)
    n = M.shape[-1]
    R = real_embedding(M)
    vec = C.ndim == 1
    Cm = C[:, None] if vec else C
    rhs = jnp.concatenate([jnp.real(Cm), jnp.imag(Cm)], axis=0)
    Z = jnp.linalg.solve(R, rhs)
    X = Z[:n] + 1j * Z[n:]
    return X[:, 0] if vec else X


def complex_solve_trace(M, dM, force_real_embedding: bool = False):
    """trace(M^{-1} dM) -- the Newton-trace-secant denominator
    (solver.h:129-139)."""
    if _backend_supports_complex_linalg() and not force_real_embedding:
        return jnp.trace(jnp.linalg.solve(M, dM))
    n = M.shape[-1]
    R = real_embedding(M)
    rhs = jnp.concatenate([jnp.real(dM), jnp.imag(dM)], axis=0)
    Z = jnp.linalg.solve(R, rhs)
    return jnp.trace(Z[:n]) + 1j * jnp.trace(Z[n:])


def complex_bilinear(v, M):
    """v^T M v for complex v, M, computed on real planes."""
    vr, vi = jnp.real(v), jnp.imag(v)
    Mr, Mi = jnp.real(M), jnp.imag(M)
    wr = Mr @ vr - Mi @ vi
    wi = Mr @ vi + Mi @ vr
    re = jnp.sum(vr * wr - vi * wi)
    im = jnp.sum(vr * wi + vi * wr)
    return re + 1j * im


def qr_column_pivoted(M):
    """Householder QR with column pivoting (Businger-Golub greedy pivot on
    trailing column norms -- the algorithm family behind LAPACK ``zgeqp3``,
    which the reference's QR-secant iteration calls at solver.h:246-252),
    on (re, im) planes under one ``lax.scan``.

    Phase convention: beta = -(alpha/|alpha|) * ||x|| (the numerically
    stable 'phase of alpha' choice).  The QR-secant update below is
    invariant to this convention (R_nn and q_n pick up conjugate phases
    that cancel), so trajectory parity with the LAPACK-built reference does
    not depend on it.  Trailing norms are recomputed exactly every step
    (O(n^2), same order as the Householder update itself) instead of
    downdated -- no cancellation drift.

    Returns (Vr, Vi, tau_r, tau_i, Rr, Ri, perm): packed unit-lower
    reflectors (V[:, k] = v_k, v_k[k] = 1), their taus, the triangular
    factor, and the column permutation (A[:, perm] = Q R).
    """
    n = M.shape[-1]
    rdtype = jnp.real(M).dtype
    Ar0 = jnp.real(M)
    Ai0 = jnp.imag(M)
    rows = jnp.arange(n)

    def step(carry, k):
        Ar, Ai, perm = carry
        below = (rows >= k).astype(rdtype)[:, None]

        # greedy pivot: largest trailing column norm among columns >= k
        nrm2 = jnp.sum((Ar * Ar + Ai * Ai) * below, axis=0)
        nrm2 = jnp.where(rows >= k, nrm2, -1.0)
        jstar = jnp.argmax(nrm2)

        # swap columns k <-> jstar (planes + permutation record)
        idx = rows.at[k].set(jstar).at[jstar].set(k)
        Ar = Ar[:, idx]
        Ai = Ai[:, idx]
        perm = perm[idx]

        # Householder vector for x = A[k:, k]
        xr = Ar[:, k] * below[:, 0]
        xi = Ai[:, k] * below[:, 0]
        normx = jnp.sqrt(jnp.sum(xr * xr + xi * xi))
        a_r = Ar[k, k]
        a_i = Ai[k, k]
        absa = jnp.sqrt(a_r * a_r + a_i * a_i)
        tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype)
        # beta = -(alpha/|alpha|) normx  (alpha = 0 -> beta = -normx)
        ph_r = jnp.where(absa > 0, a_r / jnp.maximum(absa, tiny), 1.0)
        ph_i = jnp.where(absa > 0, a_i / jnp.maximum(absa, tiny), 0.0)
        b_r = -ph_r * normx
        b_i = -ph_i * normx
        # v = x - beta e_k, normalized to v[k] = 1: v = x / (alpha - beta)
        d_r = a_r - b_r
        d_i = a_i - b_i
        d2 = d_r * d_r + d_i * d_i
        degen = d2 < tiny            # x = 0: H = I (tau = 0)
        d2s = jnp.where(degen, 1.0, d2)
        inv_r = d_r / d2s
        inv_i = -d_i / d2s
        vr = xr * inv_r - xi * inv_i
        vi = xr * inv_i + xi * inv_r
        vr = jnp.where(rows == k, 1.0, vr)
        vi = jnp.where(rows == k, 0.0, vi)
        # tau = (beta - alpha) / beta = -d / beta
        b2 = b_r * b_r + b_i * b_i
        b2s = jnp.where(degen, 1.0, b2)
        t_r = jnp.where(degen, 0.0, -(d_r * b_r + d_i * b_i) / b2s)
        t_i = jnp.where(degen, 0.0, -(d_i * b_r - d_r * b_i) / b2s)

        # A <- (I - tau v v^H) A : w = v^H A, A -= tau v w
        wr = vr @ Ar + vi @ Ai       # Re(v^H A)
        wi = vr @ Ai - vi @ Ar       # Im(v^H A)
        twr = t_r * wr - t_i * wi
        twi = t_r * wi + t_i * wr
        Ar = Ar - (vr[:, None] * twr[None, :] - vi[:, None] * twi[None, :])
        Ai = Ai - (vr[:, None] * twi[None, :] + vi[:, None] * twr[None, :])
        # column k below the diagonal is exactly zero by construction
        colk = rows == k
        Ar = jnp.where(colk[None, :] & (rows > k)[:, None], 0.0, Ar)
        Ai = jnp.where(colk[None, :] & (rows > k)[:, None], 0.0, Ai)

        return (Ar, Ai, perm), (vr, vi, t_r, t_i)

    (Rr, Ri, perm), (Vr, Vi, tau_r, tau_i) = jax.lax.scan(
        step, (Ar0, Ai0, jnp.arange(n)), jnp.arange(n))
    return Vr.T, Vi.T, tau_r, tau_i, Rr, Ri, perm


def _apply_qH(Vr, Vi, tau_r, tau_i, ur, ui):
    """u <- Q^H u for Q = H_1 ... H_n (packed reflectors): apply
    H_k^H = I - conj(tau_k) v_k v_k^H in ascending k."""
    def step(carry, vk):
        ur, ui = carry
        vr, vi, t_r, t_i = vk
        # s = v^H u
        s_r = vr @ ur + vi @ ui
        s_i = vr @ ui - vi @ ur
        # conj(tau) * s
        c_r = t_r * s_r + t_i * s_i
        c_i = t_r * s_i - t_i * s_r
        ur = ur - (vr * c_r - vi * c_i)
        ui = ui - (vr * c_i + vi * c_r)
        return (ur, ui), None

    (ur, ui), _ = jax.lax.scan(step, (ur, ui),
                               (Vr.T, Vi.T, tau_r, tau_i))
    return ur, ui


def qr_secant_delta(M, dM):
    """The reference's TRUE QR-secant update (solver.h:210-383): column-
    pivoted QR M P = Q R; v = P [-R_11^{-1} r; 1] (so M v = R_nn q_n);
    d_omega = -R_nn / (Q^H dM v)_n.  All steps on (re, im) planes.
    Returns the complex d_omega."""
    n = M.shape[-1]
    rdtype = jnp.real(M).dtype
    Vr, Vi, tau_r, tau_i, Rr, Ri, perm = qr_column_pivoted(M)

    # back-substitution: R[0:n-1, 0:n-1] w = R[0:n-1, n-1]
    rr = Rr[:, n - 1]
    ri = Ri[:, n - 1]

    def bsub(carry, k):
        wr, wi = carry
        # residual row k: r_k - sum_{j>k} R[k, j] w_j   (w_j = 0 for j <= k)
        s_r = Rr[k] @ wr - Ri[k] @ wi
        s_i = Rr[k] @ wi + Ri[k] @ wr
        num_r = rr[k] - s_r
        num_i = ri[k] - s_i
        dkk_r = Rr[k, k]
        dkk_i = Ri[k, k]
        d2 = dkk_r * dkk_r + dkk_i * dkk_i
        wk_r = (num_r * dkk_r + num_i * dkk_i) / d2
        wk_i = (num_i * dkk_r - num_r * dkk_i) / d2
        wr = wr.at[k].set(wk_r)
        wi = wi.at[k].set(wk_i)
        return (wr, wi), None

    w0 = jnp.zeros((n,), rdtype)
    (wr, wi), _ = jax.lax.scan(bsub, (w0, w0),
                               jnp.arange(n - 2, -1, -1))

    # v[perm[i]] = -w[i] (i < n-1), v[perm[n-1]] = 1
    vr = jnp.zeros((n,), rdtype).at[perm].set(-wr).at[perm[n - 1]].set(1.0)
    vi = jnp.zeros((n,), rdtype).at[perm].set(-wi).at[perm[n - 1]].set(0.0)

    # u = Q^H (dM v); d_omega = -R_nn / u_n
    dMr = jnp.real(dM)
    dMi = jnp.imag(dM)
    ur = dMr @ vr - dMi @ vi
    ui = dMr @ vi + dMi @ vr
    ur, ui = _apply_qH(Vr, Vi, tau_r, tau_i, ur, ui)
    den = ur[n - 1] + 1j * ui[n - 1]
    Rnn = Rr[n - 1, n - 1] + 1j * Ri[n - 1, n - 1]
    return -Rnn / den


def null_space_vector(M, force_real_embedding: bool = False,
                      method: str | None = None):
    """Null-space (least-singular right-singular) vector of M, conjugated to
    match the reference's nullSpace() output convention (solver.h:58-112).

    Methods:
      * ``svd`` (default with complex linalg): exact reference semantics.
      * ``inverse`` (default on the real embedding): inverse iteration --
        two LU solves amplify the null direction by 1/sigma_min, and are
        *more* accurate than an SVD in f32.
    """
    complex_ok = _backend_supports_complex_linalg() and not force_real_embedding
    if method is None:
        method = "svd" if complex_ok else "inverse"

    if method == "svd" and complex_ok:
        _, _, vh = jnp.linalg.svd(M)
        return jnp.conj(vh[-1, :])

    n = M.shape[-1]
    R = real_embedding(M)
    if method == "svd":
        _, _, vh = jnp.linalg.svd(R)
        z = vh[-1, :]
    else:
        lu, piv = jax.scipy.linalg.lu_factor(R)
        z = jnp.ones((2 * n,), R.dtype)
        z = z.at[n:].set(0.3)  # break real/imag symmetry
        for _ in range(2):
            z = jax.scipy.linalg.lu_solve((lu, piv), z)
            z = z / jnp.sqrt(jnp.sum(z * z))
    zr, zi = z[:n], z[n:]
    nrm = jnp.sqrt(jnp.sum(zr * zr + zi * zi))
    # v = zr + i zi IS the null vector (R [zr; zi] ~ M v); the complex-SVD
    # path's conj(vh[-1]) equals the null vector too, so no conjugation here.
    return zr / nrm + 1j * (zi / nrm)
