"""Block-banded complex LU factorization + triangular solves on device.

The shifted systems of the sparse eigensolve path (shift-invert Arnoldi and
the bordered-Newton polish) need M(sigma)^{-1} applied to vectors without
ever materializing the dense operator.  The kernel-integral operator is
banded (kappa decays in |eta - eta'|; the singularity handler adds a width-5
band, reference ``src/singularity_handler.cpp:3-24``), so the factorization
is a block-banded LU **without pivoting**:

    for k in block rows:               (lax.scan -- nb sequential steps)
        invD_k = inv(W[k, 0])          (complex bs x bs via real embedding)
        for i in 1..h:   L      = W[k+i, -i] @ invD_k        (stored in place)
        for i,j in 1..h: W[k+i, j-i] -= L_i @ W[k, j]

Banded LU has no fill outside the band, so the factors live in the same
(nb, 2h+1) block-row storage.  All block products are (re, im)-plane
real matmuls; the per-step inverse is one real 2bs x 2bs inverse.

No pivoting is safe here in the usual shift-invert sense: the operator's
diagonal blocks are dominated by the reference's 1 + 1/tau identity term
(solver.h:439-459) and near-singularity at a converged shift expresses as a
*globally* small singular value that inverse iteration amplifies -- exactly
the effect shift-invert exploits.  Validated against the dense-path goldens
in tests/test_banded.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp


def _cmm(a, b):
    """Complex block matmul on (2, bs, bs) planes."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    return jnp.stack([ar @ br - ai @ bi, ar @ bi + ai @ br])


def _cmm_b(a, b):
    """Batched complex block matmul on (..., 2, bs, x) planes: one pair of
    batched matmuls per plane combination instead of a Python loop of
    per-block products (the loop form emits O(h^2) individual small matmul
    HLOs per factorization step; the batched form is a single fat
    matmul)."""
    ar, ai = a[..., 0, :, :], a[..., 1, :, :]
    br, bi = b[..., 0, :, :], b[..., 1, :, :]
    return jnp.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], axis=-3)


def _cmm_sum(a, b, axis: int = 0):
    """sum_k a[k] @ b[k] on (k, 2, bs, x) planes as ONE contraction:
    einsum over the block index k runs as a single matmul with the
    contraction dimension k*bs."""
    ar, ai = a[:, 0], a[:, 1]
    br, bi = b[:, 0], b[:, 1]
    rr = jnp.einsum("kab,kbc->ac", ar, br) - jnp.einsum("kab,kbc->ac", ai, bi)
    ri = jnp.einsum("kab,kbc->ac", ar, bi) + jnp.einsum("kab,kbc->ac", ai, br)
    return jnp.stack([rr, ri])


def _cinv(a):
    """Complex inverse of a (2, bs, bs) plane block via the real 2bs x 2bs
    embedding [[A, -B], [B, A]]; its inverse is [[C, -D], [D, C]] with
    C + iD = (A + iB)^{-1}."""
    bs = a.shape[-1]
    R = jnp.block([[a[0], -a[1]], [a[1], a[0]]])
    Ri = jnp.linalg.inv(R)
    return jnp.stack([Ri[:bs, :bs], Ri[bs:, :bs]])


@dataclass(frozen=True)
class BandedLU:
    """Factored block-banded operator.

    W: (nb + h, 2h+1, 2, bs, bs) block-row storage; W[i, h+d] holds the
       factor block at (row i, col i+d): U on d >= 0, unit-L on d < 0.
    invD: (nb, 2, bs, bs) inverses of the U diagonal blocks.
    """
    W: Any
    invD: Any
    n: int
    block: int
    h: int

    @property
    def nb(self) -> int:
        return self.n // self.block


jax.tree_util.register_dataclass(
    BandedLU, data_fields=["W", "invD"], meta_fields=["n", "block", "h"])


def rowmajor_from_bdia(op) -> tuple:
    """BDIAOperator (diag-major) -> (W, h): block-ROW-major banded storage
    (nb + h, 2h+1, 2, bs, bs), padded with h zero rows so the factorization
    window never leaves the array."""
    nb = op.n // op.block
    h = max(abs(d) for d in op.offsets)
    W = jnp.zeros((nb + h, 2 * h + 1, 2, op.block, op.block),
                  op.data.dtype)
    for k, d in enumerate(op.offsets):
        W = W.at[:nb, h + d].set(op.data[k])
    return W, h


def banded_lu(op) -> BandedLU:
    """Factor a BDIAOperator in place of its band.  Jittable; nb sequential
    scan steps.  Each step's O(h^2) block products run as TWO batched
    matmuls (L = rows @ invD over i; upd = L_i U_j over (i, j)) rather than
    a Python loop of h^2 individual block matmuls -- the loop form made the
    factorization chain the tok8192 bottleneck.

    Scatter geometry: row i (i = 1..h) takes L_i at band column h-i and
    -upd[i, j] at columns h+j-i (j = 1..h, a contiguous run).  Both are
    realized by placing blocks at FIXED columns (h and h+1..2h) and rolling
    row i left by i; the roll wraps columns < i, which are zero by
    construction, so nothing contaminates."""
    W, h = rowmajor_from_bdia(op)
    nb = op.n // op.block
    bs = op.block
    invD0 = jnp.zeros((nb, 2, bs, bs), op.data.dtype)
    ivec = jnp.arange(1, h + 1)

    def roll_rows(rows):
        return jax.vmap(lambda r, s: jnp.roll(r, -s, axis=0))(rows, ivec)

    # mask[i] marks band column h-i (the L slot) after the roll
    lmask = roll_rows(jnp.concatenate(
        [jnp.zeros((h, h)), jnp.ones((h, 1)), jnp.zeros((h, h))],
        axis=1)[..., None])[..., 0].astype(op.data.dtype)
    lmask5 = lmask[:, :, None, None, None]

    def step(carry, k):
        W, invD = carry
        # rows k .. k+h of the band
        win = jax.lax.dynamic_slice_in_dim(W, k, h + 1, axis=0)
        iD = _cinv(win[0, h])
        if h:
            Lsrc = win[ivec, h - ivec]                     # (h, 2, bs, bs)
            L = _cmm_b(Lsrc, iD[None])                     # (h, 2, bs, bs)
            U = win[0, h + 1:]                             # (h, 2, bs, bs)
            upd = _cmm_b(L[:, None], U[None])              # (h, h, 2, .., ..)
            zpad = jnp.zeros((h, h + 1, 2, bs, bs), W.dtype)
            upd_placed = roll_rows(jnp.concatenate([zpad, upd], axis=1))
            l_placed = roll_rows(jnp.concatenate(
                [zpad[:, :h], L[:, None], zpad[:, :h]], axis=1))
            new_lower = ((win[1:] - upd_placed) * (1.0 - lmask5)
                         + l_placed * lmask5)
            W = jax.lax.dynamic_update_slice_in_dim(
                W, jnp.concatenate([win[:1], new_lower]), k, axis=0)
        invD = jax.lax.dynamic_update_slice_in_dim(
            invD, iD[None], k, axis=0)
        return (W, invD), None

    (W, invD), _ = jax.lax.scan(step, (W, invD0), jnp.arange(nb))
    return BandedLU(W=W, invD=invD, n=op.n, block=bs, h=h)


def banded_solve(lu: BandedLU, xr, xi):
    """Solve M z = x given the banded factorization, on (re, im) planes.

    xr, xi: (n,) vectors or (n, r) multivectors.  Forward substitution with
    the unit-L band, then backward with U using the stored diagonal-block
    inverses; both are lax.scans carrying an h-block sliding window.
    """
    nb, bs, h = lu.nb, lu.block, lu.h
    vec = xr.ndim == 1
    xr2 = xr[:, None] if vec else xr
    xi2 = xi[:, None] if vec else xi
    r = xr2.shape[1]
    b = jnp.stack([xr2.reshape(nb, bs, r), xi2.reshape(nb, bs, r)], axis=1)

    def cmv(blk, v):
        """(2, bs, bs) complex block times (2, bs, r) complex segment."""
        return jnp.stack([blk[0] @ v[0] - blk[1] @ v[1],
                          blk[0] @ v[1] + blk[1] @ v[0]])

    W = lu.W

    # forward: y[k] = b[k] - sum_{i=1..h} L[k, -i] y[k-i]; the h-term sum is
    # ONE contraction over the stacked window (win[c] pairs with row[c],
    # c = h-i), not h separate block matvecs
    def fwd(win, k):
        # win: (h, 2, bs, r) = y[k-h .. k-1] (zeros for k-i < 0)
        row = jax.lax.dynamic_index_in_dim(W, k, axis=0, keepdims=False)
        y = b[k] - _cmm_sum(row[:h], win) if h else b[k]
        win = jnp.concatenate([win[1:], y[None]], axis=0)
        return win, y

    win0 = jnp.zeros((h, 2, bs, r), b.dtype)
    _, y = jax.lax.scan(fwd, win0, jnp.arange(nb))

    # backward: z[k] = invD[k] (y[k] - sum_{j=1..h} U[k, +j] z[k+j])
    def bwd(win, k):
        # win: (h, 2, bs, r) = z[k+1 .. k+h] (zeros past the edge)
        row = jax.lax.dynamic_index_in_dim(W, k, axis=0, keepdims=False)
        iD = jax.lax.dynamic_index_in_dim(lu.invD, k, axis=0, keepdims=False)
        t = y[k] - _cmm_sum(row[h + 1:], win) if h else y[k]
        z = cmv(iD, t)
        win = jnp.concatenate([z[None], win[:-1]], axis=0)
        return win, z

    _, z = jax.lax.scan(bwd, win0, jnp.arange(nb - 1, -1, -1))
    z = z[::-1]
    zr = z[:, 0].reshape(lu.n, r)
    zi = z[:, 1].reshape(lu.n, r)
    if vec:
        zr, zi = zr[:, 0], zi[:, 0]
    return zr, zi


def _ct(blk):
    """Transpose (NOT conjugated) of a (2, bs, bs) complex plane block."""
    return jnp.swapaxes(blk, -1, -2)


def banded_selected_inverse(lu: BandedLU):
    """Upper-band blocks of Z = M^{-1} for complex-SYMMETRIC banded M, by
    block Takahashi recurrences on the banded LU (selected inversion).

    The Newton-trace update of the reference eigensolve needs
    tr(M^{-1} dM) (solver.h:113-160); dM is banded, so only the entries of
    M^{-1} INSIDE the band are required -- and those close on themselves:
    with M = L D U~ (U~ unit upper, from the stored non-unit U via
    U~_ik = D_i^{-1} U_ik),

        Z_ij = -sum_{k=i+1..i+h} U~_ik Z_kj          (j > i)
        Z_ii = D_i^{-1} - sum_{k=i+1..i+h} U~_ik Z_ki

    evaluated backward from the bottom-right corner; every Z on the right
    lies in the band below/right of (i, j), and lower entries mirror by the
    symmetry Z_kj = Z_jk^T.  Cost O(nb h^2) block matmuls -- same order as
    the factorization itself, so the trace never densifies anything.

    Returns Zu: (nb, h+1, 2, bs, bs) with Zu[i, d] = Z_{i, i+d}
    (zero-padded past the bottom edge).
    """
    nb, bs, h = lu.nb, lu.block, lu.h
    W, invD = lu.W, lu.invD

    # static gather geometry for Zsel[dj-1, dk-1] = Z_{i+dk, i+dj}:
    # win[dk-1, dj-dk] when dj >= dk, else the symmetric mirror
    # transpose(win[dj-1, dk-dj])
    import numpy as _np
    djv = _np.arange(1, h + 1)[:, None]
    dkv = _np.arange(1, h + 1)[None, :]
    lower = djv >= dkv
    sel_a = jnp.asarray(_np.where(lower, dkv - 1, djv - 1))
    sel_b = jnp.asarray(_np.where(lower, djv - dkv, dkv - djv))
    tflag = jnp.asarray(~lower)[..., None, None, None]

    def _cmm_sum_rows(a, b):
        """out[j] = sum_k a[k] @ b[j, k] on planes."""
        ar, ai = a[:, 0], a[:, 1]
        br, bi = b[:, :, 0], b[:, :, 1]
        rr = (jnp.einsum("kab,jkbc->jac", ar, br)
              - jnp.einsum("kab,jkbc->jac", ai, bi))
        ri = (jnp.einsum("kab,jkbc->jac", ar, bi)
              + jnp.einsum("kab,jkbc->jac", ai, br))
        return jnp.stack([rr, ri], axis=1)

    def step(win, i):
        # win[t] = Zu row (i + 1 + t), t = 0..h-1 (zeros beyond the edge)
        row_w = jax.lax.dynamic_index_in_dim(W, i, axis=0, keepdims=False)
        iD = jax.lax.dynamic_index_in_dim(invD, i, axis=0, keepdims=False)
        if h == 0:
            return win, iD[None]
        ut = _cmm_b(iD[None], row_w[h + 1:])          # (h, 2, bs, bs)
        Zsel = win[sel_a, sel_b]                      # (h, h, 2, bs, bs)
        Zsel = jnp.where(tflag, _ct(Zsel), Zsel)
        z_off = -_cmm_sum_rows(ut, Zsel)              # rows dj = 1..h
        z0 = iD - _cmm_sum(ut, _ct(z_off))
        z_row = jnp.concatenate([z0[None], z_off])    # (h+1, 2, bs, bs)
        new_win = jnp.concatenate([z_row[None], win[:-1]], axis=0)
        return new_win, z_row

    win0 = jnp.zeros((h, h + 1, 2, bs, bs), W.dtype)
    _, z_rows = jax.lax.scan(step, win0, jnp.arange(nb - 1, -1, -1))
    return z_rows[::-1]


def banded_trace_product(Zu, op):
    """tr(M^{-1} A) for complex-symmetric banded M (Zu from
    ``banded_selected_inverse``) and complex-symmetric BDIAOperator A:
    since both are symmetric, tr(Z A) = sum_{(i,j) in band} Z_ij (*) A_ij
    elementwise -- diagonal block-column once, off-diagonal columns twice.

    Returns the complex scalar as (re, im).
    """
    h = max(op.offsets)
    tr_r = jnp.asarray(0.0, Zu.dtype)
    tr_i = jnp.asarray(0.0, Zu.dtype)
    for d in range(h + 1):
        A = op.data[op.offsets.index(d)]     # (nb, 2, bs, bs)
        Z = Zu[:, d]
        w = 1.0 if d == 0 else 2.0
        tr_r = tr_r + w * jnp.sum(Z[:, 0] * A[:, 0] - Z[:, 1] * A[:, 1])
        tr_i = tr_i + w * jnp.sum(Z[:, 0] * A[:, 1] + Z[:, 1] * A[:, 0])
    return tr_r, tr_i
