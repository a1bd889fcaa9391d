"""Sparse (block-banded) end-to-end eigensolve: the BASELINE north-star path.

The kernel-integral operator (reference assembly ``solver.h:417-515``) decays
algebraically in |eta - eta'| while its eigenvectors are localized along the
field line, so a banded truncation |eta - eta'| <= band_deta reproduces the
eigenvalue to the reference's 1e-6 criterion at a fraction of the dense
operator (validated against the dense-path goldens in
tests/test_sparse_eigen.py).  This module never materializes the dense
matrix:

  * ``assemble_bdia`` evaluates kernel integrals ONLY for pairs inside the
    kept block diagonals and lands them directly in BDIA block storage
    (default block size 128), exploiting the operator's complex
    symmetry to mirror the lower diagonals for free.
  * The eigensolve is shift-invert Arnoldi: B = M(sigma)^{-1} M'(sigma) with
    the SpMV = ``ops.sparse.bdia_matvec`` (4 batched einsums) and the
    shifted solve = ``ops.banded`` block-banded LU.  Ritz values map back by
    omega = sigma - 1/mu.
  * Refinement is a bordered-Newton secant iteration on the smallest
    singular pair (the banded analogue of the reference's QRSecant update,
    solver.h:210-383): v from inverse iteration on the banded LU,
    d_omega = -(v^T M v) / (v^T M' v); all operator applications are SpMVs.

Peak memory is O(n * bandwidth), so grids the dense path cannot hold
assemble and solve here (see benchmarks/bench_sparse_eigen.py).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from .. import accel
from ..grid import Grid
from ..ops import kernels
from ..ops import banded
from ..ops.singularity import (SINGULAR_BAND_HALF_WIDTH,
                               singularity_coeff_band)
from ..ops.sparse import BDIAOperator, bdia_matvec
from . import eigen as eigen_mod
from .arnoldi import arnoldi_factorization, ritz_from_hessenberg

# Default banding cutoff |eta - eta'| <= band_deta.  20.0 keeps the dropped
# pairs' eigenvalue influence below ~1e-7 relative on the canonical tokamak
# (measured via the dense-path comparison in tests/test_sparse_eigen.py and
# the n=128 banded-Newton sweep in BENCH_ASSEMBLY.md).
DEFAULT_BAND_DETA = 20.0


def pick_block(n: int, preferred: int = 128) -> int:
    """Largest power-of-two block size (up to ``preferred``) dividing n."""
    for bs in (preferred, 64, 32, 16, 8):
        if bs <= n and n % bs == 0:
            return bs
    return n


def band_halfwidth(p, grid: Grid, block: int, band_deta: float) -> int:
    """Static block half-bandwidth h: every element pair with
    |eta_i - eta_j| <= band_deta lies inside block offsets [-h, h].
    Also never narrower than the singularity-handler band
    (singularity_handler.cpp:3-24).

    Electromagnetic operators use the INTERLEAVED unknown ordering
    [phi_0, A_0, phi_1, A_1, ...] (not the reference's [phi; A] block
    ordering, solver.h:461-511): an element pair (i, j) then occupies
    interleaved offsets |r - c| <= 2|i - j| + 1, which keeps the 2x2
    phi/A coupling inside one contiguous band instead of two off-center
    stripes -- the ordering that makes the EM operator block-banded."""
    w_el = max(int(np.ceil(band_deta / float(grid.dx))),
               SINGULAR_BAND_HALF_WIDTH)
    if p.electromagnetic:
        dim = 2 * grid.npoints
        nb = dim // block
        return min((2 * w_el + 1 + block - 1) // block, nb - 1)
    nb = grid.npoints // block
    return min(-(-w_el // block), nb - 1)


def em_de_max(n: int, h: int, block: int) -> int:
    """Largest element offset |i - j| reachable inside kept interleaved
    block diagonals 0..h (block size ``block``, matrix dim 2n)."""
    return min(((h + 1) * block) // 2, n - 1)


# ---------------------------------------------------------------------------
# plane helpers: BDIA data is (ndiag, nb, 2, bs, bs) real planes; complex
# scalar algebra on operators happens plane-wise (the data never leaves real
# storage).
# ---------------------------------------------------------------------------

def _plane_scale(data, cr, ci):
    """(re, im) planes * complex scalar (cr + i ci)."""
    re = data[..., 0, :, :] * cr - data[..., 1, :, :] * ci
    im = data[..., 0, :, :] * ci + data[..., 1, :, :] * cr
    return jnp.stack([re, im], axis=-3)


def bdia_secant(op_new: BDIAOperator, op_old: BDIAOperator, d_omega):
    """(M_new - M_old) / d_omega on BDIA planes (solver.h:54-57)."""
    dr = jnp.real(d_omega)
    di = jnp.imag(d_omega)
    inv = 1.0 / (dr * dr + di * di)
    diff = op_new.data - op_old.data
    return BDIAOperator(data=_plane_scale(diff, dr * inv, -di * inv),
                        offsets=op_new.offsets, n=op_new.n,
                        block=op_new.block)


def _cdot_bilinear(vr, vi, wr, wi):
    """v^T w (unconjugated, matching complex_bilinear) on planes."""
    return (jnp.sum(vr * wr - vi * wi), jnp.sum(vr * wi + vi * wr))


# ---------------------------------------------------------------------------
# direct-to-BDIA assembly
# ---------------------------------------------------------------------------

def assemble_bdia(p, grid: Grid, coeff_band, omega, h: int, block: int,
                  quad=None, chunk: int = 4096, tiers=None,
                  fused: bool = False) -> BDIAOperator:
    """Assemble the electrostatic operator directly into BDIA block storage.

    Evaluates kernel integrals only for pairs in block diagonals 0..h (the
    negative diagonals mirror by complex symmetry, solver.h:446-459:
    M[j][i] = M[i][j]); the dense n x n matrix never exists.

    coeff_band: (n, 2h'+1) banded singularity coefficients from
    ``singularity_coeff_band`` -- row i, column (j - i + h') -- covering at
    least the kept band.

    Returns a BDIAOperator with offsets (-h..h).
    """
    if p.electromagnetic:
        return _assemble_bdia_em(p, grid, coeff_band, omega, h, block,
                                 quad, chunk, tiers, fused)
    n = grid.npoints
    bs = block
    nb = n // bs
    dx = grid.dx
    eta = grid.eta
    rdtype = eta.dtype
    cw = coeff_band.shape[1] // 2
    de_max = min((h + 1) * bs - 1, n - 1)

    # All index math lives ON DEVICE (broadcasted_iota + gathers): baked
    # numpy index constants at n = 8192 blow the remote compiler's request
    # size limit (HTTP 413) -- and iota is free.

    # ---- stage 1: kernel table T[de - 1, i] = k0(eta_i, eta_{i+de}),
    # de = 1..de_max, as a PADDED (de_max, n) grid (entries past the edge
    # clamp to a dummy finite pair and are never gathered in stage 2) ----
    T_r, T_i = _kernel_table(p, grid, omega, de_max, (0,), quad, chunk,
                             tiers, fused=fused)

    diag_val = jnp.asarray(1.0 + 1.0 / p.tau, rdtype)
    # zero row 0 so adiff = 0 gathers produce 0 before the diagonal override
    T_r = jnp.concatenate([jnp.zeros((1, n), rdtype), T_r[0]]).reshape(-1)
    T_i = jnp.concatenate([jnp.zeros((1, n), rdtype), T_i[0]]).reshape(-1)
    coeff_flat = coeff_band.reshape(-1)
    ncol = coeff_band.shape[1]

    pos_blocks = []
    for d in range(h + 1):
        nrow = nb - d
        shp = (nrow, bs, bs)
        I3 = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
        A3 = jax.lax.broadcasted_iota(jnp.int32, shp, 1)
        B3 = jax.lax.broadcasted_iota(jnp.int32, shp, 2)
        i_idx = I3 * bs + A3
        j_idx = (I3 + d) * bs + B3
        de = j_idx - i_idx
        adiff = jnp.abs(de)
        lo = jnp.minimum(i_idx, j_idx)
        pos = adiff * n + lo                      # row adiff of padded T
        cvals = jnp.take(coeff_flat,
                         lo * ncol + jnp.minimum(adiff, cw) + cw)
        vr = -jnp.take(T_r, pos) * cvals * dx
        vi = -jnp.take(T_i, pos) * cvals * dx
        if d == 0:
            eye = i_idx == j_idx
            vr = jnp.where(eye, diag_val, vr)
            vi = jnp.where(eye, 0.0, vi)
        blk = jnp.stack([vr, vi], axis=1)
        if d:
            blk = jnp.pad(blk, [(0, d), (0, 0), (0, 0), (0, 0)])
        pos_blocks.append(blk)

    neg = []
    for d in range(1, h + 1):
        t = jnp.swapaxes(pos_blocks[d][:nb - d], -1, -2)
        neg.append(jnp.pad(t, [(d, 0), (0, 0), (0, 0), (0, 0)]))

    data = jnp.stack(neg[::-1] + pos_blocks)
    return BDIAOperator(data=data, offsets=tuple(range(-h, h + 1)),
                        n=n, block=bs)


def _kernel_table(p, grid, omega, de_max: int, ms, quad, chunk, tiers,
                  electron: bool = False, i0=0, ncols: int | None = None,
                  fused: bool = False):
    """Ordered-pair kernel table over the PADDED (de, i) grid:
    row de - 1 holds kappa(eta_i, eta_{i + de}) for i = i0..i0+ncols-1
    (entries with i < 0 or i + de >= n evaluate a clamped dummy pair and
    must not be read).  Tier slices are contiguous row ranges.  Returns
    per-m (re, im) plane lists, each shaped (de_max, ncols).

    ``i0`` (traced ok) / ``ncols`` (static) support the mesh-sharded
    assembly: each shard computes only the table window covering its own
    block rows plus the de_max halo."""
    n = grid.npoints
    eta = grid.eta
    rdtype = eta.dtype
    dx = grid.dx
    nc = n if ncols is None else ncols

    def rows(lo_de, hi_de, q):
        nr = hi_de - lo_de + 1
        DE = jax.lax.broadcasted_iota(jnp.int32, (nr, nc), 0) + lo_de
        I2 = jax.lax.broadcasted_iota(jnp.int32, (nr, nc), 1) + i0
        Ic = jnp.clip(I2, 0, n - 1)
        Jc = jnp.clip(I2 + DE, 0, n - 1)
        valid = (I2 >= 0) & (I2 + DE <= n - 1)
        ea = jnp.take(eta, Ic).reshape(-1)
        eb = jnp.where(valid, jnp.take(eta, Jc),
                       jnp.take(eta, Ic) + dx).reshape(-1)

        def compute(args):
            a, b = args
            if fused:
                from ..ops import pallas_kappa
                vals = pallas_kappa.kappa_pairs_fused(
                    p, a, b, omega, ms=ms, quad=q,
                    interpret=fused == "interpret")
            else:
                vals, _ = kernels.kappa_f_tau(p, a, b, omega, ms=ms, quad=q)
            if electron:
                vals = (vals[0],
                        vals[1] + kernels.kappa_f_tau_e(p, a, b, omega, 1),
                        vals[2] + kernels.kappa_f_tau_e(p, a, b, omega, 2))
            return vals

        return eigen_mod._chunked(compute, (ea, eb), nr * nc, chunk)

    sections = []
    if tiers is None:
        sections.append((1, de_max, quad))
    else:
        lo_de = 1
        for ij_ub, scale in tiers:
            hi_de = min(de_max, max(lo_de - 1, ij_ub - 1))
            if hi_de >= lo_de:
                sections.append(
                    (lo_de, hi_de, kernels.scaled_quad(quad, rdtype, scale)))
                lo_de = hi_de + 1
        if lo_de <= de_max:
            sections.append(
                (lo_de, de_max,
                 kernels.scaled_quad(quad, rdtype, tiers[-1][1])))

    parts = [rows(lo, hi, q) for lo, hi, q in sections]
    out_r, out_i = [], []
    for m in range(len(ms)):
        out_r.append(jnp.concatenate(
            [jnp.real(pt[m]).astype(rdtype).reshape(-1, nc) for pt in parts]))
        out_i.append(jnp.concatenate(
            [jnp.imag(pt[m]).astype(rdtype).reshape(-1, nc) for pt in parts]))
    return out_r, out_i


def _assemble_bdia_em(p, grid: Grid, coeff_band, omega, h: int, block: int,
                      quad=None, chunk: int = 4096, tiers=None,
                      fused: bool = False) -> BDIAOperator:
    """Electromagnetic direct-to-BDIA assembly in the INTERLEAVED ordering
    [phi_0, A_0, phi_1, A_1, ...] (matrix dim 2n).

    The reference's [phi; A] block layout (solver.h:461-511) puts the phi-A
    coupling n columns off the diagonal; interleaving folds the whole 2x2
    structure of an element pair (i, j) into interleaved offsets
    |r - c| <= 2|i - j| + 1, so the |eta - eta'| kernel decay gives one
    contiguous block band.  Entry map (ii = r//2, jj = c//2, s = sign(jj-ii),
    kernel table evaluated once per ordered element pair and shared by all
    four components -- one integrand sweep yields m = 0, 1, 2 and already
    includes the electron closed forms):

        (phi, phi)  -K0 * coeff(min,|d|) * dx      diag: 1 + 1/tau
        (phi, A)     s * K1 * dx                   diag: 0    (U antisym)
        (A, phi)    -s * K1 * dx                   diag: 0    (U^T = -U)
        (A, A)       K2 * dx                       diag: 2 tau/beta_e bi(eta)

    (K1 is antisymmetric and K2 symmetric under eta <-> eta', matching the
    reference's explicit mirroring.)  The interleaved matrix is globally
    complex symmetric, so negative block diagonals mirror by transposition
    exactly like the electrostatic path.  All index math is device-side
    iota (no baked index constants -- see assemble_bdia).
    """
    n = grid.npoints
    bs = block
    dim = 2 * n
    nb = dim // bs
    dx = grid.dx
    eta = grid.eta
    rdtype = eta.dtype
    cw = coeff_band.shape[1] // 2
    de_max = em_de_max(n, h, bs)

    Tr, Ti = _kernel_table(p, grid, omega, de_max, (0, 1, 2), quad, chunk,
                           tiers, electron=True, fused=fused)
    zrow = jnp.zeros((1, n), rdtype)
    T0r, T1r, T2r = (jnp.concatenate([zrow, t]).reshape(-1) for t in Tr)
    T0i, T1i, T2i = (jnp.concatenate([zrow, t]).reshape(-1) for t in Ti)

    coeff_flat = coeff_band.reshape(-1)
    ncol = coeff_band.shape[1]
    diag_phi = jnp.asarray(1.0 + 1.0 / p.tau, rdtype)
    diag_A = ((2.0 * p.tau) / p.beta_e * p.bi(eta)).astype(rdtype)  # (n,)

    pos_blocks = []
    for d in range(h + 1):
        nrow = nb - d
        shp = (nrow, bs, bs)
        I3 = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
        A3 = jax.lax.broadcasted_iota(jnp.int32, shp, 1)
        B3 = jax.lax.broadcasted_iota(jnp.int32, shp, 2)
        r_idx = I3 * bs + A3
        c_idx = (I3 + d) * bs + B3
        ii = r_idx // 2
        jj = c_idx // 2
        de = jj - ii
        adiff = jnp.abs(de)
        lo = jnp.minimum(ii, jj)
        pos = adiff * n + lo
        sgn = jnp.sign(de).astype(rdtype)
        usign = jnp.where(r_idx % 2 == 0, sgn, -sgn)
        cvals = jnp.take(coeff_flat,
                         lo * ncol + jnp.minimum(adiff, cw) + cw)
        phiphi = (r_idx % 2 == 0) & (c_idx % 2 == 0)
        AA = (r_idx % 2 == 1) & (c_idx % 2 == 1)
        vr = jnp.where(phiphi, -jnp.take(T0r, pos) * cvals,
                       jnp.where(AA, jnp.take(T2r, pos),
                                 usign * jnp.take(T1r, pos))) * dx
        vi = jnp.where(phiphi, -jnp.take(T0i, pos) * cvals,
                       jnp.where(AA, jnp.take(T2i, pos),
                                 usign * jnp.take(T1i, pos))) * dx
        if d == 0:
            eye = r_idx == c_idx
            dvals = jnp.where(r_idx % 2 == 0, diag_phi, jnp.take(diag_A, ii))
            vr = jnp.where(eye, dvals, vr)
            vi = jnp.where(eye, 0.0, vi)
        blk = jnp.stack([vr, vi], axis=1)
        if d:
            blk = jnp.pad(blk, [(0, d), (0, 0), (0, 0), (0, 0)])
        pos_blocks.append(blk)

    neg = []
    for d in range(1, h + 1):
        t = jnp.swapaxes(pos_blocks[d][:nb - d], -1, -2)
        neg.append(jnp.pad(t, [(d, 0), (0, 0), (0, 0), (0, 0)]))

    data = jnp.stack(neg[::-1] + pos_blocks)
    return BDIAOperator(data=data, offsets=tuple(range(-h, h + 1)),
                        n=dim, block=bs)


def assemble_bdia_window(p, grid: Grid, coeff_band, omega, h: int,
                         block: int, row0, nbl: int, quad=None,
                         chunk: int = 4096, tiers=None,
                         fused: bool = False):
    """Block rows [row0, row0 + nbl) of the global BDIA operator, ALL 2h+1
    diagonals built directly (no transpose mirroring; crossing blocks
    INCLUDED -- the mesh-sharded SPIKE path masks/extracts them itself).

    ``row0`` may be a traced scalar (inside shard_map it comes from
    ``jax.lax.axis_index``); ``nbl`` is static.  The kernel table is
    computed only over the window [row0*bs - de_max, row0*bs + nbl*bs),
    so the quadrature work -- the dominant cost -- shards linearly over
    the mesh.  Returns raw (2h+1, nbl, 2, bs, bs) planes (same layout as
    ``BDIAOperator.data`` rows).  Validated against ``assemble_bdia`` in
    tests/test_spike.py."""
    n = grid.npoints
    bs = block
    dx = grid.dx
    rdtype = grid.eta.dtype
    em = bool(p.electromagnetic)
    dim = 2 * n if em else n
    nb = dim // bs
    de_max = em_de_max(n, h, bs) if em else min((h + 1) * bs - 1, n - 1)

    el0 = (row0 * bs) // 2 if em else row0 * bs   # first element row
    nel = (nbl * bs) // 2 if em else nbl * bs     # element rows in window
    i0 = el0 - de_max
    ncols = nel + de_max

    ms = (0, 1, 2) if em else (0,)
    Tr, Ti = _kernel_table(p, grid, omega, de_max, ms, quad, chunk, tiers,
                           electron=em, i0=i0, ncols=ncols, fused=fused)
    zrow = jnp.zeros((1, ncols), rdtype)
    Tr = [jnp.concatenate([zrow, t]).reshape(-1) for t in Tr]
    Ti = [jnp.concatenate([zrow, t]).reshape(-1) for t in Ti]

    coeff_flat = coeff_band.reshape(-1)
    ncol = coeff_band.shape[1]
    cw = ncol // 2
    diag_phi = jnp.asarray(1.0 + 1.0 / p.tau, rdtype)
    if em:
        diag_A = ((2.0 * p.tau) / p.beta_e * p.bi(grid.eta)).astype(rdtype)

    blocks = []
    for d in range(-h, h + 1):
        shp = (nbl, bs, bs)
        I3 = jax.lax.broadcasted_iota(jnp.int32, shp, 0) + row0
        A3 = jax.lax.broadcasted_iota(jnp.int32, shp, 1)
        B3 = jax.lax.broadcasted_iota(jnp.int32, shp, 2)
        r_idx = I3 * bs + A3
        c_idx = (I3 + d) * bs + B3
        ii = r_idx // 2 if em else r_idx
        jj = c_idx // 2 if em else c_idx
        de = jj - ii
        adiff = jnp.abs(de)
        lo = jnp.minimum(ii, jj)
        valid = (c_idx >= 0) & (c_idx < dim)
        lo_c = jnp.clip(lo, i0, i0 + ncols - 1)
        pos = jnp.clip(adiff, 0, de_max) * ncols + (lo_c - i0)
        cvals = jnp.take(coeff_flat,
                         lo_c * ncol + jnp.minimum(adiff, cw) + cw)
        vmask = valid.astype(rdtype)
        if not em:
            vr = -jnp.take(Tr[0], pos) * cvals * dx * vmask
            vi = -jnp.take(Ti[0], pos) * cvals * dx * vmask
        else:
            sgn = jnp.sign(de).astype(rdtype)
            usign = jnp.where(r_idx % 2 == 0, sgn, -sgn)
            phiphi = (r_idx % 2 == 0) & (c_idx % 2 == 0)
            AA = (r_idx % 2 == 1) & (c_idx % 2 == 1)
            vr = jnp.where(phiphi, -jnp.take(Tr[0], pos) * cvals,
                           jnp.where(AA, jnp.take(Tr[2], pos),
                                     usign * jnp.take(Tr[1], pos))) \
                * dx * vmask
            vi = jnp.where(phiphi, -jnp.take(Ti[0], pos) * cvals,
                           jnp.where(AA, jnp.take(Ti[2], pos),
                                     usign * jnp.take(Ti[1], pos))) \
                * dx * vmask
        if d == 0:
            eye = r_idx == c_idx
            if em:
                dvals = jnp.where(r_idx % 2 == 0, diag_phi,
                                  jnp.take(diag_A, jnp.clip(ii, 0, n - 1)))
            else:
                dvals = diag_phi
            vr = jnp.where(eye, dvals, vr)
            vi = jnp.where(eye, 0.0, vi)
        blocks.append(jnp.stack([vr, vi], axis=1))
    return jnp.stack(blocks)


def deinterleave(vec):
    """Interleaved [phi_0, A_0, phi_1, A_1, ...] -> reference block layout
    [phi; A] (solver.h:461-511) for output parity."""
    return np.concatenate([vec[0::2], vec[1::2]])


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@dataclass
class SparseEigenState:
    omega: Any
    d_omega: Any
    M: Any          # BDIAOperator at omega
    dM: Any         # BDIAOperator (secant derivative)


jax.tree_util.register_dataclass(
    SparseEigenState, data_fields=["omega", "d_omega", "M", "dM"],
    meta_fields=[])


def _null_vector(lu, n, dtype, iters: int = 2):
    """Inverse iteration on the banded LU: amplifies the near-null direction
    by 1/sigma_min per solve (the banded nullSpace, cf. solver.h:58-112)."""
    vr = jnp.ones((n,), dtype)
    vi = 0.3 * (jnp.arange(n, dtype=dtype) / n - 0.5)
    for _ in range(iters):
        vr, vi = banded.banded_solve(lu, vr, vi)
        nrm = jnp.sqrt(jnp.sum(vr * vr + vi * vi))
        vr, vi = vr / nrm, vi / nrm
    return vr, vi


def trace_newton_step(p, grid, coeff_band, state: SparseEigenState,
                      h: int, block: int, quad=None, chunk: int = 4096,
                      tiers=None, fused: bool = False):
    """One Newton-trace-secant step on the banded operator
    (solver.h:113-160): d_omega = -1 / tr(M^{-1} dM), with the banded trace
    computed EXACTLY by block-Takahashi selected inversion -- only the
    entries of M^{-1} inside the band exist, so nothing densifies.  This is
    the reference's default iteration; its basin of attraction is what the
    golden step counts (and the stellarator case's 17-100-step walks)
    measure, and the smallest-singular-pair updates do NOT share it."""
    lu = banded.banded_lu(state.M)
    Zu = banded.banded_selected_inverse(lu)
    tr_r, tr_i = banded.banded_trace_product(Zu, state.dM)
    tr = tr_r + 1j * tr_i
    d_omega = -1.0 / tr
    omega = state.omega + d_omega
    M_new = assemble_bdia(p, grid, coeff_band, omega, h, block, quad, chunk,
                          tiers, fused)
    dM = bdia_secant(M_new, state.M, d_omega)
    return SparseEigenState(omega=omega, d_omega=d_omega, M=M_new, dM=dM)


def bordered_newton_step(p, grid, coeff_band, state: SparseEigenState,
                         h: int, block: int, quad=None, chunk: int = 4096,
                         tiers=None, fused: bool = False):
    """One banded bordered-Newton (QR-secant analogue) step:
    d_omega = -(v^T M v) / (v^T dM v) with v by banded inverse iteration."""
    lu = banded.banded_lu(state.M)
    vr, vi = _null_vector(lu, state.M.n, state.M.data.dtype)
    Mvr, Mvi = bdia_matvec(state.M, vr, vi)
    dMvr, dMvi = bdia_matvec(state.dM, vr, vi)
    nr, ni = _cdot_bilinear(vr, vi, Mvr, Mvi)
    dr, di = _cdot_bilinear(vr, vi, dMvr, dMvi)
    num = nr + 1j * ni
    den = dr + 1j * di
    d_omega = -num / den
    omega = state.omega + d_omega
    M_new = assemble_bdia(p, grid, coeff_band, omega, h, block, quad, chunk,
                          tiers, fused)
    dM = bdia_secant(M_new, state.M, d_omega)
    return SparseEigenState(omega=omega, d_omega=d_omega, M=M_new, dM=dM)


def init_state(p, grid, coeff_band, omega_init, h, block, quad=None,
               chunk: int = 4096, tiers=None, fused: bool = False):
    """Reference ctor seeding (solver.h:396-415), banded."""
    omega_old = 0.99 * omega_init
    d_omega = 0.01 * omega_init
    M_old = assemble_bdia(p, grid, coeff_band, omega_old, h, block, quad,
                          chunk, tiers, fused)
    omega = omega_old + d_omega
    M = assemble_bdia(p, grid, coeff_band, omega, h, block, quad, chunk,
                      tiers, fused)
    dM = bdia_secant(M, M_old, d_omega)
    return SparseEigenState(omega=omega, d_omega=d_omega, M=M, dM=dM)


def arnoldi_estimate(state: SparseEigenState, m_krylov: int):
    """Jittable core of the shift-invert stage: banded LU of M(sigma) and an
    m-step Arnoldi factorization of B = M^{-1} M', whose matvec is the
    banded BDIA SpMV + banded triangular solves."""
    lu = banded.banded_lu(state.M)

    def solve_B(xr, xi):
        wr, wi = bdia_matvec(state.dM, xr, xi)
        return banded.banded_solve(lu, wr, wi)

    V, H = arnoldi_factorization(solve_B, state.M.n, m_krylov,
                                 state.M.data.dtype)
    return V, H


def host64_polish_banded(p, grid, coeff_band, state: SparseEigenState,
                         tol: float, h: int, block: int, max_steps: int = 8,
                         quad=None, chunk: int = 4096, tiers=None,
                         fused: bool = False):
    """Hybrid refinement for f32 devices: device BANDED assembly + host
    complex128 banded linear algebra (scipy splu with natural ordering keeps
    the fill inside the band).  The banded twin of eigen.host64_polish --
    peak host memory O(n * bandwidth)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from ..utils.transfer import fetch

    def to_csc(op: BDIAOperator):
        data = np.asarray(fetch(op.data), np.float64)
        nb = op.n // op.block
        bs = op.block
        rows_blk = np.arange(nb)
        mats = []
        rr, cc = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        rows_l, cols_l, vals_l = [], [], []
        for k, d in enumerate(op.offsets):
            valid = rows_blk[(rows_blk + d >= 0) & (rows_blk + d < nb)]
            blk = data[k, valid]          # (nv, 2, bs, bs)
            r0 = valid[:, None, None] * bs + rr[None]
            c0 = (valid + d)[:, None, None] * bs + cc[None]
            rows_l.append(r0.ravel())
            cols_l.append(c0.ravel())
            vals_l.append((blk[:, 0] + 1j * blk[:, 1]).ravel())
        A = sp.coo_matrix(
            (np.concatenate(vals_l),
             (np.concatenate(rows_l), np.concatenate(cols_l))),
            shape=(op.n, op.n)).tocsc()
        return A

    def null_vec(lu, n):
        rng = np.random.default_rng(0)
        v = rng.normal(size=n) + 1j * rng.normal(size=n)
        for _ in range(3):
            v = lu.solve(v)
            v = v / np.linalg.norm(v)
        return v

    omega = eigen_mod.fetch_complex(state.omega)
    A = to_csc(state.M)
    dA = to_csc(state.dM)
    # device assembly via the jitted (re, im)-input wrapper
    assemble = _assemble_jit(h, block, quad, chunk, grid.eta.dtype, tiers,
                             fused)
    # frozen-v bordered secant (see eigen.host64_polish): the bilinear zero
    # is quadratically insensitive to v error, so v refreshes only at the
    # convergence signal -- 2 banded factorizations instead of one per step
    v = null_vec(spla.splu(A, permc_spec="NATURAL"), A.shape[0])
    refreshed = False
    steps = 0
    for _ in range(max_steps):
        den = v @ (dA @ v)
        d_omega = -(v @ (A @ v)) / den if den != 0 else complex(0.0)
        if not (np.isfinite(d_omega.real) and np.isfinite(d_omega.imag)):
            # device loop already at the certification floor (0/0 secant):
            # zero step; the refreshed-v pass certifies (see
            # eigen.host64_polish)
            d_omega = complex(0.0)
        omega = omega + d_omega
        steps += 1
        converged = abs(d_omega) < tol * abs(omega)
        if converged and refreshed:
            break
        M_new = assemble(p, grid, coeff_band,
                         jnp.asarray(omega.real, grid.eta.dtype),
                         jnp.asarray(omega.imag, grid.eta.dtype))
        A_new = to_csc(M_new)
        dA = (A_new - A) / d_omega
        A = A_new
        if converged:
            v = null_vec(spla.splu(A, permc_spec="NATURAL"), A.shape[0])
            refreshed = True
    if not refreshed:
        v = null_vec(spla.splu(A, permc_spec="NATURAL"), A.shape[0])
    return omega, v, steps


def solve_shifts(p, sigmas, tol: float | None = None, m_krylov: int = 16,
                 workers: int = 1, **kw):
    """Banded multi-shift eigensolve (BASELINE config 5 building block):
    for every shift sigma run the shift-invert Arnoldi stage + banded
    Newton polish of ``solve`` and return the full eigen-pairs.

    Unlike the dense ``arnoldi.solve_shifts_batched`` (omega estimates
    only; vmapped dense LU = O(shifts * n^2) memory), each shift here
    costs O(n * band) memory and returns (omega, eigenvector, steps).
    All shifts share one compiled executable set (the _fns cache), and
    ``workers > 1`` fans shifts out over the available devices the same
    way the driver's parallel scan does (each worker pins its arrays to a
    device via the thread-local jax.default_device).

    Returns list of (omega, vector, steps) in sigma order; a failed shift
    yields (nan, None, 0) instead of raising, after warning with the shift
    value and the exception (so a diverged shift stays distinguishable from
    an assembly bug or OOM in the logs).
    """
    import concurrent.futures
    import warnings

    import jax as _jax

    def one(args):
        i, sig = args
        devs = _jax.devices()
        with _jax.default_device(devs[i % len(devs)]):
            try:
                om, vec, steps, _ = solve(p, sig, tol=tol,
                                          m_krylov=m_krylov, **kw)
                return om, vec, steps
            except Exception as e:
                warnings.warn(f"solve_shifts: shift {sig} failed: "
                              f"{type(e).__name__}: {e}")
                return complex(float("nan"), float("nan")), None, 0

    items = list(enumerate([complex(s) for s in np.asarray(sigmas)]))
    if workers <= 1:
        return [one(it) for it in items]
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(one, items))


@jax.jit
def _nullspace_jit(M: BDIAOperator):
    """Banded LU + inverse-iteration nullspace as ONE compiled program
    (an eager scan would dispatch every primitive separately)."""
    lu = banded.banded_lu(M)
    return _null_vector(lu, M.n, M.data.dtype, iters=3)


_JIT_CACHE: dict = {}
_ASSEMBLE_BDIA_JIT: dict = {}


def _assemble_jit(h, block, quad, chunk, dtype, tiers=None,
                  fused: bool = False):
    """Cached jitted banded assembly (p, grid, coeff_band, re, im) -> BDIA."""
    qkey = tuple(sorted(quad.items())) if quad else None
    key = (h, block, qkey, chunk, jnp.dtype(dtype).name, tiers, fused)
    if key not in _ASSEMBLE_BDIA_JIT:
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        _ASSEMBLE_BDIA_JIT[key] = jax.jit(
            lambda p, g, cb, re, im: assemble_bdia(
                p, g, cb, (re + 1j * im).astype(cdtype), h, block, quad,
                chunk, tiers, fused))
    return _ASSEMBLE_BDIA_JIT[key]


def _fns(h, block, quad, chunk, dtype, method: str = "TraceSecant",
         tiers=None, fused: bool = False):
    qkey = tuple(sorted(quad.items())) if quad else None
    key = (h, block, qkey, chunk, jnp.dtype(dtype).name, method, tiers,
           fused)
    if key not in _JIT_CACHE:
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        init = jax.jit(lambda p, g, cb, re, im: init_state(
            p, g, cb, (re + 1j * im).astype(cdtype), h, block, quad, chunk,
            tiers, fused))
        step_fn = trace_newton_step if method == "TraceSecant" \
            else bordered_newton_step
        step = jax.jit(partial(step_fn, h=h, block=block,
                               quad=quad, chunk=chunk, tiers=tiers,
                               fused=fused))
        _JIT_CACHE[key] = (init, step, jax.jit(
            arnoldi_estimate, static_argnames=("m_krylov",)))
    return _JIT_CACHE[key]


def _traced_fn(h, block, quad, chunk, dtype, method, tiers,
               fused: bool = False):
    """Fully-traced sparse solve: init + ``lax.while_loop`` Newton iteration
    as ONE program, convergence test on device (one host sync per solve --
    the sparse twin of eigen._traced_solve_fn)."""
    qkey = tuple(sorted(quad.items())) if quad else None
    key = ("traced", h, block, qkey, chunk, jnp.dtype(dtype).name, method,
           tiers, fused)
    if key not in _JIT_CACHE:
        cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
        step_fn = trace_newton_step if method == "TraceSecant" \
            else bordered_newton_step

        # runtime rounding-floor detection for f32 (see
        # eigen._traced_solve_fn: replaces the hard-coded 2e-4 plateau)
        detect_floor = jnp.dtype(cdtype) == jnp.complex64
        rdtype = jnp.float64 if cdtype == jnp.complex128 else jnp.float32

        def run(p, g, cb, re, im, tol, max_steps):
            state = init_state(p, g, cb, (re + 1j * im).astype(cdtype),
                               h, block, quad, chunk, tiers, fused)

            def cond(carry):
                state, j, done, d_prev, sc = carry
                return jnp.logical_and(j < max_steps,
                                       jnp.logical_not(done))

            def body(carry):
                state, j, _, d_prev, sc = carry
                new = step_fn(p, g, cb, state, h=h, block=block,
                              quad=quad, chunk=chunk, tiers=tiers,
                              fused=fused)
                adw = jnp.abs(new.d_omega)
                aw = jnp.abs(new.omega)
                done = adw < tol * aw
                if detect_floor:
                    ok = jnp.logical_and(jnp.isfinite(adw),
                                         jnp.isfinite(aw))
                    stag = jnp.logical_and(adw < 1e-3 * aw,
                                           adw > 0.8 * d_prev)
                    sc = jnp.where(jnp.logical_and(ok, stag), sc + 1, 0)
                    done = jnp.logical_or(jnp.logical_and(done, ok),
                                          jnp.logical_or(~ok, sc >= 2))
                    state = jax.tree_util.tree_map(
                        lambda n, o: jnp.where(ok, n, o), new, state)
                    d_prev = jnp.where(ok, adw.astype(rdtype), d_prev)
                else:
                    state = new
                    d_prev = adw.astype(rdtype)
                return state, j + 1, done, d_prev, sc

            state, n_steps, _, _, _ = jax.lax.while_loop(
                cond, body,
                (state, jnp.asarray(0, jnp.int32), jnp.asarray(False),
                 jnp.asarray(jnp.inf, rdtype), jnp.asarray(0, jnp.int32)))
            return state, n_steps

        _JIT_CACHE[key] = jax.jit(run)
    return _JIT_CACHE[key]


def solve(p, omega_init, tol: float | None = None, quad=None,
          chunk: int = 16384, dtype=None, band_deta: float | None = None,
          block: int | None = None, m_krylov: int = 0,
          host64: bool = False, stats: dict | None = None,
          method: str = "TraceSecant", tiered: bool | None = None,
          loop: str | None = None, fused: bool | None = None):
    """Sparse end-to-end eigensolve.  Returns (omega, eigenvector, steps,
    state); optionally fills ``stats`` with SpMV/assembly metrics.

    ``method``: "TraceSecant" (default; banded Newton-trace via selected
    inversion -- the reference's iteration and basin, solver.h:113-160) or
    "QRSecant" (banded bordered-Newton on the smallest singular pair --
    faster per step, smaller basin).

    m_krylov > 0 runs the shift-invert Arnoldi stage first (use when the
    initial guess is far or several modes are wanted); the Newton iteration
    then polishes to the reference criterion |d_omega| < tol * |omega|
    (main.cpp:53-56).

    ``loop``: "device" runs the fully-traced lax.while_loop Newton
    iteration (one host sync per solve), "host" the host-driven loop;
    default per platform (``accel.newton_loop``).

    ``fused``: route the banded kernel table through the fused kappa
    kernel (ops/pallas_kappa.py); ``"interpret"`` runs that kernel in the
    Pallas interpreter.  Default per platform (``accel.fused_assembly``);
    f32-only.
    """
    tol = tol if tol is not None else 1e-6
    dtype = dtype if dtype is not None else jnp.asarray(p.length).dtype
    band_deta = band_deta if band_deta is not None else DEFAULT_BAND_DETA
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    dim = 2 * p.npoints if p.electromagnetic else p.npoints
    block = block if block is not None else pick_block(dim)
    h = band_halfwidth(p, grid, block, band_deta)
    w_el = em_de_max(p.npoints, h, block) if p.electromagnetic \
        else (h + 1) * block - 1
    coeff_band = singularity_coeff_band(p.npoints, w_el, dtype=dtype)

    if tiered is None:
        tiered = dtype == jnp.float32
    tiers = None
    if tiered:
        dxf = 2.0 * float(p.length) / (p.npoints - 1)
        tiers = kernels.tier_thresholds_ij(dxf, p.npoints)
    platform = accel.current()
    if fused is None:
        fused = accel.fused_assembly(platform, dtype)
    if fused and dtype == jnp.float64:
        raise ValueError("fused assembly is f32-only")

    init, step, arnoldi_jit = _fns(h, block, quad, chunk, dtype, method,
                                   tiers, fused)
    if loop is None:
        loop = accel.newton_loop(platform)
    if loop not in ("host", "device"):
        raise ValueError(f"loop must be 'host' or 'device', got {loop!r}")
    omega_init = complex(omega_init)
    seed = omega_init
    state = None
    if loop == "host" or m_krylov:
        state = init(p, grid, coeff_band,
                     jnp.asarray(omega_init.real, dtype),
                     jnp.asarray(omega_init.imag, dtype))

    if m_krylov:
        t0 = time.time()
        _V, (Hr, Hi) = arnoldi_jit(state, m_krylov=m_krylov)
        jax.block_until_ready(Hr)
        t_arnoldi = time.time() - t0
        omegas, _ = ritz_from_hessenberg(
            (Hr, Hi), eigen_mod.fetch_complex(state.omega), m_krylov)
        est = complex(omegas[0])
        if np.isfinite(est.real) and np.isfinite(est.imag):
            # re-seed the Newton polish from the Arnoldi estimate
            seed = est
            if loop == "host":
                state = init(p, grid, coeff_band,
                             jnp.asarray(est.real, dtype),
                             jnp.asarray(est.imag, dtype))
        if stats is not None:
            stats["arnoldi_s"] = t_arnoldi
            stats["arnoldi_omega"] = est

    # f32 loops stop at their runtime-detected rounding floor (stagnation
    # detector, see eigen.solve) instead of a hard-coded 2e-4 plateau
    dev_tol = tol
    f32 = dtype != jnp.float64
    if loop == "device":
        run = _traced_fn(h, block, quad, chunk, dtype, method, tiers,
                         fused)
        state, n_dev = run(p, grid, coeff_band,
                           jnp.asarray(seed.real, dtype),
                           jnp.asarray(seed.imag, dtype),
                           jnp.asarray(dev_tol, dtype),
                           jnp.asarray(p.iteration_step_limit + 1,
                                       jnp.int32))
        n_steps = int(n_dev)
    else:
        n_steps = 0
        d_prev, sc = float("inf"), 0
        for j in range(p.iteration_step_limit + 1):
            prev = state
            state = step(p, grid, coeff_band, state)
            n_steps = j + 1
            adw = abs(eigen_mod.fetch_complex(state.d_omega))
            aw = abs(eigen_mod.fetch_complex(state.omega))
            if f32 and not (np.isfinite(adw) and np.isfinite(aw)):
                state = prev   # f32 floor blow-up: keep last good state
                break
            if adw < dev_tol * aw:
                break
            if f32 and adw < 1e-3 * aw and adw > 0.8 * d_prev:
                sc += 1
                if sc >= 2:   # runtime rounding-floor detection
                    break
            else:
                sc = 0
            d_prev = adw

    if stats is not None:
        stats["nnz"] = state.M.nnz
        stats["block"] = block
        stats["h"] = h
        stats["band_fraction"] = state.M.nnz / (state.M.n ** 2)
        # live-operator SpMV rate (the BASELINE nnz/s metric, measured on
        # the operator the solve actually used).  The reps chain inside ONE
        # jitted fori_loop (x renormalized each step so nothing hoists), so
        # per-dispatch latency does not swamp small operators.
        reps = 50

        @jax.jit
        def mv_chain(M, xr, xi):
            def body(_, c):
                xr, xi = c
                yr, yi = bdia_matvec(M, xr, xi)
                nrm = jnp.sqrt(jnp.sum(yr * yr + yi * yi)) + 1e-30
                return yr / nrm, yi / nrm
            xr, xi = jax.lax.fori_loop(0, reps, body, (xr, xi))
            return xr.sum() + xi.sum()

        xr = jnp.ones((state.M.n,), dtype)
        xi = jnp.zeros((state.M.n,), dtype)
        float(mv_chain(state.M, xr, xi))  # compile + warm
        t0 = time.time()
        float(mv_chain(state.M, xr, xi))
        stats["spmv_nnz_per_s"] = state.M.nnz * reps / (time.time() - t0)

    if host64:
        omega, v, extra = host64_polish_banded(
            p, grid, coeff_band, state, tol, h, block, quad=quad, chunk=chunk,
            tiers=tiers, fused=fused)
        if p.electromagnetic:
            v = deinterleave(v)
        return omega, v, n_steps + extra, state

    vr, vi = _nullspace_jit(state.M)
    vec = np.asarray(vr) + 1j * np.asarray(vi)
    if p.electromagnetic:
        vec = deinterleave(vec)
    return eigen_mod.fetch_complex(state.omega), vec, n_steps, state
