"""delta-f particle-in-cell initial-value solver along a field line.

Vectorized re-design of the reference PIC path
(``include/solver_pic.h:16-533``): markers live in structure-of-arrays form,
the CIC charge deposition becomes ``segment_sum`` scatter-adds, the field
gather is a vectorized indexed load, and the whole time loop runs under
``jax.lax.scan``.  The reference's thread-pool blocking (512-marker velocity
blocks, 256 deposition batches with private buffers + serial reduce,
solver_pic.h:129-138, 250-352) is replaced wholesale by XLA vectorization;
multi-chip marker sharding adds a ``psum`` over the deposited density
(see ``emme_tpu.parallel``).

Faithful behavioral details preserved:
  * j0 / drift-center pull-back start at ZERO and are (re)computed during
    each field solve (solver_pic.h:34-47, 269-273) -- the first RK stage
    therefore sees j0 == 0 exactly like the reference.
  * the 3-stage low-storage RK tableau (solver_pic.h:466-470).
  * cell_width = 2 L / npoints (NOT the eigen grid's 2 L/(npoints-1)).
  * PIC uses the tokamak-form drift frequencies directly from parameters
    (solver_pic.h:361-370), independent of the geometry subclass.
  * RNG differs (explicit jax.random keys vs std::random_device) so golden
    comparisons are statistical in gamma/omega.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from .. import accel
from ..ops.bessel import bessel_j0, bessel_j1, bessel_i01_scaled

# Low-storage RK tableau (reference solver_pic.h:466-470).
RK_COEF = np.array([
    [1.0, 0.62653829327080, 0.0, 0.0],
    [0.0, 1.0, -0.55111240553326, 0.0],
    [0.0, 1.5220585509963, -0.52205855099628, 0.92457411226246],
    [1.0, 0.13686116839369, -1.1368611683937, 0.0],
])


@dataclass
class PICState:
    eta: Any          # (n,) marker position along field line
    v_para: Any       # (n,) constant
    v_perp: Any       # (n,) constant
    weight: Any       # (n,) complex
    omega_dv: Any     # (n,) velocity dependence of magnetic drift freq
    omega_st: Any     # (n,) diamagnetic drift freq
    p_weight: Any     # (n,) Fm/g normalization
    j0: Any           # (n,) gyroaverage, recomputed each field solve
    dc_pb: Any        # (n,) drift-center pull-back operator
    field: Any        # (nf,) complex


jax.tree_util.register_dataclass(
    PICState,
    data_fields=["eta", "v_para", "v_perp", "weight", "omega_dv", "omega_st",
                 "p_weight", "j0", "dc_pb", "field"],
    meta_fields=[])


def cell_width(p):
    return 2.0 * p.length / p.npoints


def quasi_neutrality_coef(p, dtype=jnp.float64):
    """1 / ((1 + 1/tau - Gamma0(b)) * cell_width), Gamma0 = I0(b) e^{-b}
    (solver_pic.h:372-391)."""
    cw = cell_width(p)
    idx = jnp.arange(p.npoints, dtype=dtype)
    b = p.b_theta * (1.0 + (p.shat * (idx * cw - p.length)) ** 2)
    i0s, _, _ = bessel_i01_scaled(b.astype(
        jnp.complex128 if dtype == jnp.float64 else jnp.complex64))
    gamma0 = jnp.real(i0s)  # I0(b) e^{-b} for real b >= 0
    # pin the dtype: bessel_i01_scaled's f64 internals upcast under an
    # x64-enabled config even for f32 inputs, which would silently promote
    # the whole PIC state (caught by the fused-kernel parity tests, r5)
    return (1.0 / ((1.0 + 1.0 / p.tau - gamma0) * cw)).astype(dtype)


def init_state(p, marker_per_cell: int, key, dtype=jnp.float64) -> PICState:
    """Marker loading (solver_pic.h:180-236): uniform eta, Gaussian v_para,
    |Gaussian| v_perp, uniform initial weight in [0, 0.001], water-bag
    reweighted p_weight normalized to 2L / sum."""
    n = marker_per_cell * p.npoints
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64
    k1, k2, k3, k4 = jax.random.split(key, 4)
    eta = jax.random.uniform(k1, (n,), dtype, -p.length, p.length)
    v_para = (jax.random.normal(k2, (n,), dtype)
              * p.vt / jnp.sqrt(p.water_bag_weight_vpara))
    v_perp = jnp.abs(jax.random.normal(k3, (n,), dtype)
                     * p.vt / jnp.sqrt(p.water_bag_weight_vperp))
    weight = jax.random.uniform(k4, (n,), dtype, 0.0, 0.001).astype(cdtype)

    vt2 = p.vt * p.vt
    omega_dv = (v_para**2 + 0.5 * v_perp**2) / (2.0 * vt2)
    omega_st = p.omega_s_i * (
        1.0 + p.eta_i * ((v_para**2 + v_perp**2) / (2.0 * vt2) - 1.5))
    p_weight = v_perp * jnp.exp(
        -(v_para**2 * (1.0 - p.water_bag_weight_vpara)
          + v_perp**2 * (1.0 - p.water_bag_weight_vperp)) / (2.0 * vt2))
    p_weight = p_weight * (2.0 * p.length / jnp.sum(p_weight))

    return PICState(
        eta=eta, v_para=v_para, v_perp=v_perp, weight=weight,
        omega_dv=omega_dv, omega_st=omega_st, p_weight=p_weight,
        j0=jnp.zeros(n, dtype), dc_pb=jnp.zeros(n, cdtype),
        field=jnp.zeros(p.npoints, cdtype))


def _locate(p, eta):
    cw = cell_width(p)
    x = (eta + p.length) / cw
    idx = jnp.floor(x)
    w = x - idx
    return idx.astype(jnp.int32), w


def _omega_d(p, eta):
    return p.omega_d_bar * (jnp.cos(eta) + p.shat * eta * jnp.sin(eta))


def _omega_d_integral(p, eta, v_para):
    return ((p.q * p.R / v_para) * p.omega_d_bar
            * (jnp.sin(eta) * (1.0 + p.shat) - p.shat * eta * jnp.cos(eta)))


def _gather_cic_matmul(table, idx, nf, bf16: bool = False):
    """Gather rows of ``table`` (nf, c) at marker cells as ONE flat
    TRANSPOSED one-hot matmul: table.T (c, nf) @ one_hot(idx).T (nf, m)
    -> (c, m).  The one-hot is generated fused into this single consumer
    (materializing it would be m*nf floats).  ``bf16`` runs the product
    with bf16 operands (the one-hot is exact in bf16; the table loses ~3
    decimal digits -- under the delta-f Monte-Carlo noise, validated
    statistically in the gamma/omega fit).  The f32 product runs at
    HIGHEST precision: a TF32 product would truncate the table the same
    way without asking.  Returns (c, m); callers index rows."""
    dt = jnp.bfloat16 if bf16 else table.dtype
    oh = jax.nn.one_hot(idx % nf, nf, dtype=dt)            # (m, nf), fused
    # preferred_element_type makes the f32 accumulation EXPLICIT for the
    # bf16-operand product (the declared output dtype would otherwise be
    # bf16, and the CPU backend would honor that with a lossy bf16
    # accumulator over ~1M markers)
    return jnp.matmul(table.astype(dt).T, oh.T,
                      preferred_element_type=table.dtype,
                      precision=jax.lax.Precision.HIGHEST)


def gather_cic(field, idx, w, nf, cw, method: str | None = None):
    """CIC field gather: returns (phi, dphi) at marker positions.

    phi = (1-w) f[i] + w f[i+1]; dphi is the CIC blend of the centered
    difference g[c] = (f[c+1] - f[c-1]) / (2 cw) (identical to the
    reference's four-point stencil, solver_pic.h:96-104).  ``method``:
    'take' (indexed loads; the default on every platform -- on an H100 it
    beat the one-hot product, CHANGES.md), 'matmul' (one-hot matrix
    product), 'bf16' (one-hot product with bf16 operands, ~3-digit table
    truncation under the MC noise).
    """
    if method is None or method == "take":
        fm1 = field[(idx - 1) % nf]
        f0 = field[idx % nf]
        f1 = field[(idx + 1) % nf]
        f2 = field[(idx + 2) % nf]
        phi = (1.0 - w) * f0 + w * f1
        dphi = ((1.0 - w) * (f1 - fm1) + w * (f2 - f0)) / (2.0 * cw)
        return phi, dphi
    g = jnp.roll(field, -1) - jnp.roll(field, 1)       # f[c+1] - f[c-1]
    fp = jnp.roll(field, -1)                           # f[c+1]
    gp = jnp.roll(g, -1)                               # g[c+1]
    table = jnp.stack([jnp.real(field), jnp.imag(field),
                       jnp.real(fp), jnp.imag(fp),
                       jnp.real(g), jnp.imag(g),
                       jnp.real(gp), jnp.imag(gp)], axis=-1)
    rows = _gather_cic_matmul(table, idx, nf,
                              bf16=(method == "bf16"))  # (8, m)
    f0 = rows[0] + 1j * rows[1]
    f1 = rows[2] + 1j * rows[3]
    g0 = rows[4] + 1j * rows[5]
    g1 = rows[6] + 1j * rows[7]
    phi = (1.0 - w) * f0 + w * f1
    dphi = ((1.0 - w) * g0 + w * g1) / (2.0 * cw)
    return phi, dphi


def put_velocity(p, s: PICState, gather_method: str | None = None):
    """d(weight)/dt for every marker (solver_pic.h:82-140)."""
    nf = p.npoints
    cw = cell_width(p)
    x_perp = s.v_perp / p.vt
    sb = jnp.sqrt(p.b_theta * (1.0 + (p.shat * s.eta) ** 2))
    dj0 = (-p.b_theta * p.shat**2 * x_perp * s.eta
           * bessel_j1(x_perp * sb) / sb)

    idx, w = _locate(p, s.eta)
    phi, dphi = gather_cic(s.field, idx, w, nf, cw, method=gather_method)

    omega_d = _omega_d(p, s.eta)
    common = (1j * ((s.omega_st - omega_d * s.omega_dv) * s.j0 * phi)
              - s.v_para / (p.q * p.R) * (s.j0 * dphi + dj0 * phi))
    if p.drift_center_transformation_switch:
        return s.p_weight * jnp.conj(s.dc_pb) * common
    return (-s.weight * omega_d * s.omega_dv * 1j + s.p_weight * common)


def _deposit_segment(den, idx, w, nf):
    """CIC scatter-add via segment_sum."""
    i0 = idx % nf
    i1 = (idx + 1) % nf
    return (jax.ops.segment_sum(den * (1.0 - w), i0, num_segments=nf)
            + jax.ops.segment_sum(den * w, i1, num_segments=nf))


def _deposit_matmul(den, idx, w, nf, bf16: bool = False):
    """CIC deposition as ONE flat transposed one-hot matmul:

        y = [re*wl, im*wl, re*wr, im*wr].T (4, m) @ one_hot(idx) (m, nf)

    The contraction runs over all markers at once.  The right-CIC-node
    part lands on idx and is rolled by one cell, exactly the periodic
    (idx + 1) % nf target.

    The f32 product runs at HIGHEST precision: at DEFAULT a GPU may run it
    in TF32 and keep ~3 decimal digits of each marker's charge, a
    departure from the configured f32 that the caller never asked for."""
    wl = (1.0 - w)
    rdt = jnp.real(den).dtype
    vals = jnp.stack([jnp.real(den) * wl, jnp.imag(den) * wl,
                      jnp.real(den) * w, jnp.imag(den) * w], axis=0)
    dt = jnp.bfloat16 if bf16 else vals.dtype
    oh = jax.nn.one_hot(idx % nf, nf, dtype=dt)            # (m, nf), fused
    # explicit f32 accumulation for the bf16 operands (see gather)
    y = jnp.matmul(vals.astype(dt), oh, preferred_element_type=rdt,
                   precision=jax.lax.Precision.HIGHEST)    # (4, nf)
    left = y[0] + 1j * y[1]
    right = y[2] + 1j * y[3]
    return left + jnp.roll(right, 1)


def deposit(den, idx, w, nf, method: str | None = None):
    """CIC charge deposition den -> grid.  ``method``: 'segment' (scatter
    adds), 'matmul' / 'bf16' (one-hot contraction), or None for the
    platform default (``accel.pic_deposit``)."""
    if method is None:
        method = accel.pic_deposit(accel.current())
    if method == "segment":
        return _deposit_segment(den, idx, w, nf)
    return _deposit_matmul(den, idx, w, nf, bf16=(method == "bf16"))


def solve_field(p, s: PICState, qn_coef, density_reduce=None,
                deposit_method: str | None = None):
    """Charge deposition + quasi-neutrality solve (solver_pic.h:249-354).
    Also refreshes j0 and the drift-center pull-back as the reference does.

    ``density_reduce``: optional callable applied to the deposited density
    (e.g. a ``psum`` when markers are sharded across devices)."""
    nf = p.npoints
    x_perp = s.v_perp / p.vt
    sb = jnp.sqrt(p.b_theta * (1.0 + (p.shat * s.eta) ** 2))
    j0 = bessel_j0(x_perp * sb)
    dc_pb = jnp.exp(-1j * _omega_d_integral(p, s.eta, s.v_para) * s.omega_dv)

    den = (j0 * s.weight * dc_pb if p.drift_center_transformation_switch
           else j0 * s.weight)
    idx, w = _locate(p, s.eta)
    d = deposit(den, idx, w, nf, method=deposit_method)
    if density_reduce is not None:
        d = density_reduce(d)
    field = d * qn_coef
    return PICState(eta=s.eta, v_para=s.v_para, v_perp=s.v_perp,
                    weight=s.weight, omega_dv=s.omega_dv, omega_st=s.omega_st,
                    p_weight=s.p_weight, j0=j0, dc_pb=dc_pb, field=field)


def update(p, s: PICState, velocity, dt, qn_coef, density_reduce=None,
           deposit_method: str | None = None):
    """Push eta (periodic bound), advance weights, re-solve field
    (solver_pic.h:142-156, 393-396)."""
    eta = s.eta + s.v_para * dt / (p.q * p.R)
    # periodic bound to [-L, L): jnp.mod already lands in [0, 2L)
    eta = jnp.mod(eta + p.length, 2.0 * p.length) - p.length
    weight = s.weight + velocity * dt
    s = PICState(eta=eta, v_para=s.v_para, v_perp=s.v_perp, weight=weight,
                 omega_dv=s.omega_dv, omega_st=s.omega_st,
                 p_weight=s.p_weight, j0=s.j0, dc_pb=s.dc_pb, field=s.field)
    return solve_field(p, s, qn_coef, density_reduce, deposit_method)


def rk3_generic(state, velocity_fn, update_fn, dt):
    """3-stage low-storage scheme over an abstract state
    (solver_pic.h:425-435 template-fold): stage p uses velocity
    sum_k coef[p][k] v_k and substep coef[p][p+1] dt.  The state concept
    mirrors the reference's (put_velocity/update); any pytree works."""
    v = []
    for stage in range(3):
        v.append(velocity_fn(state))
        # float(): np.float64 tableau scalars are STRONG-typed and would
        # promote the whole f32 state under an x64-enabled config
        combo = jax.tree_util.tree_map(
            lambda *xs: sum(float(RK_COEF[stage][k]) * x
                            for k, x in enumerate(xs)),
            *v)
        state = update_fn(state, combo, float(RK_COEF[stage][stage + 1]) * dt)
    return state, v


def rk3_error_estimate(v, dt, norm_fn):
    """Embedded error combination sum_k coef[3][k] v_k scaled by dt
    (solver_pic.h:437-457)."""
    combo = jax.tree_util.tree_map(
        lambda *xs: sum(float(RK_COEF[3][k]) * x for k, x in enumerate(xs)),
        *v)
    return norm_fn(combo, dt)


def rk3_step(p, s: PICState, dt, qn_coef, density_reduce=None,
             gather_method: str | None = None,
             deposit_method: str | None = None):
    """PIC instantiation of the 3-stage scheme."""
    return rk3_generic(
        s,
        lambda st: put_velocity(p, st, gather_method),
        lambda st, vel, sub_dt: update(p, st, vel, sub_dt, qn_coef,
                                       density_reduce, deposit_method),
        dt)


def field_stats(field):
    """Per-step (mean Re, mean Im, rms) diagnostics (main.cpp:111-118)."""
    nf = field.shape[-1]
    return jnp.stack([
        jnp.mean(jnp.real(field)),
        jnp.mean(jnp.imag(field)),
        jnp.sqrt(jnp.mean(jnp.real(field * jnp.conj(field))))])


# ---------------------------------------------------------------------------
# Sorted-window marker path: the full-width one-hot CIC gather/deposit
# matmuls contract over ALL nf cells for a useful minor dimension of 4-8
# columns.  Sorting markers by eta (one multi-operand lax.sort) makes each
# marker chunk CELL-LOCAL, so the one-hots only span a W-cell window around
# the chunk: nf/W times fewer flops, exactly the same arithmetic.  Markers
# drift between re-sorts; the window slack absorbs a statically-bounded drift
# (bound from max|v_para|, which never changes), eta runs UNWRAPPED inside
# a sorted block (guard cells handle periodicity exactly), and any marker
# that still escapes its window is clamped AND counted (the returned
# violation count is asserted zero in tests and reported by the driver).
# ---------------------------------------------------------------------------

_RK_SUBSTEP_SUM = float(sum(abs(RK_COEF[s][s + 1]) for s in range(3)))


def _split_c(z):
    return jnp.real(z), jnp.imag(z)


def sort_by_eta(p, s: PICState) -> PICState:
    """Sort all marker arrays by (wrapped) eta -- one multi-operand
    lax.sort; complex fields ride as (re, im) plane operands."""
    eta = _wrap_eta(p, s.eta)
    wr, wi = _split_c(s.weight)
    dr, di = _split_c(s.dc_pb)
    out = jax.lax.sort(
        (eta, s.v_para, s.v_perp, wr, wi, s.omega_dv, s.omega_st,
         s.p_weight, s.j0, dr, di), dimension=0, num_keys=1)
    (eta, v_para, v_perp, wr, wi, odv, ost, pw, j0, dr, di) = out
    return PICState(eta=eta, v_para=v_para, v_perp=v_perp,
                    weight=wr + 1j * wi, omega_dv=odv, omega_st=ost,
                    p_weight=pw, j0=j0, dc_pb=dr + 1j * di, field=s.field)


def _window_bases(p, eta_sorted, n_chunks: int, W: int, G: int, nfe: int,
                  quant: int = 1):
    """Per-chunk window starts in EXTENDED cell coordinates, centered on
    the chunk's sorted span (margin >= (W - span)/2 - quant on both sides);
    ``quant > 1`` floor-quantizes the bases so the deposit fold can bucket
    chunks by alignment (costs <= quant - 1 cells of right margin)."""
    cw = cell_width(p)
    C = eta_sorted.shape[0] // n_chunks
    idx = jnp.floor((eta_sorted + p.length) / cw).astype(jnp.int32) + G
    first = idx[0::C]
    last = idx[C - 1::C]
    mid = (first + last) // 2
    base = jnp.clip(mid - W // 2, 0, nfe - W - 1)
    if quant > 1:
        base = (base // quant) * quant
    return base


def _field_table_ext(field, G: int):
    """Extended (nf + 2G + 2, 8) gather table: [f, f(+1), g, g(+1)] planes
    of the periodic field with G wrapped guard rows left and G + 2 right,
    so unwrapped window indices need no mod."""
    g = jnp.roll(field, -1) - jnp.roll(field, 1)
    fp = jnp.roll(field, -1)
    gp = jnp.roll(g, -1)
    table = jnp.stack([jnp.real(field), jnp.imag(field),
                       jnp.real(fp), jnp.imag(fp),
                       jnp.real(g), jnp.imag(g),
                       jnp.real(gp), jnp.imag(gp)], axis=-1)
    return jnp.concatenate([table[-G:], table, table[:G + 2]])


def _gather_windowed(table_ext, eta, w0, W: int, G: int, cw, L):
    """CIC gather with per-chunk W-cell one-hots (vs nf-cell full-width),
    BATCHED over chunks: one gathered table stack (n_chunks, W, 8) and one
    batched einsum -- a sequential ``lax.scan`` of tiny per-chunk matmuls
    lost to the full-width path; the batched form cuts the work by nf/W
    while staying one fat dispatch.
    Returns (phi, dphi, violations)."""
    n_chunks = w0.shape[0]
    C = eta.shape[0] // n_chunks
    dtype = table_ext.dtype

    x = (eta.reshape(n_chunks, C) + L) / cw
    idxf = jnp.floor(x)
    w = (x - idxf).astype(dtype)
    lidx = idxf.astype(jnp.int32) + G - w0[:, None]
    viol = jnp.sum((lidx < 0) | (lidx >= W)).astype(jnp.int32)
    lidx = jnp.clip(lidx, 0, W - 1)
    tw = table_ext[w0[:, None] + jnp.arange(W)[None, :]]   # (nc, W, 8)
    oh = jax.nn.one_hot(lidx, W, dtype=dtype)              # (nc, C, W)
    cols = jnp.einsum("ncw,nwe->nce", oh, tw)
    f0 = cols[..., 0] + 1j * cols[..., 1]
    f1 = cols[..., 2] + 1j * cols[..., 3]
    g0 = cols[..., 4] + 1j * cols[..., 5]
    g1 = cols[..., 6] + 1j * cols[..., 7]
    phi = (1.0 - w) * f0 + w * f1
    dphi = ((1.0 - w) * g0 + w * g1) / (2.0 * cw)
    return phi.reshape(-1), dphi.reshape(-1), viol


def _deposit_windowed(den, eta, w0, W: int, G: int, nf: int, cw, L,
                      quant: int):
    """CIC deposit with batched per-chunk W-cell one-hot contractions.

    The per-chunk window sums land on the extended grid WITHOUT any
    scatter: window bases are pre-quantized to multiples of ``quant``
    (see ``_window_bases``), so chunks group into nfe/quant alignment
    buckets via one tiny one-hot matmul, and the buckets overlap-add onto
    the grid with STATIC slices.  Returns (density (nf,) complex,
    violations)."""
    n_chunks = w0.shape[0]
    C = den.shape[0] // n_chunks
    rdtype = jnp.real(den).dtype
    nfe = nf + 2 * G + 2

    x = (eta.reshape(n_chunks, C) + L) / cw
    idxf = jnp.floor(x)
    w = (x - idxf).astype(rdtype)
    lidx = idxf.astype(jnp.int32) + G - w0[:, None]
    viol = jnp.sum((lidx < 0) | (lidx >= W)).astype(jnp.int32)
    lidx = jnp.clip(lidx, 0, W - 1)
    oh = jax.nn.one_hot(lidx, W, dtype=rdtype)             # (nc, C, W)
    den2 = den.reshape(n_chunks, C)
    wl = 1.0 - w
    vals = jnp.stack([jnp.real(den2) * wl, jnp.imag(den2) * wl,
                      jnp.real(den2) * w, jnp.imag(den2) * w], axis=-1)
    y = jnp.einsum("ncw,nce->nwe", oh, vals)               # (nc, W, 4)
    # left CIC node at lidx, right node at lidx + 1
    upd = jnp.zeros((n_chunks, W + 1, 2), rdtype)
    upd = upd.at[:, :W].add(y[..., :2])
    upd = upd.at[:, 1:].add(y[..., 2:])

    # bucket overlap-add fold: w0 is a multiple of quant, so chunk sums
    # group by w0/quant and land with static slices
    n_buckets = (nfe - W) // quant + 1
    ohb = jax.nn.one_hot(w0 // quant, n_buckets, dtype=rdtype)
    fb = jnp.einsum("nb,nwe->bwe", ohb, upd)               # (nb, W+1, 2)
    acc = jnp.zeros((n_buckets * quant + W + 1, 2), rdtype)
    for b in range(n_buckets):
        acc = jax.lax.dynamic_update_slice_in_dim(
            acc, jax.lax.dynamic_slice_in_dim(acc, b * quant, W + 1, 0)
            + fb[b], b * quant, axis=0)
    acc = acc[:nfe]

    # fold the guards back onto the periodic grid
    out = acc[G:G + nf]
    out = out.at[nf - G:].add(acc[:G])
    right = acc[G + nf:]
    out = out.at[:right.shape[0]].add(right)
    return out[:, 0] + 1j * out[:, 1], viol


def _wrap_eta(p, eta):
    return jnp.mod(eta + p.length, 2.0 * p.length) - p.length


def put_velocity_sorted(p, s: PICState, w0, W: int, G: int):
    """put_velocity with the windowed gather; ``s.eta`` may be UNWRAPPED
    (guard cells absorb the periodic image); physics terms use the wrapped
    coordinate."""
    cw = cell_width(p)
    eta_p = _wrap_eta(p, s.eta)
    x_perp = s.v_perp / p.vt
    sb = jnp.sqrt(p.b_theta * (1.0 + (p.shat * eta_p) ** 2))
    dj0 = (-p.b_theta * p.shat**2 * x_perp * eta_p
           * bessel_j1(x_perp * sb) / sb)

    table_ext = _field_table_ext(s.field, G)
    phi, dphi, viol = _gather_windowed(table_ext, s.eta, w0, W, G, cw,
                                       p.length)

    omega_d = _omega_d(p, eta_p)
    common = (1j * ((s.omega_st - omega_d * s.omega_dv) * s.j0 * phi)
              - s.v_para / (p.q * p.R) * (s.j0 * dphi + dj0 * phi))
    if p.drift_center_transformation_switch:
        return s.p_weight * jnp.conj(s.dc_pb) * common, viol
    return (-s.weight * omega_d * s.omega_dv * 1j
            + s.p_weight * common), viol


def solve_field_sorted(p, s: PICState, qn_coef, w0, W: int, G: int,
                       quant: int = 1, density_reduce=None):
    """solve_field with the windowed deposit (unwrapped eta ok)."""
    nf = p.npoints
    cw = cell_width(p)
    eta_p = _wrap_eta(p, s.eta)
    x_perp = s.v_perp / p.vt
    sb = jnp.sqrt(p.b_theta * (1.0 + (p.shat * eta_p) ** 2))
    j0 = bessel_j0(x_perp * sb)
    dc_pb = jnp.exp(-1j * _omega_d_integral(p, eta_p, s.v_para) * s.omega_dv)

    den = (j0 * s.weight * dc_pb if p.drift_center_transformation_switch
           else j0 * s.weight)
    d, viol = _deposit_windowed(den, s.eta, w0, W, G, nf, cw, p.length,
                                quant)
    if density_reduce is not None:
        d = density_reduce(d)
    field = d * qn_coef
    return PICState(eta=s.eta, v_para=s.v_para, v_perp=s.v_perp,
                    weight=s.weight, omega_dv=s.omega_dv,
                    omega_st=s.omega_st, p_weight=s.p_weight, j0=j0,
                    dc_pb=dc_pb, field=field), viol


def rk3_step_sorted(p, s: PICState, dt, qn_coef, w0, W: int, G: int,
                    quant: int = 1, density_reduce=None):
    """RK3 step on the sorted/windowed path; eta stays UNWRAPPED within a
    sorted block (no per-stage mod -- the wrap happens at re-sort time).
    Returns (state, violations)."""
    viols = jnp.asarray(0, jnp.int32)
    v = []
    for stage in range(3):
        vel, vg = put_velocity_sorted(p, s, w0, W, G)
        v.append(vel)
        combo = sum(float(RK_COEF[stage][k]) * x for k, x in enumerate(v))
        sub_dt = float(RK_COEF[stage][stage + 1]) * dt
        eta = s.eta + s.v_para * sub_dt / (p.q * p.R)
        weight = s.weight + combo * sub_dt
        s = PICState(eta=eta, v_para=s.v_para, v_perp=s.v_perp,
                     weight=weight, omega_dv=s.omega_dv,
                     omega_st=s.omega_st, p_weight=s.p_weight, j0=s.j0,
                     dc_pb=s.dc_pb, field=s.field)
        s, vd = solve_field_sorted(p, s, qn_coef, w0, W, G, quant,
                                   density_reduce)
        viols = (viols + vg + vd).astype(jnp.int32)
    return s, viols


def run_sorted(p, marker_per_cell: int, n_steps: int, dt, key=None,
               resort_every: int = 15, window: int = 384,
               chunk_markers: int = 8192):
    """``run`` on the sorted-window path.  Markers re-sort every
    ``resort_every`` steps; the guard width G is chosen STATICALLY from the
    realized max|v_para| (which never changes) so that no marker can drift
    past its window between sorts -- the returned ``violations`` count is
    the runtime proof (zero in every validated configuration).

    Returns (stats (n_steps, 3), final state, violations)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    dtype = jnp.asarray(p.length).dtype

    # realized max |v_para| (same RNG stream as init_state), fetched once
    # on the host to make the guard width static
    n = marker_per_cell * p.npoints
    _k1, k2, _k3, _k4 = jax.random.split(key, 4)
    vmax = float(jax.jit(lambda k: jnp.max(jnp.abs(
        jax.random.normal(k, (n,), dtype)
        * p.vt / jnp.sqrt(p.water_bag_weight_vpara))))(k2))

    nf = p.npoints
    cw = 2.0 * float(p.length) / nf
    # a window wider than the grid is pointless and would make the
    # window-base clip bound negative (wrap-around gathers / non-positive
    # bucket counts downstream; ADVICE r4) -- clamp to the grid
    W = min(int(window), nf)
    quant = max(1, W // 8)     # window-base quantum for the deposit fold
    # the window-escape guarantee: between sorts the fastest marker drifts
    # R * dt * vmax * sum|substep| / (q R_major); the window margin after
    # centering is ~(W - span)/2 - quant cells.  Derive the largest safe
    # re-sort interval instead of trusting the caller (span allowance 16
    # cells + CIC reach).  The returned violation count is the runtime
    # proof.
    span_allow = max(16, 2 * int(chunk_markers) // max(marker_per_cell, 1))
    margin_eta = ((W - span_allow) // 2 - 4 - quant) * cw
    drift_per_step = float(dt) * vmax * (_RK_SUBSTEP_SUM + 0.2) \
        / float(p.q * p.R)
    safe_R = max(1, int(margin_eta / max(drift_per_step, 1e-30)))
    R = min(int(resort_every), safe_R, n_steps)
    while n_steps % R:         # must divide n_steps (scan structure)
        R -= 1
    G = int(np.ceil(R * drift_per_step / cw)) + 2
    nfe = nf + 2 * G + 2
    n_chunks = max(1, n // int(chunk_markers))

    s0 = jax.jit(lambda k: init_state(p, marker_per_cell, k,
                                      dtype=dtype))(key)

    @jax.jit
    def full(s):
        # inside the jit: one compiled program for the quasi-neutrality
        # table too
        qn = quasi_neutrality_coef(p, dtype=dtype)

        def outer(s, _):
            s = sort_by_eta(p, s)
            w0 = _window_bases(p, s.eta, n_chunks, W, G, nfe, quant)

            def inner(s, _):
                s, viol = rk3_step_sorted(p, s, dt, qn, w0, W, G, quant)
                return s, (field_stats(s.field), viol)

            s, (stats, viols) = jax.lax.scan(inner, s, None, length=R)
            return s, (stats, viols)

        s, (stats, viols) = jax.lax.scan(outer, s, None,
                                         length=n_steps // R)
        return s, stats.reshape(n_steps, -1), viols.sum()

    s, stats, viols = full(s0)
    return stats, s, viols


def run(p, marker_per_cell: int, n_steps: int, dt, key=None,
        density_reduce=None, record_fields: bool = False,
        gather_method: str | None = None,
        deposit_method: str | None = None):
    """Full PIC run under lax.scan.  Returns (stats (n_steps, 3), final state,
    optionally the per-step fields).  ``gather_method``/``deposit_method``
    select the CIC kernels ('take'/'matmul', 'segment'/'matmul'; None =
    per-backend default)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    dtype = jnp.asarray(p.length).dtype
    s0 = init_state(p, marker_per_cell, key, dtype=dtype)
    qn_coef = quasi_neutrality_coef(p, dtype=dtype)

    def body(s, _):
        s, _v = rk3_step(p, s, dt, qn_coef, density_reduce,
                         gather_method, deposit_method)
        out = (field_stats(s.field), s.field) if record_fields \
            else (field_stats(s.field), None)
        return s, out

    s_final, outs = jax.lax.scan(body, s0, None, length=n_steps)
    stats, fields = outs
    return stats, s_final, fields


_PREP_JIT_CACHE: dict = {}


def _prepare_jit(marker_per_cell: int, dtype):
    """Cached jitted (init_state, quasi_neutrality_coef) prologue: compiled
    once per (markers, dtype) instead of dispatched eagerly at every scan
    point."""
    key = (marker_per_cell, jnp.dtype(dtype).name)
    if key not in _PREP_JIT_CACHE:
        _PREP_JIT_CACHE[key] = jax.jit(lambda p, k: (
            init_state(p, marker_per_cell, k, dtype=dtype),
            quasi_neutrality_coef(p, dtype=dtype)))
    return _PREP_JIT_CACHE[key]


_RUN_JIT_CACHE: dict = {}


def run_jitted(p, marker_per_cell: int, n_steps: int, dt, key,
               record_fields: bool = False, gather_method: str | None = None,
               deposit_method: str | None = None):
    """``run`` through a module-cached jit wrapper -- the driver-facing
    entry: compiled once per (shape, options) across scan points."""
    k = (marker_per_cell, n_steps, record_fields, gather_method,
         deposit_method)
    if k not in _RUN_JIT_CACHE:
        _RUN_JIT_CACHE[k] = jax.jit(lambda p, dt, key: run(
            p, marker_per_cell, n_steps, dt, key=key,
            record_fields=record_fields, gather_method=gather_method,
            deposit_method=deposit_method))
    dtype = jnp.asarray(p.length).dtype
    return _RUN_JIT_CACHE[k](p, jnp.asarray(dt, dtype), key)


def run_streaming(p, marker_per_cell: int, n_steps: int, dt, stream_path,
                  key=None, chunk_steps: int = 16,
                  gather_method: str | None = None,
                  deposit_method: str | None = None):
    """``run`` with per-step field dumps STREAMED to disk during the run
    (the reference writes each step's field before the next one starts,
    main.cpp:105-110, so a killed run keeps its field history; the buffered
    ``run`` loses everything).

    Streaming: the time loop runs as jitted ``chunk_steps``-long
    lax.scan segments; after each segment the fields are fetched and
    APPENDED to ``stream_path`` (complex128 raw, same layout as the
    buffered dump) and flushed.  At the default chunk the extra dispatches
    cost <1% of the run while bounding history loss to chunk_steps steps.

    Returns (stats (n_steps, 3), final state).
    """
    from ..utils.transfer import fetch

    key = key if key is not None else jax.random.PRNGKey(0)
    dtype = jnp.asarray(p.length).dtype
    s0, qn_coef = _prepare_jit(marker_per_cell, dtype)(p, key)

    def body(s, _):
        s, _v = rk3_step(p, s, dt, qn_coef, None,
                         gather_method, deposit_method)
        return s, (field_stats(s.field), s.field)

    @partial(jax.jit, static_argnames=("length",))
    def segment(s, length):
        return jax.lax.scan(body, s, None, length=length)

    s = s0
    stats_l = []
    with open(stream_path, "wb") as f:
        done = 0
        while done < n_steps:
            k = min(chunk_steps, n_steps - done)
            s, (stats, fields) = segment(s, length=k)
            fetch(fields).astype(np.complex128).tofile(f)
            f.flush()
            os.fsync(f.fileno())
            stats_l.append(np.asarray(fetch(stats)))
            done += k
    return np.concatenate(stats_l), s


def run_timed(p, marker_per_cell: int, n_steps: int, dt, key=None,
              record_fields: bool = False):
    """Observability variant of ``run``: host-driven step loop with the
    reference's per-phase timer sections ("Particle Pushing", "Field Solve",
    "Diagnostics"; solver_pic.h:127-155) around separately-jitted phases.
    Slower than the fused lax.scan run (per-step dispatches + syncs) -- use
    to see the push/deposit/diagnose split on the device timeline.
    Returns (stats, final state, fields or None)."""
    from ..utils.timer import section

    key = key if key is not None else jax.random.PRNGKey(0)
    dtype = jnp.asarray(p.length).dtype
    with section("Initial"):
        s0, qn_coef = _prepare_jit(marker_per_cell, dtype)(p, key)
        jax.block_until_ready(s0.field)

    vel_jit = jax.jit(lambda s: put_velocity(p, s))

    def _upd(s, vel, sub_dt):
        eta = s.eta + s.v_para * sub_dt / (p.q * p.R)
        eta = jnp.mod(eta + p.length, 2.0 * p.length) - p.length
        weight = s.weight + vel * sub_dt
        return PICState(eta=eta, v_para=s.v_para, v_perp=s.v_perp,
                        weight=weight, omega_dv=s.omega_dv,
                        omega_st=s.omega_st, p_weight=s.p_weight, j0=s.j0,
                        dc_pb=s.dc_pb, field=s.field)

    upd_jit = jax.jit(_upd)
    field_jit = jax.jit(lambda s: solve_field(p, s, qn_coef))
    stats_jit = jax.jit(field_stats)

    s = s0
    stats_l, fields_l = [], []
    for _ in range(n_steps):
        v = []
        for stage in range(3):
            with section("Particle Pushing"):
                v.append(vel_jit(s))
                # float(): np.float64 tableau scalars would strong-type
                # the whole state to f64/c128 under an x64-enabled config
                combo = jax.tree_util.tree_map(
                    lambda *xs: sum(float(RK_COEF[stage][k]) * x
                                    for k, x in enumerate(xs)), *v)
                s = upd_jit(s, combo, float(RK_COEF[stage][stage + 1]) * dt)
                jax.block_until_ready(s.weight)
            with section("Field Solve"):
                s = field_jit(s)
                jax.block_until_ready(s.field)
        with section("Diagnostics"):
            stats_l.append(np.asarray(stats_jit(s.field)))
            if record_fields:
                fields_l.append(np.asarray(s.field))
    stats = np.stack(stats_l)
    fields = np.stack(fields_l) if record_fields else None
    return stats, s, fields


def run_adaptive(p, marker_per_cell: int, total_time: float, dt0, key=None,
                 upper_err_bound=1e-7, lower_err_bound=1e-10):
    """Adaptive-step PIC run to t = total_time using ``step_adaptive``
    (the reference Integrator's embedded-error doubling/halving,
    solver_pic.h:437-457, which its main() never wires up -- exposed here
    through the config surface).  Returns (times, stats, final state):
    ``times`` are the accepted step END times (nonuniform)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    dtype = jnp.asarray(p.length).dtype
    s = init_state(p, marker_per_cell, key, dtype=dtype)
    qn_coef = quasi_neutrality_coef(p, dtype=dtype)
    t, dt = 0.0, float(dt0)
    times, stats_l = [], []
    while t < total_time - 1e-12:
        dt = min(dt, total_time - t)
        s, dt_taken, dt = step_adaptive(p, s, dt, qn_coef,
                                        upper_err_bound, lower_err_bound)
        t += dt_taken
        times.append(t)
        stats_l.append(np.asarray(field_stats(s.field)))
    return np.asarray(times), np.stack(stats_l), s


def _fit_gamma(second, dt, views: bool = False):
    """LSQ slope of log rms(phi) over the (already-halved) window — the
    closed form of solver_pic.h:490-501.  The two compile-time conventions:

    * plain (default): the reference loop weights val*t BEFORE t += dt, so
      t_i = i*dt starting at 0 — paired with the (nn+1) coefficient that
      belongs to t_i = (i+1)*dt, this biases gamma by
      -12*sum(vals)/(dt*nn*(nn^2-1)); reproduced faithfully
      (calculate_omega_fft uses the unbiased fit).
    * ``views`` (EMME_USE_VIEWS, solver_pic.h:479-489): the accumulate
      lambda increments t FIRST, so t_i = (i+1)*dt — the unbiased pairing.

    Both pinned against the reference compiled each way
    (tests/goldens/omega_fit.json)."""
    vals = np.log(second[:, 2])
    t = dt * (np.arange(len(vals)) + (1 if views else 0))
    weighted_sum = float(np.sum(vals * t))
    ssum = float(np.sum(vals))
    nn = len(vals)
    return (6.0 * (2.0 * weighted_sum - dt * ssum * (nn + 1))
            / (dt * dt * nn * (nn * nn - 1)))


def calculate_omega(stats, dt, views: bool = False):
    """gamma from the LSQ slope of log rms(phi) over the second half; omega
    from peak spacing of log|mean Re phi| (solver_pic.h:475-529);
    ``views`` selects the EMME_USE_VIEWS time-weight convention for gamma
    (the omega peak fit is identical in both builds)."""
    stats = np.asarray(stats)
    n = len(stats) // 2
    second = stats[n:]
    gamma = _fit_gamma(second, dt, views=views)

    real_log = np.log(np.abs(second[:, 0]))
    peaks = [i for i in range(1, len(real_log) - 1)
             if real_log[i] > real_log[i - 1] and real_log[i] > real_log[i + 1]]
    omega = 0.0
    if len(peaks) > 1:
        omega = np.pi * (len(peaks) - 1) / (dt * (peaks[-1] - peaks[0]))
    return complex(omega, gamma)


def calculate_omega_nonuniform(times, stats):
    """(omega, gamma) fit for ADAPTIVE-step runs (nonuniform sample times
    from ``run_adaptive``): gamma by LSQ slope of log rms(phi) against the
    actual times over the second half; omega by peak counting against the
    actual peak times (the uniform-dt generalization of calculate_omega)."""
    times = np.asarray(times)
    stats = np.asarray(stats)
    n = len(stats) // 2
    t = times[n:]
    second = stats[n:]
    gamma = np.polyfit(t, np.log(second[:, 2]), 1)[0]

    real_log = np.log(np.abs(second[:, 0]))
    peaks = [i for i in range(1, len(real_log) - 1)
             if real_log[i] > real_log[i - 1] and real_log[i] > real_log[i + 1]]
    omega = 0.0
    if len(peaks) > 1:
        omega = np.pi * (len(peaks) - 1) / (t[peaks[-1]] - t[peaks[0]])
    return complex(omega, gamma)


def calculate_omega_fft(stats, dt, pad: int = 16):
    """Sign-resolving FFT variant of the omega fit.

    The reference's peak-counting fit cannot determine the sign of the real
    frequency (its own FIXME at solver_pic.h:514-527 suggests exactly this
    fix).  Here the complex mean field phi_bar(t) = <Re phi> + i <Im phi>
    over the second half is growth-flattened by the fitted gamma, Hann
    windowed, zero-padded, and the dominant spectral line is refined by
    parabolic interpolation of log|F|.  A mode evolving as
    e^{-i omega_r t + gamma t} lands at FFT frequency f = -omega_r / 2 pi,
    so the returned real part carries the physical sign and matches the
    eigen-method eigenvalue's convention.  gamma uses the unbiased LSQ slope
    (not the reference's intercept-biased closed form, see _fit_gamma)."""
    stats = np.asarray(stats)
    n = len(stats) // 2
    second = stats[n:]
    t_fit = dt * np.arange(len(second))
    gamma = float(np.polyfit(t_fit, np.log(second[:, 2]), 1)[0])

    m = len(second)
    t = dt * np.arange(m)
    sig = (second[:, 0] + 1j * second[:, 1]) * np.exp(-gamma * t)
    sig = sig * np.hanning(m)
    nfft = pad * m
    F = np.fft.fft(sig, n=nfft)
    mag = np.abs(F)
    k = int(np.argmax(mag))
    # parabolic (quadratic-log) interpolation around the peak bin
    km, kp = (k - 1) % nfft, (k + 1) % nfft
    lm, l0, lp = np.log(mag[km]), np.log(mag[k]), np.log(mag[kp])
    denom = lm - 2.0 * l0 + lp
    delta = 0.5 * (lm - lp) / denom if denom != 0.0 else 0.0
    f_peak = (k + delta) / (nfft * dt)
    if k + delta > nfft / 2:  # wrap to the negative-frequency branch
        f_peak -= 1.0 / dt
    omega = -2.0 * np.pi * f_peak
    return complex(omega, gamma)


def update_err(s: PICState, combo, dt):
    """Reference error norm (solver_pic.h:158-169): NB the reference loops
    the first field.size() markers only (an acknowledged quirk, faithfully
    reproduced): err = sqrt(sum |v_i dt|^2 / sum |w_i|^2) over i < nf."""
    nf = s.field.shape[-1]
    v = combo[:nf] * dt
    w = s.weight[:nf]
    err = jnp.sum(jnp.real(v) ** 2 + jnp.imag(v) ** 2)
    tot = jnp.sum(jnp.real(w) ** 2 + jnp.imag(w) ** 2)
    return jnp.sqrt(err / tot)


def step_adaptive(p, s: PICState, current_dt, qn_coef,
                  upper_err_bound=1e-7, lower_err_bound=1e-10,
                  density_reduce=None, max_halvings: int = 30):
    """Adaptive step with embedded-error halving/doubling and state rollback
    (solver_pic.h:437-457).  Host-level control flow around jitted steps.
    Returns (new_state, dt_taken, next_dt)."""
    s0 = s
    dt = float(current_dt)
    for _ in range(max_halvings):
        s_new, v = rk3_step(p, s0, dt, qn_coef, density_reduce)
        combo = jax.tree_util.tree_map(
            lambda *xs: sum(RK_COEF[3][k] * x for k, x in enumerate(xs)), *v)
        err = float(update_err(s_new, combo, dt))
        if err < upper_err_bound:
            next_dt = dt * 2.0 if err < lower_err_bound else dt
            return s_new, dt, next_dt
        dt *= 0.5
    raise RuntimeError("step_adaptive: error bound not reached")
