"""Fused Pallas kernel (Triton route) for the kappa_f_tau transit-time
integral on f32 pair lists.

Assembly -- evaluating the ion kernel integral for every kept (eta, eta')
pair -- dominates the eigen solve.  The XLA implementation
(``ops/kernels.py``) evaluates the integrand over a (pairs, panels, nodes)
array and may materialise intermediates at fusion boundaries (the Bessel
Taylor/asymptotic ``where``-hybrid, the up to three moment outputs).  This
kernel evaluates the whole chain -- contour rotation, lambda propagator,
scaled complex Bessel I0/I1 hybrid, log-domain underflow-safe exponential,
velocity moments and the Gauss-Kronrod panel reduction -- in registers, so
per pair only a handful of scalars cross device memory:

  in:  per-pair d_eta, beta_1, bi(eta), bi(eta'), panel mids/half-widths
  out: per-pair integral (re, im) per velocity moment

Each program takes a block of pairs and loops over the panels; within a
panel the (pairs, G) tile holds the panel's Gauss-Kronrod nodes
padded to a power of two G with zero-weight nodes (15 -> 16, 31 -> 32), so
node positions come from index arithmetic on the per-pair panel rows -- no
gather and no matrix product.  The block of pairs follows from G so that a
program's tile stays at TILE_ELEMS elements.

All complex arithmetic is explicit (re, im) f32 pairs; the scaled-Bessel
evaluation is the Taylor + asymptotic hybrid of ``ops/bessel.py`` with term
counts sized for the f32 rounding floor.  The f64 path stays on the XLA
implementation.

Physics mirrored from reference ``src/Parameters.cpp:113-184``; panel mesh
identical to ``ops/kernels.py`` (same transit_panel_bounds / G-K rule), so
the kernel is drop-in for the f32 assembly and validated against the XLA
path in tests/test_pallas_kappa.py.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import accel
from . import kernels, quadrature

SAFE_EXP_CUTOFF = kernels.SAFE_EXP_CUTOFF
# Elements (pairs x nodes) per program: the integrand keeps ~60 live f32
# values per element, so 256 elements over 4 warps (2 per thread) stay in
# registers.  Twice that spills, and an H100 then runs the kernel ~8x
# slower (measured on G-K 15 and 31 meshes; CHANGES.md).
TILE_ELEMS = 256
NUM_WARPS = 4

# f32 Bessel hybrid term counts (vs 44/14 in the f64-capable ops/bessel.py):
# truncation error ~1e-9 at the |w| = 12 split, well under the f32 integrand
# rounding floor of ~1e-7.
_TAYLOR_TERMS = 26
_ASYM_TERMS = 10
_SPLIT = 12.0


# ---------------------------------------------------------------------------
# (re, im) complex helpers -- plain functions over f32 array pairs
# ---------------------------------------------------------------------------

def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cinv(br, bi):
    d = 1.0 / (br * br + bi * bi)
    return br * d, -bi * d


def _cdiv(ar, ai, br, bi):
    d = 1.0 / (br * br + bi * bi)
    return (ar * br + ai * bi) * d, (ai * br - ar * bi) * d


def _cexp(ar, ai):
    e = jnp.exp(ar)
    return e * jnp.cos(ai), e * jnp.sin(ai)


def _csqrt_rhp(wr, wi):
    """Principal sqrt for Re w >= 0 (algebraic form, no trig)."""
    r = jnp.sqrt(wr * wr + wi * wi)
    t = jnp.sqrt(0.5 * (r + wr) + 1e-30)
    return t, wi / (2.0 * t)


def _bessel_i01_scaled_ri(zr, zi):
    """f32 scaled I0/I1 hybrid on (re, im) planes (ops/bessel.py semantics):
    returns (i0r, i0i, i1r, i1i, zsr, zsi) with i_n = I_n(z) e^{zs},
    zs = z if Re z < 0 else -z."""
    neg = zr < 0
    zsr = jnp.where(neg, zr, -zr)
    zsi = jnp.where(neg, zi, -zi)
    wr = jnp.where(neg, -zr, zr)
    wi = jnp.where(neg, -zi, zi)
    aw2 = wr * wr + wi * wi

    # Taylor branch, scaled by e^{-w}
    qr, qi = 0.25 * (wr * wr - wi * wi), 0.5 * wr * wi
    t0r = jnp.ones_like(wr)
    t0i = jnp.zeros_like(wr)
    t1r = jnp.ones_like(wr)
    t1i = jnp.zeros_like(wr)
    for k in range(_TAYLOR_TERMS, 0, -1):
        c0 = np.float32(1.0 / (k * k))
        c1 = np.float32(1.0 / (k * (k + 1)))
        pr, pi = _cmul(t0r, t0i, qr, qi)
        t0r, t0i = 1.0 + pr * c0, pi * c0
        pr, pi = _cmul(t1r, t1i, qr, qi)
        t1r, t1i = 1.0 + pr * c1, pi * c1
    sr, si = _cexp(-wr, -wi)
    i0tr, i0ti = _cmul(t0r, t0i, sr, si)
    hr, hi = 0.5 * wr, 0.5 * wi
    ur, ui = _cmul(t1r, t1i, sr, si)
    i1tr, i1ti = _cmul(hr, hi, ur, ui)

    # Asymptotic branch (DLMF 10.40.1 + recessive 10.40.5), scaled by e^{-w}
    a0 = np.ones(_ASYM_TERMS)
    a1 = np.ones(_ASYM_TERMS)
    for k in range(1, _ASYM_TERMS):
        odd2 = (2 * k - 1) ** 2
        a0[k] = a0[k - 1] * (0.0 - odd2) / (k * 8.0)
        a1[k] = a1[k - 1] * (4.0 - odd2) / (k * 8.0)
    vr, vi = _cinv(jnp.where(aw2 == 0, jnp.ones_like(wr), wr), wi)
    s0mr = jnp.zeros_like(wr)
    s0mi = jnp.zeros_like(wr)
    s0pr = jnp.zeros_like(wr)
    s0pi = jnp.zeros_like(wr)
    s1mr = jnp.zeros_like(wr)
    s1mi = jnp.zeros_like(wr)
    s1pr = jnp.zeros_like(wr)
    s1pi = jnp.zeros_like(wr)
    for k in range(_ASYM_TERMS - 1, -1, -1):
        sg = -1.0 if (k % 2) else 1.0
        s0mr, s0mi = _cmul(s0mr, s0mi, vr, vi)
        s0mr = s0mr + np.float32(sg * a0[k])
        s0pr, s0pi = _cmul(s0pr, s0pi, vr, vi)
        s0pr = s0pr + np.float32(a0[k])
        s1mr, s1mi = _cmul(s1mr, s1mi, vr, vi)
        s1mr = s1mr + np.float32(sg * a1[k])
        s1pr, s1pi = _cmul(s1pr, s1pi, vr, vi)
        s1pr = s1pr + np.float32(a1[k])
    two_pi = np.float32(2.0 * np.pi)
    sqr, sqi = _csqrt_rhp(two_pi * wr, two_pi * wi)
    pfr, pfi = _cinv(sqr, sqi)
    sgn = jnp.where(wi >= 0, 1.0, -1.0).astype(wr.dtype)
    # e^{-2w} = (e^{-w})^2
    e2r, e2i = _cmul(sr, si, sr, si)
    # sigma0 = i sgn ; sigma1 = -i sgn : multiply recessive sums
    r0r, r0i = _cmul(e2r, e2i, s0pr, s0pi)
    r0r, r0i = -sgn * r0i, sgn * r0r
    r1r, r1i = _cmul(e2r, e2i, s1pr, s1pi)
    r1r, r1i = sgn * r1i, -sgn * r1r
    i0ar, i0ai = _cmul(pfr, pfi, s0mr + r0r, s0mi + r0i)
    i1ar, i1ai = _cmul(pfr, pfi, s1mr + r1r, s1mi + r1i)

    use_t = aw2 <= np.float32(_SPLIT * _SPLIT)
    i0r = jnp.where(use_t, i0tr, i0ar)
    i0i = jnp.where(use_t, i0ti, i0ai)
    i1r = jnp.where(use_t, i1tr, i1ar)
    i1i = jnp.where(use_t, i1ti, i1ai)
    i1r = jnp.where(neg, -i1r, i1r)
    i1i = jnp.where(neg, -i1i, i1i)
    return i0r, i0i, i1r, i1i, zsr, zsi


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------

def _kappa_kernel(scal_ref, pair_ref, mid_ref, halfw_ref, x_ref, wk_ref,
                  *out_refs, ms, n_panels):
    """One block of pairs: loop over panels, evaluate the integrand on the
    (block_pairs, nodes) tile, accumulate with the Kronrod weights.

    scal: (8,) [om_r, om_i, arc, qR, vt, ws_i, eta_i, pad]
    pair: (4, BP) [d_eta, beta1, bi_a, bi_b]
    mid/halfw: (PP, BP) panel centres / half-widths (rows >= n_panels unused)
    x/wk: (G,) node abscissae / Kronrod weights (zero on the pad node)
    out_refs: 2 * len(ms) (BP,) outputs, (re, im) per moment
    """
    om_r = scal_ref[0]
    om_i = scal_ref[1]
    arc = scal_ref[2]
    qR = scal_ref[3]
    vt = scal_ref[4]
    ws_i = scal_ref[5]
    eta_i = scal_ref[6]

    de = pair_ref[0, :][:, None]
    b1 = pair_ref[1, :][:, None]
    ba = pair_ref[2, :][:, None]
    bb = pair_ref[3, :][:, None]
    x = x_ref[...][None, :]
    wk = wk_ref[...][None, :]

    # per-pair factors, hoisted out of the panel loop
    sbb = jnp.sqrt(ba * bb)
    c = 0.5 * vt * b1 / (qR * de)
    k_de = qR * de / vt
    bsum = ba + bb
    # contour rotation (Parameters.cpp:121-129): omi = -copysign(1, Re om).
    # e^{i phi} with phi = -omi * atan(t/arc) evaluated without atan:
    # cos(atan y) = 1/sqrt(1+y^2), sin(atan y) = y/sqrt(1+y^2).
    omi = -jnp.sign(jnp.where(om_r == 0, jnp.float32(1.0), om_r))

    def panel(k, accs):
        mid = mid_ref[k, :][:, None]
        hw = halfw_ref[k, :][:, None]
        # node positions; the pad node sits at t = mid (weight 0)
        t = jnp.maximum(mid + hw * x, 1e-6)
        w = wk * hw

        y = t / arc
        rinv = jax.lax.rsqrt(1.0 + y * y)
        ear = rinv
        eai = -omi * y * rinv
        tautr = t * ear
        tauti = t * eai
        g = omi * t / (arc * (1.0 + y * y))
        jacr = ear + eai * g
        jaci = eai - ear * g

        # lambda = 1 + 0.5 i (taut vt)/(qR d_eta) beta1
        lamr = 1.0 - c * tauti
        lami = c * tautr

        # z = sqrt(bi bi') / lambda
        zr, zi = _cdiv(sbb, jnp.zeros_like(lamr), lamr, lami)
        i0r, i0i, i1r, i1i, zsr, zsi = _bessel_i01_scaled_ri(zr, zi)

        # lam^-3
        l2r, l2i = _cmul(lamr, lami, lamr, lami)
        l3r, l3i = _cmul(l2r, l2i, lamr, lami)
        l3ir, l3ii = _cinv(l3r, l3i)

        # norm_vel = qR d_eta / (vt taut)
        tinvr, tinvi = _cinv(tautr, tauti)
        nvr = k_de * tinvr
        nvi = k_de * tinvi
        nv2r, nv2i = _cmul(nvr, nvi, nvr, nvi)

        # i0_coef = (om - ws(1 + eta_i(0.5 nv^2 - 1.5)))/lam
        #           + ws eta_i (0.5(ba+bb) - lam) lam^-3
        ar = om_r - ws_i * (1.0 + eta_i * (0.5 * nv2r - 1.5))
        ai = om_i - ws_i * eta_i * 0.5 * nv2i
        c0r, c0i = _cdiv(ar, ai, lamr, lami)
        dr, di = _cmul(0.5 * bsum - lamr, -lami, l3ir, l3ii)
        i0cr = c0r + ws_i * eta_i * dr
        i0ci = c0i + ws_i * eta_i * di
        i1cr = -ws_i * eta_i * sbb * l3ir
        i1ci = -ws_i * eta_i * sbb * l3ii

        # log-domain exponent (Parameters.cpp:156-175)
        # log_norm_vel = -0.5 nv^2 ; log_i_beta = -0.5 i b1 nv
        # log_hf_tau = i taut om ; log_exp_term = -(ba+bb)/(2 + i b1 / nv)
        er = -0.5 * nv2r + 0.5 * b1 * nvi - tauti * om_r - tautr * om_i
        ei = -0.5 * nv2i - 0.5 * b1 * nvr + tautr * om_r - tauti * om_i
        qir, qii = _cdiv(jnp.zeros_like(nvr), b1 + jnp.zeros_like(nvr),
                         nvr, nvi)
        etr, eti = _cdiv(-bsum + jnp.zeros_like(nvr), jnp.zeros_like(nvr),
                         2.0 + qir, qii)
        er = er + etr - zsr
        ei = ei + eti - zsi

        keep = er >= SAFE_EXP_CUTOFF
        exr, exi = _cexp(jnp.where(keep, er, SAFE_EXP_CUTOFF), ei)
        # core = exp * (i0_coef i0s + i1_coef i1s)
        p0r, p0i = _cmul(i0cr, i0ci, i0r, i0i)
        p1r, p1i = _cmul(i1cr, i1ci, i1r, i1i)
        cr_, ci_ = _cmul(exr, exi, p0r + p1r, p0i + p1i)
        cr_ = jnp.where(keep, cr_, 0.0)
        ci_ = jnp.where(keep, ci_, 0.0)

        # base = jacob / taut * core
        jtr, jti = _cmul(jacr, jaci, tinvr, tinvi)
        mr, mi_v = _cmul(jtr, jti, cr_, ci_)

        out = []
        prev_m = 0
        for m, (acc_r, acc_i) in zip(ms, zip(accs[0::2], accs[1::2])):
            for _ in range(m - prev_m):
                mr, mi_v = _cmul(mr, mi_v, nvr, nvi)
            prev_m = m
            out += [acc_r + mr * w, acc_i + mi_v * w]
        return tuple(out)

    zero = jnp.zeros((de.shape[0], x.shape[1]), jnp.float32)
    accs = jax.lax.fori_loop(0, n_panels, panel, (zero,) * (2 * len(ms)))
    for ref, acc in zip(out_refs, accs):
        ref[...] = jnp.sum(acc, axis=1)


# ---------------------------------------------------------------------------
# wrapper
# ---------------------------------------------------------------------------

def _node_tables(order: int):
    """G-K abscissae and Kronrod weights padded to a power of two with
    zero-weight nodes."""
    x, wk, _ = quadrature.gk_rule(order)
    g = pl.next_power_of_2(order)
    x_full = np.zeros((g,), np.float32)
    wk_full = np.zeros((g,), np.float32)
    x_full[:order] = x
    wk_full[:order] = wk
    return x_full, wk_full


@partial(jax.jit, static_argnames=("ms", "n_shoulder", "n_osc", "n_tail",
                                   "order", "interpret"))
def _kappa_pairs_call(p, d_eta, beta1, bi_a, bi_b, om_r, om_i, *,
                      ms, n_shoulder, n_osc, n_tail, order,
                      interpret=False):
    n_panels = n_shoulder + n_osc + n_tail
    pp = pl.next_power_of_2(n_panels)
    x_full, wk_full = _node_tables(order)
    g = x_full.shape[0]
    bp = max(1, TILE_ELEMS // g)          # pairs per program
    npairs = d_eta.shape[0]
    npad = pl.cdiv(npairs, bp) * bp

    f32 = jnp.float32
    omega = (om_r + 1j * om_i).astype(jnp.complex64)
    bounds = kernels.transit_panel_bounds(
        p, jnp.abs(d_eta), omega, n_shoulder=n_shoulder, n_osc=n_osc,
        n_tail=n_tail).astype(f32)
    # (panels, pairs) layout: a program's panel row is one contiguous load
    mid = 0.5 * (bounds[:, :-1] + bounds[:, 1:]).T
    halfw = 0.5 * (bounds[:, 1:] - bounds[:, :-1]).T
    mid = jnp.pad(mid, ((0, pp - n_panels), (0, npad - npairs)))
    halfw = jnp.pad(halfw, ((0, pp - n_panels), (0, npad - npairs)))

    pair = jnp.stack([d_eta, beta1, bi_a, bi_b]).astype(f32)
    # pad pairs with d_eta = 1 (any nonzero: avoids 0/0; results discarded)
    pair = jnp.pad(pair, ((0, 0), (0, npad - npairs)), constant_values=1.0)

    scal = jnp.stack([om_r.astype(f32), om_i.astype(f32),
                      jnp.asarray(p.arc_coeff, f32),
                      jnp.asarray(p.q * p.R, f32),
                      jnp.asarray(p.vt, f32),
                      jnp.asarray(p.omega_s_i, f32),
                      jnp.asarray(p.eta_i, f32),
                      jnp.asarray(0.0, f32)])

    outs = pl.pallas_call(
        partial(_kappa_kernel, ms=ms, n_panels=n_panels),
        grid=(npad // bp,),
        in_specs=[
            pl.BlockSpec((8,), lambda i: (0,)),
            pl.BlockSpec((4, bp), lambda i: (0, i)),
            pl.BlockSpec((pp, bp), lambda i: (0, i)),
            pl.BlockSpec((pp, bp), lambda i: (0, i)),
            pl.BlockSpec((g,), lambda i: (0,)),
            pl.BlockSpec((g,), lambda i: (0,)),
        ],
        out_specs=[pl.BlockSpec((bp,), lambda i: (i,))] * (2 * len(ms)),
        out_shape=[jax.ShapeDtypeStruct((npad,), f32)] * (2 * len(ms)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="kappa_pairs",
    )(scal, pair, mid, halfw, jnp.asarray(x_full), jnp.asarray(wk_full))
    return tuple(o[:npairs] for o in outs)


def kappa_pairs_fused(p, eta, eta_p, omega, ms=(0,), quad=None,
                      interpret: bool = False):
    """Drop-in fused-kernel replacement for ``kernels.kappa_f_tau`` on f32
    pair lists (no embedded error output -- the runtime quadrature guard
    uses the XLA path).  Returns a tuple of complex64 (npairs,) arrays.

    The kernel runs compiled on a GPU; ``interpret=True`` runs it in the
    Pallas interpreter on any platform (the CPU tests)."""
    if not interpret:
        accel.require_kernel_route()
    quad = quad or {}
    preset = kernels.panel_preset(jnp.float32)
    order = int(quad.get("order", p.integration_start_points))
    eta = jnp.asarray(eta, jnp.float32)
    eta_p = jnp.asarray(eta_p, jnp.float32)
    d_eta = eta - eta_p
    beta1 = p.beta_1(eta, eta_p).astype(jnp.float32)
    bi_a = p.bi(eta).astype(jnp.float32)
    bi_b = p.bi(eta_p).astype(jnp.float32)
    omega = jnp.asarray(omega)
    om_r = jnp.real(omega).astype(jnp.float32)
    om_i = jnp.imag(omega).astype(jnp.float32)
    out = _kappa_pairs_call(
        p, d_eta, beta1, bi_a, bi_b, om_r, om_i, ms=tuple(ms),
        n_shoulder=int(quad.get("n_shoulder", preset["n_shoulder"])),
        n_osc=int(quad.get("n_osc", preset["n_osc"])),
        n_tail=int(quad.get("n_tail", preset["n_tail"])),
        order=order, interpret=bool(interpret))
    pref = -1j * (p.q * p.R) / (p.vt * jnp.sqrt(2.0 * jnp.pi))
    pref = pref.astype(jnp.complex64)
    return tuple(pref * (out[2 * k] + 1j * out[2 * k + 1])
                 for k in range(len(ms)))
