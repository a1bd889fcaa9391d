"""Sparse (block-banded, never-dense) eigensolve path vs the dense path and
the reference goldens."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emme_tpu import from_config
from emme_tpu.grid import Grid
from emme_tpu.ops.singularity import (singularity_coeff_band,
                                      singularity_coeff_matrix)
from emme_tpu.solvers import eigen, sparse_eigen


def test_singularity_coeff_band_matches_matrix():
    n, h = 64, 9
    cb = np.asarray(singularity_coeff_band(n, h))
    cm = np.asarray(singularity_coeff_matrix(n))
    for i in (0, 1, 30, 62, 63):
        for dj in range(-h, h + 1):
            j = i + dj
            if 0 <= j < n:
                assert cb[i, dj + h] == cm[i, j]


def test_assemble_bdia_matches_dense_band(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    coeff = singularity_coeff_matrix(64)
    om = jnp.complex128(-0.8 + 0.25j)
    M = np.asarray(eigen.assemble_matrix(p, grid, coeff, om, chunk=512))
    bs, h = 16, 2
    cband = singularity_coeff_band(64, (h + 1) * bs - 1)
    op = sparse_eigen.assemble_bdia(p, grid, cband, om, h, bs, chunk=512)
    data = np.asarray(op.data)
    nb = 64 // bs
    Mb = M.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    for k, d in enumerate(op.offsets):
        for r in range(nb):
            c = r + d
            if 0 <= c < nb:
                got = data[k, r, 0] + 1j * data[k, r, 1]
                np.testing.assert_allclose(got, Mb[r, c], atol=1e-13)
            else:
                assert not data[k, r].any()  # zero padding


def test_sparse_solve_tok32_golden(golden_eigenvalues, tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    stats = {}
    om, vec, steps, state = sparse_eigen.solve(
        p, -0.8 + 0.25j, tol=1e-6, block=8, band_deta=20.0, stats=stats)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    # the dense operator never existed; the stored band is a strict subset
    assert stats["nnz"] < 32 * 32
    assert stats["spmv_nnz_per_s"] > 0
    # eigenvector correlates with the dense-path golden
    gv = np.fromfile("tests/goldens/eigenvector_tok32.bin", np.complex128)
    corr = abs(np.vdot(gv, vec)) / (np.linalg.norm(gv) * np.linalg.norm(vec))
    assert corr > 1 - 1e-5


@pytest.mark.slow
def test_sparse_solve_arnoldi_stage_recovers_far_guess(golden_eigenvalues,
                                                       tokamak_cfg):
    """From a deliberately bad guess, the shift-invert Arnoldi stage must
    pull omega into the right basin before the Newton polish."""
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    stats = {}
    om, _vec, _steps, _state = sparse_eigen.solve(
        p, -0.45 + 0.65j, tol=1e-6, block=8, band_deta=20.0,
        m_krylov=16, stats=stats)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    # the shift-invert linearization is first-order in (omega - sigma), so
    # from far away the Ritz value is an improvement, not an answer
    est = stats["arnoldi_omega"]
    assert abs(est - ref) < 0.8 * abs(complex(-0.45, 0.65) - ref)


def test_host64_polish_banded_tok32(golden_eigenvalues, tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    om, vec, steps, _ = sparse_eigen.solve(
        p, -0.8 + 0.25j, tol=1e-6, block=8, band_deta=20.0, host64=True)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 2e-6
    assert np.linalg.norm(vec) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.slow
def test_bdia_secant_matches_dense_secant(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    bs, h = 8, 3
    cband = singularity_coeff_band(32, (h + 1) * bs - 1)
    om1 = jnp.complex128(-0.8 + 0.25j)
    dom = jnp.complex128(0.01 * (-0.8 + 0.25j))
    A = sparse_eigen.assemble_bdia(p, grid, cband, om1, h, bs)
    B = sparse_eigen.assemble_bdia(p, grid, cband, om1 + dom, h, bs)
    dM = sparse_eigen.bdia_secant(B, A, dom)
    got = np.asarray(dM.data[:, :, 0]) + 1j * np.asarray(dM.data[:, :, 1])
    expect = ((np.asarray(B.data[:, :, 0]) + 1j * np.asarray(B.data[:, :, 1]))
              - (np.asarray(A.data[:, :, 0]) + 1j * np.asarray(A.data[:, :, 1]))
              ) / complex(dom)
    np.testing.assert_allclose(got, expect, atol=1e-12)


# ---------------------------------------------------------------------------
# electromagnetic (interleaved phi/A ordering)
# ---------------------------------------------------------------------------

def _interleave_perm(n):
    """Permutation taking the reference [phi; A] layout to interleaved."""
    perm = np.empty(2 * n, np.int64)
    perm[0::2] = np.arange(n)
    perm[1::2] = np.arange(n) + n
    return perm


@pytest.mark.slow
def test_assemble_bdia_em_matches_dense(stellarator_cfg):
    """The EM banded assembly must equal the dense 2x2-block operator
    (solver.h:461-511) permuted to interleaved ordering, inside the band."""
    cfg = dict(stellarator_cfg, npoints=32)
    p = from_config(cfg)
    assert p.electromagnetic
    grid = Grid.create(p.length, p.npoints)
    coeff = singularity_coeff_matrix(32)
    om = jnp.complex128(-1.656 + 2.49j)
    M = np.asarray(eigen.assemble_matrix(p, grid, coeff, om, chunk=512))
    perm = _interleave_perm(32)
    Mi = M[np.ix_(perm, perm)]

    bs, h = 16, 2
    de_max = sparse_eigen.em_de_max(32, h, bs)
    cband = singularity_coeff_band(32, de_max)
    op = sparse_eigen.assemble_bdia(p, grid, cband, om, h, bs, chunk=512)
    assert op.n == 64 and op.block == bs
    data = np.asarray(op.data)
    nb = 64 // bs
    Mb = Mi.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    for k, d in enumerate(op.offsets):
        for r in range(nb):
            c = r + d
            if 0 <= c < nb:
                got = data[k, r, 0] + 1j * data[k, r, 1]
                # zero out dense entries beyond the kept |i-j| <= de_max band
                ii = (r * bs + np.arange(bs)[:, None]) // 2
                jj = (c * bs + np.arange(bs)[None, :]) // 2
                expect = np.where(np.abs(jj - ii) <= de_max, Mb[r, c], 0.0)
                expect = np.where((r * bs + np.arange(bs)[:, None])
                                  == (c * bs + np.arange(bs)[None, :]),
                                  Mb[r, c], expect)
                np.testing.assert_allclose(got, expect, atol=1e-13)
            else:
                assert not data[k, r].any()


@pytest.mark.slow
def test_sparse_solve_stel32_golden(golden_eigenvalues, stellarator_cfg):
    """End-to-end electromagnetic sparse solve vs the reference golden.
    The banded TraceSecant (selected-inversion trace) shares the dense
    trace iteration's basin: it converges in the reference's own 17 steps
    where the smallest-singular-pair updates diverge from this guess."""
    cfg = dict(stellarator_cfg, npoints=32)
    p = from_config(cfg)
    stats = {}
    om, vec, steps, state = sparse_eigen.solve(
        p, -1.656 + 2.49j, tol=1e-6, block=16, band_deta=20.0, stats=stats)
    ref = complex(*golden_eigenvalues["stel32"]["omega"])
    # same quadrature-limited tolerance as the dense stel32 test
    assert abs(om - ref) / abs(ref) < 5e-5
    assert steps == golden_eigenvalues["stel32"]["steps"]
    assert state.M.n == 64
    # eigenvector comes back in the reference [phi; A] layout
    gv = np.fromfile("tests/goldens/eigenvector_stel32.bin", np.complex128)
    corr = abs(np.vdot(gv, vec)) / (np.linalg.norm(gv) * np.linalg.norm(vec))
    assert corr > 1 - 1e-5


@pytest.mark.slow
def test_tiered_em_sparse_assembly_matches(stellarator_cfg):
    """EM banded assembly with |i-j| tiers (contiguous de-group slicing of
    the flat kernel table) agrees with the untiered operator."""
    from emme_tpu.ops import kernels as K

    cfg = dict(stellarator_cfg, npoints=32)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    bs, h = 16, 2
    de_max = sparse_eigen.em_de_max(32, h, bs)
    cband = singularity_coeff_band(32, de_max)
    om = jnp.complex128(-1.656 + 2.49j)
    dx = 2.0 * float(p.length) / 31
    tiers = K.tier_thresholds_ij(dx, 32)
    A = sparse_eigen.assemble_bdia(p, grid, cband, om, h, bs, chunk=512)
    B = sparse_eigen.assemble_bdia(p, grid, cband, om, h, bs, chunk=512,
                                   tiers=tiers)
    assert float(jnp.abs(A.data - B.data).max()) < 1e-7
    assert float(jnp.abs(A.data - B.data).max()) > 0


@pytest.mark.slow
def test_solve_shifts_banded_multishift(golden_eigenvalues, tokamak_cfg):
    """Multi-shift banded eigensolve: full eigenpairs per shift at
    O(n*band) memory, shifts fanned over devices (BASELINE config 5
    building block; supersedes the dense estimate-only batched Arnoldi)."""
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    out = sparse_eigen.solve_shifts(
        p, [-0.8 + 0.25j, -0.5 + 0.2j], tol=1e-6, m_krylov=12,
        workers=2, block=8, band_deta=20.0)
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    for om, vec, steps in out:
        assert abs(om - ref) / abs(ref) < 2e-6
        assert vec is not None and len(vec) == 32
        assert steps > 0


def test_bdia_matvec_matches_dense_production_operator(tokamak_cfg):
    # the BDIA einsum SpMV on the production operator equals the dense
    # product of the same stored blocks
    from emme_tpu.ops.sparse import bdia_matvec

    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    h, bs = 3, 8
    cband = singularity_coeff_band(p.npoints, (h + 1) * bs - 1)
    op = sparse_eigen.assemble_bdia(p, grid, cband, -0.8 + 0.25j, h, bs,
                                    quad={"n_shoulder": 8, "n_osc": 16,
                                          "n_tail": 4})
    nb = op.n // bs
    data = np.asarray(op.data)
    dense = np.zeros((op.n, op.n), complex)
    for k, d in enumerate(op.offsets):
        for i in range(max(0, -d), min(nb, nb - d)):
            j = i + d
            dense[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = \
                data[k, i, 0] + 1j * data[k, i, 1]
    rng = np.random.default_rng(0)
    x = rng.normal(size=op.n) + 1j * rng.normal(size=op.n)
    yr, yi = bdia_matvec(op, jnp.asarray(x.real), jnp.asarray(x.imag))
    want = dense @ x
    np.testing.assert_allclose(np.asarray(yr) + 1j * np.asarray(yi), want,
                               rtol=0, atol=1e-12 * np.abs(want).max())
    assert op.nnzb == sum(nb - abs(d) for d in op.offsets)


@pytest.mark.slow
def test_sparse_solve_device_loop_matches_host(tokamak_cfg,
                                               golden_eigenvalues):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    kw = dict(tol=1e-6, block=8, band_deta=20.0)
    om_h, vec_h, n_h, _ = sparse_eigen.solve(p, -0.8 + 0.25j, loop="host",
                                             **kw)
    om_d, vec_d, n_d, _ = sparse_eigen.solve(p, -0.8 + 0.25j, loop="device",
                                             **kw)
    assert n_d == n_h
    assert abs(om_d - om_h) / abs(om_h) < 1e-12
    corr = abs(np.vdot(vec_h, vec_d)) / (
        np.linalg.norm(vec_h) * np.linalg.norm(vec_d))
    assert corr > 1 - 1e-10
