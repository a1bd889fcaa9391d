"""Fused kappa kernel (Pallas, Triton route) vs the XLA integrand path, in
the Pallas interpreter on the CPU; the compiled kernel's own tests are in
tests/test_gpu.py."""
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from emme_tpu import from_config
from emme_tpu.grid import Grid
from emme_tpu.ops import kernels, pallas_kappa
from emme_tpu.solvers import eigen


@pytest.fixture(scope="module")
def tok32_f32(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    return from_config(cfg, dtype=jnp.float32)


def test_fused_matches_xla_f32_tokamak(tok32_f32):
    """Per-pair kernel integrals from the fused kernel agree with the XLA
    f32 path to the f32 rounding floor (the reference acceptance bar is
    max(1e-6, 1e-6|I|); both paths sit at ~1e-7 abs of the f64 truth)."""
    p = tok32_f32
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    om = jnp.asarray(-0.574227 + 0.274304j, jnp.complex64)
    vals, _ = jax.jit(lambda a, b: kernels.kappa_f_tau(
        p, a, b, om, ms=(0,)))(grid.eta[iu], grid.eta[ju])
    fused = pallas_kappa.kappa_pairs_fused(
        p, grid.eta[iu], grid.eta[ju], om, ms=(0,), interpret=True)
    d = np.abs(np.asarray(fused[0]) - np.asarray(vals[0]))
    assert d.max() < 5e-7


@pytest.mark.slow
def test_fused_em_moments_match_xla(stellarator_cfg):
    """All three EM moments from one fused sweep match the XLA path."""
    cfg = dict(stellarator_cfg, npoints=24)
    p = from_config(cfg, dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    om = jnp.asarray(-1.656 + 2.49j, jnp.complex64)
    vals, _ = jax.jit(lambda a, b: kernels.kappa_f_tau(
        p, a, b, om, ms=(0, 1, 2)))(grid.eta[iu], grid.eta[ju])
    fused = pallas_kappa.kappa_pairs_fused(
        p, grid.eta[iu], grid.eta[ju], om, ms=(0, 1, 2), interpret=True)
    for m in range(3):
        d = np.abs(np.asarray(fused[m]) - np.asarray(vals[m]))
        scale = np.abs(np.asarray(vals[m])).max()
        assert d.max() < 5e-6 * max(scale, 1.0)


@pytest.mark.slow
def test_fused_tiered_assembly_matrix(tok32_f32):
    """assemble_matrix(fused=True) with tier meshes equals the XLA-path
    matrix to the f32 floor."""
    p = tok32_f32
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    from emme_tpu.ops.singularity import singularity_coeff_matrix
    coeff = singularity_coeff_matrix(p.npoints, dtype=jnp.float32)
    tiers = kernels.tier_thresholds_ij(float(grid.dx), p.npoints)
    om = jnp.asarray(-0.574227 + 0.274304j, jnp.complex64)
    M_x = np.asarray(eigen.assemble_matrix(p, grid, coeff, om, tiers=tiers))
    M_f = np.asarray(eigen.assemble_matrix(p, grid, coeff, om, tiers=tiers,
                                           fused="interpret"))
    assert np.abs(M_f - M_x).max() < 1e-6


def test_fused_solve_reaches_golden(tok32_f32, golden_eigenvalues):
    """End-to-end f32 fused solve converges to the reference eigenvalue at
    the f32 plateau (same criterion the XLA f32 path meets)."""
    om, vec, nsteps, _ = eigen.solve(tok32_f32, -0.8 + 0.25j, tol=2e-4,
                                     fused="interpret")
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(om - ref) / abs(ref) < 5e-4


def test_fused_sparse_bdia_assembly_matches(tok32_f32):
    # the fused integrand routed through the banded kernel table must
    # reproduce the XLA-path BDIA assembly (f32, Pallas interpreter)
    import jax
    import jax.numpy as jnp
    import numpy as np
    from emme_tpu.ops.singularity import singularity_coeff_band
    from emme_tpu.solvers import sparse_eigen

    p = tok32_f32
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    om = -0.8 + 0.25j
    h, bs = 3, 8
    cband = singularity_coeff_band(p.npoints, (h + 1) * bs - 1,
                                   dtype=jnp.float32)
    quad = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
    mk = lambda fused: jax.jit(lambda: sparse_eigen.assemble_bdia(
        p, grid, cband, jnp.complex64(om), h, bs, quad=quad,
        fused=fused))()
    ref = np.asarray(mk(False).data)
    got = np.asarray(mk("interpret").data)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 2e-6 * scale


@pytest.mark.parametrize("npairs", [1, 31, 33, 100])
def test_kernel_odd_pair_counts(tok32_f32, npairs):
    """Pair counts that are not a multiple of the block: the padded pairs
    are computed and dropped, the real ones match the XLA chain."""
    p = tok32_f32
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    iu, ju = iu[-npairs:], ju[-npairs:]
    om = jnp.asarray(-0.574227 + 0.274304j, jnp.complex64)
    vals, _ = jax.jit(lambda a, b: kernels.kappa_f_tau(
        p, a, b, om, ms=(0,)))(grid.eta[iu], grid.eta[ju])
    got = pallas_kappa.kappa_pairs_fused(p, grid.eta[iu], grid.eta[ju], om,
                                         ms=(0,), interpret=True)
    assert got[0].shape == (npairs,)
    want = np.asarray(vals[0])
    assert np.abs(np.asarray(got[0]) - want).max() < 1e-5 * np.abs(want).max()


def test_kernel_em_moments_small(stellarator_cfg):
    """The three EM moments of one sweep match the XLA path (small grid,
    every tier of the panel mesh)."""
    p = from_config(dict(stellarator_cfg, npoints=10), dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    om = jnp.asarray(-1.656 + 2.49j, jnp.complex64)
    quad = {"n_shoulder": 4, "n_osc": 8, "n_tail": 2}
    vals, _ = jax.jit(lambda a, b: kernels.kappa_f_tau(
        p, a, b, om, ms=(0, 1, 2), quad=quad))(grid.eta[iu], grid.eta[ju])
    got = pallas_kappa.kappa_pairs_fused(p, grid.eta[iu], grid.eta[ju], om,
                                         ms=(0, 1, 2), quad=quad,
                                         interpret=True)
    for g, w in zip(got, vals):
        w = np.asarray(w)
        assert np.abs(np.asarray(g) - w).max() < 1e-5 * np.abs(w).max()


def test_kernel_without_compiled_route_raises(tok32_f32):
    """On the CPU the kernel has no compiled route: asking for it without
    interpret=True is an error, never a silent interpreter run."""
    p = tok32_f32
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    with pytest.raises(RuntimeError, match="interpret=True"):
        pallas_kappa.kappa_pairs_fused(p, grid.eta[:3], grid.eta[1:4],
                                       -0.57 + 0.27j)
    with pytest.raises(RuntimeError, match="no compiled route"):
        eigen.solve(p, -0.8 + 0.25j, tol=1e-3, fused=True)


def test_fused_f64_rejected(tokamak_cfg):
    p = from_config(dict(tokamak_cfg, npoints=16))
    with pytest.raises(ValueError, match="f32-only"):
        eigen.solve(p, -0.8 + 0.25j, fused="interpret")
