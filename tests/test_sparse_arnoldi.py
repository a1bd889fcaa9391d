"""BDIA operator SpMV (single device and row-sharded) and shift-invert
Arnoldi."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emme_tpu import from_config
from emme_tpu.ops import sparse
from emme_tpu.solvers import arnoldi


@pytest.fixture(scope="module")
def banded_matrix():
    rng = np.random.default_rng(0)
    n = 512
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    i = np.arange(n)
    M *= np.exp(-np.abs(i[:, None] - i[None, :]) / 40.0)
    return M


def test_bdia_offsets_respect_threshold(banded_matrix):
    op = sparse.bdia_from_dense(banded_matrix, block=128, threshold=1e-2)
    assert 0 in op.offsets
    assert len(op.offsets) < 2 * (512 // 128) - 1


@pytest.mark.parametrize("nrhs", [None, 4])
def test_bdia_matvec_matches_dense(banded_matrix, nrhs):
    M = banded_matrix
    n = M.shape[0]
    op = sparse.bdia_from_dense(M, block=128, threshold=0.0)
    rng = np.random.default_rng(3)
    shape = (n,) if nrhs is None else (n, nrhs)
    x = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    yr, yi = jax.jit(sparse.bdia_matvec)(op, jnp.asarray(x.real),
                                         jnp.asarray(x.imag))
    y = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.abs(y - M @ x).max() < 1e-9


def test_bdia_dropped_diagonals_zero_contribution(banded_matrix):
    # with a threshold, result equals matvec against the band-truncated M
    M = banded_matrix
    op = sparse.bdia_from_dense(M, block=128, threshold=1e-3)
    nb = 512 // 128
    blocks = M.reshape(nb, 128, nb, 128).transpose(0, 2, 1, 3).copy()
    keep = np.isin(np.arange(nb)[None, :] - np.arange(nb)[:, None],
                   list(op.offsets))
    blocks[~keep] = 0
    Md = blocks.transpose(0, 2, 1, 3).reshape(512, 512)
    rng = np.random.default_rng(4)
    x = rng.normal(size=512) + 1j * rng.normal(size=512)
    yr, yi = sparse.bdia_matvec(op, jnp.asarray(x.real), jnp.asarray(x.imag))
    y = np.asarray(yr) + 1j * np.asarray(yi)
    assert np.abs(y - Md @ x).max() < 1e-10


def test_sharded_bdia_matvec_matches_dense(banded_matrix):
    """Row-block sharded SpMV with ppermute halo exchange on the virtual
    8-device mesh reproduces the dense matvec."""
    from emme_tpu.parallel import mesh as mesh_mod
    from emme_tpu.parallel import sharded

    M = banded_matrix  # 512x512, decay length 40 -> band fits 1-block halo
    op = sparse.bdia_from_dense(M, block=32, threshold=1e-3)
    m = mesh_mod.make_mesh(n_rows=8, n_scan=1)
    data, halo = sharded.shard_bdia(op, m)
    rng = np.random.default_rng(5)
    x = rng.normal(size=512) + 1j * rng.normal(size=512)
    xr = jax.device_put(jnp.asarray(x.real), mesh_mod.row_sharding(m))
    xi = jax.device_put(jnp.asarray(x.imag), mesh_mod.row_sharding(m))
    yr, yi = jax.jit(lambda d, a, b: sharded.sharded_bdia_matvec(
        d, op.offsets, halo, m, a, b))(data, xr, xi)
    y = np.asarray(yr) + 1j * np.asarray(yi)

    # compare against the band-truncated dense product (same stored data)
    yr_ref, yi_ref = sparse.bdia_matvec(op, jnp.asarray(x.real),
                                        jnp.asarray(x.imag))
    y_ref = np.asarray(yr_ref) + 1j * np.asarray(yi_ref)
    assert np.abs(y - y_ref).max() < 1e-10


class TestArnoldi:
    @pytest.mark.slow
    def test_arnoldi_plus_polish_matches_golden(self, tokamak_cfg,
                                                golden_eigenvalues):
        cfg = dict(tokamak_cfg, npoints=32)
        p = from_config(cfg)
        om, vec, steps = arnoldi.solve(p, sigma=-0.8 + 0.25j, m_krylov=24,
                                       newton_polish=6)
        ref = complex(*golden_eigenvalues["tok32"]["omega"])
        assert abs(om - ref) / abs(ref) < 2e-6

    def test_raw_estimate_in_neighbourhood(self, tokamak_cfg,
                                           golden_eigenvalues):
        cfg = dict(tokamak_cfg, npoints=32)
        p = from_config(cfg)
        om, _, _ = arnoldi.solve(p, sigma=-0.6 + 0.28j, m_krylov=24,
                                 newton_polish=0)
        ref = complex(*golden_eigenvalues["tok32"]["omega"])
        assert abs(om - ref) < 0.15  # linearized estimate, no polish

    def test_multi_shift_batched(self, tokamak_cfg, golden_eigenvalues):
        cfg = dict(tokamak_cfg, npoints=32)
        p = from_config(cfg)
        sigmas = np.array([-0.7 + 0.3j, -0.5 + 0.25j])
        ests = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24)
        ref = complex(*golden_eigenvalues["tok32"]["omega"])
        assert all(abs(e - ref) < 0.2 for e in ests)

    def test_multi_shift_sharded_over_scan_axis(self, tokamak_cfg):
        from emme_tpu.parallel import mesh as mesh_mod
        cfg = dict(tokamak_cfg, npoints=16)
        p = from_config(cfg)
        m = mesh_mod.make_mesh(n_rows=2, n_scan=4)
        sigmas = np.array([-0.7 + 0.3j, -0.6 + 0.25j, -0.8 + 0.2j,
                           -0.5 + 0.3j])
        ests = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=12, mesh=m)
        assert np.isfinite(ests).all()


@pytest.mark.slow
def test_sharded_bdia_matvec_multihop_overlap_modes(banded_matrix):
    """Wide-band case (halo spans 3 shard stripes): the overlapped
    double-buffered relay and the serialized relay produce identical
    results, matching the single-device matvec."""
    from emme_tpu.parallel import mesh as mesh_mod
    from emme_tpu.parallel import sharded

    M = banded_matrix  # 512x512
    op = sparse.bdia_from_dense(M, block=16, threshold=1e-6)
    halo_blocks = max(abs(d) for d in op.offsets)
    m = mesh_mod.make_mesh(n_rows=8, n_scan=1)
    nbl = (512 // 16) // 8
    assert halo_blocks > nbl, "test needs a multi-hop halo"
    data, halo = sharded.shard_bdia(op, m)
    rng = np.random.default_rng(6)
    x = rng.normal(size=512) + 1j * rng.normal(size=512)
    xr = jax.device_put(jnp.asarray(x.real), mesh_mod.row_sharding(m))
    xi = jax.device_put(jnp.asarray(x.imag), mesh_mod.row_sharding(m))

    yr_ref, yi_ref = sparse.bdia_matvec(op, jnp.asarray(x.real),
                                        jnp.asarray(x.imag))
    y_ref = np.asarray(yr_ref) + 1j * np.asarray(yi_ref)
    for overlap in (True, False):
        yr, yi = jax.jit(lambda d, a, b, o=overlap: sharded.sharded_bdia_matvec(
            d, op.offsets, halo, m, a, b, overlap=o))(data, xr, xi)
        y = np.asarray(yr) + 1j * np.asarray(yi)
        assert np.abs(y - y_ref).max() < 1e-10, overlap
