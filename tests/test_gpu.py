"""Tests that need a CUDA card (marker "gpu"); they skip elsewhere.

Run on the card, in one process:  JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from emme_tpu import accel, from_config
from emme_tpu.grid import Grid
from emme_tpu.ops import kernels, linalg, pallas_kappa
from emme_tpu.solvers import eigen, pic

pytestmark = pytest.mark.gpu


def test_platform_defaults_on_card(gpu):
    plat = accel.current()
    assert plat == "gpu"
    assert accel.newton_loop(plat) == "device"
    assert accel.fused_assembly(plat, jnp.float32)
    assert not accel.fused_assembly(plat, jnp.float64)
    assert accel.pic_deposit(plat) == "matmul"
    accel.require_kernel_route(plat)


@pytest.mark.parametrize("ms", [(0,), (0, 1, 2)])
def test_compiled_kernel_matches_xla(gpu, tokamak_cfg, stellarator_cfg, ms):
    """The compiled kernel against the XLA chain, at a pair count that is
    not a multiple of the block."""
    cfg = stellarator_cfg if len(ms) == 3 else tokamak_cfg
    p = from_config(dict(cfg, npoints=200), dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    om = jnp.asarray(-0.8 + 0.25j, jnp.complex64)
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(lambda a, b: kernels.kappa_f_tau(
            p, a, b, om, ms=ms))(grid.eta[iu], grid.eta[ju])
    got = pallas_kappa.kappa_pairs_fused(p, grid.eta[iu], grid.eta[ju], om,
                                         ms=ms)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.abs(g - w).max() < 1e-5 * np.abs(w).max()


def test_default_solve_on_card(gpu, tokamak_cfg, golden_eigenvalues):
    """f32 tok128 on the card's defaults (fused kernel, device loop)."""
    p = from_config(dict(tokamak_cfg, npoints=128), dtype=jnp.float32)
    om, vec, n, _ = eigen.solve(p, -0.8 + 0.25j, tol=1e-6)
    ref = complex(*golden_eigenvalues["tok128"]["omega"])
    assert abs(om - ref) / abs(ref) < 1e-4
    assert np.isfinite(vec).all()


def test_complex_linalg_on_card(gpu):
    """ops.linalg runs complex LU directly on the GPU (no real embedding);
    f64 solve against numpy."""
    rng = np.random.default_rng(0)
    n = 64
    M = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n)) + 4 * np.eye(n)
    dM = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    got = complex(linalg.complex_solve_trace(jnp.asarray(M), jnp.asarray(dM)))
    want = np.trace(np.linalg.solve(M, dM))
    assert abs(got - want) < 1e-10 * abs(want)


def test_pic_default_methods_agree_on_card(gpu, tokamak_cfg):
    """The card's default CIC routes (take + one-hot matmul at HIGHEST
    precision) reproduce the take + segment trajectory: the two deposits
    differ only in f32 summation order."""
    p = from_config(dict(tokamak_cfg, npoints=64), dtype=jnp.float32)
    key = jax.random.PRNGKey(1)
    st_d = np.asarray(pic.run_jitted(p, 64, 8, 0.25, key)[0])
    st_s = np.asarray(pic.run_jitted(p, 64, 8, 0.25, key,
                                     gather_method="take",
                                     deposit_method="segment")[0])
    np.testing.assert_allclose(st_d, st_s, rtol=1e-4)
