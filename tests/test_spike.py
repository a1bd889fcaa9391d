"""Distributed (SPIKE + Woodbury) banded solve vs the single-device path,
on the virtual 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emme_tpu import from_config
from emme_tpu.grid import Grid
from emme_tpu.ops import banded
from emme_tpu.ops.singularity import singularity_coeff_band
from emme_tpu.ops.sparse import BDIAOperator, bdia_matvec
from emme_tpu.parallel import mesh as mesh_mod
from emme_tpu.parallel import spike
from emme_tpu.solvers import sparse_eigen


# light panel meshes: every test here compares sharded-vs-single-device
# on the SAME operator, so quadrature depth only sets the cost
QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}


def _mesh(rows):
    return mesh_mod.make_mesh(n_rows=rows, n_scan=1,
                              devices=jax.devices("cpu")[:rows])


def _tok_op_build(tokamak_cfg, n=64, bs=8, h=2):
    cfg = dict(tokamak_cfg, npoints=n)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    cband = singularity_coeff_band(p.npoints, (h + 1) * bs - 1)
    op = sparse_eigen.assemble_bdia(p, grid, cband, -0.8 + 0.25j, h, bs,
                                    quad=QUAD)
    return p, grid, cband, op


@pytest.fixture(scope="module")
def tok_op(tokamak_cfg):
    """The shared n=64 banded operator (assembly is the dominant cost of
    this module; build it once)."""
    return _tok_op_build(tokamak_cfg)


@pytest.mark.slow
def test_assemble_window_matches_global(tok_op):
    p, grid, cband, op = tok_op
    nb = op.n // op.block
    h = max(op.offsets)
    # windows tile the matrix; stacked windows must reproduce the global data
    nbl = nb // 4
    parts = [sparse_eigen.assemble_bdia_window(
        p, grid, cband, -0.8 + 0.25j, h, op.block, s * nbl, nbl, quad=QUAD)
        for s in range(4)]
    got = jnp.concatenate(parts, axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(op.data),
                               rtol=0, atol=1e-12)


@pytest.mark.slow
def test_assemble_window_matches_global_em(stellarator_cfg):
    cfg = dict(stellarator_cfg, npoints=32)
    p = from_config(cfg)
    assert p.electromagnetic
    grid = Grid.create(p.length, p.npoints)
    bs, h = 8, 3
    w_el = sparse_eigen.em_de_max(p.npoints, h, bs)
    cband = singularity_coeff_band(p.npoints, w_el)
    om = -1.656 + 2.490j
    op = sparse_eigen.assemble_bdia(p, grid, cband, om, h, bs, quad=QUAD)
    nb = op.n // bs
    nbl = nb // 2
    parts = [sparse_eigen.assemble_bdia_window(
        p, grid, cband, om, h, bs, s * nbl, nbl, quad=QUAD)
        for s in range(2)]
    got = jnp.concatenate(parts, axis=1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(op.data),
                               rtol=0, atol=1e-12)


def test_sharded_assembly_matches(tok_op):
    p, grid, cband, op = tok_op
    mesh = _mesh(4)
    with mesh:
        op_s = jax.jit(lambda: spike.sharded_assemble_bdia(
            p, grid, cband, -0.8 + 0.25j, max(op.offsets), op.block, mesh,
            quad=QUAD))()
        data = jax.device_get(op_s.data)
    np.testing.assert_allclose(data, np.asarray(op.data), rtol=0, atol=1e-12)


def test_spike_solve_matches_banded(tok_op):
    p, grid, cband, op = tok_op
    rng = np.random.default_rng(0)
    fr = jnp.asarray(rng.normal(size=op.n))
    fi = jnp.asarray(rng.normal(size=op.n))
    lu = banded.banded_lu(op)
    zr_ref, zi_ref = banded.banded_solve(lu, fr, fi)
    mesh = _mesh(4)
    with mesh:
        # jit the shard_map program (eager shard_map dispatches each traced
        # primitive separately -- minutes of pure dispatch on this host)
        zr, zi = jax.jit(lambda d, a, b: spike.sharded_solve_vec(
            BDIAOperator(data=d, offsets=op.offsets, n=op.n,
                         block=op.block), mesh, a, b))(op.data, fr, fi)
        zr, zi = jax.device_get((zr, zi))
    scale = np.abs(np.asarray(zr_ref)).max()
    np.testing.assert_allclose(zr, np.asarray(zr_ref), rtol=0,
                               atol=1e-10 * scale)
    np.testing.assert_allclose(zi, np.asarray(zi_ref), rtol=0,
                               atol=1e-10 * scale)


def test_spike_trace_matches_takahashi(tok_op):
    p, grid, cband, op = tok_op
    # dM from a nearby omega (a real secant difference, not a toy)
    op2 = sparse_eigen.assemble_bdia(p, grid, cband, -0.81 + 0.26j,
                                     max(op.offsets), op.block, quad=QUAD)
    dM = sparse_eigen.bdia_secant(op2, op, 0.01 + 0.01j)
    lu = banded.banded_lu(op)
    Zu = banded.banded_selected_inverse(lu)
    tr_ref_r, tr_ref_i = banded.banded_trace_product(Zu, dM)
    tr_ref = complex(float(tr_ref_r), float(tr_ref_i))
    mesh = _mesh(4)
    with mesh:
        dr, di = jax.jit(lambda a, b: spike.sharded_trace_d_omega(
            BDIAOperator(data=a, offsets=op.offsets, n=op.n,
                         block=op.block),
            BDIAOperator(data=b, offsets=dM.offsets, n=dM.n,
                         block=dM.block), mesh))(op.data, dM.data)
        got = -1.0 / complex(float(dr), float(di))
    assert abs(got - tr_ref) / abs(tr_ref) < 1e-10


@pytest.mark.slow
def test_sharded_solve_end_to_end_matches(tokamak_cfg, golden_eigenvalues):
    # the whole distributed Newton walk (sharded assembly + SPIKE trace +
    # secant) must match the single-device sparse solve to f64 roundoff --
    # same trajectory, same step count -- and hit the golden eigenvalue.
    cfg = dict(tokamak_cfg, npoints=128)
    p = from_config(cfg)
    # band_deta=10 keeps h (=4 blocks) <= nbl (=4) on the 4-row mesh
    om_ref, vec_ref, n_ref, _ = sparse_eigen.solve(
        p, -0.8 + 0.25j, tol=1e-6, quad=QUAD, block=8, band_deta=10.0)
    mesh = _mesh(4)
    om, vec, n, _ = spike.solve(p, -0.8 + 0.25j, mesh, tol=1e-6, quad=QUAD,
                                block=8, band_deta=10.0)
    assert n == n_ref
    assert abs(om - om_ref) / abs(om_ref) < 1e-11
    corr = abs(np.vdot(vec, vec_ref)) / (
        np.linalg.norm(vec) * np.linalg.norm(vec_ref))
    assert corr > 1 - 1e-9
    golden = complex(*golden_eigenvalues["tok128"]["omega"])
    assert abs(om - golden) / abs(golden) < 2e-2  # band_deta=10 truncation


@pytest.mark.slow
def test_driver_mesh_sparse_end_to_end(tmp_path, tokamak_cfg):
    # product surface: `"mesh": {"rows": N}` in the input JSON routes the
    # sparse backend through the distributed SPIKE solve; omega must match
    # the meshless driver run to f64 roundoff.
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=128, method="eigen",
                eigen_backend="sparse", band_block=8, band_deta=10.0,
                initial_guess=[-0.8, 0.25], iteration_precision=1e-6,
                quad_guard="off")
    r0 = driver.run(base, output_dir=tmp_path / "single", verbose=False,
                    quad=QUAD)
    r1 = driver.run(dict(base, mesh={"rows": 4}),
                    output_dir=tmp_path / "mesh", verbose=False, quad=QUAD)
    ev0 = complex(*r0["result"]["(None)"]["scan_result"][0]["eigenvalue"])
    ev1 = complex(*r1["result"]["(None)"]["scan_result"][0]["eigenvalue"])
    assert abs(ev1 - ev0) / abs(ev0) < 1e-11
    # the BDIA dump + sidecar must exist and be loadable
    from emme_tpu.ops.sparse import load_bdia_dump
    op = load_bdia_dump(tmp_path / "mesh" / "eigenMatrics" /
                        "eigenMatrix.bin")
    assert op.n == 128


@pytest.mark.slow
def test_driver_mesh_dense_end_to_end(tmp_path, tokamak_cfg):
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=64, method="eigen",
                initial_guess=[-0.8, 0.25], iteration_precision=1e-6,
                quad_guard="off")
    r0 = driver.run(base, output_dir=tmp_path / "single", verbose=False,
                    quad=QUAD)
    r1 = driver.run(dict(base, mesh={"rows": 4}),
                    output_dir=tmp_path / "mesh", verbose=False, quad=QUAD)
    ev0 = complex(*r0["result"]["(None)"]["scan_result"][0]["eigenvalue"])
    ev1 = complex(*r1["result"]["(None)"]["scan_result"][0]["eigenvalue"])
    assert abs(ev1 - ev0) / abs(ev0) < 1e-10


def test_driver_mesh_pic(tmp_path, tokamak_cfg):
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=32, method="PIC", marker_per_cell=16,
                step_number=8, time_step=0.25, initial_guess=[-0.8, 0.25])
    r1 = driver.run(dict(base, mesh={"rows": 4}),
                    output_dir=tmp_path / "mesh", verbose=False)
    ev = r1["result"]["(None)"]["scan_result"][0]["eigenvalue"]
    assert np.isfinite(ev).all()


@pytest.mark.parametrize("rows,want", [(None, [0]), (4, [0, 1, 2, 3])])
def test_driver_reports_device_set(tmp_path, tokamak_cfg, rows, want):
    """The result names the devices that held the solve's arrays: one for
    a meshless run, every device of the rows axis for a mesh run."""
    from emme_tpu import driver
    cfg = dict(tokamak_cfg, npoints=32, method="PIC", marker_per_cell=16,
               step_number=8, time_step=0.25, initial_guess=[-0.8, 0.25])
    if rows:
        cfg["mesh"] = {"rows": rows}
    out = driver.run(cfg, output_dir=tmp_path, verbose=False)
    assert out["result"]["(None)"]["scan_result"][0]["devices"] == want


def test_sharded_nullspace(tok_op):
    p, grid, cband, op = tok_op
    mesh = _mesh(4)
    with mesh:
        vr, vi = jax.jit(lambda d: spike.sharded_nullspace(
            BDIAOperator(data=d, offsets=op.offsets, n=op.n,
                         block=op.block), mesh))(op.data)
        vr, vi = jax.device_get((vr, vi))
    # same amplified direction as the single-device inverse iteration
    lu = banded.banded_lu(op)
    from emme_tpu.solvers.sparse_eigen import _null_vector
    wr, wi = _null_vector(lu, op.n, op.data.dtype, iters=3)
    v = vr + 1j * vi
    w = np.asarray(wr) + 1j * np.asarray(wi)
    corr = abs(np.vdot(v, w)) / (np.linalg.norm(v) * np.linalg.norm(w))
    assert corr > 1 - 1e-9


@pytest.mark.slow
def test_driver_mesh_rows_scan_end_to_end(tmp_path, tokamak_cfg):
    """The 2-D rows x scan topology from the input file: 4 scan points run
    2 at a time, each solve SPIKE-distributed over its own 2-device row
    group; converged eigenvalues must match the meshless sequential scan
    (both converge to |d_omega| < 1e-6 |omega| from slightly different
    continuation seeds)."""
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=128, method="eigen",
                eigen_backend="sparse", band_block=8, band_deta=10.0,
                initial_guess=[-0.8, 0.25], iteration_precision=1e-6,
                quad_guard="off",
                eta_i={"head": 3.13, "step": 0.1, "tail": 3.43})
    r0 = driver.run(base, output_dir=tmp_path / "seq", verbose=False,
                    quad=QUAD)
    r1 = driver.run(dict(base, mesh={"rows": 2, "scan": 2}),
                    output_dir=tmp_path / "mesh2x2", verbose=False,
                    quad=QUAD)
    res0 = r0["result"]["eta_i"]["scan_result"]
    res1 = r1["result"]["eta_i"]["scan_result"]
    assert len(res0) == len(res1) == 4
    for a, b in zip(res0, res1):
        ea = complex(*a["eigenvalue"])
        eb = complex(*b["eigenvalue"])
        assert abs(ea - eb) / abs(ea) < 1e-5


@pytest.mark.slow
def test_driver_shifts_rows_scan(tmp_path, tokamak_cfg):
    """BASELINE config 5 surface: "shifts" in the input fan out over the
    scan groups, each solve sharded over its group's rows axis."""
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=128, method="eigen",
                eigen_backend="sparse", band_block=8, band_deta=10.0,
                iteration_precision=1e-6, quad_guard="off",
                shifts=[[-0.8, 0.25], [-0.75, 0.3]],
                mesh={"rows": 2, "scan": 2})
    r = driver.run(base, output_dir=tmp_path / "shifts", verbose=False,
                   quad=QUAD)
    out = r["result"]["shifts"]["scan_result"]
    assert len(out) == 2
    evs = [complex(*o["eigenvalue"]) for o in out]
    # both shifts converge to the same (banded) tok128 eigenvalue
    assert abs(evs[0] - evs[1]) / abs(evs[0]) < 1e-4
    assert out[0]["shift"] == [-0.8, 0.25]


def test_block_tridiag_selected_inverse():
    """_bt_factor/_bt_solve/_bt_z_band vs the dense inverse on a random
    unit-diagonal block-tridiagonal complex matrix (S=5 blocks of 6)."""
    rng = np.random.default_rng(3)
    S, n2 = 5, 6
    Rsup = [jnp.asarray(np.stack([0.3 * rng.normal(size=(n2, n2)),
                                  0.3 * rng.normal(size=(n2, n2))]))
            for _ in range(S - 1)]
    Rsub = [jnp.asarray(np.stack([0.3 * rng.normal(size=(n2, n2)),
                                  0.3 * rng.normal(size=(n2, n2))]))
            for _ in range(S - 1)]
    D, Ebar = spike._bt_factor(Rsup, Rsub, S, n2, jnp.float64)

    # dense assembly
    r = S * n2
    Rd = np.eye(r, dtype=np.complex128)
    for s in range(S - 1):
        Rd[s*n2:(s+1)*n2, (s+1)*n2:(s+2)*n2] = \
            np.asarray(Rsup[s][0]) + 1j * np.asarray(Rsup[s][1])
        Rd[(s+1)*n2:(s+2)*n2, s*n2:(s+1)*n2] = \
            np.asarray(Rsub[s][0]) + 1j * np.asarray(Rsub[s][1])
    Zd_dense = np.linalg.inv(Rd)

    # solve
    b = [jnp.asarray(np.stack([rng.normal(size=(n2, 3)),
                               rng.normal(size=(n2, 3))])) for _ in range(S)]
    x = spike._bt_solve(Rsup, Rsub, D, b, S)
    bd = np.concatenate([np.asarray(bb[0]) + 1j * np.asarray(bb[1])
                         for bb in b])
    xd = np.linalg.solve(Rd, bd)
    xs = np.concatenate([np.asarray(xx[0]) + 1j * np.asarray(xx[1])
                         for xx in x])
    assert np.abs(xs - xd).max() < 1e-10

    # selected inverse band
    Zd, Zsup1, Zsub1, Zsup2, Zsub2 = spike._bt_z_band(Rsup, Rsub, D, Ebar, S)
    def blk(z):
        return np.asarray(z[0]) + 1j * np.asarray(z[1])
    for s in range(S):
        assert np.abs(blk(Zd[s]) -
                      Zd_dense[s*n2:(s+1)*n2, s*n2:(s+1)*n2]).max() < 1e-10
    for s in range(S - 1):
        assert np.abs(blk(Zsup1[s]) -
                      Zd_dense[s*n2:(s+1)*n2, (s+1)*n2:(s+2)*n2]).max() < 1e-10
        assert np.abs(blk(Zsub1[s]) -
                      Zd_dense[(s+1)*n2:(s+2)*n2, s*n2:(s+1)*n2]).max() < 1e-10
    for s in range(S - 2):
        assert np.abs(blk(Zsup2[s]) -
                      Zd_dense[s*n2:(s+1)*n2, (s+2)*n2:(s+3)*n2]).max() < 1e-10
        assert np.abs(blk(Zsub2[s]) -
                      Zd_dense[(s+2)*n2:(s+3)*n2, s*n2:(s+1)*n2]).max() < 1e-10


@pytest.mark.slow
def test_driver_mesh_rows_scan_pic(tmp_path, tokamak_cfg):
    """PIC through the 2-D topology: scan points fan over the groups, each
    run marker-sharded with psum deposition over its rows axis."""
    from emme_tpu import driver
    base = dict(tokamak_cfg, npoints=32, method="PIC", marker_per_cell=16,
                step_number=8, time_step=0.25, initial_guess=[-0.8, 0.25],
                eta_i={"head": 3.13, "step": 0.1, "tail": 3.23},
                mesh={"rows": 2, "scan": 2})
    r = driver.run(base, output_dir=tmp_path / "picmesh", verbose=False)
    out = r["result"]["eta_i"]["scan_result"]
    assert len(out) == 2
    for o in out:
        assert np.isfinite(o["eigenvalue"]).all(), o


@pytest.mark.slow
def test_sharded_bordered_matches_single_device(tokamak_cfg):
    """method='QRSecant' on the mesh (the distributed bordered-Newton
    update) walks the same trajectory as the single-device sparse backend's
    QRSecant (both route to the bordered update on the banded path)."""
    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    om_ref, _v, n_ref, _ = sparse_eigen.solve(
        p, -0.8 + 0.25j, tol=1e-6, quad=QUAD, block=8, band_deta=10.0,
        method="QRSecant")
    mesh = _mesh(4)
    om, _vec, n, _ = spike.solve(p, -0.8 + 0.25j, mesh, tol=1e-6, quad=QUAD,
                                 block=8, band_deta=10.0, method="QRSecant")
    assert abs(om - om_ref) / abs(om_ref) < 1e-9
    assert n == n_ref


def test_driver_mesh_method_combos(tmp_path, tokamak_cfg):
    """Every "mesh" x iteration_method combo either works or fails with the
    documented error (VERDICT r4 next-round #7)."""
    from emme_tpu import driver

    base = dict(tokamak_cfg, npoints=32, method="eigen",
                iteration_method="QRSecant",
                mesh={"rows": 2}, quad_guard="off")
    # dense + mesh + QRSecant: documented single-device-only error
    with pytest.raises(ValueError, match="single-device"):
        driver.run(dict(base, eigen_backend="dense"),
                   output_dir=tmp_path / "d", verbose=False,
                   checkpoint=False)
    # sparse + mesh + QRSecant: routes to the distributed bordered update
    out = driver.run(dict(base, eigen_backend="sparse", band_block=8,
                          band_deta=10.0),
                     output_dir=tmp_path / "s", verbose=False,
                     checkpoint=False)
    ev = out["result"]["(None)"]["scan_result"][0]["eigenvalue"]
    assert isinstance(ev, list) and np.isfinite(ev).all()


def test_reduced_algebra_hlo_flat():
    """The scan-ified reduced algebra (block-Thomas factor/solve + z-band
    selected inverse, round 5) must trace to an S-INDEPENDENT program:
    jaxpr equation counts identical at S = 8 / 16 / 32, so a pod-scale
    shard count pays the same compile cost as S = 8 (VERDICT r4 weak #4)."""
    import jax

    m2 = 4   # tiny 2m interface width; block shapes don't matter for size

    def algebra(Rsup, Rsub, b):
        S = Rsup.shape[0] + 1
        D, Ebar = spike._bt_factor(Rsup, Rsub, S, m2, Rsup.dtype)
        x = spike._bt_solve(Rsup, Rsub, D, b, S)
        Zd, Zs1, Zb1, Zs2, Zb2 = spike._bt_z_band(Rsup, Rsub, D, Ebar, S)
        return x, Zd, Zs1, Zb1, Zs2, Zb2

    sizes = []
    for S in (8, 16, 32):
        Rsup = jnp.zeros((S - 1, 2, m2, m2), jnp.float32)
        Rsub = jnp.zeros((S - 1, 2, m2, m2), jnp.float32)
        b = jnp.zeros((S, 2, m2, 3), jnp.float32)
        jaxpr = jax.make_jaxpr(algebra)(Rsup, Rsub, b)
        sizes.append(len(jaxpr.jaxpr.eqns))
    assert sizes[0] == sizes[1] == sizes[2], sizes
