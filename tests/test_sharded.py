"""Mesh-sharded paths on the 8-device virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from emme_tpu import from_config
from emme_tpu.grid import Grid
from emme_tpu.ops.singularity import singularity_coeff_matrix
from emme_tpu.parallel import mesh as mesh_mod
from emme_tpu.parallel import sharded
from emme_tpu.solvers import eigen, pic


def test_virtual_mesh():
    assert len(jax.devices()) == 8
    m = mesh_mod.make_mesh()
    assert m.shape == {"rows": 8, "scan": 1}


def test_sharded_assembly_matches_single(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    coeff = singularity_coeff_matrix(p.npoints)
    m = mesh_mod.make_mesh()
    om = jnp.complex128(-0.8 + 0.25j)
    M_single = np.asarray(eigen.assemble_matrix(p, grid, coeff, om))
    M_sharded = np.asarray(jax.jit(
        lambda: sharded.sharded_assemble(p, grid, coeff, om, m))())
    assert np.abs(M_sharded - M_single).max() < 1e-12


@pytest.mark.slow
def test_sharded_newton_converges(tokamak_cfg, golden_eigenvalues):
    cfg = dict(tokamak_cfg, npoints=32)
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    coeff = singularity_coeff_matrix(p.npoints)
    m = mesh_mod.make_mesh()

    state = sharded.sharded_init_state(p, grid, coeff,
                                       jnp.complex128(-0.8 + 0.25j), m)
    step = jax.jit(lambda s: sharded.sharded_newton_step(p, grid, coeff, s, m))
    for j in range(p.iteration_step_limit + 1):
        state = step(state)
        if abs(complex(state.d_omega)) < 1e-6 * abs(complex(state.omega)):
            break
    ref = complex(*golden_eigenvalues["tok32"]["omega"])
    assert abs(complex(state.omega) - ref) / abs(ref) < 2e-6


def test_pic_sharded_deposition_matches_single(tokamak_cfg):
    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    m = mesh_mod.make_mesh()
    key = jax.random.PRNGKey(7)
    qn = pic.quasi_neutrality_coef(p)
    s0 = pic.init_state(p, 16, key)   # 1024 markers, divisible by 8

    s_single, _ = pic.rk3_step(p, s0, 0.25, qn)
    s_shard = jax.jit(lambda s: sharded.pic_sharded_step(p, m, qn, s, 0.25))(s0)
    f1 = np.asarray(s_single.field)
    f2 = np.asarray(s_shard.field)
    assert np.abs(f1 - f2).max() < 1e-10 * (np.abs(f1).max() + 1e-30)


def test_pic_sharded_matmul_deposit_under_shard_map(tokamak_cfg):
    """The one-hot matmul deposition (the GPU default) must also work inside
    shard_map with a psum reduction (regression: a zeros-initialized scan
    carry had the wrong varying-manual-axes type)."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    cfg = dict(tokamak_cfg, npoints=64)
    p = from_config(cfg)
    m = mesh_mod.make_mesh()
    n_rows = m.shape["rows"]
    qn = pic.quasi_neutrality_coef(p)
    s0 = pic.init_state(p, 16, jax.random.PRNGKey(7))

    def shard_fn(s):
        reduce = partial(jax.lax.psum, axis_name="rows")
        new_s, _v = pic.rk3_generic(
            s,
            lambda st: pic.put_velocity(p, st),
            lambda st, vel, sub_dt: pic.update(
                p, st, vel, sub_dt, qn, density_reduce=reduce,
                deposit_method="matmul"),
            0.25)
        return new_s

    marker_spec = pic.PICState(
        eta=P("rows"), v_para=P("rows"), v_perp=P("rows"), weight=P("rows"),
        omega_dv=P("rows"), omega_st=P("rows"), p_weight=P("rows"),
        j0=P("rows"), dc_pb=P("rows"), field=P(None))
    s_shard = jax.jit(shard_map(shard_fn, mesh=m, in_specs=(marker_spec,),
                                out_specs=marker_spec))(s0)
    s_single, _ = pic.rk3_step(p, s0, 0.25, qn)
    f1 = np.asarray(s_single.field)
    f2 = np.asarray(s_shard.field)
    assert np.abs(f1 - f2).max() < 1e-10 * (np.abs(f1).max() + 1e-30)


def test_pic_sharded_timed_and_streaming(tmp_path, tokamak_cfg):
    """Mesh PIC keeps the observability surface (VERDICT r4 #8):
    pic_timers and stream_fields work sharded and match the plain sharded
    run's statistics."""
    from emme_tpu import driver
    from emme_tpu.utils.timer import Timer

    base = dict(tokamak_cfg, method="PIC", npoints=32, marker_per_cell=16,
                step_number=4, mesh={"rows": 2})
    out_plain = driver.run(dict(base, stream_fields=False),
                           output_dir=tmp_path / "a", verbose=False,
                           checkpoint=False)
    out_timed = driver.run(dict(base, pic_timers=True, stream_fields=False),
                           output_dir=tmp_path / "b", verbose=False,
                           checkpoint=False)
    out_stream = driver.run(dict(base),   # stream_fields defaults on
                            output_dir=tmp_path / "c", verbose=False,
                            checkpoint=False)
    evs = [o["result"]["(None)"]["scan_result"][0]["eigenvalue"]
           for o in (out_plain, out_timed, out_stream)]
    assert evs[0] == pytest.approx(evs[1], rel=1e-6)
    assert evs[0] == pytest.approx(evs[2], rel=1e-6)
    # the streamed dump exists and holds n_steps fields
    dump = tmp_path / "c" / "eigenMatrics" / "eigenMatrix.bin"
    data = np.fromfile(dump, dtype=np.complex128)
    assert data.size == 4 * 32
    # the timed run recorded the reference's PIC sections
    t = Timer.get_timer()
    assert any("Particle Pushing" in k for k in t._acc)
    assert any("Field Solve" in k for k in t._acc)
