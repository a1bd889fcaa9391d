"""BASELINE config 4: eigen-operator apply interleaved with PIC particle
deposition (the "PIC-coupled variant" row of BASELINE.md).

Each coupled step runs, inside one fused jit:
  1. one BDIA SpMV of the assembled kernel-integral operator applied to the
     current field (the eigen-path operator apply, batched einsums), and
  2. one delta-f PIC RK3 step -- marker push (gather) + CIC deposition
     (one-hot matmul / segment-sum) + quasi-neutrality solve -- whose field
     is REPLACED by the normalized SpMV output, coupling the two workloads'
     dataflow (the PIC gather reads what the SpMV wrote).

This is the interleaving stress the BASELINE row asks for: the SpMV and
the deposition contractions alternating with elementwise marker arithmetic
in one program, markers resident in device memory.  Prints one JSON line
with coupled steps/s.
"""

import json
import pathlib
from functools import partial
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_STEPS = 60


def main():
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp

    on_card = accel.current() == "gpu"
    dtype = jnp.float32 if on_card else jnp.float64
    if not on_card:
        jax.config.update("jax_enable_x64", True)

    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops.singularity import singularity_coeff_band
    from emme_tpu.ops.sparse import bdia_matvec
    from emme_tpu.solvers import pic, sparse_eigen

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 1024
    mpc = 256
    p = from_config(cfg, dtype=dtype)
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    block = sparse_eigen.pick_block(p.npoints)
    h = sparse_eigen.band_halfwidth(p, grid, block, 10.0)
    w_el = (h + 1) * block - 1
    cband = singularity_coeff_band(p.npoints, w_el, dtype=dtype)
    dxf = 2.0 * float(p.length) / (p.npoints - 1)
    tiers = None
    if dtype == jnp.float32:
        from emme_tpu.ops import kernels
        tiers = kernels.tier_thresholds_ij(dxf, p.npoints)
    cdtype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
    M = jax.jit(lambda re, im: sparse_eigen.assemble_bdia(
        p, grid, cband, (re + 1j * im).astype(cdtype), h, block,
        tiers=tiers))(jnp.asarray(-0.832, dtype), jnp.asarray(0.257, dtype))

    # jit the setup (one compiled program instead of eager dispatches)
    qn = jax.jit(lambda: pic.quasi_neutrality_coef(p, dtype=dtype))()
    s0 = jax.jit(lambda k: pic.init_state(p, mpc, k, dtype=dtype))(
        jax.random.PRNGKey(0))

    @partial(jax.jit, static_argnums=2)
    def coupled(M, s, n_steps):
        def body(s, _):
            # eigen-operator apply on the live field (real planes)
            fr, fi = bdia_matvec(M, jnp.real(s.field).astype(dtype),
                                 jnp.imag(s.field).astype(dtype))
            nrm = jnp.sqrt(jnp.sum(fr * fr + fi * fi)) + 1e-30
            s = jax.tree_util.tree_map(lambda x: x, s)
            s = pic.PICState(eta=s.eta, v_para=s.v_para, v_perp=s.v_perp,
                             weight=s.weight, omega_dv=s.omega_dv,
                             omega_st=s.omega_st, p_weight=s.p_weight,
                             j0=s.j0, dc_pb=s.dc_pb,
                             field=(fr + 1j * fi) / nrm)
            s, _v = pic.rk3_step(p, s, 0.25, qn)
            return s, pic.field_stats(s.field)
        s, stats = jax.lax.scan(body, s, None, length=n_steps)
        return stats

    import numpy as np
    np.asarray(coupled(M, s0, N_STEPS))  # compile + warm
    t0 = time.time()
    stats = np.asarray(coupled(M, s0, N_STEPS))
    wall = time.time() - t0
    assert np.isfinite(stats).all()
    print(json.dumps({
        "metric": "coupled_spmv_plus_pic_step",
        "n": p.npoints, "markers": p.npoints * mpc,
        "nnz": int(M.nnz), "steps": N_STEPS,
        "value": round(wall / N_STEPS * 1e3, 3), "unit": "ms/step",
        "steps_per_s": round(N_STEPS / wall, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
