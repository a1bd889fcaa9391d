"""Weak-scaling harness for the sharded paths (BASELINE target: >=80%
nnz/s efficiency 1 -> N hosts).

Runs the pair-sharded assembly and the marker-sharded PIC step over meshes
of 1, 2, 4, ... devices with FIXED PER-DEVICE WORK and reports the weak
efficiency t(1) / t(N).

On several cards the 'rows' axis rides the interconnect and this measures
true comm/compute overlap.  On the CPU's virtual mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=N) the numbers validate
the collective structure (no sharding-induced blowups, constant per-device
memory), NOT hardware scaling -- set EMME_SCALING_CARDS=1 on a multi-card
host for the real curve.
"""
import json
import os
import sys
import pathlib
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

if __name__ == "__main__" and "XLA_FLAGS" not in os.environ:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np


def main():
    import jax
    # default to the virtual CPU mesh; set EMME_SCALING_CARDS=1 on a
    # multi-card host for the real curve
    if not os.environ.get("EMME_SCALING_CARDS"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops.singularity import singularity_coeff_matrix
    from emme_tpu.parallel import mesh as mesh_mod
    from emme_tpu.parallel import sharded
    from emme_tpu.solvers import pic

    devices = jax.devices()
    sizes = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32
    cdtype = jnp.complex128 if dtype == jnp.float64 else jnp.complex64

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        base = json.load(f)

    results = {}
    # ---- assembly weak scaling: npairs grows ~ linearly with devices by
    # scaling npoints ~ sqrt(N)
    for n_dev in sizes:
        npoints = int(64 * np.sqrt(n_dev) // 2 * 2)
        cfg = dict(base, npoints=npoints)
        p = from_config(cfg, dtype=dtype)
        grid = Grid.create(p.length, p.npoints, dtype=dtype)
        coeff = singularity_coeff_matrix(p.npoints, dtype=dtype)
        mesh = mesh_mod.make_mesh(n_rows=n_dev, n_scan=1,
                                  devices=devices[:n_dev])
        fn = jax.jit(lambda p, g, c: sharded.sharded_assemble(
            p, g, c, jnp.asarray(-0.8 + 0.25j, cdtype), mesh, chunk=2048))
        M = fn(p, grid, coeff)
        jax.block_until_ready(M)
        t0 = time.time()
        for _ in range(3):
            M = fn(p, grid, coeff)
        jax.block_until_ready(M)
        results.setdefault("assembly", {})[n_dev] = (time.time() - t0) / 3

    # ---- PIC weak scaling: markers grow linearly with devices
    for n_dev in sizes:
        cfg = dict(base, npoints=64)
        p = from_config(cfg, dtype=dtype)
        mesh = mesh_mod.make_mesh(n_rows=n_dev, n_scan=1,
                                  devices=devices[:n_dev])
        qn = pic.quasi_neutrality_coef(p, dtype=dtype)
        s0 = pic.init_state(p, 64 * n_dev, jax.random.PRNGKey(0), dtype=dtype)
        fn = jax.jit(lambda s: sharded.pic_sharded_step(p, mesh, qn, s, 0.25))
        s = fn(s0)
        jax.block_until_ready(s.field)
        t0 = time.time()
        for _ in range(5):
            s = fn(s)
        jax.block_until_ready(s.field)
        results.setdefault("pic_step", {})[n_dev] = (time.time() - t0) / 5

    # ---- BDIA SpMV weak scaling (the BASELINE nnz/s metric): fixed
    # row-blocks per device, matrix grows with the mesh; halo exchange by
    # ppermute stripe relay, overlap on/off A/B (VERDICT r1 item 5).
    from emme_tpu.ops import sparse as sparse_mod
    from emme_tpu.parallel.mesh import row_sharding

    bs, nbl_per_dev, halo = 64, 8, 2   # band: offsets -2..2
    rng = np.random.RandomState(0)
    for overlap in (True, False):
        key = f"spmv_overlap_{overlap}"
        for n_dev in sizes:
            nb = nbl_per_dev * n_dev
            n = nb * bs
            offs = tuple(range(-halo, halo + 1))
            data_np = rng.standard_normal(
                (len(offs), nb, 2, bs, bs)).astype(dtype)
            op = sparse_mod.BDIAOperator(
                data=jnp.asarray(data_np), offsets=offs, n=n, block=bs)
            mesh = mesh_mod.make_mesh(n_rows=n_dev, n_scan=1,
                                      devices=devices[:n_dev])
            data, h = sharded.shard_bdia(op, mesh)
            xr = jax.device_put(jnp.asarray(rng.standard_normal(n), dtype),
                                row_sharding(mesh))
            xi = jax.device_put(jnp.asarray(rng.standard_normal(n), dtype),
                                row_sharding(mesh))
            fn = jax.jit(lambda d, a, b: sharded.sharded_bdia_matvec(
                d, offs, h, mesh, a, b, overlap=overlap))
            out = fn(data, xr, xi)
            jax.block_until_ready(out)
            reps = 30
            t0 = time.time()
            for _ in range(reps):
                out = fn(data, *out)
            jax.block_until_ready(out)
            t = (time.time() - t0) / reps
            results.setdefault(key, {})[n_dev] = t
            results.setdefault(key + "_nnz", {})[n_dev] = op.nnz

    for name, times in results.items():
        if name.endswith("_nnz"):
            continue
        t1 = times[sizes[0]]
        for n_dev in sizes:
            eff = t1 / times[n_dev]
            rec = {
                "bench": name, "devices": n_dev,
                "t_per_call_s": round(times[n_dev], 5),
                "weak_efficiency": round(eff, 3),
            }
            nnz = results.get(name + "_nnz", {}).get(n_dev)
            if nnz:
                rec["nnz_per_s"] = round(nnz / times[n_dev] / 1e9, 3)
                rec["nnz_per_s_unit"] = "Gnnz/s"
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
