"""Worker process for the multi-process jax.distributed smoke test
(tests/test_distributed.py).  Each of the 2 processes owns 4 virtual CPU
devices; the global 8-device ``rows`` mesh spans both processes, so the
SPIKE all_gathers/psums exercise REAL cross-process collectives (the DCN
path of SURVEY 5.8) rather than intra-process device emulation.

Usage: python distributed_worker.py <process_id> <num_processes> <port> <out>
"""
import json
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

if __name__ == "__main__":
    # only when run AS the worker: the test process imports this module for
    # build_op and must keep its own (8-device) XLA_FLAGS
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def build_op(QUAD):
    """Deterministic tok64 banded operator + secant pair, identical on every
    process (plain single-device arrays; the test shards them globally)."""
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops.singularity import singularity_coeff_band
    from emme_tpu.solvers import sparse_eigen as se

    cfg = json.load(open(REPO / "tests" / "goldens" / "inputs"
                         / "tokamak.json"))
    cfg["npoints"] = 64
    p = from_config(cfg)
    grid = Grid.create(p.length, p.npoints)
    bs, h = 2, 4
    cband = singularity_coeff_band(p.npoints, (h + 1) * bs - 1)
    M = se.assemble_bdia(p, grid, cband, -0.8 + 0.25j, h, bs, quad=QUAD)
    M_old = se.assemble_bdia(p, grid, cband, 0.99 * (-0.8 + 0.25j), h, bs,
                             quad=QUAD)
    dM = se.bdia_secant(M, M_old, 0.01 * (-0.8 + 0.25j))
    return M, dM


def global_sharded(mesh, spec, host_array):
    """Identical-per-process host array -> global jax.Array with ``spec``."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: np.asarray(host_array)[idx])


def main():
    pid, nproc, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], sys.argv[4])
    from emme_tpu.parallel import mesh as mesh_mod

    mesh_mod.distributed_init(f"localhost:{port}", num_processes=nproc,
                              process_id=pid)
    devices = jax.devices()
    assert len(devices) == 4 * nproc, devices
    assert jax.process_count() == nproc

    from jax.sharding import PartitionSpec as P
    from emme_tpu.parallel import spike
    from emme_tpu.ops.sparse import BDIAOperator

    mesh = mesh_mod.make_mesh(n_rows=len(devices), devices=devices)
    QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
    M, dM = build_op(QUAD)

    spec = P(None, "rows", None, None, None)
    Mg = BDIAOperator(data=global_sharded(mesh, spec, M.data),
                      offsets=M.offsets, n=M.n, block=M.block)
    dMg = BDIAOperator(data=global_sharded(mesh, spec, dM.data),
                       offsets=dM.offsets, n=dM.n, block=dM.block)

    with mesh:
        # distributed Newton-trace step: per-shard banded LU + Takahashi,
        # cross-process all_gather of interface corners, psum of the trace
        dr, di = jax.jit(lambda a, b: spike.sharded_trace_d_omega(
            BDIAOperator(data=a, offsets=M.offsets, n=M.n, block=M.block),
            BDIAOperator(data=b, offsets=M.offsets, n=M.n, block=M.block),
            mesh))(Mg.data, dMg.data)
        dr, di = float(dr), float(di)

        # distributed solve: M z = f with f row-sharded across processes
        f = np.linspace(-1.0, 1.0, M.n)
        fr = global_sharded(mesh, P("rows"), f)
        fi = global_sharded(mesh, P("rows"), 0.5 * f)
        zr, zi = jax.jit(lambda d, a, b: spike.sharded_solve_vec(
            BDIAOperator(data=d, offsets=M.offsets, n=M.n, block=M.block),
            mesh, a, b))(Mg.data, fr, fi)
        nrm = float(jax.jit(
            lambda a, b: (a * a + b * b).sum())(zr, zi))

    if pid == 0:
        with open(out, "w") as fo:
            json.dump({"dr": dr, "di": di, "solve_norm2": nrm,
                       "process_count": jax.process_count()}, fo)
    print(f"worker {pid}: dr={dr!r} di={di!r} nrm={nrm!r}", flush=True)


if __name__ == "__main__":
    main()
