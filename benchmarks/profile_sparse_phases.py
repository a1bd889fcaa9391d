"""Phase profile of the sparse (banded) eigensolve at large n on the device:
assembly vs banded LU vs Takahashi selected inverse vs banded solve.

Each phase is timed as a dependent chain inside one jit (traced rep count),
differencing two chain lengths so dispatch and sync costs cancel.
Usage: python benchmarks/profile_sparse_phases.py [n] [band_deta]
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np


def main(n=8192, band_deta=10.0):
    import jax
    import jax.numpy as jnp
    from emme_tpu import accel
    accel.enable_compile_cache()

    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops import banded, kernels
    from emme_tpu.solvers import sparse_eigen as se

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = n
    on_card = accel.current() == "gpu"
    dtype = jnp.float32 if on_card else jnp.float64
    p = from_config(cfg, dtype=dtype)
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    block = se.pick_block(n)
    h = se.band_halfwidth(p, grid, block, band_deta)
    nb = n // block
    print(f"n={n} block={block} h={h} nb={nb} chain={nb} steps",
          flush=True)
    w_el = (h + 1) * block - 1
    coeff_band = se.singularity_coeff_band(n, w_el, dtype=dtype)
    tiers = kernels.tier_thresholds_ij(2.0 * float(p.length) / (n - 1), n) \
        if dtype == jnp.float32 else None
    fused = accel.fused_assembly(accel.current(), dtype)

    assemble = se._assemble_jit(h, block, None, 16384, dtype, tiers, fused)

    t0 = time.time()
    M = assemble(p, grid, coeff_band, jnp.asarray(-0.8, dtype),
                 jnp.asarray(0.25, dtype))
    jax.block_until_ready(M.data)
    print(f"assembly compile+run: {time.time()-t0:.2f}s", flush=True)

    def timed(label, fn, *args, reps=3):
        @jax.jit
        def chain(r, *a):
            def body(_, c):
                return fn(*a, c)
            return jax.lax.fori_loop(0, r, body, jnp.zeros((), dtype))
        float(chain(1, *args))
        t0 = time.time(); float(chain(1, *args)); t1 = time.time() - t0
        t0 = time.time(); float(chain(1 + reps, *args)); t2 = time.time() - t0
        per = (t2 - t1) / reps
        print(f"{label:34s} {per*1e3:10.1f} ms", flush=True)
        return per

    # assembly (re-run, perturbed omega so nothing hoists)
    def do_assemble(c):
        M2 = se.assemble_bdia(p, grid, coeff_band,
                              (-0.8 + c) + 0.25j, h, block, None, 16384,
                              tiers, fused)
        return M2.data[0, 0, 0, 0, 0] * 1e-20 + c * 0

    t_asm = timed("assembly", lambda c: do_assemble(c), reps=2)

    def do_lu(data, c):
        M2 = se.BDIAOperator(data=data + c * 1e-30, offsets=M.offsets,
                             n=M.n, block=M.block)
        lu = banded.banded_lu(M2)
        return lu.invD[0, 0, 0, 0] * 1e-20 + c * 0

    t_lu = timed("banded_lu", do_lu, M.data, reps=2)

    def do_tak(data, c):
        M2 = se.BDIAOperator(data=data + c * 1e-30, offsets=M.offsets,
                             n=M.n, block=M.block)
        lu = banded.banded_lu(M2)
        Zu = banded.banded_selected_inverse(lu)
        tr_r, tr_i = banded.banded_trace_product(Zu, M2)
        return tr_r * 1e-20 + c * 0

    t_tak = timed("lu + takahashi + trace", do_tak, M.data, reps=2)

    lu = jax.jit(banded.banded_lu)(M)
    jax.block_until_ready(lu.W)

    def do_solve(W, invD, c):
        lu2 = banded.BandedLU(W=W + c * 1e-30, invD=invD, n=M.n,
                              block=M.block, h=h)
        xr = jnp.ones((n,), dtype)
        zr, zi = banded.banded_solve(lu2, xr, xr * 0.5)
        return zr[0] * 1e-20 + c * 0

    t_sol = timed("banded_solve (1 rhs)", do_solve, lu.W, lu.invD,
                  reps=3)

    print(json.dumps({"n": n, "h": h, "block": block,
                      "assembly_ms": round(t_asm * 1e3, 1),
                      "lu_ms": round(t_lu * 1e3, 1),
                      "lu_takahashi_trace_ms": round(t_tak * 1e3, 1),
                      "solve_ms": round(t_sol * 1e3, 1)}), flush=True)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    bd = float(sys.argv[2]) if len(sys.argv) > 2 else 10.0
    main(n, bd)
