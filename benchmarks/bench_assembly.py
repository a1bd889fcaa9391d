"""Assembly-path roofline measurement (VERDICT r1 item 4).

Three measurements on the default device, sharing one methodology (a
device->host scalar fetch after a dependent chain):

1. `exp_ceiling`   -- throughput of a bare complex-exponential sweep, the
   dominant transcendental of the kappa integrand: the speed-of-light
   proxy for elementwise-bound work.
2. `kernel_sweep`  -- throughput of the actual kappa_f_tau integrand
   (nodes/s) on a large pair batch: the assembly inner loop without
   materialization.
3. `assembly`      -- full tok1024 dense assembly wall (operator
   materialization included), untiered vs |d_eta|-tiered meshes.

Prints one JSON line per measurement and appends nothing.
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


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
    from emme_tpu.ops import kernels
    from emme_tpu.ops.singularity import singularity_coeff_matrix
    from emme_tpu.solvers import eigen

    def _timed(f):
        t0 = time.time()
        f()
        return time.time() - t0

    def drain(x):
        """Wait for the device work by fetching a scalar reduction."""
        return float(jax.jit(lambda a: jnp.real(a).sum() + jnp.imag(a).sum()
                             if jnp.iscomplexobj(a) else a.sum())(x))

    # ---- 1. complex-exp ceiling ------------------------------------------
    NE = 1 << 22

    @jax.jit
    def exp_chain(x, iters):
        def body(_, v):
            w = jnp.exp(1j * v)
            return jnp.real(w) + jnp.imag(w) * 1e-9  # keep it real + dependent
        return jax.lax.fori_loop(0, iters, body, x)

    x = jnp.linspace(0.1, 1.1, NE, dtype=dtype)
    drain(exp_chain(x, 2)); drain(exp_chain(x, 802))
    t2 = min(_timed(lambda: drain(exp_chain(x, 2))) for _ in range(5))
    t802 = min(_timed(lambda: drain(exp_chain(x, 802))) for _ in range(5))
    exp_per_s = NE * 800 / (t802 - t2)
    print(json.dumps({"bench": "exp_ceiling", "cexp_per_s": exp_per_s,
                      "unit": "complex-exp/s"}), flush=True)

    # ---- 2. kernel integrand sweep ---------------------------------------
    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 1024
    p = from_config(cfg, dtype=dtype)
    grid = Grid.create(p.length, p.npoints, dtype=dtype)
    om = complex(-0.8323805740805391, 0.2565467084687576)

    NP = 16384
    rng_eta = jnp.linspace(-19.0, 19.0, NP).astype(dtype)
    eta_b = rng_eta + jnp.abs(jnp.sin(rng_eta * 13.7)) * 3.0 + 0.05

    preset = kernels.panel_preset(dtype)
    nodes_per_pair = sum(preset.values()) * int(p.integration_start_points)

    def sweep(reps):
        @jax.jit
        def run(ea, eb, re, im):
            omj = (re + 1j * im).astype(
                jnp.complex64 if dtype == jnp.float32 else jnp.complex128)

            def body(k, acc):
                # acc feeds back into eta so the loop body cannot be hoisted
                (v,), _ = kernels.kappa_f_tau(
                    p, ea + 1e-12 * acc, eb, omj, ms=(0,))
                return acc + jnp.real(v).sum()
            return jax.lax.fori_loop(0, reps, body, jnp.asarray(0.0, dtype))
        return run

    f1 = sweep(1)
    f41 = sweep(41)
    a = (jnp.asarray(om.real, dtype), jnp.asarray(om.imag, dtype))
    drain(f1(rng_eta, eta_b, *a)); drain(f41(rng_eta, eta_b, *a))
    ta = min(_timed(lambda: drain(f1(rng_eta, eta_b, *a))) for _ in range(3))
    tb = min(_timed(lambda: drain(f41(rng_eta, eta_b, *a))) for _ in range(3))
    nodes_per_s = NP * nodes_per_pair * 40 / (tb - ta)
    print(json.dumps({"bench": "kernel_sweep", "nodes_per_s": nodes_per_s,
                      "nodes_per_pair": nodes_per_pair,
                      "pairs_per_s": nodes_per_s / nodes_per_pair}),
          flush=True)

    # ---- 3. full assembly, untiered vs tiered ----------------------------
    coeff = singularity_coeff_matrix(p.npoints, dtype=dtype)
    dx = 2.0 * float(p.length) / (p.npoints - 1)
    tiers = kernels.tier_thresholds_ij(dx, p.npoints)
    npairs = p.npoints * (p.npoints - 1) // 2

    for name, t_arg in (("untiered", None), ("tiered", tiers)):
        fn = jax.jit(lambda pp, g, c, re, im, t_arg=t_arg:
                     eigen.assemble_matrix(
                         pp, g, c, (re + 1j * im).astype(
                             jnp.complex64 if dtype == jnp.float32
                             else jnp.complex128),
                         chunk=16384, tiers=t_arg))
        M = fn(p, grid, coeff, *a)
        drain(M)
        best = 1e9
        for _ in range(6):
            t0 = time.time()
            M = fn(p, grid, coeff, *a)
            drain(M)
            best = min(best, time.time() - t0)
        # integrand evals actually issued
        if t_arg is None:
            n_nodes = npairs * nodes_per_pair
        else:
            import numpy as np
            iu, ju = np.triu_indices(p.npoints, k=1)
            dij = ju - iu
            n_nodes = 0
            lo = 0
            for ij_ub, scale in tiers:
                m = ((dij >= lo) & (dij < ij_ub)).sum()
                q = kernels.scaled_quad(None, dtype, scale)
                n_nodes += int(m) * sum(
                    v for k, v in q.items() if k.startswith("n_")) * \
                    int(p.integration_start_points)
                lo = ij_ub
        print(json.dumps({
            "bench": f"assembly_tok1024_{name}", "wall_s": round(best, 3),
            "integrand_nodes": int(n_nodes),
            "achieved_nodes_per_s": n_nodes / best}), flush=True)


if __name__ == "__main__":
    main()
