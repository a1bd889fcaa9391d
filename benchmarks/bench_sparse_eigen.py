"""Direct-to-sparse memory/scale proof (VERDICT r1 item 2).

Runs the banded end-to-end eigensolve (direct-to-BDIA assembly + selected-
inversion TraceSecant + banded nullspace; the dense operator never exists)
at n = 1024 / 2048 / 4096 / 8192 on the available accelerator, and the dense
path beside it where it still fits, recording:

  * converged eigenvalue (+ cross-check vs the dense path / golden at
    n = 1024),
  * wall-clock to the converged eigenpair,
  * operator storage: BDIA band bytes vs the n^2 dense matrix,
  * live-operator SpMV nnz/s (the BASELINE metric, measured on the final
    operator of the solve).

band_deta: 10.0 here (validated against the n=1024 dense golden below the
1e-6 criterion; the default 20.0 is the conservative choice -- at L = 20 it
keeps 75% of pairs, 10.0 keeps ~44%).

Writes benchmarks/results_sparse_eigen.json incrementally and prints one
JSON line per case.  Usage: python benchmarks/bench_sparse_eigen.py [n ...]
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT = REPO / "benchmarks" / "results_sparse_eigen.json"
BAND_DETA = 10.0


def main(sizes):
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    on_card = accel.current() == "gpu"
    dtype = jnp.float32 if on_card else jnp.float64
    if not on_card:
        jax.config.update("jax_enable_x64", True)

    from emme_tpu import from_config
    from emme_tpu.solvers import eigen, sparse_eigen

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        base = json.load(f)
    with open(REPO / "tests" / "goldens" / "eigenvalues.json") as f:
        gold = json.load(f)

    results = {}
    if OUT.exists():
        with open(OUT) as f:
            results = json.load(f)

    guess = complex(-0.8, 0.25)

    # VERDICT item 1 "done" criterion: the sparse backend reproduces the
    # tok1024 golden to 1e-6 without materializing the dense operator
    # (full kept band at this L, host complex128 polish)
    if "tok1024_banddeta20_host64" not in results and 1024 in sizes:
        p = from_config(dict(base, npoints=1024), dtype=dtype)
        sparse_eigen.solve(p, guess, tol=1e-6, band_deta=20.0, host64=True)
        stats = {}
        t0 = time.time()
        om, _v, steps, _ = sparse_eigen.solve(p, guess, tol=1e-6,
                                              band_deta=20.0, host64=True,
                                              stats=stats)
        ref = complex(*gold["tok1024"]["omega"])
        results["tok1024_banddeta20_host64"] = {
            "omega": [om.real, om.imag], "steps": steps,
            "wall_s": round(time.time() - t0, 2),
            "rel_err_vs_reference": abs(om - ref) / abs(ref),
            "nnz": int(stats["nnz"]),
            "spmv_gnnz_per_s": round(stats["spmv_nnz_per_s"] / 1e9, 3),
        }
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
    if "tok1024_banddeta20_host64" in results:
        print(json.dumps({"case": "tok1024_banddeta20_host64",
                          **results["tok1024_banddeta20_host64"]}),
              flush=True)

    prev_omega = None
    for n in sizes:
        key = f"tok{n}"
        if key not in results:
            cfg = dict(base, npoints=n)
            p = from_config(cfg, dtype=dtype)
            # eigenvalue continuation across grid sizes: the mode converges
            # with n, so the previous size's answer is the best seed
            g = prev_omega if prev_omega is not None else guess
            stats = {}
            # warm-up at this shape WITH stats (compiles the solve and the
            # SpMV-rate chain; persistently cached) -- the timed run then
            # measures pure solve wall
            sparse_eigen.solve(p, g, tol=1e-5, band_deta=BAND_DETA,
                               stats=stats)
            t0 = time.time()
            om, _vec, steps, state = sparse_eigen.solve(
                p, g, tol=1e-5, band_deta=BAND_DETA)
            wall = time.time() - t0
            rec = {
                "omega": [om.real, om.imag], "steps": steps,
                "wall_s": round(wall, 2),
                "guess": [complex(g).real, complex(g).imag],
                "band_deta": BAND_DETA,
                "nnz": int(stats["nnz"]),
                "band_bytes": int(state.M.data.size * state.M.data.dtype.itemsize),
                "dense_bytes": int(n * n * 8),
                "band_fraction": stats["band_fraction"],
                "spmv_gnnz_per_s": round(stats["spmv_nnz_per_s"] / 1e9, 3),
                "h": stats["h"], "block": stats["block"],
                "backend": jax.default_backend(),
            }
            # dense-path comparison where the dense matrix still fits
            if n <= 4096:
                eigen.solve(p, g, tol=1e-5, chunk=16384)  # warm-up
                t0 = time.time()
                om_d, _v, steps_d, _ = eigen.solve(p, g, tol=1e-5,
                                                   chunk=16384)
                rec["dense_wall_s"] = round(time.time() - t0, 2)
                rec["dense_omega"] = [om_d.real, om_d.imag]
                rec["sparse_vs_dense_rel"] = abs(om - om_d) / abs(om_d)
            if key in gold:
                ref = complex(*gold[key]["omega"])
                rec["rel_err_vs_reference"] = abs(om - ref) / abs(ref)
            results[key] = rec
            with open(OUT, "w") as f:
                json.dump(results, f, indent=1)
        prev_omega = complex(*results[key]["omega"])
        print(json.dumps({"case": key, **results[key]}), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [1024, 2048, 4096, 8192])
