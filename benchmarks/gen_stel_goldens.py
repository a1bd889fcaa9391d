"""Generate stellarator eigenvalue goldens at n = 128/256/512 with the
native CPU-exact engine (reference-equivalent adaptive quadrature, f64).

The reference's own canonical stellarator case is n=1024
(/root/reference/input-stellarator-example.json:1-31), but the repo's round-1
goldens stopped at stel128 with truncated precision and no step count
(VERDICT "what's weak" #1).  This script regenerates stel128 at full
precision and extends the golden sequence to n=256 and n=512 so the device
n=1024 answer can be tied to a grid-convergence sequence.

Writes results incrementally to tests/goldens/stellarator_sequence.json so a
killed run keeps completed entries.  Intended to run in the background:

    nohup python benchmarks/gen_stel_goldens.py [n ...] &
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_enable_x64", True)

OUT = REPO / "tests" / "goldens" / "stellarator_sequence.json"


def main(sizes):
    import jax.numpy as jnp

    from emme_tpu import from_config
    from emme_tpu.solvers import eigen_native

    with open(REPO / "tests" / "goldens" / "inputs" / "stellarator.json") as f:
        base = json.load(f)

    results = {}
    if OUT.exists():
        with open(OUT) as f:
            results = json.load(f)

    guess = complex(base["initial_guess"][0], base["initial_guess"][1])
    for n in sizes:
        key = f"stel{n}"
        if key in results:
            print(f"{key}: already done, skipping", flush=True)
            continue
        cfg = dict(base)
        cfg["npoints"] = n
        p = from_config(cfg, dtype=jnp.float64)
        t0 = time.time()

        def cb(j, omega, d_omega):
            print(f"  {key} step {j}: omega={omega:.12g} "
                  f"|dw|/|w|={abs(d_omega)/abs(omega):.2e} "
                  f"[{time.time()-t0:.0f}s]", flush=True)

        omega, vec, steps, _M = eigen_native.solve(
            p, guess, tol=float(base["iteration_precision"]), callback=cb)
        wall = time.time() - t0
        results[key] = {
            "omega": [omega.real, omega.imag],
            "steps": steps,
            "initial_guess": [guess.real, guess.imag],
            "native_wall_s_2core": round(wall, 1),
        }
        with open(OUT, "w") as f:
            json.dump(results, f, indent=1)
        print(f"{key}: omega={omega!r} steps={steps} wall={wall:.0f}s",
              flush=True)


if __name__ == "__main__":
    sizes = [int(a) for a in sys.argv[1:]] or [128, 256, 512]
    main(sizes)
