"""Validate the device eigen path against the native stellarator golden
sequence (n = 128 / 256 / 512 / 1024).

The goldens in tests/goldens/stellarator_sequence.json were generated by the
native CPU engine (reference-equivalent adaptive quadrature, f64) from the
canonical initial guess of /root/reference/input-stellarator-example.json.
This script reruns each grid size with the JAX panel-quadrature path on the
available accelerator (f32 assembly + host complex128 polish via
``host64=True``) from the SAME guess and reports the relative eigenvalue
disagreement -- the grid-sequence tie between the device n=1024 answer and
the reference-exact engine.

Writes/updates STEL_VALIDATION.md at the repo root and prints one JSON line
per case.  Usage:  python benchmarks/bench_stel_sequence.py [n ...]
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

OUT_MD = REPO / "STEL_VALIDATION.md"
OUT_JSON = REPO / "benchmarks" / "results_stel_sequence.json"

HEADER = """# Stellarator grid-sequence validation (device vs native reference engine)

Canonical case: `/root/reference/input-stellarator-example.json` (q=2,
beta_e=0.02 electromagnetic, G-K order 31, guess omega0 = -1.656 + 2.490i).
Goldens: `tests/goldens/stellarator_sequence.json`, generated by the
reference-exact native engine (f64 adaptive quadrature; agreement with the
C++ reference is asserted at 1e-12 in tests/test_native.py).

Each row solves from the SAME canonical initial guess with the device path
(f32 panel-quadrature assembly on device, host complex128 bordered-Newton
polish to |d_omega| < 1e-6 |omega|) and compares the converged eigenvalue.
Note the sequence is NOT monotone in n: the Newton iteration from a fixed
guess selects different mode branches at coarse n (the n=1024 row is the
canonical case; its 3-step convergence shows the guess sits on the tracked
branch there).

| n | golden omega (native, f64) | device omega (f32 + host64 polish) | rel err | steps (golden) | steps (device) | wall s | device |
|---|---|---|---|---|---|---|---|
"""


def main(sizes):
    import jax

    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp

    from emme_tpu import from_config
    from emme_tpu.solvers import eigen

    on_card = accel.current() == "gpu"
    dtype = jnp.float32 if on_card else jnp.float64
    if not on_card:
        jax.config.update("jax_enable_x64", True)

    with open(REPO / "tests" / "goldens" / "inputs" / "stellarator.json") as f:
        base = json.load(f)
    with open(REPO / "tests" / "goldens" / "stellarator_sequence.json") as f:
        goldens = json.load(f)

    results = {}
    if OUT_JSON.exists():
        with open(OUT_JSON) as f:
            results = json.load(f)

    guess = complex(base["initial_guess"][0], base["initial_guess"][1])
    rows = []
    for n in sizes:
        key = f"stel{n}"
        ref = complex(*goldens[key]["omega"])
        if key not in results:
            cfg = dict(base, npoints=n)
            p = from_config(cfg, dtype=dtype)
            t0 = time.time()
            om, _vec, steps, _ = eigen.solve(
                p, guess, tol=float(base["iteration_precision"]),
                host64=True)
            wall = time.time() - t0
            results[key] = {"omega": [om.real, om.imag], "steps": steps,
                            "wall_s": round(wall, 1),
                            "device": jax.devices()[0].device_kind}
            with open(OUT_JSON, "w") as f:
                json.dump(results, f, indent=1)
        r = results[key]
        om = complex(*r["omega"])
        rel = abs(om - ref) / abs(ref)
        print(json.dumps({"case": key, "omega": [om.real, om.imag],
                          "rel_err": rel, "steps": r["steps"],
                          "wall_s": r["wall_s"]}), flush=True)
        rows.append(
            f"| {n} | {ref.real:.12g} {ref.imag:+.12g}i | "
            f"{om.real:.12g} {om.imag:+.12g}i | {rel:.2e} | "
            f"{goldens[key]['steps']} | {r['steps']} | {r['wall_s']} | "
            f"{r.get('device', 'not recorded')} |")

    with open(OUT_MD, "w") as f:
        f.write(HEADER)
        f.write("\n".join(rows) + "\n")
    print(f"wrote {OUT_MD}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [128, 256, 512, 1024])
