"""Time-to-converged-eigenpair across the BASELINE benchmark cases
(tokamak n=1024, stellarator n=1024, tokamak 4x grid n=4096) on the
available accelerator, using the hybrid host-c128 polish so every case
meets the reference iteration_precision regardless of device precision.

Reference wall-clocks on this host's 2-core CPU (tests/goldens/
eigenvalues.json): tokamak n=1024 674.7 s; the stellarator and 4x-grid
cases are not tractable for the reference on this host (extrapolated
O(hours): stel128 already takes 424 s and assembly scales ~n^2).
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

CASES = [
    ("tokamak_n1024", "tokamak.json", 1024, complex(-0.8, 0.25), 4096),
    ("stellarator_n1024", "stellarator.json", 1024, complex(-1.656, 2.49), 4096),
    ("tokamak_n4096_4x", "tokamak.json", 4096, complex(-0.8, 0.25), 8192),
]


def main():
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import eigen

    for name, f, npoints, guess, chunk in CASES:
        with open(REPO / "tests" / "goldens" / "inputs" / f) as fh:
            cfg = json.load(fh)
        cfg["npoints"] = npoints
        p = from_config(cfg, dtype=jnp.float32)
        # warm-up (compilation, persistent-cached)
        eigen.solve(p, guess, chunk=chunk, dtype=jnp.float32, host64=True)
        t0 = time.time()
        om, vec, steps, _ = eigen.solve(p, guess, chunk=chunk,
                                        dtype=jnp.float32, host64=True)
        print(json.dumps({
            "case": name, "omega": [om.real, om.imag], "steps": steps,
            "wall_s": round(time.time() - t0, 2),
        }), flush=True)


if __name__ == "__main__":
    main()
