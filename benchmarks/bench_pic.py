"""Canonical delta-f PIC benchmark: tokamak npoints=1024 x 1024 markers/cell
(~1.05M markers), 180 RK3 steps, dt=0.25 (reference input-example.json).

The whole time loop runs as ONE jitted ``lax.scan`` on the device (markers
resident in device memory for the full run); wall-clock is measured around
the scan dispatch plus the stats fetch.

Reference baseline: the C++ code on this host (2 hardware threads) runs the
same case in 146.2 s (tests/goldens/eigenvalues.json pic_tok1024).  The
fitted (omega, gamma) is compared statistically -- RNG streams differ
(reference seeds from std::random_device, solver_pic.h:356-359).
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

REF_SECONDS = 146.2
GOLDEN = complex(0.837758, 0.203384)  # (omega, gamma) fitted by the reference


def run_canonical() -> float:
    """Run the canonical PIC case once (after a warm-up) and return the
    wall-clock seconds; asserts the fitted (omega, gamma) statistically
    against the reference golden.  Shared by __main__ and bench.py.  The
    gather and deposit take the platform's defaults (``accel``)."""
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import pic

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 1024
    on_card = accel.current() == "gpu"
    p = from_config(cfg, dtype=jnp.float32 if on_card else
                    jnp.asarray(0.0).dtype)
    run_jit = jax.jit(lambda key: pic.run(
        p, cfg["marker_per_cell"], cfg["step_number"],
        cfg["time_step"], key=key)[0])
    run = lambda key: np.asarray(run_jit(key))

    print("warm-up (compilation)...", file=sys.stderr, flush=True)
    run(jax.random.PRNGKey(0))

    t0 = time.time()
    stats = run(jax.random.PRNGKey(1))
    elapsed = time.time() - t0

    om = pic.calculate_omega(stats, cfg["time_step"])
    print(f"fitted omega={om.real:.4f} gamma={om.imag:.4f} "
          f"(reference {GOLDEN.real:.4f}, {GOLDEN.imag:.4f})",
          file=sys.stderr, flush=True)
    assert abs(om.real - GOLDEN.real) / abs(GOLDEN.real) < 0.05
    assert abs(om.imag - GOLDEN.imag) / abs(GOLDEN.imag) < 0.10
    return elapsed


def main():
    elapsed = run_canonical()
    print(json.dumps({
        "metric": "pic_tokamak_1024x1024_180steps",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(REF_SECONDS / elapsed, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
