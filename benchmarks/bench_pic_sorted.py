"""A/B benchmark: full-width one-hot CIC (``pic.run``) vs the sorted-window
marker path (``pic.run_sorted``) at the canonical tokamak PIC case and at
scaled-up grids where the window win grows.

The sorted path's one-hot matmuls span a W-cell window instead of all nf
cells (nf/W fewer flops, identical arithmetic); see pic.py's sorted-window
section.
Prints one JSON line per case with both times, the speedup, the fitted
(omega, gamma) of each, and the sorted path's violation count (must be 0).
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np


def bench_case(npoints, mpc, n_steps, dt, window, resort_every, repeats=3):
    import jax
    import jax.numpy as jnp
    from emme_tpu import accel, from_config
    from emme_tpu.solvers import pic

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = npoints
    on_card = accel.current() == "gpu"
    p = from_config(cfg, dtype=jnp.float32 if on_card else
                    jnp.asarray(0.0).dtype)

    run = jax.jit(lambda key: pic.run(p, mpc, n_steps, dt, key=key)[0])
    np.asarray(run(jax.random.PRNGKey(0)))          # warm
    base = []
    for r in range(repeats):
        t0 = time.time()
        stats_b = np.asarray(run(jax.random.PRNGKey(1)))
        base.append(time.time() - t0)

    # sorted path (run_sorted jits internally)
    stats_s, _s, viols = pic.run_sorted(
        p, mpc, n_steps, dt, key=jax.random.PRNGKey(0),
        resort_every=resort_every, window=window)     # warm
    srt = []
    for r in range(repeats):
        t0 = time.time()
        stats_s, _s, viols = pic.run_sorted(
            p, mpc, n_steps, dt, key=jax.random.PRNGKey(1),
            resort_every=resort_every, window=window)
        stats_s = np.asarray(stats_s)
        srt.append(time.time() - t0)

    om_b = pic.calculate_omega(stats_b, dt)
    om_s = pic.calculate_omega(stats_s, dt)
    tb, ts = float(np.median(base)), float(np.median(srt))
    out = {
        "case": f"n{npoints}_mpc{mpc}_steps{n_steps}",
        "baseline_s": round(tb, 3),
        "sorted_s": round(ts, 3),
        "speedup": round(tb / ts, 2),
        "violations": int(viols),
        "omega_base": [round(om_b.real, 4), round(om_b.imag, 4)],
        "omega_sorted": [round(om_s.real, 4), round(om_s.imag, 4)],
        "base_runs": [round(x, 3) for x in base],
        "sorted_runs": [round(x, 3) for x in srt],
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    cases = [
        # canonical: 1024 cells x 1024 mpc, 180 steps
        dict(npoints=1024, mpc=1024, n_steps=180, dt=0.25,
             window=256, resort_every=30),
        # larger grid, same marker total: window win grows with nf/W
        dict(npoints=4096, mpc=256, n_steps=180, dt=0.25,
             window=256, resort_every=30),
    ]
    for c in cases:
        bench_case(**c)


if __name__ == "__main__":
    main()
