"""Batched shift-invert Arnoldi: 16 shifts in one vmapped factorization
(BASELINE config 5; on a multi-host pod the shift axis shards over the
mesh's ``scan`` axis -- tests/test_sparse_arnoldi.py covers that path on
the virtual mesh; here all 16 run on one chip).

Each shift assembles M(sigma), M'(sigma), LU-factors the real embedding,
and runs a 24-step Arnoldi factorization of M^{-1} M'; the Ritz value
closest to each sigma seeds a Newton polish (not timed -- the estimate
quality is the point of the multi-shift mode: mapping several branches of
the dispersion relation in one sweep).
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np


def main():
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import arnoldi

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 128
    p = from_config(cfg, dtype=jnp.float32)

    rng = np.random.default_rng(0)
    sigmas = (-0.8 + 0.25j) + 0.15 * (rng.normal(size=16)
                                      + 1j * rng.normal(size=16))
    t0 = time.time()
    ests = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24,
                                        dtype=jnp.float32)
    warm_compile = time.time() - t0
    t0 = time.time()
    ests = arnoldi.solve_shifts_batched(p, sigmas, m_krylov=24,
                                        dtype=jnp.float32)
    elapsed = time.time() - t0

    golden = complex(-0.7542951557921043, 0.27860070416972454)  # tok128
    near = sorted(abs(e - golden) for e in ests)[:4]
    print(json.dumps({
        "metric": "arnoldi_16shift_tok128",
        "wall_s": round(elapsed, 2),
        "compile_s": round(warm_compile, 2),
        "n_shifts": 16,
        "closest_estimates_err": [round(float(x), 4) for x in near],
    }), flush=True)


if __name__ == "__main__":
    main()
