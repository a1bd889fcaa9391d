"""Diagnose the stel128/stel256 device-vs-native disagreement seen in
STEL_VALIDATION.md (1.2e-4 / 1.7e-3 rel, vs 4e-6 / 1.3e-5 at n=512/1024).

Two hypotheses, separated here on CPU f64:
  (a) panel-mesh quadrature error (present at f64 too)  -> f64 solve from
      the canonical guess lands at the same offset;
  (b) eigenvalue ill-conditioning amplifying the f32 assembly
      rounding -> condition estimate kappa = sum|v_i v_j| / |v^T M' v|
      (relative-entry-perturbation to d_omega gain) is large at n=128/256
      and small at n=512/1024.
"""
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from emme_tpu import from_config
from emme_tpu.grid import Grid
from emme_tpu.ops.singularity import singularity_coeff_matrix
from emme_tpu.solvers import eigen


def condition_at(cfg, omega_star):
    """kappa: |d_omega| per unit RELATIVE entry perturbation of M."""
    p = from_config(cfg, dtype=jnp.float64)
    grid = Grid.create(p.length, p.npoints)
    coeff = singularity_coeff_matrix(p.npoints)
    om = jnp.complex128(omega_star)
    M = np.asarray(eigen.assemble_matrix(p, grid, coeff, om, chunk=1024))
    dom = 1e-5 * omega_star
    M2 = np.asarray(eigen.assemble_matrix(p, grid, coeff,
                                          jnp.complex128(omega_star + dom),
                                          chunk=1024))
    dM = (M2 - M) / dom
    # null vector by inverse iteration
    import scipy.linalg
    lu = scipy.linalg.lu_factor(M)
    rng = np.random.default_rng(0)
    v = rng.normal(size=M.shape[0]) + 1j * rng.normal(size=M.shape[0])
    for _ in range(4):
        v = scipy.linalg.lu_solve(lu, v)
        v /= np.linalg.norm(v)
    # d_omega = -(v^T dM_pert v)/(v^T M' v); worst-case relative entry
    # perturbation |delta M_ij| <= eps |M_ij| gives
    # |d_omega| <= eps * sum_ij |v_i||M_ij||v_j| / |v^T M' v|
    num = np.abs(v) @ np.abs(M) @ np.abs(v)
    den = abs(v @ (dM @ v))
    resid = np.linalg.norm(M @ v) / np.linalg.norm(M) / np.linalg.norm(v)
    return num / den, resid


def main():
    with open(REPO / "tests" / "goldens" / "inputs" / "stellarator.json") as f:
        base = json.load(f)
    with open(REPO / "tests" / "goldens" / "stellarator_sequence.json") as f:
        gold = json.load(f)

    out = {}
    for n in [128, 256, 512]:
        cfg = dict(base, npoints=n)
        om_star = complex(*gold[f"stel{n}"]["omega"])
        t0 = time.time()
        kappa, resid = condition_at(cfg, om_star)
        out[f"kappa_stel{n}"] = kappa
        print(json.dumps({"case": f"stel{n}", "kappa_rel_entry_to_domega":
                          float(kappa), "null_resid": float(resid),
                          "s": round(time.time() - t0, 1)}), flush=True)

    # f64 panel-quadrature solve from the canonical guess at n=128
    cfg = dict(base, npoints=128)
    p = from_config(cfg, dtype=jnp.float64)
    t0 = time.time()
    om, _v, steps, _ = eigen.solve(p, -1.656 + 2.49j, tol=1e-6, chunk=1024)
    ref = complex(*gold["stel128"]["omega"])
    print(json.dumps({"case": "stel128_f64_dense", "omega": [om.real, om.imag],
                      "rel_err_vs_native": abs(om - ref) / abs(ref),
                      "steps": steps, "s": round(time.time() - t0, 1)}),
          flush=True)


if __name__ == "__main__":
    main()
