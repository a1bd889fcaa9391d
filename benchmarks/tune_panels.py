"""Panel-mesh auto-tuner (VERDICT r4 next-round #3).

Searches the minimal (n_shoulder, n_osc, n_tail) per |d_eta| tier subject to
the REFERENCE acceptance criterion err <= max(integration_accuracy,
integration_precision * |I|) (functions.h:237-247) -- the same criterion the
runtime quadrature_guard enforces -- measured as the DIRECT deviation from
the f64 dense mesh (40/144/16, the golden-grade reference the tier table was
originally validated on) with a 2x safety margin.

Envelope: the canonical tokamak (ES, acc=prec=1e-6 -- the binding case) and
stellarator (EM, m=0,1,2 moments, acc=1e-2/prec=1e-5) cases, each at the
initial guess, the converged eigenvalue, and a mid-walk omega; pairs drawn
from the actual n=1024 grids per tier's |d_eta| range.

Run on CPU f64 (the truncation error is what is being measured; the f32
rounding floor sits below the tuned margin).  Output: a per-tier table of
passing candidates by cost; the chosen presets land in ops/kernels.py with
the measured margins recorded here.
"""
import itertools
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

import emme_tpu
from emme_tpu.grid import Grid
from emme_tpu.ops import kernels

REF_QUAD = {"n_shoulder": 40, "n_osc": 144, "n_tail": 16}
N_PAIRS = 768
RNG = np.random.default_rng(0)

# tier |d_eta| ranges (kernels.TIER_TABLE boundaries) + a candidate 4th tier
TIERS = [(0.0, 0.6), (0.6, 8.0), (8.0, 16.0), (16.0, 40.0)]

CANDIDATES = sorted(
    itertools.product((2, 3, 4, 6, 8), (4, 6, 8, 12, 16, 24, 32),
                      (1, 2, 3, 4)),
    key=lambda c: sum(c))

CASES = []


def _load(name, npoints, omegas):
    cfg = json.load(open(REPO / "tests/goldens/inputs" / name))
    cfg["npoints"] = npoints
    p = emme_tpu.from_config(cfg)
    CASES.append((name.split(".")[0], p, omegas,
                  float(p.integration_accuracy),
                  float(p.integration_precision)))


_load("tokamak.json", 1024,
      [-0.8 + 0.25j, -0.8324 + 0.2565j, -0.95 + 0.31j])
_load("stellarator.json", 1024,
      [-1.656 + 2.49j, -1.6566 + 2.4903j, -1.5 + 2.2j])


def sample_pairs(p, lo, hi, n):
    g = Grid.create(p.length, p.npoints)
    eta = np.asarray(g.eta)
    dx = float(g.dx)
    i = RNG.integers(0, p.npoints - 1, size=4 * n)
    dij_lo = max(1, int(np.ceil(lo / dx)))
    dij_hi = max(dij_lo + 1, int(np.floor(hi / dx)))
    d = RNG.integers(dij_lo, dij_hi + 1, size=4 * n)
    j = i + d
    ok = j < p.npoints
    i, j = i[ok][:n], j[ok][:n]
    return jnp.asarray(eta[i]), jnp.asarray(eta[j])


from functools import partial


@partial(jax.jit, static_argnums=(4,))
def _eval(p, ea, eb, om, quad_tuple):
    quad = dict(quad_tuple)
    ms = (0, 1, 2) if p.electromagnetic else (0,)
    vals, _ = kernels.kappa_f_tau(p, ea, eb, om, ms=ms, quad=quad)
    return vals


def run():
    chosen = []
    for t_idx, (lo, hi) in enumerate(TIERS):
        worst_pass = {}
        for cand in CANDIDATES:
            cost = sum(cand)
            ok_all = True
            margin = 0.0
            for name, p, omegas, acc, prec in CASES:
                if hi > 2 * float(p.length):
                    continue
                ea, eb = sample_pairs(p, lo, min(hi, 2 * float(p.length)),
                                      N_PAIRS)
                for om in omegas:
                    ref = _eval(p, ea, eb, om,
                                tuple(sorted(REF_QUAD.items())))
                    got = _eval(p, ea, eb, om, tuple(sorted(
                        {"n_shoulder": cand[0], "n_osc": cand[1],
                         "n_tail": cand[2]}.items())))
                    for r, g in zip(ref, got):
                        r = np.asarray(r)
                        g = np.asarray(g)
                        thresh = np.maximum(acc, prec * np.abs(r))
                        dev = np.abs(g - r)
                        m = float((dev / thresh).max())
                        margin = max(margin, m)
                        if m > 0.5:     # 2x safety margin
                            ok_all = False
                    if not ok_all:
                        break
                if not ok_all:
                    break
            if ok_all:
                worst_pass[cand] = margin
                print(f"tier {t_idx} [{lo},{hi}): PASS {cand} "
                      f"cost {cost} margin {margin:.3f}", flush=True)
                chosen.append((t_idx, cand, margin))
                break   # CANDIDATES sorted by cost: first pass = minimal
            else:
                print(f"tier {t_idx} [{lo},{hi}): fail {cand} "
                      f"(margin {margin:.1f})", flush=True)
    print("\nchosen:", chosen)


if __name__ == "__main__":
    run()
