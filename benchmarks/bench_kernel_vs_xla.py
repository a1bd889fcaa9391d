"""The fused kappa kernel against the plain XLA chain, and the PIC CIC
routes, timed on the default device in one process.

    python benchmarks/bench_kernel_vs_xla.py [--out results.json]

Measurements (f32 throughout; each prints one JSON line):

1. ``kernel_alone``  -- the per-pair kernel values for the full tok1024
   pair list (m=0) and the stel1024 pair list (m=0,1,2): the fused Pallas
   kernel (``ops/pallas_kappa.py``) against the chunked XLA chain the
   solver runs without it (``eigen._pair_values(fused=False)``).
2. ``end_to_end``    -- whole f32 solves with ``fused=True`` / ``False``:
   tok1024 dense, stel1024 dense, tok8192 never-dense (``band_deta`` 10).
3. ``pic_route``     -- the canonical PIC run (1024 markers per cell,
   180 RK3 steps) for each gather/deposit pair.

Each variant is warmed once (compile excluded), then the variants run
interleaved (A B B A ...) so a drift of the card's clock hits both; the
medians are reported with min and max.  The first lines give the card's
name and power limit.  ``--interpret`` runs the kernel in the Pallas
interpreter (a CPU check of the script at small sizes, not a timing).
"""

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np

TOK1024 = complex(-0.8323805740805391, 0.2565467084687576)
STEL1024 = complex(-1.65655594094, 2.49032058254)
TOK8192_GUESS = complex(-0.8405, 0.2529)


def card_name() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except OSError as e:
        return f"not available ({e})"


def load(name: str, **over) -> dict:
    with open(REPO / "tests" / "goldens" / "inputs" / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def stats(ts) -> dict:
    return {"median_s": float(np.median(ts)), "min_s": float(min(ts)),
            "max_s": float(max(ts)), "n": len(ts)}


def interleaved(fns: dict, order: list, reps: int) -> dict:
    """Warm each variant once, then time ``order`` ``reps`` times over;
    ``fns`` map a label to a callable that returns once the device is done.
    Returns {label: (times, last result)}."""
    out = {k: ([], fn()) for k, fn in fns.items()}
    for _ in range(reps):
        for k in order:
            t0 = time.perf_counter()
            res = fns[k]()
            out[k][0].append(time.perf_counter() - t0)
            out[k] = (out[k][0], res)
    return out


def emit(record: dict, log: list):
    log.append(record)
    print(json.dumps(record), flush=True)


def kernel_alone(name, n, ms, omega, reps, interpret, log):
    import jax
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.solvers import eigen

    p = from_config(load(name, npoints=n), dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    ea, eb = grid.eta[iu], grid.eta[ju]
    om = jnp.asarray(omega, jnp.complex64)
    fused = "interpret" if interpret else True
    fk = jax.jit(lambda a, b, o: eigen._pair_values(p, a, b, o, ms, None,
                                                    2048, fused))
    fx = jax.jit(lambda a, b, o: eigen._pair_values(p, a, b, o, ms, None,
                                                    2048, False))
    fns = {"kernel": lambda: jax.block_until_ready(fk(ea, eb, om)),
           "xla": lambda: jax.block_until_ready(fx(ea, eb, om))}
    res = interleaved(fns, ["xla", "kernel", "kernel", "xla"], reps)
    err = max(float(np.abs(np.asarray(g) - np.asarray(w)).max()
                    / np.abs(np.asarray(w)).max())
              for g, w in zip(res["kernel"][1], res["xla"][1]))
    emit({"bench": "kernel_alone", "case": f"{name}{n}", "ms": list(ms),
          "pairs": int(len(iu)), "kernel": stats(res["kernel"][0]),
          "xla": stats(res["xla"][0]),
          "max_rel_diff": err}, log)


def end_to_end(case, reps, interpret, n_dense, n_sparse, log):
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import eigen, sparse_eigen

    fused = "interpret" if interpret else True
    if case.endswith("_sparse"):
        p = from_config(load("tokamak", npoints=n_sparse),
                        dtype=jnp.float32)

        def run(f):
            om, _, n, _ = sparse_eigen.solve(p, TOK8192_GUESS, tol=1e-6,
                                             band_deta=10.0, fused=f)
            return om, n
    else:
        name, guess = (("stellarator", -1.656 + 2.490j)
                       if case.startswith("stel") else
                       ("tokamak", -0.8 + 0.25j))
        p = from_config(load(name, npoints=n_dense), dtype=jnp.float32)

        def run(f):
            om, _, n, _ = eigen.solve(p, guess, tol=1e-6, fused=f)
            return om, n

    fns = {"kernel": lambda: run(fused), "xla": lambda: run(False)}
    res = interleaved(fns, ["xla", "kernel", "kernel", "xla"], reps)
    rec = {"bench": "end_to_end", "case": case}
    for k in ("kernel", "xla"):
        om, n = res[k][1]
        rec[k] = dict(stats(res[k][0]), steps=int(n),
                      omega=[om.real, om.imag])
    emit(rec, log)


def pic_routes(reps, n, mpc, steps, log):
    import jax
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.solvers import pic

    p = from_config(load("tokamak", npoints=n), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    routes = [("take", "segment"), ("take", "matmul"), ("matmul", "matmul")]
    fns = {f"{g}+{d}": (lambda g=g, d=d: np.asarray(pic.run_jitted(
        p, mpc, steps, 0.25, key, gather_method=g, deposit_method=d)[0]))
        for g, d in routes}
    order = list(fns) + list(fns)[::-1]
    res = interleaved(fns, order, max(1, reps // 2))
    for k, (ts, st) in res.items():
        om = pic.calculate_omega(st, 0.25)
        emit({"bench": "pic_route", "route": k, "markers": n * mpc,
              "steps": steps, **stats(ts), "omega": om.real,
              "gamma": om.imag}, log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", help="also write every record to this JSON file")
    ap.add_argument("--interpret", action="store_true",
                    help="run the kernel in the Pallas interpreter")
    ap.add_argument("--n-dense", type=int, default=1024)
    ap.add_argument("--n-sparse", type=int, default=8192)
    ap.add_argument("--pic", type=int, nargs=3, default=(1024, 1024, 180),
                    metavar=("NPOINTS", "MARKERS_PER_CELL", "STEPS"))
    ap.add_argument("--only", choices=["kernel_alone", "end_to_end",
                                       "pic_route"], action="append")
    args = ap.parse_args(argv)

    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    dev = jax.devices()[0]
    log: list = []
    emit({"bench": "device", "platform": dev.platform,
          "kind": dev.device_kind, "nvidia_smi": card_name()}, log)
    if not args.interpret:
        accel.require_kernel_route(dev.platform)
    parts = args.only or ["kernel_alone", "end_to_end", "pic_route"]

    if "kernel_alone" in parts:
        kernel_alone("tokamak", args.n_dense, (0,), TOK1024, args.reps,
                     args.interpret, log)
        kernel_alone("stellarator", args.n_dense, (0, 1, 2), STEL1024,
                     args.reps, args.interpret, log)
    if "end_to_end" in parts:
        for case in (f"tok{args.n_dense}", f"stel{args.n_dense}",
                     f"tok{args.n_sparse}_sparse"):
            end_to_end(case, args.reps, args.interpret, args.n_dense,
                       args.n_sparse, log)
    if "pic_route" in parts:
        pic_routes(args.reps, *args.pic, log)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(log, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
