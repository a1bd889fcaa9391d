"""Smoke run of the main paths on one NVIDIA GPU, in one process.

    python chip_smoke.py               # phases 0-6 on one card
    python chip_smoke.py --four-cards  # the mesh paths on four cards only

Phases (each prints its own lines; any failure ends the run with a
non-zero exit and no result line):

  0  the card: JAX's devices and nvidia-smi's name and power limit
  1  tok1024 eigen solve, f32, through the CLI, against the C++ golden
  2  the same solve in f64, the CLI's default precision
  3  canonical PIC (1024 markers per cell, 180 RK3 steps) through the CLI
  4  tok8192 never-dense sparse solve, f32, against an f64 solve on the card
  5  the fused kappa kernel against the plain XLA chain at real widths
  6  the card-marked tests (pytest -m gpu), in this process

``--four-cards`` runs the dense, SPIKE and PIC mesh paths through the CLI
with ``"mesh": {"rows": 4}``, each beside the same input without a mesh,
and checks the device set the driver's result reports.

The times printed are those of a smoke run (phase 1: one cold and one
warm call; the others: one call, compile included), not a benchmark.
The last line is the result object, printed only when every phase passed.
"""

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent
INPUTS = REPO / "tests" / "goldens" / "inputs"
DEVICE = "gpu"

# tests/goldens/eigenvalues.json
TOK1024 = complex(-0.8323805740805391, 0.2565467084687576)
PIC_TOK1024 = (0.837758, 0.203384)
TOK8192_GUESS = (-0.8405, 0.2529)     # n=4096 continuation seed

# tolerances, with their reasons
TOL_F32 = 1e-4      # the bar the f32 eigen path is held to
TOL_F64 = 1e-6      # the reference's own |d omega| < 1e-6 |omega|
TOL_PIC_OMEGA = 0.05    # statistical: the RNG streams differ from the
TOL_PIC_GAMMA = 0.10    # reference's (benchmarks/bench_pic.py)
# four cards vs one, PIC: the same markers from the same seed, so only the
# psum's f32 summation order differs; far above that rounding, far below
# any change a faulty reduction would make to the fitted omega and gamma
TOL_PIC_MESH = 1e-4
TOL_SPARSE = 1e-4   # f32 vs f64 of the same banded solve: the f32 run stops
                    # at its own rounding floor, held to the f32 bar
# fused kernel vs XLA chain, relative to the largest entry: f32 sums over
# 44 panels x 15 nodes in another order (sqrt(660) * 6e-8 ~ 2e-6 typical)
TOL_KERNEL = 1e-5


def log(*a):
    print(*a, flush=True)


def load_input(name: str, **over) -> dict:
    with open(INPUTS / f"{name}.json") as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def check(name: str, value: float, tol: float):
    ok = value <= tol
    log(f"  {name}: {value:.3e} (tolerance {tol:.0e}) "
        f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(f"{name} {value:.3e} exceeds {tol:.0e}")


def run_cli(cfg: dict, *flags: str, workdir: pathlib.Path) -> tuple:
    """One solve through ``emme_tpu.cli.main`` in this process; returns
    (first result object, seconds)."""
    from emme_tpu import cli

    workdir.mkdir(parents=True, exist_ok=True)
    path = workdir / "input.json"
    path.write_text(json.dumps(cfg))
    t0 = time.perf_counter()
    rc = cli.main([str(path), "-o", str(workdir), "--device", DEVICE, "-q",
                   "--no-checkpoint", *flags])
    dt = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"cli exited {rc}")
    out = json.loads((workdir / "output.json").read_text())
    return out["result"]["(None)"]["scan_result"][0], dt


def cold_warm(cfg: dict, *flags: str, workdir: pathlib.Path) -> dict:
    """Run a CLI solve twice: the first call compiles, the second reuses
    the compiled programs.  Prints both times; returns the warm result."""
    _, t_cold = run_cli(cfg, *flags, workdir=workdir / "cold")
    res, t_warm = run_cli(cfg, *flags, workdir=workdir / "warm")
    log(f"  smoke timing (not a benchmark): first call {t_cold:.2f} s "
        f"(compile ~{t_cold - t_warm:.2f} s), second call {t_warm:.3f} s")
    return res


def timed(cfg: dict, *flags: str, workdir: pathlib.Path) -> dict:
    """One CLI solve, compile included in the time printed."""
    res, dt = run_cli(cfg, *flags, workdir=workdir)
    log(f"  smoke timing (not a benchmark): {dt:.2f} s, compile included")
    return res


def omega_of(res: dict) -> complex:
    ev = res["eigenvalue"]
    if not isinstance(ev, list):
        raise SystemExit(f"solve failed: {res}")
    return complex(ev[0], ev[1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase0_card() -> dict:
    log("phase 0: the card")
    try:    # a child that stays off JAX
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        smi = smi.stdout.strip() or smi.stderr.strip()
    except OSError as e:
        smi = f"not available ({e})"
    import jax

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    log(f"  jax devices: {dev}")
    log(f"  nvidia-smi: {smi}")
    if dev["platform"] != DEVICE:
        raise SystemExit(f"no GPU: JAX runs on {dev['platform']!r}")
    from emme_tpu import accel
    log(f"  compile cache: {accel.enable_compile_cache()}")
    return dev


def phase1_f32(tmp: pathlib.Path):
    from emme_tpu import accel

    log("phase 1: tok1024 eigen, f32, CLI")
    log(f"  Newton loop: {accel.newton_loop('gpu')}; fused kappa kernel: "
        f"{accel.fused_assembly('gpu', 'float32')}")
    res = cold_warm(load_input("tokamak", npoints=1024), "--f32",
                    workdir=tmp / "p1")
    om = omega_of(res)
    log(f"  omega {om}, Newton steps {res['iteration_steps']}")
    check("relative error vs golden tok1024", abs(om - TOK1024) / abs(TOK1024),
          TOL_F32)


def phase2_f64(tmp: pathlib.Path):
    log("phase 2: tok1024 eigen, f64, CLI")
    res = timed(load_input("tokamak", npoints=1024), workdir=tmp / "p2")
    om = omega_of(res)
    log(f"  omega {om}, Newton steps {res['iteration_steps']}")
    check("relative error vs golden tok1024", abs(om - TOK1024) / abs(TOK1024),
          TOL_F64)


def phase3_pic(tmp: pathlib.Path):
    from emme_tpu import accel

    log("phase 3: canonical PIC (1024 x 1024 markers, 180 steps), f32, CLI")
    log(f"  gather take, deposit {accel.pic_deposit('gpu')}")
    res = timed(load_input("tokamak", method="PIC", npoints=1024), "--f32",
                workdir=tmp / "p3")
    om = omega_of(res)
    log(f"  omega {om.real:.6f}, gamma {om.imag:.6f}")
    check("omega relative error vs pic_tok1024",
          abs(om.real - PIC_TOK1024[0]) / PIC_TOK1024[0], TOL_PIC_OMEGA)
    check("gamma relative error vs pic_tok1024",
          abs(om.imag - PIC_TOK1024[1]) / PIC_TOK1024[1], TOL_PIC_GAMMA)


def tok8192_cfg(**over) -> dict:
    cfg = dict(npoints=8192, eigen_backend="sparse", band_deta=10.0,
               initial_guess=list(TOK8192_GUESS))
    cfg.update(over)
    return load_input("tokamak", **cfg)


def phase4_sparse(tmp: pathlib.Path):
    log("phase 4: tok8192 never-dense, f32 vs f64 on the card, CLI")
    res32 = timed(tok8192_cfg(), "--f32", workdir=tmp / "p4")
    om32 = omega_of(res32)
    log(f"  f32 omega {om32}, Newton steps {res32['iteration_steps']}")
    # the f64 reference uses the same tiered panel meshes, so the two runs
    # differ only in arithmetic precision
    res64 = timed(tok8192_cfg(quad_tiered=True), workdir=tmp / "p4f64")
    om64 = omega_of(res64)
    log(f"  f64 omega {om64}, Newton steps {res64['iteration_steps']}")
    check("relative difference f32 vs f64", abs(om32 - om64) / abs(om64),
          TOL_SPARSE)


def kernel_vs_xla(name: str, ms: tuple, omega: complex):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops import kernels, pallas_kappa

    p = from_config(load_input(name, npoints=1024), dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    iu, ju = np.triu_indices(p.npoints, k=1)
    ea, eb = grid.eta[iu], grid.eta[ju]
    om = jnp.asarray(omega, jnp.complex64)
    fused = jax.jit(lambda a, b, o: pallas_kappa.kappa_pairs_fused(
        p, a, b, o, ms=ms))(ea, eb, om)

    @jax.jit
    def plain(a, b, o):
        def chunk(args):
            return kernels.kappa_f_tau(p, args[0], args[1], o, ms=ms)[0]
        n = a.shape[0]
        c = 16384
        pad = -n % c
        a = jnp.pad(a, (0, pad), mode="edge").reshape(-1, c)
        b = jnp.pad(b, (0, pad), mode="edge").reshape(-1, c)
        return tuple(v.reshape(-1)[:n] for v in jax.lax.map(chunk, (a, b)))

    with jax.default_matmul_precision("highest"):
        ref = plain(ea, eb, om)
    for m, got, want in zip(ms, fused, ref):
        got, want = np.asarray(got), np.asarray(want)
        err = np.abs(got - want).max() / np.abs(want).max()
        check(f"{name} {len(iu)} pairs m={m}: max|kernel - xla| / max|xla| "
              f"(f32, xla at precision=highest)", err, TOL_KERNEL)


def phase5_kernel():
    log("phase 5: fused kappa kernel (Pallas, Triton route) vs XLA chain")
    kernel_vs_xla("tokamak", (0,), TOK1024)
    kernel_vs_xla("stellarator", (0, 1, 2), complex(-1.656, 2.490))


def phase6_tests():
    import pytest

    log("phase 6: card-marked tests (pytest -m gpu, in this process)")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      str(REPO / "tests")])
    if rc != 0:
        raise SystemExit(f"card-marked tests failed (pytest exit {rc})")


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def one_vs_four(label: str, cfg: dict, tmp: pathlib.Path) -> tuple:
    """The same input through the CLI without a mesh and with
    ``"mesh": {"rows": 4}``; checks where each ran, from the driver's
    result.  Returns the two result objects."""
    r1, t1 = run_cli(cfg, "--f32", workdir=tmp / f"{label}1")
    r4, t4 = run_cli(dict(cfg, mesh={"rows": 4}), "--f32",
                     workdir=tmp / f"{label}4")
    for n, r, t in ((1, r1, t1), (4, r4, t4)):
        log(f"  {n} card{'s' if n > 1 else ''}: omega {omega_of(r)}, "
            f"steps {r.get('iteration_steps', '-')}, devices "
            f"{r['devices']}, {t:.2f} s compile included")
    if r1["devices"] != [0] or r4["devices"] != [0, 1, 2, 3]:
        raise SystemExit(f"expected devices [0] and [0, 1, 2, 3], got "
                         f"{r1['devices']} and {r4['devices']}")
    return r1, r4


def four_cards(dev: dict, tmp: pathlib.Path, n_dense: int = 1024,
               n_sparse: int = 8192, pic_over: dict | None = None):
    if dev["count"] < 4:
        raise SystemExit(f"--four-cards needs 4 devices, have {dev['count']}")

    log(f"four cards 1: tok{n_dense} f32 dense, rows=4 (sharded assembly), "
        "CLI")
    r1, r4 = one_vs_four("dense", load_input("tokamak", npoints=n_dense),
                         tmp)
    om1, om4 = omega_of(r1), omega_of(r4)
    # two f32 solves, each stopped at the floor of its own assembly order
    check("relative difference 4 cards vs 1", abs(om4 - om1) / abs(om1),
          TOL_F32)

    log(f"four cards 2: tok{n_sparse} f32 sparse, rows=4 (SPIKE Newton), "
        "CLI")
    r1, r4 = one_vs_four("sparse", tok8192_cfg(npoints=n_sparse), tmp)
    om1, om4 = omega_of(r1), omega_of(r4)
    check("relative difference 4 cards vs 1", abs(om4 - om1) / abs(om1),
          TOL_SPARSE)

    cfg = load_input("tokamak", method="PIC", npoints=1024)
    cfg.update(pic_over or {})
    log(f"four cards 3: PIC {cfg['npoints']} x {cfg['marker_per_cell']} "
        f"markers, {cfg['step_number']} steps, rows=4 (psum deposit), CLI")
    r1, r4 = one_vs_four("pic", cfg, tmp)
    w1, w4 = omega_of(r1), omega_of(r4)
    # deterministic: both runs draw the same markers from the same seed, so
    # only the psum's f32 summation order differs from the one-card sum
    check("omega relative difference 4 cards vs 1",
          abs(w4.real - w1.real) / abs(w1.real), TOL_PIC_MESH)
    check("gamma relative difference 4 cards vs 1",
          abs(w4.imag - w1.imag) / abs(w1.imag), TOL_PIC_MESH)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh paths on four cards, each "
                         "beside its one-card run")
    args = ap.parse_args(argv)

    dev = phase0_card()
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        if args.four_cards:
            four_cards(dev, tmp)
        else:
            phase1_f32(tmp)
            phase2_f64(tmp)
            phase3_pic(tmp)
            phase4_sparse(tmp)
    if not args.four_cards:
        phase5_kernel()
        phase6_tests()
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
