"""Benchmark: time-to-converged-eigenpair, canonical tokamak case (n=1024).

Runs the full Newton-trace-secant eigensolve (init + iterations to the
reference convergence criterion + nullspace extraction) on the default
device (GPU f32/c64; CPU f64) and reports wall-clock excluding
one-time compilation (the persistent compile cache under .jax_cache makes
compiles one-time per machine).

Prints ONE JSON line:
  {"metric": ..., "value": seconds, "unit": "s", "vs_baseline": speedup}

Baseline: the C++ reference (2 hardware threads on this host) measured on the
same input -- see tests/goldens/eigenvalues.json: solve wall ~718 s.
"""

import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent
sys.path.insert(0, str(REPO))

# Reference C++ wall-clock for the same solve on a 2-core CPU host, measured
# via .refbuild/emme_ref on golden_tok1024 (eigen method, 5 Newton steps +
# SVD): All=674.72s (initial 175.2, Iteration 485.1, SVD 12.0).
REF_SECONDS = 674.7
GOLDEN = complex(-0.83238057408053912, 0.2565467084687576)


def main():
    import jax
    from emme_tpu import accel
    accel.enable_compile_cache()
    import jax.numpy as jnp

    on_card = accel.current() == "gpu"
    dtype = jnp.float32 if on_card else jnp.float64
    if not on_card:
        jax.config.update("jax_enable_x64", True)

    from emme_tpu import from_config
    from emme_tpu.solvers import eigen
    from emme_tpu.utils.transfer import fetch

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 1024
    p = from_config(cfg, dtype=dtype)

    chunk = 16384
    # Warm-up solves trigger all compilation (cached persistently) for BOTH
    # timed paths (the host64 variant compiles its own traced loop).
    print("warm-up (compilation)...", file=sys.stderr, flush=True)
    eigen.solve(p, -0.8 + 0.25j, tol=1e-5, chunk=chunk)
    eigen.solve(p, -0.8 + 0.25j, tol=1e-6, chunk=chunk, host64=True)

    # Timed: full solve = init (2 assemblies) + iterations + nullspace.
    # (f32 solves auto-enable the |d_eta|-tiered panel meshes.)
    t0 = time.time()
    om, vec, nsteps, _ = eigen.solve(p, -0.8 + 0.25j, tol=1e-5, chunk=chunk)
    elapsed = time.time() - t0

    rel_err = abs(om - GOLDEN) / abs(GOLDEN)
    print(f"eigenvalue {om} steps {nsteps} rel_err_vs_reference {rel_err:.3g}",
          file=sys.stderr, flush=True)
    # the f32 fused+tiered device loop converges well inside the f32 bar
    assert rel_err < 1e-4, f"accuracy regression: {rel_err}"

    # secondary: the reference's own 1e-6 criterion via the hybrid polish
    # (device f32 assembly + host complex128 bordered Newton)
    t0 = time.time()
    om64, _v, nsteps64, _ = eigen.solve(p, -0.8 + 0.25j, tol=1e-6,
                                        chunk=chunk, host64=True)
    elapsed64 = time.time() - t0
    rel_err64 = abs(om64 - GOLDEN) / abs(GOLDEN)
    print(f"host64 tol=1e-6: {om64} steps {nsteps64} rel_err "
          f"{rel_err64:.3g} in {elapsed64:.2f}s", file=sys.stderr, flush=True)

    # secondary: canonical stellarator case (EM dim 2048, host64 polish;
    # golden stellarator_sequence.json n=1024, agreement 1.3e-5)
    stel_seconds = None
    stel_err = None
    try:
        if not on_card:
            raise RuntimeError("stel1024 secondary is GPU-only (a dense f64 "
                               "EM solve would take hours on this CPU)")
        with open(REPO / "tests" / "goldens" / "inputs"
                  / "stellarator.json") as f:
            scfg = json.load(f)
        scfg["npoints"] = 1024
        sp = from_config(scfg, dtype=dtype)
        STEL_GOLDEN = complex(-1.65655594094, 2.49032058254)
        eigen.solve(sp, -1.656 + 2.490j, tol=1e-6, chunk=chunk,
                    host64=on_card)  # warm
        t0 = time.time()
        som, _sv, _sn, _ = eigen.solve(sp, -1.656 + 2.490j, tol=1e-6,
                                       chunk=chunk, host64=on_card)
        stel_seconds = time.time() - t0
        stel_err = abs(som - STEL_GOLDEN) / abs(STEL_GOLDEN)
        print(f"stel1024: {som} in {stel_seconds:.2f}s rel_err "
              f"{stel_err:.3g}", file=sys.stderr, flush=True)
        assert stel_err < 2e-4, f"stellarator regression: {stel_err}"
    except Exception as e:  # secondary cases must not sink the headline
        print(f"stel bench skipped: {e}", file=sys.stderr, flush=True)

    # secondary: canonical PIC case (1024x1024 markers, 180 steps;
    # goldens pic_tok1024, reference 146.2 s on the 2-core host)
    pic_seconds = None
    try:
        from benchmarks.bench_pic import run_canonical
        pic_seconds = run_canonical()
    except Exception as e:  # PIC bench must not sink the headline metric
        print(f"pic bench skipped: {e}", file=sys.stderr, flush=True)

    # secondary: largest never-dense banded eigensolve (n=8192, 30 M nnz;
    # the BASELINE scaling axis)
    sp8192_seconds = None
    try:
        if not on_card:
            raise RuntimeError("tok8192 sparse secondary is GPU-only")
        from emme_tpu.solvers import sparse_eigen
        cfg8 = dict(cfg, npoints=8192)
        p8 = from_config(cfg8, dtype=dtype)
        guess8 = complex(-0.8405, 0.2529)   # n=4096 continuation seed
        sparse_eigen.solve(p8, guess8, tol=1e-5, band_deta=10.0)  # warm
        t0 = time.time()
        om8, _v8, _s8, _ = sparse_eigen.solve(p8, guess8, tol=1e-5,
                                              band_deta=10.0)
        sp8192_seconds = time.time() - t0
        print(f"tok8192 sparse: {om8} in {sp8192_seconds:.2f}s",
              file=sys.stderr, flush=True)
        # against the f64 solve of the same case (tiered panel meshes,
        # band_deta 10) on an H100: chip_smoke.py phase 4
        ref8 = complex(-0.8417840951279627, 0.25225266594890466)
        assert abs(om8 - ref8) / abs(ref8) < 1e-4
    except Exception as e:
        print(f"tok8192 bench skipped: {e}", file=sys.stderr, flush=True)

    out = {
        "metric": "time_to_converged_eigenpair_tokamak_n1024",
        "value": round(elapsed, 3),
        "unit": "s",
        "vs_baseline": round(REF_SECONDS / elapsed, 2),
        "tol1e6_host64_s": round(elapsed64, 3),
        "tol1e6_rel_err": float(f"{rel_err64:.3g}"),
    }
    if stel_seconds is not None:
        out["stel1024_host64_s"] = round(stel_seconds, 3)
        out["stel1024_rel_err"] = float(f"{stel_err:.3g}")
    if pic_seconds is not None:
        out["pic_tok1024_s"] = round(pic_seconds, 3)
        out["pic_vs_baseline"] = round(146.2 / pic_seconds, 2)
    if sp8192_seconds is not None:
        out["tok8192_sparse_s"] = round(sp8192_seconds, 3)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
