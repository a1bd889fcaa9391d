"""Command-line driver: ``python -m emme_tpu.cli [input.json]``.

Unlike the reference's hard-coded ``input.json`` in the cwd (main.cpp:183),
the input path, output directory, compute device, and dtype are selectable.
"""

from __future__ import annotations

import argparse
import sys


def virtual_cpu_devices(device: str, rows, scan, env) -> int:
    """Virtual CPU devices a run needs (0: none).  Only a CPU run with a
    mesh gets them: driver.run ignores a topology without rows, and a card
    never borrows CPU devices for a mesh it cannot hold."""
    on_cpu = device == "cpu" or (device == "auto"
                                 and env.get("JAX_PLATFORMS") == "cpu")
    need = int(rows or 0) * int(scan or 1)
    return need if on_cpu and need > 1 else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="emme_tpu",
        description="Gyrokinetic eigensolver on JAX (EMME-compatible inputs)")
    ap.add_argument("input", nargs="?", default="input.json",
                    help="input JSON file (default: input.json)")
    ap.add_argument("-o", "--output-dir", default=".",
                    help="directory for output.json and eigenMatrics/")
    ap.add_argument("--device", choices=["auto", "cpu", "gpu"],
                    default="auto",
                    help="compute platform: gpu fails at once on a machine "
                         "without a CUDA card; auto takes JAX's default "
                         "(default: auto)")
    ap.add_argument("--f32", action="store_true",
                    help="single precision (complex64); the default is "
                         "double precision (complex128)")
    ap.add_argument("--host64", action="store_true",
                    help="hybrid polish: device f32 assembly + host "
                         "complex128 linalg (reaches the reference "
                         "tolerance from an --f32 run)")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="disable scan checkpoint/resume")
    ap.add_argument("--chunk", type=int, default=2048,
                    help="assembly pair-chunk size")
    ap.add_argument("--scan-mode", choices=["wavefront", "independent"],
                    default="wavefront",
                    help="parallel-scan seeding: wavefront keeps eigenvalue "
                         "continuation in batches; independent seeds every "
                         "point from the user guess")
    ap.add_argument("--scan-workers", type=int, default=1,
                    help="device-parallel scan: fan this many concurrent "
                         "scan points out over the available devices "
                         "(disables eigenvalue continuation)")
    ap.add_argument("--mesh-rows", type=int, default=None,
                    help="distribute every solve over an N-device 'rows' "
                         "mesh: sharded assembly (dense), SPIKE-distributed "
                         "banded Newton solve (sparse), marker-sharded PIC; "
                         "equivalent to input key \"mesh\": {\"rows\": N}")
    ap.add_argument("--mesh-scan", type=int, default=None,
                    help="2-D rows x scan topology: split rows*scan devices "
                         "into scan disjoint row groups and run that many "
                         "scan points (or shifts) concurrently, each solve "
                         "sharded over its group; equivalent to "
                         "\"mesh\": {\"rows\": R, \"scan\": S}")
    ap.add_argument("--debug", action="store_true",
                    help="EMME_DEBUG analogue: NaN-raising jits + input "
                         "dimension/positivity validation")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    if args.mesh_scan and not args.mesh_rows:
        # a scan axis without a rows axis would be silently ignored
        ap.error("--mesh-scan requires --mesh-rows (use --mesh-rows 1 for "
                 "a pure scan-parallel topology)")

    # the topology may come from the CLI or the input JSON "mesh" key, or a
    # MIX (CLI rows + JSON scan) -- replicate driver.run's per-axis merge,
    # because a CPU mesh needs virtual devices and the XLA flag must be set
    # before jax initializes
    try:
        import json
        with open(args.input) as f:
            mesh_cfg = json.load(f).get("mesh") or {}
    except Exception:
        mesh_cfg = {}   # driver.run reports input errors properly
    rows = args.mesh_rows if args.mesh_rows is not None \
        else mesh_cfg.get("rows")
    scan = args.mesh_scan if args.mesh_scan is not None \
        else mesh_cfg.get("scan", 1)
    import os
    need = virtual_cpu_devices(args.device, rows, scan, os.environ)
    flags = os.environ.get("XLA_FLAGS", "")
    if need and "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={need}").strip()

    import jax
    from . import accel
    if args.device != "auto":
        # "gpu" lists CUDA alone: a machine without a card fails here
        # instead of running on the CPU
        jax.config.update("jax_platforms",
                          {"cpu": "cpu", "gpu": "cuda"}[args.device])
        accel.require(args.device)
    jax.config.update("jax_enable_x64", not args.f32)
    import jax.numpy as jnp

    accel.enable_compile_cache()
    from . import driver
    dtype = jnp.float32 if args.f32 else jnp.float64
    driver.run(args.input, output_dir=args.output_dir, dtype=dtype,
               checkpoint=not args.no_checkpoint, verbose=not args.quiet,
               chunk=args.chunk, host64=args.host64,
               scan_workers=args.scan_workers, scan_mode=args.scan_mode,
               mesh_rows=args.mesh_rows, mesh_scan=args.mesh_scan,
               debug=args.debug)
    return 0


if __name__ == "__main__":
    sys.exit(main())
