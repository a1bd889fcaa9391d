"""Banded (BDIA) SpMV throughput benchmark (BASELINE north-star metric:
nnz/s per device).

Timing methodology: each measurement runs a DEPENDENT CHAIN of matvecs
(x_{k+1} = A x_k / s) inside one jitted ``fori_loop`` at two chain lengths
and reports the difference -- the fixed dispatch+sync cost cancels exactly,
and the serial dependency matches how Arnoldi actually consumes SpMV.  The
bound is the device's memory bandwidth: each stored block is read once per
matvec.
"""
import json
import sys
import time
import pathlib

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np


def chain_time(matvec, operands, x0, k_lo=512, k_hi=4096, tries=2):
    """Per-iteration time of the dependent chain x_{k+1} = A x_k / 64.

    The trip count is a TRACED argument (fori_loop lowers to while_loop), so
    one compile serves both chain lengths; the fixed dispatch+sync cost
    cancels in the (k_hi - k_lo) difference.  ``operands`` (the operator
    arrays) are jit ARGUMENTS, not closure constants.
    ``matvec``: (operands, xr, xi) -> (yr, yi) with matching shapes."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(operands, xr, xi, k):
        def body(_, c):
            yr, yi = matvec(operands, *c)
            s = jnp.float32(1.0 / 64.0)
            return yr * s, yi * s
        return jax.lax.fori_loop(0, k, body, (xr, xi))

    def sync(out):
        return float(jax.jit(lambda a: a.sum())(out[0]))

    sync(run(operands, *x0, 8))  # compile + warm
    def t(k):
        best = float("inf")
        for _ in range(tries):
            t0 = time.time()
            sync(run(operands, *x0, k))
            best = min(best, time.time() - t0)
        return best

    # grow the chain until the differenced work dwarfs dispatch jitter
    # (small operators run a matvec in ~2 us; 4096 of those is still noise)
    while t(k_hi) < 0.5 and k_hi < 2 ** 21:
        k_lo, k_hi = k_lo * 8, k_hi * 8
    return (t(k_hi) - t(k_lo)) / (k_hi - k_lo)


def bench_case(label, op, M_dense=None):
    import jax.numpy as jnp
    from emme_tpu.ops import sparse

    rng = np.random.default_rng(1)
    n = op.n
    x = jnp.asarray(rng.normal(size=n).astype(np.float32))
    xi = jnp.asarray(rng.normal(size=n).astype(np.float32))

    dt = chain_time(lambda o, a, b: sparse.bdia_matvec(o, a, b), op, (x, xi))
    stored = op.data.shape[0] * (n // op.block) * 2 * op.block ** 2 * 4
    print(f"{label}: ndiag={len(op.offsets)} nnz={op.nnz/1e6:.2f}M "
          f"t={dt*1e6:.0f}us nnz/s={op.nnz/dt/1e9:.1f}G "
          f"BW(stored)={stored/dt/1e9:.0f}GB/s", flush=True)

    if M_dense is not None:
        Mr = jnp.asarray(M_dense.real.astype(np.float32))
        Mi = jnp.asarray(M_dense.imag.astype(np.float32))
        dt_d = chain_time(
            lambda o, a, b: (o[0] @ a - o[1] @ b, o[0] @ b + o[1] @ a),
            (Mr, Mi), (x, xi))
        print(f"  dense XLA matvec (same data): t={dt_d*1e6:.0f}us "
              f"({dt_d/dt:.2f}x bdia)", flush=True)
    return op.nnz / dt


def synthetic(rng, n, bs):
    nb = n // bs
    M = (rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
         ).astype(np.complex64)
    i = np.arange(nb)
    keep = np.abs(i[:, None] - i[None, :]) <= max(1, nb // 3)
    blocks = M.reshape(nb, bs, nb, bs).transpose(0, 2, 1, 3)
    blocks[~keep] = 0
    return blocks.transpose(0, 2, 1, 3).reshape(n, n)


def tokamak_operator():
    """The real assembled kernel-integral operator, tokamak n=1024."""
    import jax
    import jax.numpy as jnp
    from emme_tpu import from_config
    from emme_tpu.grid import Grid
    from emme_tpu.ops.singularity import singularity_coeff_matrix
    from emme_tpu.solvers import eigen

    with open(REPO / "tests" / "goldens" / "inputs" / "tokamak.json") as f:
        cfg = json.load(f)
    cfg["npoints"] = 1024
    p = from_config(cfg, dtype=jnp.float32)
    grid = Grid.create(p.length, p.npoints, dtype=jnp.float32)
    coeff = singularity_coeff_matrix(p.npoints, dtype=jnp.float32)
    fn = jax.jit(lambda re, im: eigen.assemble_matrix(
        p, grid, coeff, (re + 1j * im).astype(jnp.complex64), chunk=4096))
    M = fn(jnp.float32(-0.8), jnp.float32(0.25))
    Mr = np.asarray(jax.jit(jnp.real)(M))
    Mi = np.asarray(jax.jit(jnp.imag)(M))
    return Mr + 1j * Mi


def main():
    from emme_tpu import accel
    accel.enable_compile_cache()
    from emme_tpu.ops import sparse

    rng = np.random.default_rng(0)
    for n, bs in ((2048, 128), (4096, 128), (8192, 256)):
        M = synthetic(rng, n, bs)
        op = sparse.bdia_from_dense(M, block=bs, threshold=1e-9)
        bench_case(f"band n={n} bs={bs}", op, M_dense=M)

    M = tokamak_operator()
    op = sparse.bdia_from_dense(M, block=128, threshold=0.0)
    bench_case("tokamak n=1024 operator bs=128", op, M_dense=M)


if __name__ == "__main__":
    main()
