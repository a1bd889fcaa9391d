"""Microbenchmark of PIC CIC primitive implementations on the device.

Methodology: every variant runs inside a dependent ``fori_loop`` chain
whose INPUTS vary with the carry -- without that, XLA either dead-code-eliminates all but the consumed slice of the
output (an early version "measured" a full-width gather at 0.09 ms by
letting XLA slice the matmul to one row) or hoists the loop-invariant body
out of the chain entirely (negative times).  Outputs are consumed by full
sums; timings difference two chain lengths.
"""
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(REPO))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from emme_tpu import accel
    accel.enable_compile_cache()

    n, nf, W, chunk = 1 << 20, 1024, 256, 8192
    n_chunks = n // chunk
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    idx = jax.random.randint(k1, (n,), 0, nf, dtype=jnp.int32)
    idx_sorted = jnp.sort(idx)
    table = jax.random.normal(k2, (nf, 8), jnp.float32)
    vals = jax.random.normal(k2, (n, 4), jnp.float32)
    w0 = (idx_sorted.reshape(n_chunks, chunk)[:, 0] - W // 4
          ).clip(0, nf - W)

    def timed(fn, *args, reps=20, label=""):
        @jax.jit
        def chain(r, *a):
            def body(_, c):
                return fn(*a, c)
            return jax.lax.fori_loop(0, r, body, jnp.zeros((), jnp.float32))
        float(chain(2, *args))
        t0 = time.time(); float(chain(2, *args)); t1 = time.time() - t0
        t0 = time.time(); float(chain(2 + reps, *args)); t2 = time.time() - t0
        print(f"{label:46s} {(t2 - t1) / reps * 1e3:9.3f} ms", flush=True)

    def vary(idx, c):
        return (idx + c.astype(jnp.int32)) % nf

    def scan_gather(table, idx, c):
        t = table + c
        def body(_, ic):
            oh = jax.nn.one_hot(ic, nf, dtype=table.dtype)
            return None, oh @ t
        _, out = jax.lax.scan(body, None,
                              vary(idx, c).reshape(n_chunks, chunk))
        return out.sum() * 1e-20 + c
    timed(scan_gather, table, idx,
          label="gather: chunked scan one-hot f32 (round 3)")

    def flat_gather(table, idx, c):
        oh = jax.nn.one_hot(vary(idx, c), nf, dtype=table.dtype)
        return ((table + c).T @ oh.T).sum() * 1e-20 + c
    timed(flat_gather, table, idx, reps=10,
          label="gather: flat transposed one-hot (round 4)")

    def take_gather(table, idx, c):
        return jnp.take(table + c, vary(idx, c), axis=0).sum() * 1e-20 + c
    timed(take_gather, table, idx, label="gather: jnp.take rows")

    def win_gather(table, idx_s, w0, c):
        tw = (table + c)[w0[:, None] + jnp.arange(W)[None, :]]
        lidx = (vary(idx_s, c).reshape(n_chunks, chunk)
                - w0[:, None]).clip(0, W - 1)
        oh = jax.nn.one_hot(lidx, W, dtype=table.dtype)
        return jnp.einsum("ncw,nwe->nce", oh, tw).sum() * 1e-20 + c
    timed(win_gather, table, idx_sorted, w0,
          label=f"gather: windowed batched einsum W={W}")

    def scan_deposit(vals, idx, c):
        v = (vals + c).reshape(n_chunks, chunk, 4)
        def body(_, args):
            ic, vc = args
            oh = jax.nn.one_hot(ic, nf, dtype=vals.dtype)
            return None, oh.T @ vc
        _, ys = jax.lax.scan(
            body, None, (vary(idx, c).reshape(n_chunks, chunk), v))
        return ys.sum() * 1e-20 + c
    timed(scan_deposit, vals, idx,
          label="deposit: chunked scan one-hot f32 (round 3)")

    def flat_deposit(vals, idx, c):
        oh = jax.nn.one_hot(vary(idx, c), nf, dtype=vals.dtype)
        return ((vals + c).T @ oh).sum() * 1e-20 + c
    timed(flat_deposit, vals, idx, reps=10,
          label="deposit: flat transposed one-hot (round 4)")

    def seg_deposit(vals, idx, c):
        return jax.ops.segment_sum(vals + c, vary(idx, c),
                                   num_segments=nf).sum() * 1e-20 + c
    timed(seg_deposit, vals, idx, reps=5, label="deposit: segment_sum")

    ops = tuple(jax.random.normal(jax.random.PRNGKey(i), (n,), jnp.float32)
                for i in range(11))

    def do_sort(eta, rest, c):
        out = jax.lax.sort((eta + c,) + rest, dimension=0, num_keys=1)
        return out[0][-1] * 1e-20 + c
    timed(do_sort, ops[0], ops[1:], reps=10,
          label="lax.sort 11 operands 1M")


if __name__ == "__main__":
    main()
