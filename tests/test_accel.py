"""Platform decisions, the CLI's device handling, the compile cache, the
removed input keys and the chip smoke script's refusal to run off the card."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import jax

from emme_tpu import accel, cli, driver

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("platform, want", [
    ("cpu", dict(loop="host", deposit="segment", fused32=False)),
    ("gpu", dict(loop="device", deposit="matmul", fused32=True)),
])
def test_platform_defaults(platform, want):
    assert accel.newton_loop(platform) == want["loop"]
    assert accel.pic_deposit(platform) == want["deposit"]
    assert accel.fused_assembly(platform, "float32") == want["fused32"]
    assert not accel.fused_assembly(platform, "float64")


@pytest.mark.parametrize("platform, ok", [("gpu", True), ("cpu", False)])
def test_kernel_route(platform, ok):
    if ok:
        accel.require_kernel_route(platform)
    else:
        with pytest.raises(RuntimeError, match="no compiled route"):
            accel.require_kernel_route(platform)


def test_current_platform():
    assert accel.current() == "cpu"
    assert accel.current(jax.devices()) == "cpu"

    class Dev:
        platform = "rocm"
    with pytest.raises(RuntimeError, match="unsupported platform"):
        accel.current([Dev()])


def test_require_platform():
    accel.require("cpu")
    with pytest.raises(RuntimeError, match="asked for 'gpu'"):
        accel.require("gpu")


@pytest.mark.parametrize("device, rows, scan, env, want", [
    ("cpu", 4, 1, {}, 4),
    ("cpu", 2, 3, {}, 6),
    ("cpu", None, 2, {}, 0),          # a scan axis alone makes no mesh
    ("cpu", 1, 1, {}, 0),
    ("gpu", 4, 1, {}, 0),             # a card never borrows CPU devices
    ("auto", 2, 1, {"JAX_PLATFORMS": "cpu"}, 2),
    ("auto", 2, 1, {}, 0),
])
def test_cli_virtual_devices(device, rows, scan, env, want):
    assert cli.virtual_cpu_devices(device, rows, scan, env) == want


def test_cli_device_gpu_fails_without_card(tmp_path, tokamak_cfg):
    path = tmp_path / "input.json"
    path.write_text(json.dumps(dict(tokamak_cfg, npoints=8)))
    jax.devices()           # backends already up on the CPU
    prev = jax.config.jax_platforms
    try:
        with pytest.raises(RuntimeError, match="gpu"):
            cli.main([str(path), "-o", str(tmp_path), "--device", "gpu"])
    finally:
        jax.config.update("jax_platforms", prev)
    assert not (tmp_path / "output.json").exists()


def test_cli_rejects_tpu(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--device", "tpu"])
    assert "invalid choice" in capsys.readouterr().err


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, monkeypatch, env_dir):
    prev = jax.config.jax_compilation_cache_dir
    try:
        if env_dir:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
            jax.config.update("jax_compilation_cache_dir", want)
            assert accel.enable_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = accel.enable_compile_cache()
            assert got == str(REPO / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("key", sorted(driver.REMOVED_KEYS))
def test_removed_keys_raise(tmp_path, tokamak_cfg, key):
    cfg = dict(tokamak_cfg, npoints=8, **{key: "auto"})
    with pytest.raises(ValueError, match=key):
        driver.run(cfg, output_dir=tmp_path, verbose=False)
    with pytest.raises(ValueError, match=key):
        driver.solve_once_pic(dict(cfg, method="PIC"), 0j)


def test_mesh_larger_than_devices_raises(tmp_path, tokamak_cfg):
    n = len(jax.devices())
    cfg = dict(tokamak_cfg, npoints=8, mesh={"rows": n + 1})
    with pytest.raises(ValueError, match=f"needs {n + 1} devices"):
        driver.run(cfg, output_dir=tmp_path, verbose=False)


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr + out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
