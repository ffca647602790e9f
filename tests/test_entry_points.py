"""Measurement entry points: the compile-cache location, and the refusal
of ``chip_smoke.py`` and ``bench.py`` to measure anything without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bitar_tpu.utils import compile_cache

REPO = Path(__file__).resolve().parent.parent


def test_compile_cache_honours_env(monkeypatch):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, "/elsewhere/cache")
    assert compile_cache.configure_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_in_checkout(monkeypatch):
    import jax

    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.configure_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def cpu_env():
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    r = subprocess.run([sys.executable, script], cwd=REPO, env=cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "GBps" not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    # A directory with chip_smoke.py and nothing else of the repository.
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
