"""Test configuration.

All tests run on JAX's CPU backend with 8 virtual devices, so the device
decode executor and the multi-device sharding paths run without a GPU (the
reference has no test fixtures at all — survey §4).  Tests that need the
card are marked ``gpu`` and take the ``gpu`` fixture, which skips them
where ``nvidia-smi`` finds no card; ``python chip_smoke.py`` is the
command that checks the card itself.
"""

import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_corpus(rng, sizes=(0, 1, 7, 100, 4096, 65536, 131072, 200000)):
    """Mixed-entropy test corpus: text, random, runs, structured."""
    out = []
    for n in sizes:
        if n == 0:
            out.append(b"")
            continue
        text = (b"the quick brown fox jumps over the lazy dog %d " % n) * (n // 20 + 1)
        out.append(text[:n])
        out.append(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
        out.append(bytes(rng.integers(0, 4, n, dtype=np.uint8)))
        out.append(b"\xab" * n)
        # structured: repeating 16-byte records with a counter
        rec = np.zeros((n // 16 + 1, 16), dtype=np.uint8)
        rec[:, 0] = np.arange(rec.shape[0]) & 0xFF
        rec[:, 5] = 7
        out.append(rec.tobytes()[:n])
    return out


@pytest.fixture(scope="session")
def corpus(rng):
    return make_corpus(rng)


@pytest.fixture
def gpu():
    """Skip unless this machine has an NVIDIA card (decided when the test
    runs, never at import: every xdist worker must collect the same
    tests)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("needs an NVIDIA GPU (run python chip_smoke.py on the card)")
