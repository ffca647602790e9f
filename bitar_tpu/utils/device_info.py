"""What device a measurement ran on.

Every benchmark result names its device: JAX's platform, device kind and
count, and the card's name and power limit as ``nvidia-smi`` reports them
(a card set below its maximum power runs slower under load, so a rate
means little without its limit).  Measurement entry points call
``require_gpu`` first: without a GPU they stop instead of writing CPU
numbers under device metric names.
"""

from __future__ import annotations

import subprocess
import sys

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def nvidia_smi_lines() -> list[str]:
    """``name, power.limit`` per card, read by a child process (which
    stays off JAX and the card's memory)."""
    try:
        r = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                           timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi unavailable: {e}"]
    if r.returncode != 0:
        return [f"nvidia-smi failed rc={r.returncode}: {r.stderr.strip()}"]
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def device_record() -> dict:
    """The JSON record a benchmark puts beside its numbers."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": nvidia_smi_lines()}


def require_gpu(tool: str) -> None:
    """Exit with status 2 unless JAX's first device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        print(f"{tool}: needs a GPU; JAX found platform {platform!r}. "
              f"No measurement taken.", file=sys.stderr)
        raise SystemExit(2)
