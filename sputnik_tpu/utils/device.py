"""The card a measurement runs on, named in every result it prints."""

from __future__ import annotations

import subprocess

__all__ = ["require_gpu", "device_record", "nvidia_smi_line"]


def require_gpu():
    """The JAX devices, or ``SystemExit`` when JAX found no GPU: a
    measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {devices[0].platform!r}")
    return devices


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def nvidia_smi_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
