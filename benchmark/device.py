"""Which device a measurement runs on.

A measurement path that finds no GPU fails; it never falls back to the
CPU, whose times say nothing about the card.
"""
from __future__ import annotations

import shutil
import subprocess


def nvidia_smi_lines() -> list:
    """`name, power.limit` of every card, as nvidia-smi prints them (a card
    set below its maximum power runs slower under load, so this belongs
    beside every time)."""
    if shutil.which("nvidia-smi") is None:
        return ["nvidia-smi not found"]
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60,
    )
    return [l.strip() for l in out.stdout.splitlines() if l.strip()] or [out.stderr.strip()]


def require_gpu() -> dict:
    """The default JAX device as {"platform", "kind", "count"}; exits
    non-zero, with the reason on stderr, when it is not a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default device is {devs[0].platform!r} "
            f"({devs[0].device_kind}); this measurement runs only on the card"
        )
    return {"platform": devs[0].platform, "kind": devs[0].device_kind, "count": len(devs)}
