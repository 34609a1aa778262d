"""Which device a measurement runs on.

Every speed number names its device: JAX's platform, device kind and count,
and the card's name and power limit as `nvidia-smi` reports them (a card
set below its maximum power runs slower under load). A measurement path
that finds no GPU fails instead of timing the CPU backend.
"""

from __future__ import annotations

import subprocess


class NoGPUError(RuntimeError):
    """JAX's default device is not a GPU."""


def card_power() -> str:
    """`name, power.limit` of each card, one line per card, from a child
    process that stays off JAX."""
    out = subprocess.run(
        [
            "nvidia-smi", "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu() -> dict:
    """The device record for results: {"platform", "kind", "count"}.
    Raises NoGPUError unless JAX's default device is a GPU."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise NoGPUError(
            f"no GPU: JAX's default device is {dev.platform} ({dev.device_kind})"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
