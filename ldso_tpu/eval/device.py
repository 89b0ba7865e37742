"""The accelerator a measurement runs on.

Every number the bench and the chip smoke test print names its device;
a path that finds no GPU fails instead of timing the CPU.
"""

from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default backend, which
    must be a GPU; raises RuntimeError otherwise."""
    import jax

    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's default backend is {d.platform!r} "
                           f"({d.device_kind}); this needs a GPU")
    return dict(platform=d.platform, kind=d.device_kind, count=len(devs))


def card_name_power() -> str:
    """Each card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process; JAX is not involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
