"""Device selection and description helpers.

The reference selects SYCL devices by vendor/type strings with capability
checks (``utils/sycl_utils.hpp:398-465`` device_selector in
fateshelled/sycl_points).  Under JAX the runtime owns device discovery;
this helper keeps the same call shape for configuration compatibility and
exposes basic capability info (the analog of print_device_info).
"""

from __future__ import annotations

import subprocess
from typing import Optional

import jax


def select_device(vendor: str = "", type: str = "") -> jax.Device:
    """Pick a device matching platform substrings; GPU before CPU.

    ``vendor``/``type`` are matched case-insensitively against the platform
    and device-kind strings ("gpu", "cpu", "h100", ...).
    """
    devs = jax.devices()
    want = f"{vendor} {type}".strip().lower()
    if want:
        for d in devs:
            hay = f"{d.platform} {getattr(d, 'device_kind', '')}".lower()
            if all(tok in hay for tok in want.split()):
                return d
    for platform in ("gpu", "cpu"):
        for d in devs:
            if d.platform == platform:
                return d
    return devs[0]


def require_gpu(count: int = 1) -> list:
    """The first ``count`` GPU devices; exits nonzero when JAX has fewer.

    Measurement entry points call this first: a number taken on the CPU
    must never pass for a device number."""
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        raise SystemExit(
            f"needs {count} GPU(s); JAX found {len(devs)} "
            f"{devs[0].platform} device(s)"
        )
    return devs[:count]


def card_line() -> str:
    """``name, power.limit`` of each card as nvidia-smi reports them, read
    by a child process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


def device_info(device: Optional[jax.Device] = None) -> dict:
    d = device or jax.devices()[0]
    info = {
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "?"),
        "id": d.id,
        "process_index": d.process_index,
    }
    try:
        stats = d.memory_stats()
        if stats:
            info["bytes_limit"] = stats.get("bytes_limit")
            info["bytes_in_use"] = stats.get("bytes_in_use")
    except Exception:
        pass
    return info


def print_device_info():
    for d in jax.devices():
        print(device_info(d))
