"""What the measurement scripts run on, and a refusal to measure anything else.

Timings are only meaningful on the accelerator the system is deployed on, so the
benchmarks and the chip smoke test call `require_gpu` first and print
`describe_devices()` before any number: a run that finds only a CPU fails rather
than timing the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional, Sequence

import jax

# Published peaks of the cards the benchmarks may divide by, keyed by JAX's
# `device_kind`. Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense
# rates (no sparsity), at its full 700 W power limit.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,
        "tf32_flops": 495e12,
        "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def require_gpu(devices: Optional[Sequence[jax.Device]] = None) -> list:
    """The devices to measure on (default: all); raises unless all are GPUs."""
    devices = list(jax.devices() if devices is None else devices)
    if not devices or any(d.platform != "gpu" for d in devices):
        found = ", ".join(f"{d.platform}:{d.device_kind}" for d in devices) or "nothing"
        raise RuntimeError(f"this measurement needs an NVIDIA GPU; JAX found: {found}")
    return devices


def peaks(device_kind: str) -> Dict[str, float]:
    """Published peaks for `device_kind`; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add them to "
            f"mava_jax/utils/device.py with their source (known: {sorted(PEAKS)})"
        )
    return PEAKS[device_kind]


def card_info() -> str:
    """`name, power.limit` of each card, one per line, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def describe_devices(devices: Sequence[jax.Device]) -> str:
    """One line: platform, device_kind, device count and the cards' power limit."""
    return (
        f"platform {devices[0].platform}; device_kind {devices[0].device_kind}; "
        f"{len(devices)} device(s); card: {card_info()}"
    )
