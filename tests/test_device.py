"""Measurement guards: no benchmark or smoke run times a CPU, and an unknown
device has no published peak."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mava_jax.utils import device

REPO = Path(__file__).resolve().parents[1]


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        device.require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError, match="nothing"):
        device.require_gpu([])


def test_require_gpu_refuses_a_mixed_list():
    class FakeGpu:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    gpus = [FakeGpu()]
    assert device.require_gpu(gpus) == gpus
    with pytest.raises(RuntimeError):
        device.require_gpu([FakeGpu(), jax.devices("cpu")[0]])


def test_peaks_known_and_unknown_device_kind():
    h100 = device.peaks("NVIDIA H100 80GB HBM3")
    assert h100["bf16_flops"] == 989e12 and h100["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError, match="no published peaks"):
        device.peaks("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError):
        device.peaks("cpu")


def test_bench_mfu_uses_the_peak_table():
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import bench_mfu
    finally:
        sys.path.remove(str(REPO / "scripts"))
    assert not hasattr(bench_mfu, "PEAK_BF16_FLOPS")
    assert "peaks" in bench_mfu.main.__code__.co_names


def test_chip_smoke_helpers_refuse_cpu():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with pytest.raises(RuntimeError):
        chip_smoke.require_gpu(jax.devices("cpu"))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check(False, "refused")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_exit_nonzero_without_a_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, script], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    lines = [l for l in proc.stdout.splitlines() if l.strip()]
    if lines:
        with pytest.raises(json.JSONDecodeError):
            json.loads(lines[-1])
