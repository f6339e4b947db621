"""Test fixtures. NOTE: no XLA_FLAGS device-count forcing here — smoke
tests and benches must see the real 1-device CPU (assignment requirement).
Multi-device behaviour is tested in subprocesses (test_multidevice.py)."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_multidevice(script: str, devices: int = 8, timeout: int = 420) -> str:
    """Run ``script`` in a fresh python with N forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = SRC
    proc = subprocess.run(
        [sys.executable, "-c", script], env=env, capture_output=True,
        text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"multidevice script failed:\nSTDOUT:\n{proc.stdout}\n"
            f"STDERR:\n{proc.stderr}")
    return proc.stdout


@pytest.fixture(scope="session")
def multidevice():
    return run_multidevice


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
