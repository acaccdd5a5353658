"""Test-session bootstrap: force 8 host devices before JAX initializes.

Multi-device tests (sharding specs, production meshes, elastic rescale)
need >= 8 devices; on a CPU-only host XLA exposes 1 unless the host
platform is split.  The flag must be in the environment before the first
``import jax`` anywhere in the test session, which is why it lives here
rather than in a fixture.  An operator-provided XLA_FLAGS wins.
"""

import os

if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one (the "
        "CUDA kernels have no CPU mode). On the card: pytest -m cuda")
