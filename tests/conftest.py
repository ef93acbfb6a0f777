"""Test configuration: force a CPU backend with 8 virtual devices.

Unit and parity tests run on the CPU backend so they are hermetic and
can exercise multi-device sharding on an 8-device virtual mesh (the
standard JAX fake-backend trick, cf. SURVEY.md §4d).  The mesh engine
engages automatically on any multi-device host; tests opt into it with
KMER_TPU_FORCE_MESH=1, so the 8 virtual devices alone do not switch
every tool onto it.  Checks that need the GPU carry the `gpu` marker
and skip here (see the `gpu` fixture).
"""

import os

import jax
import pytest

os.environ.setdefault("KMER_TPU_FORCE_MESH", "0")
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on the CPU backend")


@pytest.fixture
def gpu():
    """Skip unless a GPU backend can be started in a child process (the
    suite's own process is pinned to the CPU above)."""
    import subprocess
    import sys

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        capture_output=True, text=True, env=env, timeout=120)
    if r.returncode != 0 or r.stdout.strip() != "gpu":
        pytest.skip("no GPU backend on this host")
