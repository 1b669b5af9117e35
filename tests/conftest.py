"""Test configuration: force an 8-device CPU mesh before JAX loads.

Unit tests run on the CPU backend (the plain-JAX DP route) so they are
hermetic and can exercise multi-device sharding on a virtual mesh.  What
needs the card is marked ``gpu``: it skips here and runs on the card
through ``python chip_smoke.py``.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
# Rewrite any pre-existing device-count flag rather than asserting on it
# later: the suite is built around an 8-device mesh.
import re

flags = os.environ.get("XLA_FLAGS", "")
flags = re.sub(
    r"--xla_force_host_platform_device_count=\d+", "", flags
).strip()
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=8"
).strip()

import jax

# if something imported jax before this file, the env var above came
# too late; the config update wins
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (runs via chip_smoke.py)"
    )
    if jax.default_backend() != "cpu" or len(jax.devices()) != 8:
        pytest.exit(
            "test suite needs the 8-device CPU backend but got "
            f"{jax.default_backend()} x{len(jax.devices())}; a process "
            "that imported jax before conftest.py pinned XLA_FLAGS is "
            "the usual cause",
            returncode=3,
        )


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests unless JAX runs on a CUDA device."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a CUDA device; run `python chip_smoke.py` "
                    "on the card")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_seq(rng, n: int, n_frac: float = 0.0) -> str:
    bases = np.array(list("ACGT"))
    s = bases[rng.integers(0, 4, size=n)]
    if n_frac > 0:
        mask = rng.random(n) < n_frac
        s[mask] = "N"
    return "".join(s)


def mutate(rng, seq: str, sub=0.1, ins=0.05, dele=0.05) -> str:
    """Derive a homologous sequence (for realistic alignment paths)."""
    out = []
    bases = "ACGT"
    for ch in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(bases[rng.integers(0, 4)])
        else:
            out.append(ch)
        if rng.random() < ins:
            out.append(bases[rng.integers(0, 4)])
    if not out:
        out.append("A")
    return "".join(out)
