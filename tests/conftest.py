"""Test configuration: the suite runs on the CPU with 8 virtual devices.

Mirrors the reference's test strategy of running everything both on 0 workers
and on 2 local worker processes (``test/runtests.jl:8-22``): a virtual
8-device CPU mesh exercises the same sharding/collective code paths as a
multi-GPU host.  The platform is pinned through jax.config before any backend
is used.

Tests marked ``gpu`` need a card: with ``JAX_PLATFORMS`` naming another
platform the pin is left off so they reach it
(``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_card.py``);
everywhere else they skip.
"""
import os

import jax

if os.environ.get("JAX_PLATFORMS", "cpu") in ("", "cpu"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import, so every worker collects the same tests)."""
    backend = jax.default_backend()
    if backend != "gpu":
        pytest.skip(f"needs a GPU; JAX's default backend is {backend!r}")
