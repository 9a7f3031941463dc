"""Test env: a fake 8-device CPU pod by default.

JAX_PLATFORMS defaults to cpu (also for the subprocesses tests spawn), so
sharding and collective paths run on 8 virtual CPU devices with no card.
Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless a
GPU is present; on a GPU machine they run with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test when JAX finds none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on the "
                    "card)")
    return gpus[0]


@pytest.fixture()
def rng():
    # function-scoped: each test gets the same deterministic stream
    # regardless of execution order (a session-scoped rng made test DATA
    # depend on which tests ran before — order-dependent flakes)
    return np.random.default_rng(1234)


@pytest.fixture(scope="session")
def speechlike():
    """1.0 s of speech-like 16 kHz audio: harmonics + noise, f32 in [-1,1]."""
    g = np.random.default_rng(777)
    sr = 16000
    t = np.arange(sr) / sr
    f0 = 110.0 * (1.0 + 0.3 * np.sin(2 * np.pi * 2.5 * t))
    sig = sum((0.5 / k) * np.sin(2 * np.pi * k * np.cumsum(f0) / sr)
              for k in range(1, 6))
    sig = sig + 0.01 * g.standard_normal(sr)
    sig = 0.8 * sig / np.max(np.abs(sig))
    return sig.astype(np.float32)
