"""Test configuration.

By default the tests run on the host: a virtual 8-device CPU mesh, with the
Pallas kernels in interpret mode. Tests marked ``gpu`` need a card and skip
without one; run them on a GPU host with ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` (``python chip_smoke.py`` runs them too).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

# a plugin may have imported jax before this file ran
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX sees none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a GPU host)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled-executable references after each test module.

    The full suite compiles hundreds of distinct XLA:CPU programs in one
    process; holding them all alive grows the process past ~5 GB, at which
    point the XLA:CPU compiler segfaults deterministically on the next large
    compile (reproduced: the same test passes in isolation and in either
    half of the suite, and crashes only with the full prefix's accumulated
    state). Clearing per module keeps the process small; shared shapes
    recompile, which costs ~10-20 % wall time.
    """
    yield
    jax.clear_caches()
