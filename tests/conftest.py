"""Test env: CPU with 8 virtual devices unless ``JAX_PLATFORMS`` says
otherwise, so multi-device sharding paths are testable without a card
(SURVEY.md §4 item 5). XLA_FLAGS must be set before the first
``jax.devices()`` call; backend initialization is lazy, so the platform
update below still applies.

Tests that need the card carry the ``gpu`` marker (registered in
pyproject.toml). Whether a card is present is decided in the fixture below,
at run time, never at import: every xdist worker must collect the same
tests. On the card: ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``."""

import os

import jax
import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
if "JAX_PLATFORMS" not in os.environ:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
