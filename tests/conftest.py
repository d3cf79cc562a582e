"""Test environment: CPU backend with 8 virtual devices (for sharding tests)
and float64 enabled (for the oracle path).  The platform is pinned with
jax.config.update as well as JAX_PLATFORMS, so an interpreter that imported
jax before the environment was read still runs where JAX_PLATFORMS says
(the CPU when it is unset).  Tests ask for
the Pallas kernel's interpret mode explicitly.  The persistent compilation
cache is off, so test runs write nothing into the checkout.

Tests marked ``gpu`` need the card: the ``gpu`` fixture skips them when
JAX finds no GPU (decided when the test runs, never at import)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# the CPU unless JAX_PLATFORMS names another platform (the `gpu` tests on
# the card: JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu)
jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402



@pytest.fixture
def gpu():
    """Skip unless JAX runs on a GPU (tests marked ``gpu`` use this)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run on the card: see README, Quick start)")


# Duration-derived test tier: tests measured >~20 s each carry the
# `heavy` marker, applied centrally here so the tier stays one greppable
# list.  -m "not slow and not heavy" is the smoke tier; -m "not slow" is
# the core gate.
_HEAVY = (
    "test_accuracy_horizon.py::test_f32_velocity_error_500_2000_4000_steps",
    "test_cli.py::test_cli_mesh_resume_from_single_device_checkpoint",
    "test_cli.py::test_cli_orbax_cross_layout_resume",
    "test_cli.py::test_cli_orbax_sharded_checkpoint_roundtrip",
    "test_golden_flux.py::test_early_flux_matches_f64_golden",
    "test_multihost.py::test_two_process_matches_single_process",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        key = f"{item.fspath.basename}::{item.name}"
        if any(key.startswith(p) for p in _HEAVY):
            item.add_marker(pytest.mark.heavy)
