"""Test configuration: the CPU platform with an 8-device virtual mesh.

Multi-device sharding paths are validated on a virtual CPU mesh
(``--xla_force_host_platform_device_count=8``). The platform is also set
through jax.config, before any backend initializes, in case jax was imported
earlier. Pallas kernels run in interpret mode here (pyflyt_tpu/device.py);
tests marked ``gpu`` need the card and skip on the CPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


import pytest  # noqa: E402

# slow tier: interpret-mode kernel parity files (auto-marked kernel_parity;
# deselected by default via addopts in pyproject.toml — run them with
# `pytest -m kernel_parity tests/ -q`)
_KERNEL_PARITY_FILES = {
    "test_pallas_quadx.py",
    "test_pallas_fixedwing.py",
    "test_pallas_rocket.py",
    "test_pallas_dogfight.py",
    "test_selfplay_dogfight.py",
    "test_packed_hover.py",
    "test_packed_waypoints.py",
    "test_packed_mod_hovering.py",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.path.name in _KERNEL_PARITY_FILES:
            item.add_marker(pytest.mark.kernel_parity)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop JAX's compiled-program caches at each module boundary.

    The suite compiles ~250 XLA:CPU programs, several of them huge
    (interpret-mode fused kernels, env resets with stabilization scans).
    With everything cached in one process, XLA:CPU's compiler segfaults
    deterministically around the ~228th program (observed 3x at
    test_rocket.py::test_env_reset_obs once the round-3 tests pushed the
    count past it; each file passes in isolation). Modules share almost no
    jitted functions, so per-module cache clearing costs little and keeps
    the compiler's accumulated state bounded.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The GPU devices; skips the test where JAX has none (decided here, at
    run time, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the GPU (run through chip_smoke.py on the card)")
    return jax.devices("gpu")
