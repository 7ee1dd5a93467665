"""Every fused-kernel env step lowers for CUDA through Pallas's Triton
route, from this CPU-only process (no card is needed to lower). Guards
against constructs of another Pallas route creeping back into the kernels."""

import jax
import jax.numpy as jnp
import pytest

from pyflyt_tpu import device

N = 256


def _env(name):
    if name == "quadx_hover":
        from pyflyt_tpu.envs.packed_hover import PackedQuadXHoverEnv
        return PackedQuadXHoverEnv(), 4, 0
    if name == "quadx_waypoints":
        from pyflyt_tpu.envs.packed_quadx_waypoints import PackedQuadXWaypointsEnv
        return PackedQuadXWaypointsEnv(), 4, 0
    if name == "quadx_mod_hovering":
        from pyflyt_tpu.envs.quadx_mod.packed_hovering import PackedQuadXModHoveringEnv
        return PackedQuadXModHoveringEnv.create(flight_mode=9), 4, 0
    if name == "fixedwing_waypoints":
        from pyflyt_tpu.envs.packed_fixedwing_waypoints import (
            PackedFixedwingWaypointsEnv,
        )
        e = PackedFixedwingWaypointsEnv()
        return e, e.action_size, 0
    if name == "rocket_landing":
        from pyflyt_tpu.envs.packed_rocket_landing import PackedRocketLandingEnv
        e = PackedRocketLandingEnv()
        return e, e.action_size, 0
    if name == "dogfight":
        from pyflyt_tpu.envs.packed_dogfight import PackedMAFixedwingDogfightEnv
        e = PackedMAFixedwingDogfightEnv()
        return e, e.base.action_size, 2
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "quadx_hover", "quadx_waypoints", "quadx_mod_hovering",
    "fixedwing_waypoints", "rocket_landing", "dogfight",
])
def test_step_lowers_to_triton_for_cuda(name, monkeypatch):
    monkeypatch.setattr(device, "pallas_interpret", lambda: False)
    env, adim, agents = _env(name)
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    state = jax.eval_shape(env.reset, keys)[0]
    act = jax.ShapeDtypeStruct((N, agents, adim) if agents else (N, adim), jnp.float32)
    text = jax.jit(env.step).trace(state, act).lower(
        lowering_platforms=("cuda",)
    ).as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1
    for other_route in ("_custom_call\"", "mosaic"):
        assert other_route not in text.lower()
