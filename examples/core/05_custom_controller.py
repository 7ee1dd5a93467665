"""Register a custom controller over a base flight mode.

Batched-JAX equivalent of /root/reference/examples/core/05_custom_controller.py:
the reference registers a `ControlClass` instance as a new mode
(base_drone.py:265-285); here a custom controller is a pure
``(view, setpoint) -> setpoint`` function evaluated before the base-mode
cascade.
"""

import jax
import jax.numpy as jnp

from pyflyt_tpu.core import Aviary, DroneSpec


def orbit_controller(view, setpoint):
    """Circles the origin: steers the mode-7 position target along a ring."""
    pos = view[..., 3, :]
    angle = jnp.arctan2(pos[..., 1], pos[..., 0]) + 0.3
    return jnp.stack(
        [2.0 * jnp.cos(angle), 2.0 * jnp.sin(angle), setpoint[..., 2],
         setpoint[..., 3]],
        axis=-1,
    )


aviary = Aviary(
    start_pos=[[2.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(
        DroneSpec(drone_type="quadx", mode=7, custom_controller=orbit_controller),
    ),
)

state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_setpoint(state, 0, jnp.asarray([0.0, 0.0, 0.0, 1.5]))


@jax.jit
def fly(state):
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, 120)[0]


for _ in range(5):
    state = fly(state)
    print("position:", aviary.state(state, 0)[3])
