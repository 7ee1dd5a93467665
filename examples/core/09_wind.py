"""Attach wind fields to the simulation.

Batched-JAX equivalent of /root/reference/examples/core/09_simple_wind.py +
10_custom_wind.py: wind fields are pytree callables
``(physics_step, position) -> velocity`` — use the built-ins or write your
own (any struct dataclass with a __call__ works, including batched parameters).
"""

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct

from pyflyt_tpu.core import Aviary, DroneSpec
from pyflyt_tpu.core.wind import GaussianWind


# --- a custom wind field: sheared crosswind growing with height
@struct.dataclass
class ShearWind:
    strength: jnp.ndarray

    def __call__(self, physics_step, position):
        wind_x = self.strength * jnp.log1p(jnp.maximum(position[..., 2], 0.0))
        zeros = jnp.zeros_like(wind_x)
        return jnp.stack([wind_x, zeros, zeros], axis=-1)


for name, wind in (
    ("gaussian gusts", GaussianWind.init(jax.random.PRNGKey(1))),
    ("shear", ShearWind(strength=jnp.asarray(3.0))),
):
    aviary = Aviary(
        start_pos=[[0.0, 0.0, 5.0]],
        start_orn=[[0.0, 0.0, 0.0]],
        specs=(DroneSpec(drone_type="quadx", mode=7),),
        wind_fn=wind,
    )
    state = aviary.reset(jax.random.PRNGKey(0))
    state = aviary.set_setpoint(state, 0, jnp.asarray([0.0, 0.0, 0.0, 5.0]))
    state = jax.jit(
        lambda s: jax.lax.scan(lambda s, _: (aviary.step(s), None), s, None, 480)[0]
    )(state)
    print(f"{name}: drifted to", aviary.state(state, 0)[3])
