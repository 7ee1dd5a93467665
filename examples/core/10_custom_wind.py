"""Implements a custom stateful wind model.

Batched-JAX equivalent of /root/reference/examples/core/10_custom_wind.py:
the reference subclasses ``WindFieldClass`` with arbitrary parameters and an
``np_random`` noise stream; here a wind field is any pytree callable
``(physics_step, position) -> velocity``, so "stateful" parameters are
dataclass fields and randomness comes from a counter-folded JAX PRNG key
(deterministic under jit, batchable under vmap).
"""

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct

from pyflyt_tpu.core import Aviary, DroneSpec


@struct.dataclass
class MyWindField:
    """Log-height updraft + Gaussian turbulence (10_custom_wind.py:9-34)."""

    strength: jnp.ndarray  # supports an arbitrary number of parameters
    key: jnp.ndarray  # the np_random equivalent: a folded PRNG stream

    def __call__(self, physics_step, position):
        z = jnp.maximum(position[..., 2], 1e-6)
        wind = jnp.zeros_like(position)
        wind = wind.at[..., 2].set(jnp.log(z) * self.strength)
        # fresh noise every physics step, like np_random.randn(*shape)
        noise_key = jax.random.fold_in(self.key, physics_step)
        return wind + jax.random.normal(noise_key, position.shape)


aviary = Aviary(
    start_pos=[[0.0, 0.0, 1.0]],
    start_orn=[[0.0, 0.0, 0.0]],
    specs=(DroneSpec(drone_type="quadx", mode=7),),
    wind_fn=MyWindField(
        strength=jnp.asarray(1.2), key=jax.random.PRNGKey(42)
    ),
)

state = aviary.reset(jax.random.PRNGKey(0))
state = aviary.set_setpoint(state, 0, jnp.asarray([0.0, 0.0, 0.0, 1.0]))


@jax.jit
def fly(state):
    # 1000 steps ≈ 8 seconds (10_custom_wind.py:63)
    return jax.lax.scan(lambda s, _: (aviary.step(s), None), state, None, 1000)[0]


state = fly(state)
print("position after 8 s of wind:", aviary.state(state, 0)[3])
