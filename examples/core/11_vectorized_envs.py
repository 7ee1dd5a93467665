"""The fast path: thousands of auto-resetting envs in one jitted program.

This is where the framework departs from the reference: instead of one
process per environment (SubprocVecEnv), the entire batch steps in lockstep
on device, through this pure-XLA pipeline or the fused-kernel variant
(``pyflyt_tpu.envs.packed_hover``, same API over a packed state). Rates on
the GPU: ``python bench.py`` and PERF.md.
"""

import time

import jax
import jax.numpy as jnp

from pyflyt_tpu.envs import QuadXHoverEnv, autoreset_step, vec_reset

NUM_ENVS = 2048

env = QuadXHoverEnv()
keys = jax.random.split(jax.random.PRNGKey(0), NUM_ENVS)
state, obs = jax.jit(lambda k: vec_reset(env, k))(keys)


@jax.jit
def rollout(state, key, steps=128):
    def body(carry, _):
        st, key = carry
        key, sub = jax.random.split(key)
        action = jnp.asarray([0.0, 0.0, 0.0, 0.36]) + 0.05 * jax.random.normal(
            sub, (NUM_ENVS, 4)
        )
        st, out = autoreset_step(env, st, action)
        return (st, key), out.reward

    (state, key), rewards = jax.lax.scan(body, (state, key), None, steps)
    return state, key, rewards.mean()


key = jax.random.PRNGKey(1)
state, key, r = rollout(state, key)  # compile
jax.block_until_ready(r)

t0 = time.perf_counter()
state, key, r = rollout(state, key)
jax.block_until_ready(r)
dt = time.perf_counter() - t0
print(f"{NUM_ENVS * 128 / dt:,.0f} env-steps/s | mean reward {float(r):.3f}")
