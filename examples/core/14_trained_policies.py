"""Load archived trained policies and roll them out deterministically.

Every env family in this repo ships with a trained-policy artifact under
``docs/artifacts/policies_*.npz`` (the actor-critic params; see
docs/artifacts/README.md for the index with eval receipts). This example restores two of them with
``pyflyt_tpu.rl.checkpoint.restore_params`` — the counterpart of the
reference's ``PPO.load(path=".../best_model_*.zip")`` — and evaluates
them on CPU:

- the Fixedwing-Waypoints solver (3.4/4 waypoints per episode, ~75%
  complete-course over 256 episodes when it was trained);
- the rocket LANDING policy for the 13 m rung of the 2%-fuel variant
  (round 5: the stock 1% task is physically unlandable — see
  docs/PERF.md — this policy soft-lands ~2% of episodes and triggers
  the +500 stable-rest tier).

Run:  JAX_PLATFORMS=cpu python examples/core/14_trained_policies.py
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pyflyt_tpu.envs.base import vec_reset  # noqa: E402
from pyflyt_tpu.envs.fixedwing_waypoints import FixedwingWaypointsEnv  # noqa: E402
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv  # noqa: E402
from pyflyt_tpu.rl import PPO, PPOConfig, checkpoint  # noqa: E402
from pyflyt_tpu.rl.ppo import _flat_obs  # noqa: E402

ART = os.path.join(os.path.dirname(__file__), "..", "..", "docs", "artifacts")
N = 4  # CPU demo size; the archived receipts used 256 episodes


def rollout(env, ppo, params, n, extract):
    """Deterministic full-episode batch rollout; returns per-env extras."""

    @jax.jit
    def run(keys):
        st, obs = vec_reset(env, keys)

        def body(carry, _):
            st, obs, done, ep_rew = carry
            a = ppo.act_deterministic(params, _flat_obs(obs))
            st2, out = jax.vmap(env.step)(st, a)
            ep_rew = ep_rew + out.reward * (~done)
            done = done | out.termination | out.truncation
            return (st2, out.obs, done, ep_rew), None

        (st, obs, done, ep_rew), _ = jax.lax.scan(
            body, (st, obs, jnp.zeros(n, bool), jnp.zeros(n)), None,
            length=env.max_steps + 2,
        )
        return ep_rew, extract(st)

    return run(jax.random.split(jax.random.PRNGKey(7), n))


# ---- fixedwing waypoints ----------------------------------------------------
env = FixedwingWaypointsEnv()
ppo = PPO(env, PPOConfig())
template = ppo.init(jax.random.PRNGKey(0)).params
params = checkpoint.restore_params(
    os.path.join(ART, "policies_fixedwing_r5_lr3e-4_seed0"), template
)
ep_rew, (idx, complete) = rollout(
    env, ppo, params, N, lambda st: (st.wp.idx, st.env_complete)
)
print("Fixedwing-Waypoints:")
for i in range(N):
    print(f"  episode {i}: reward {float(ep_rew[i]):8.1f}  "
          f"waypoints {int(idx[i])}/4  complete={bool(complete[i])}")

# ---- rocket landing (13 m rung of the landable 2%-fuel variant) -------------
env = RocketLandingEnv(starting_fuel_ratio=0.02, ceiling=15.0,
                       max_displacement=15.0, accelerate_drop=False)
ppo = PPO(env, PPOConfig(init_log_std=-1.2, log_std_range=(-3.5, -1.0)))
template = ppo.init(jax.random.PRNGKey(0)).params
params = checkpoint.restore_params(
    os.path.join(ART, "policies_rocket_landing_L0"), template
)
ep_rew, (pad, fatal, complete, tspeed) = rollout(
    env, ppo, params, N,
    lambda st: (st.pad_contact_flag > 0.5, st.fatal_collision,
                st.env_complete,
                jnp.linalg.norm(st.prev_lin_vel, axis=-1)),
)
print("Rocket landing (13 m rung, 2% fuel; fatal threshold 1.0 m/s):")
for i in range(N):
    tier = ("COMPLETE (+500)" if bool(complete[i])
            else "soft" if bool(pad[i]) and not bool(fatal[i])
            else "pad-crash" if bool(pad[i]) else "miss")
    print(f"  episode {i}: reward {float(ep_rew[i]):8.1f}  tier={tier}  "
          f"touchdown {float(tspeed[i]):.2f} m/s")
print("(archived 256-episode receipts: docs/artifacts/README.md)")
