"""Fused-kernel Rocket-Landing env: whole agent step in one pallas_call.

Fast-path wrapper around ``ops/pallas_rocket.py``: ``N`` envs live in a
folded ``(88, 8, N/8)`` state; ``step`` runs the complete agent step
(3 aviary steps x 2 physics iterations with the fuel-tracked composite
inertia, the shaped landing reward with memo-lagged velocity checks, pad
touchdown logic, termination bookkeeping and the done-freeze) in ONE kernel.
The observation (attitude + previous action + auxiliary + pad flag + rotated
pad-relative distance) is assembled here in XLA from the final packed rows
(envs/rocket_landing.py::_obs math, rocket_landing_env.py:123-135).

Semantics match ``RocketLandingEnv`` exactly with noise off (asserted in
tests/test_pallas_rocket.py); with noise on the booster-noise PRNG stream
differs (kernel counter-hash normals), same distribution.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut, vec_reset
from pyflyt_tpu.envs.rocket_landing import RocketLandingEnv, RocketLandingState
from pyflyt_tpu.ops import pallas_rocket as prk


@struct.dataclass
class PackedRocketEnvState:
    packed: Array  # (prk.ROWS, 8, N/8)
    key: Array


@dataclasses.dataclass(frozen=True)
class PackedRocketLandingEnv:
    """Drop-in fused fast path for ``RocketLandingEnv`` batched over N
    envs (N % 8 == 0). Quaternion angle representation only (the stock
    landing configuration)."""

    base: RocketLandingEnv = dataclasses.field(default_factory=RocketLandingEnv)

    def __post_init__(self):
        assert self.base.angle_representation == "quaternion"

    @property
    def action_size(self) -> int:
        return 7

    @property
    def max_steps(self) -> int:
        return self.base.max_steps

    def action_bounds(self):
        return self.base.action_bounds()

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: RocketLandingState) -> Array:
        """Batched RocketLandingState -> packed array."""
        n = st.reward.shape[0]
        f32 = jnp.float32
        drone_rows = prk.pack_state(st.drone).reshape(prk.ROWS, n)[: prk._RWD]
        env_rows = jnp.stack(
            [
                st.reward,
                st.termination.astype(f32),
                st.truncation.astype(f32),
                st.fatal_collision.astype(f32),
                st.out_of_bounds.astype(f32),
                st.env_complete.astype(f32),
                st.step_count.astype(f32),
                st.pad_position[:, 0], st.pad_position[:, 1],
                st.pad_position[:, 2],
                st.pad_contact_flag,
                *[st.ang_vel[:, i] for i in range(3)],
                *[st.lin_vel[:, i] for i in range(3)],
                *[st.distance[:, i] for i in range(3)],
                *[st.prev_ang_vel[:, i] for i in range(3)],
                *[st.prev_lin_vel[:, i] for i in range(3)],
                *[st.prev_distance[:, i] for i in range(3)],
            ],
            axis=0,
        )
        packed = jnp.concatenate([drone_rows, env_rows], axis=0)
        assert packed.shape[0] == prk.ROWS, packed.shape
        return packed.reshape(prk.ROWS, prk.SUBLANES, n // prk.SUBLANES)

    # ----- observation (rocket_landing.py::_obs + rocket_base.attitude_obs) --
    def _obs(self, flat: Array) -> Array:
        n = flat.shape[1]
        g = lambda r, k: flat[r : r + k].T
        view = g(prk._VIEW, 12).reshape(n, 4, 3)
        quat = pm.euler_to_quat(view[:, 1])
        aux = jnp.concatenate(
            [
                g(prk._ACT, 4),
                g(prk._IGN, 1),
                g(prk._FUEL, 1),
                g(prk._BTHR, 1),
                g(prk._GBL, 2),
            ],
            axis=-1,
        )
        rotation = pm.quat_to_rotmat(quat)
        distance = g(prk._DIST, 3)
        rotated_distance = jnp.einsum("...j,...ji->...i", distance, rotation, precision="highest")
        return jnp.concatenate(
            [
                view[:, 0],
                quat,
                view[:, 2],
                view[:, 3],
                g(prk._SP, 7),  # action == setpoint
                aux,
                flat[prk._PFLAG][:, None],
                rotated_distance,
            ],
            axis=-1,
        )

    # ----- API --------------------------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedRocketEnvState, Array]:
        """``keys``: (N, 2) PRNG keys, N % 8 == 0."""
        n = keys.shape[0]
        assert n % prk.SUBLANES == 0, n
        st, obs = vec_reset(self.base, keys)
        return (
            PackedRocketEnvState(packed=self.pack_env_state(st), key=st.key[0]),
            obs,
        )

    def step(
        self, state: PackedRocketEnvState, action: Array
    ) -> tuple[PackedRocketEnvState, StepOut]:
        b = self.base
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)
        flat = state.packed.reshape(prk.ROWS, -1)
        # action -> setpoint rows, applied unconditionally at step start
        # (rocket_base.py base_step:216-221)
        act = jnp.asarray(action, dtype=flat.dtype).T
        flat = flat.at[prk._SP : prk._SP + 7].set(act)
        out = prk.packed_landing_step(
            flat.reshape(prk.ROWS, prk.SUBLANES, -1),
            seed,
            b.params,
            b.cfg,
            noisy=b.cfg.noisy_boosters,
            inner_steps=b.env_step_ratio,
            max_steps=b.max_steps,
            max_displacement=b.max_displacement,
            ceiling=b.ceiling,
            sparse=b.sparse_reward,
        )
        oflat = out.reshape(prk.ROWS, -1)
        step_out = StepOut(
            obs=self._obs(oflat),
            reward=oflat[prk._RWD],
            termination=oflat[prk._TERM] > 0.5,
            truncation=oflat[prk._TRUNC] > 0.5,
            info={
                "fatal_collision": oflat[prk._FATC] > 0.5,
                "out_of_bounds": oflat[prk._OOB] > 0.5,
                "env_complete": oflat[prk._CPLT] > 0.5,
            },
        )
        return PackedRocketEnvState(packed=out, key=key), step_out
