"""Fused-kernel MA Fixedwing Dogfight: one ARENA per lane element.

Fast-path wrapper around ``ops/pallas_dogfight.py``: ``N`` arenas live in a
folded ``(132, 8, N/8)`` state — per drone, the single
ops/pallas_fixedwing.py bank plus 13 engagement/episode rows, drone 0's bank
in rows 0-65 and drone 1's in rows 66-131 (see ops/pallas_dogfight.py).
``step`` runs the WHOLE dogfight agent step (4 aviary steps x 2
physics iterations + engagement rewards with the reference's memo lag +
termination bookkeeping) in ONE ``pallas_call``;
the 30-dim observation pair is assembled here in XLA from the final packed
state (ma_fixedwing_dogfight_env.py:209-248 — the reference recomputes it
every aviary step but only the last one is ever observed).

Semantics match ``MAFixedwingDogfightEnv`` exactly with noise off (asserted
in tests/test_pallas_dogfight.py); with noise on the booster-noise PRNG
stream differs (kernel counter-hash noise), same distribution.

Reference: /root/reference/PyFlyt/pz_envs/fixedwing_envs/
ma_fixedwing_dogfight_env.py (see envs/ma_fixedwing_dogfight.py for the
line-by-line citations this fast path inherits).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.envs.ma_fixedwing_dogfight import (
    DogfightState,
    MAFixedwingDogfightEnv,
    compute_rotation_forward,
)
from pyflyt_tpu.envs.ma_quadx_hover import MAStepOut
from pyflyt_tpu.ops import pallas_dogfight as pdg
from pyflyt_tpu.ops import pallas_fixedwing as pfw


@struct.dataclass
class PackedDogfightEnvState:
    packed: Array  # (pdg.ROWS, 8, N/8)
    key: Array
    alive: Array  # (N, 2) bool
    current_actions: Array  # (N, 2, A)
    past_actions: Array  # (N, 2, A)


def _pair(flat: Array, row: int) -> Array:
    """Per-drone row ``row`` of both banks -> (N, 2)."""
    return jnp.stack([flat[row], flat[pdg.DR + row]], axis=1)


@dataclasses.dataclass(frozen=True)
class PackedMAFixedwingDogfightEnv:
    """Drop-in fused fast path for ``MAFixedwingDogfightEnv`` batched over
    ``N`` arenas (N % 8 == 0)."""

    base: MAFixedwingDogfightEnv = dataclasses.field(
        default_factory=MAFixedwingDogfightEnv
    )

    @property
    def num_agents(self) -> int:
        return 2

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: DogfightState) -> Array:
        """Batched (N,) DogfightState -> packed (ROWS, 8, N/8) array: drone
        m's bank in rows [m * DR, (m + 1) * DR)."""
        n = st.health.shape[0]
        zeros = jnp.zeros((n,), jnp.float32)
        banks = []
        for m in range(2):
            drone = jax.tree.map(lambda x: x[:, m], st.drones)
            bank = pfw.pack_state(drone).reshape(pfw.ROWS, n)[: pdg.D_ROWS]
            f32 = bank.dtype
            env_rows = jnp.stack(
                [
                    st.health[:, m],
                    st.current_angles[:, m],
                    st.prev_angles[:, m],
                    st.current_hits[:, m].astype(f32),
                    st.current_distance,
                    st.prev_distance,
                    zeros,  # term
                    zeros,  # trunc
                    zeros,  # reward
                    zeros,  # collf
                    zeros,  # oobf
                    zeros,  # other_dead
                    st.step_count.astype(f32),
                ],
                axis=0,
            )
            banks += [bank, env_rows]
        packed = jnp.concatenate(banks, axis=0)
        return packed.reshape(pdg.ROWS, pdg.SUBLANES, n // pdg.SUBLANES)

    # ----- observation assembly (ma_fixedwing_dogfight_env.py:164-248) -----
    def _obs(self, flat: Array, past_actions: Array) -> Array:
        """(ROWS, N) flat rows -> (N, 2, 30) observation pair, identical
        math to MAFixedwingDogfightEnv._agent_states on the final aviary
        step."""
        n = flat.shape[1]
        view = jnp.stack(
            [
                flat[m * pdg.DR + pfw._VIEW : m * pdg.DR + pfw._VIEW + 12].T
                for m in range(2)
            ],
            axis=1,
        ).reshape(n, 2, 4, 3)
        health = _pair(flat, pdg._HP)
        rotation, forward = compute_rotation_forward(view[:, :, 1])
        gun_pos = view[:, :, 3] - forward * 0.35
        attitudes = view.at[:, :, 3].set(gun_pos)
        separation = gun_pos[:, ::-1] - gun_pos
        opp_ang_vel = attitudes[:, ::-1, 0]
        opp_ang_pos = attitudes[:, ::-1, 1] - attitudes[:, :, 1]
        ground_vel = jnp.einsum("nmij,nmj->nmi", rotation, attitudes[:, :, 2], precision="highest")
        opp_vel_in_self = jnp.einsum(
            "nmj,nmji->nmi", ground_vel[:, ::-1], rotation
        , precision="highest")
        opp_lin_vel = opp_vel_in_self - attitudes[:, :, 2]
        opp_lin_pos = jnp.einsum("nmj,nmji->nmi", separation, rotation, precision="highest")
        opponent = jnp.stack(
            [opp_ang_vel, opp_ang_pos, opp_lin_vel, opp_lin_pos], axis=2
        )
        return jnp.concatenate(
            [
                attitudes.reshape(n, 2, 12),
                health[..., None],
                opponent.reshape(n, 2, 12),
                health[:, ::-1][..., None],
                past_actions,
            ],
            axis=-1,
        )

    # ----- API --------------------------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedDogfightEnvState, Array]:
        """``keys``: (N, 2) PRNG keys, N % 8 == 0."""
        b = self.base
        n = keys.shape[0]
        assert n % pdg.SUBLANES == 0, n
        st, obs = jax.vmap(b.reset)(keys)
        packed = self.pack_env_state(st)
        state = PackedDogfightEnvState(
            packed=packed,
            key=st.key[0],
            alive=st.alive,
            current_actions=st.current_actions,
            past_actions=st.past_actions,
        )
        return state, obs

    def step(
        self, state: PackedDogfightEnvState, actions: Array
    ) -> tuple[PackedDogfightEnvState, MAStepOut]:
        """``actions``: (N, 2, action_size). One full agent step per arena."""
        b = self.base
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)
        flat = state.packed.reshape(pdg.ROWS, -1)
        f32 = flat.dtype

        agents_mask = state.alive
        actions = jnp.asarray(actions, dtype=f32)
        actions = jnp.where(agents_mask[..., None], actions, 0.0)
        # setpoint rows (padded to the 6-row bank slot) + other-dead flag
        a_dim = actions.shape[-1]
        other_dead = (jnp.sum(agents_mask, axis=1) < 2).astype(f32)
        for m in range(2):
            sp = m * pdg.DR + pfw._SP
            flat = flat.at[sp : sp + a_dim].set(actions[:, m].T)
            flat = flat.at[sp + a_dim : sp + 6].set(0.0)
            flat = flat.at[m * pdg.DR + pdg._OTHD].set(other_dead)

        out = pdg.packed_dogfight_step(
            flat.reshape(pdg.ROWS, pdg.SUBLANES, -1),
            seed,
            b.params,
            b.cfg,
            noisy=b.cfg.noisy_motors,
            inner_steps=b.env_step_ratio,
            dome=b.flight_dome_size,
            max_steps=b.max_steps,
            lethal_angle=b.lethal_angle_radians,
            lethal_distance=b.lethal_distance,
            damage_per_hit=b.damage_per_hit,
            collision_radius=b.collision_radius,
            sparse=b.sparse_reward,
        )
        oflat = out.reshape(pdg.ROWS, -1)
        pair = lambda row: _pair(oflat, row)

        term = pair(pdg._TERM) > 0.5
        trunc = pair(pdg._TRUNC) > 0.5
        reward = pair(pdg._RWD)
        health = pair(pdg._HP)
        # the obs's past-action block is the action of the PREVIOUS step:
        # the reference rolls past <- current at step entry and _agent_states
        # reads past_actions (ma_fixedwing_dogfight_env.py:240-248)
        obs = self._obs(oflat, state.current_actions)
        new_state = PackedDogfightEnvState(
            packed=out,
            key=key,
            alive=state.alive & ~(term | trunc),
            current_actions=actions,
            past_actions=state.current_actions,
        )
        step_out = MAStepOut(
            obs=obs,
            reward=reward,
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={
                "collision": pair(pdg._COLLF) > 0.5,
                "out_of_bounds": pair(pdg._OOBF) > 0.5,
                "wins": jnp.broadcast_to(
                    (health <= 0.0)[:, None, :], health.shape[:1] + (2, 2)
                ),
                "healths": jnp.broadcast_to(
                    health[:, None, :], health.shape[:1] + (2, 2)
                ),
            },
        )
        return new_state, step_out
