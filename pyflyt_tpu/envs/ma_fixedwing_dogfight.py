"""Multi-agent Fixedwing Dogfight (PettingZoo-style, functional core).

Re-implements
/root/reference/PyFlyt/pz_envs/fixedwing_envs/ma_fixedwing_dogfight_env.py on
the acrowing model: two aircraft, gun hit cones, health, engagement shaping.

Semantics preserved (per aviary step, memoized once per sim time in the
reference — :259-263, 306-309):
- gun origin 0.35 m behind the CG along the forward vector (:178-179)
- hit iff angle-to-opponent < lethal_angle AND distance < lethal_distance AND
  chasing (|angle| < π/2) (:199-204); health −= damage_per_hit per hit
- engagement rewards (:265-295): +closing distance (chasing, out of range),
  +10·angle progress (in range), +3/(angle+0.1) (in range), +30 hit,
  −20 being hit; −3000 on collision or leaving the dome
- termination on collision/out-of-dome or when fewer than 2 agents remain;
  health ≤ 0 itself does NOT terminate (only the ``wins`` info — :316-320)
- observation (30,): [own 12-state, own health, relative opponent 12-state,
  opponent health, past action (4)] (:240-248). NOTE: the reference declares
  a (35,) observation space but emits 30 values; we declare the actual 30.
- spawn: rejection-sample a pair ≥ 0.2·dome apart at ``spawn_height``, random
  attitude (roll/pitch ±1 rad, yaw ±2π), 10 m/s forward velocity (:97-135)
- drone-drone collision via sphere proximity (reference: PyBullet box
  contacts on the acrowing geometry).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.ma_quadx_hover import MAStepOut
from pyflyt_tpu.models import fixedwing

CONTROL_HZ = 120


@struct.dataclass
class DogfightState:
    drones: fixedwing.FixedwingState  # batched (2,)
    key: Array
    step_count: Array
    alive: Array  # (2,) bool
    current_actions: Array  # (2, action_size)
    past_actions: Array  # (2, action_size)
    health: Array  # (2,)
    current_hits: Array  # (2,) bool — hit scored BY agent i
    current_angles: Array  # (2,)
    current_offsets: Array  # (2,)
    current_distance: Array  # scalar
    prev_angles: Array  # (2,) — one aviary step older (reward memo lag)
    prev_distance: Array  # scalar
    observations: Array  # (2, 30) cache (recomputed per aviary step)


def compute_rotation_forward(orn: Array) -> tuple[Array, Array]:
    """Euler → (body→world rotation, forward vector)
    (ma_fixedwing_dogfight_env.py:321-356)."""
    R = pm.euler_to_rotmat(orn)
    c, s = jnp.cos(orn), jnp.sin(orn)
    forward = jnp.stack(
        [c[..., 2] * c[..., 1], s[..., 2] * c[..., 1], -s[..., 1]], axis=-1
    )
    return R, forward


@dataclasses.dataclass(frozen=True)
class MAFixedwingDogfightEnv:
    spawn_height: float = 15.0
    damage_per_hit: float = 0.02
    lethal_distance: float = 15.0
    lethal_angle_radians: float = 0.1
    assisted_flight: bool = True
    sparse_reward: bool = False
    flight_dome_size: float = 150.0
    max_duration_seconds: float = 60.0
    agent_hz: int = 30
    drone_model: str = "acrowing"
    collision_radius: float = 0.5
    noisy_motors: bool = True  # booster-noise toggle (parity testing)

    def __post_init__(self):
        if CONTROL_HZ % self.agent_hz != 0:
            raise AssertionError(
                f"`agent_hz` must be a round denominator of {CONTROL_HZ}."
            )
        _ = self.params

    @property
    def num_agents(self) -> int:
        return 2

    @property
    def possible_agents(self) -> list[str]:
        return ["uav_0", "uav_1"]

    @property
    def env_step_ratio(self) -> int:
        return CONTROL_HZ // self.agent_hz

    @property
    def max_steps(self) -> int:
        return int(self.agent_hz * self.max_duration_seconds)

    @functools.cached_property
    def cfg(self) -> fixedwing.FixedwingConfig:
        return fixedwing.FixedwingConfig(
            drone_model=self.drone_model,
            control_hz=CONTROL_HZ,
            noisy_motors=self.noisy_motors,
        )

    @functools.cached_property
    def params(self) -> fixedwing.FixedwingParams:
        return fixedwing.build_params(self.cfg)

    @property
    def obs_size(self) -> int:
        # the reference's actual emission: 30 assisted, 32 unassisted
        return 12 + 1 + 12 + 1 + self.action_size

    @property
    def action_size(self) -> int:
        """4 RPYT commands, or 6 "actuator" commands when
        ``assisted_flight=False`` (ma_fixedwing_base_env.py:66).

        REFERENCE QUIRK reproduced: the reference's reset tail calls
        ``aviary.set_mode(0)`` unconditionally (ma_fixedwing_base_env.py:216),
        so even unassisted 6-dim actions flow through the mode-0 surface-
        assist map ``setpoint[[0,0,1,1,2,3]] * [1,-1,1,-1,0,1]``
        (core/drones/fixedwing.py:224-225): action dims 4-5 are DEAD and
        thrust is read from index 3, despite the Box constraining index 5 to
        [0, 1]. True per-surface control is mode -1 on the core Aviary.
        """
        return 4 if self.assisted_flight else 6

    def action_bounds(self):
        high = np.ones(self.action_size)
        low = -np.ones(self.action_size)
        low[-1] = 0.0
        return low, high

    # ----- spawning ---------------------------------------------------------
    def _sample_spawn(self, key: Array) -> tuple[Array, Array]:
        """Rejection-sample ≥ 0.2·dome separation
        (ma_fixedwing_dogfight_env.py:97-113)."""
        dtype = self.cfg.dtype
        min_sep = 0.2 * self.flight_dome_size

        def sample(k):
            pos = (
                (jax.random.uniform(k, (2, 3), dtype) - 0.5)
                * self.flight_dome_size
                * 0.5
            )
            return pos.at[:, 2].set(self.spawn_height)

        def cond(carry):
            pos, _ = carry
            return jnp.linalg.norm(pos[0] - pos[1]) < min_sep

        def body(carry):
            _, i = carry
            return sample(jax.random.fold_in(key, i)), i + 1

        pos0 = jnp.zeros((2, 3), dtype).at[:, 2].set(0.0)  # forces ≥1 sample
        pos, _ = jax.lax.while_loop(cond, body, (pos0, jnp.zeros((), jnp.int32)))
        orn_key = jax.random.fold_in(key, 999_999_937)
        orn = (
            (jax.random.uniform(orn_key, (2, 3), dtype) - 0.5)
            * 2.0
            * jnp.asarray([1.0, 1.0, 2.0 * jnp.pi], dtype)
        )
        return pos, orn

    # ----- engagement geometry ---------------------------------------------
    def _agent_states(
        self, state: DogfightState
    ) -> DogfightState:
        """_compute_agent_states (ma_fixedwing_dogfight_env.py:164-248):
        hits, health decrement, and the 30-dim observation pair."""
        view = state.drones.read.view  # (2, 4, 3)
        attitudes = view
        rotation, forward = compute_rotation_forward(attitudes[:, 1])
        gun_pos = attitudes[:, 3] - forward * 0.35
        attitudes = attitudes.at[:, 3].set(gun_pos)

        separation = gun_pos[::-1] - gun_pos  # self → opponent
        distance = jnp.linalg.norm(separation[0])
        angles = jnp.arccos(
            jnp.clip(
                jnp.sum(separation * forward, axis=-1) / jnp.maximum(distance, 1e-8),
                -1.0,
                1.0,
            )
        )
        offsets = jnp.linalg.norm(jnp.cross(separation, forward), axis=-1)

        in_cone = angles < self.lethal_angle_radians
        in_range = distance < self.lethal_distance
        chasing = jnp.abs(angles) < (jnp.pi / 2.0)
        hits = in_cone & in_range & chasing
        health = state.health - self.damage_per_hit * hits[::-1]

        # opponent relative state (ma_fixedwing_dogfight_env.py:209-237)
        opp_ang_vel = attitudes[::-1, 0]
        opp_ang_pos = attitudes[::-1, 1] - attitudes[:, 1]
        ground_vel = jnp.einsum("nij,nj->ni", rotation, attitudes[:, 2], precision="highest")
        opp_vel_in_self = jnp.einsum("nj,nji->ni", ground_vel[::-1], rotation, precision="highest")
        opp_lin_vel = opp_vel_in_self - attitudes[:, 2]
        opp_lin_pos = jnp.einsum("nj,nji->ni", separation, rotation, precision="highest")
        opponent = jnp.stack(
            [opp_ang_vel, opp_ang_pos, opp_lin_vel, opp_lin_pos], axis=1
        )

        obs = jnp.concatenate(
            [
                attitudes.reshape(2, -1),
                health[:, None],
                opponent.reshape(2, -1),
                health[::-1][:, None],
                state.past_actions,
            ],
            axis=-1,
        )
        return state.replace(
            health=health,
            current_hits=hits,
            current_angles=angles,
            current_offsets=offsets,
            current_distance=distance,
            prev_angles=state.current_angles,
            prev_distance=state.current_distance,
            observations=obs,
        )

    # ----- API --------------------------------------------------------------
    def reset(self, key: Array) -> tuple[DogfightState, Array]:
        key, spawn_key = jax.random.split(key)
        pos, orn = self._sample_spawn(spawn_key)
        _, forward = compute_rotation_forward(orn)
        drones = fixedwing.init_state(
            self.params, self.cfg, pos, orn, mode=0, start_vel=forward * 10.0
        )
        if not self.assisted_flight:
            # 6-dim setpoint through the mode-0 assist map (see action_size)
            drones = drones.replace(
                setpoint=jnp.zeros((2, self.action_size), self.cfg.dtype)
            )

        def stab(carry, _):
            drones, key = carry
            key, sub = jax.random.split(key)
            drones, _ = fixedwing.step(drones, self.params, self.cfg, 0, sub)
            return (drones, key), None

        (drones, key), _ = jax.lax.scan(stab, (drones, key), None, length=10)
        dtype = self.cfg.dtype
        state = DogfightState(
            drones=drones,
            key=key,
            step_count=jnp.zeros((), jnp.int32),
            alive=jnp.ones((2,), bool),
            current_actions=jnp.zeros((2, self.action_size), dtype),
            past_actions=jnp.zeros((2, self.action_size), dtype),
            health=jnp.ones((2,), dtype),
            current_hits=jnp.zeros((2,), bool),
            current_angles=jnp.zeros((2,), dtype),
            current_offsets=jnp.zeros((2,), dtype),
            current_distance=jnp.zeros((), dtype),
            prev_angles=jnp.zeros((2,), dtype),
            prev_distance=jnp.zeros((), dtype),
            observations=jnp.zeros((2, self.obs_size), dtype),
        )
        state = self._agent_states(state)
        # the distance memo starts equal so the first progress reward is 0
        return state, state.observations

    def scene_boxes(self, state: DogfightState):
        """Gunsight markers for third-person renders, recolored on hit.

        The reference recolors each plane's gunsight cone (link 7) red while
        that agent is scoring a hit and black otherwise
        (ma_fixedwing_dogfight_env.py:383-394, colors :384-385); here the
        sight is a thin box ahead of the nose with the same two colors."""
        from pyflyt_tpu.core import camera as cam

        view = state.drones.read.view  # (2, 4, 3)
        R, forward = compute_rotation_forward(view[:, 1])
        hit = jnp.asarray([1.0, 0.0, 0.0, 0.2])
        norm = jnp.asarray([0.0, 0.0, 0.0, 0.2])
        colors = jnp.where(state.current_hits[:, None], hit, norm)
        return cam.Boxes(
            centers=view[:, 3] + forward * 0.65,
            half_extents=jnp.broadcast_to(
                jnp.asarray([0.4, 0.02, 0.02]), (2, 3)
            ),
            rotations=R,
            colors=colors,
            visible=state.alive,
        )

    def step(
        self, state: DogfightState, actions: Array
    ) -> tuple[DogfightState, MAStepOut]:
        actions = jnp.asarray(actions, dtype=self.cfg.dtype)
        agents_mask = state.alive
        actions = jnp.where(agents_mask[:, None], actions, 0.0)
        state = state.replace(
            past_actions=state.current_actions,
            current_actions=actions,
            drones=state.drones.replace(setpoint=actions),
        )
        # "terminal if other agent is dead" uses step-start agent count
        other_dead = jnp.sum(agents_mask) < 2

        def inner(carry, _):
            st, term, trunc, reward = carry
            key, sub = jax.random.split(st.key)
            drones, contact = fixedwing.step(st.drones, self.params, self.cfg, 0, sub)
            st = st.replace(drones=drones, key=key)

            # engagement rewards FIRST, from the PREVIOUS aviary step's
            # state: the reference's reward memo (last_rew_time) fires before
            # its state memo (last_obs_time), so every engagement reward for
            # step t is computed from step t-1's hits/angles/distance
            # (ma_fixedwing_dogfight_env.py:306-313 before :259-263)
            rew = jnp.zeros((2,), self.cfg.dtype)
            if not self.sparse_reward:
                in_range = st.current_distance < self.lethal_distance  # scalar
                chasing = jnp.abs(st.current_angles) < jnp.pi / 2.0  # (2,)
                closing = jnp.clip(st.prev_distance - st.current_distance, 0.0, None)
                rew = rew + closing * (~in_range & chasing) * 1.0
                rew = rew + (st.prev_angles - st.current_angles) * in_range * 10.0
                rew = rew + 3.0 / (st.current_angles + 0.1) * in_range
            rew = rew + 30.0 * st.current_hits
            rew = rew - 20.0 * st.current_hits[::-1]

            st = self._agent_states(st)

            # collisions: ground (model) | mutual proximity
            pos = drones.body.pos
            mutual = (
                jnp.linalg.norm(pos[0] - pos[1])
                < 2.0 * self.collision_radius
            )
            collision = contact | mutual
            lin_pos = drones.read.view[..., 3, :]
            oob = jnp.linalg.norm(lin_pos, axis=-1) > self.flight_dome_size
            rew = rew - 3000.0 * oob - 3000.0 * collision

            term = term | collision | oob | other_dead
            trunc = trunc | (st.step_count > self.max_steps)
            reward = reward + rew
            return (st, term, trunc, reward), (collision, oob)

        zeros_b = jnp.zeros((2,), bool)
        zeros_f = jnp.zeros((2,), self.cfg.dtype)
        (state, term, trunc, reward), (collisions, oobs) = jax.lax.scan(
            inner, (state, zeros_b, zeros_b, zeros_f), None,
            length=self.env_step_ratio,
        )
        state = state.replace(
            step_count=state.step_count + 1,
            alive=state.alive & ~(term | trunc),
        )
        out = MAStepOut(
            obs=state.observations,
            reward=reward,
            termination=term,
            truncation=trunc,
            agents_mask=agents_mask,
            info={
                "collision": jnp.any(collisions, axis=0),
                "out_of_bounds": jnp.any(oobs, axis=0),
                # every agent's info carries the full arrays, as the reference
                # does (ma_fixedwing_dogfight_env.py:322-324)
                "wins": jnp.broadcast_to(state.health <= 0.0, (2, 2)),
                "healths": jnp.broadcast_to(state.health, (2, 2)),
            },
        )
        return state, out
