"""Packed-state QuadX Hover env: the whole agent step is ONE kernel.

The default hover pipeline (envs/quadx_hover.py) interleaves the Pallas/XLA
drone step with XLA-side reward/termination logic and packs/unpacks the
state every aviary step. This variant keeps the batch state permanently in
the kernel's ``(ROWS, 8, N/8)`` layout (ops/pallas_quadx.py): ``step`` runs
``env_step_ratio`` aviary steps PLUS the task update (reward shaping,
collision/out-of-bounds termination, step-count truncation, done-freeze)
register-resident in one ``pallas_call``, and XLA only assembles the
observation from packed rows.

Semantics match ``QuadXHoverEnv`` exactly with noise off (asserted in
tests/test_packed_hover.py); with noise on the motor-noise PRNG stream
differs (kernel counter-hash normals), same distribution. Supports the hover
task's config surface on the fast-path envelope: modes 0/7/8, ENU, quaternion
or euler observations, dense or sparse reward.

Reference semantics covered (cited against the upstream tree):
- agent-step loop: quadx_base_env.py:248-279
- reward/termination: quadx_base_env.py:230-246, quadx_hover_env.py:105-119

Multi-chip: wrap ``step`` in ``jax.shard_map`` with the packed state in
``P(None, None, 'env')`` and every flat (N,) quantity (actions, obs,
rewards) in ``P('env')`` — each device then owns a lane-block and the
internal (ROWS, 8, N/8) <-> (ROWS, N) reshapes stay shard-local, so the
rollout lowers with ZERO collectives (asserted in
tests/test_packed_hover.py::test_packed_env_steps_under_shard_map).
Sharding a jitted ``step`` directly instead would all-gather the packed
state: the fold interleaves env ids across lane-blocks, so a global
reshape mixes shards.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.quadx_hover import QuadXHoverEnv
from pyflyt_tpu.envs.quadx_base import QuadXEnvState
from pyflyt_tpu.ops import pallas_quadx as pq


@struct.dataclass
class PackedHoverState:
    packed: Array  # (ROWS, 8, N/8) — drone rows 0-49, env rows 50-55
    key: Array  # scalar PRNG key driving the kernel noise seeds


def _fold(x: Array) -> Array:
    """(k, N) -> (k, 8, N/8)."""
    return x.reshape(x.shape[0], pq.SUBLANES, -1)


@dataclasses.dataclass(frozen=True)
class PackedQuadXHoverEnv:
    """Batch-level functional env (reset takes (N, 2) keys)."""

    base: QuadXHoverEnv = dataclasses.field(default_factory=QuadXHoverEnv)

    def __post_init__(self):
        assert self.base.flight_mode in (0, 7, 8)
        assert self.base.orn_conv == "ENU_FLU"

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    @property
    def action_size(self) -> int:
        return 4

    def action_bounds(self):
        return self.base.action_bounds()

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: QuadXEnvState) -> Array:
        """Batched QuadXEnvState -> packed array (env fields in rows 50-55)."""
        packed = pq.pack_state(st.drone, self.base.flight_mode)
        packed = packed.reshape(packed.shape[0], -1)
        f32 = packed.dtype
        env_rows = jnp.stack(
            [
                st.reward.astype(f32),
                st.termination.astype(f32),
                st.truncation.astype(f32),
                st.collision.astype(f32),
                st.out_of_bounds.astype(f32),
                st.step_count.astype(f32),
            ]
        )
        packed = packed.at[pq._RWD : pq._STEP + 1].set(env_rows)
        return _fold(packed)

    def unpack_env_state(self, packed: Array, template: QuadXEnvState) -> QuadXEnvState:
        """Packed array -> batched QuadXEnvState (for parity checks)."""
        drone = pq.unpack_state(packed, template.drone)
        flat = packed.reshape(packed.shape[0], -1)
        return template.replace(
            drone=drone,
            reward=flat[pq._RWD],
            termination=flat[pq._TERM] > 0.5,
            truncation=flat[pq._TRUNC] > 0.5,
            collision=flat[pq._COLL] > 0.5,
            out_of_bounds=flat[pq._OOB] > 0.5,
            step_count=flat[pq._STEP].astype(jnp.int32),
            action=flat[pq._SP : pq._SP + 4].T,
        )

    def _obs(self, flat: Array) -> Array:
        """attitude_obs (quadx_base.py:122-131) from packed rows."""
        ang_vel = flat[pq._VIEW : pq._VIEW + 3].T
        euler = flat[pq._VIEW + 3 : pq._VIEW + 6].T
        att = (
            pm.euler_to_quat(euler)
            if self.base.angle_representation == "quaternion"
            else euler
        )
        lin_vel = flat[pq._VIEW + 6 : pq._VIEW + 9].T
        lin_pos = flat[pq._VIEW + 9 : pq._VIEW + 12].T
        action = flat[pq._SP : pq._SP + 4].T
        aux = flat[pq._THR : pq._THR + 4].T
        return jnp.concatenate(
            [ang_vel, att, lin_vel, lin_pos, action, aux], axis=-1
        )

    # ----- functional env API ---------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedHoverState, Array]:
        """Batched reset: the XLA reset path (10 stabilization steps) packed."""
        st, obs = jax.vmap(self.base.reset)(keys)
        return (
            PackedHoverState(
                packed=self.pack_env_state(st),
                key=jax.random.fold_in(keys[0], 0x9ACD),
            ),
            obs,
        )

    def step(
        self, state: PackedHoverState, action: Array
    ) -> tuple[PackedHoverState, StepOut]:
        b = self.base
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)
        flat = state.packed.reshape(state.packed.shape[0], -1)
        # setpoint := action, applied unconditionally before the inner loop
        # (quadx_base.py:194-201)
        act = jnp.asarray(action, dtype=flat.dtype).T
        flat = flat.at[pq._SP : pq._SP + 4].set(act)
        out = pq.packed_hover_step(
            _fold(flat),
            seed,
            b.params,
            b.cfg,
            mode=b.flight_mode,
            noisy=b.noisy_motors,
            inner_steps=b.env_step_ratio,
            dome=b.flight_dome_size,
            max_steps=b.max_steps,
            sparse=b.sparse_reward,
        )
        oflat = out.reshape(out.shape[0], -1)
        step_out = StepOut(
            obs=self._obs(oflat),
            reward=oflat[pq._RWD],
            termination=oflat[pq._TERM] > 0.5,
            truncation=oflat[pq._TRUNC] > 0.5,
            info={
                "collision": oflat[pq._COLL] > 0.5,
                "out_of_bounds": oflat[pq._OOB] > 0.5,
                "env_complete": jnp.zeros_like(oflat[pq._COLL], bool),
            },
        )
        return PackedHoverState(packed=out, key=key), step_out


# ---------------------------------------------------------------------------
# cached auto-reset on the packed layout (mirrors envs/base.py)
# ---------------------------------------------------------------------------


@struct.dataclass
class PackedAutoResetState:
    env_state: PackedHoverState
    cache_packed: Array
    cache_obs: Array
    step_idx: Array
    key: Array


def packed_autoreset_init(
    env: PackedQuadXHoverEnv, keys: Array
) -> tuple[PackedAutoResetState, Array]:
    state, obs = env.reset(keys)
    cache_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0x5EED))(keys)
    cache_state, cache_obs = env.reset(cache_keys)
    return (
        PackedAutoResetState(
            env_state=state,
            cache_packed=cache_state.packed,
            cache_obs=cache_obs,
            step_idx=jnp.zeros((), jnp.int32),
            key=jax.random.fold_in(keys[0], 0xCACE),
        ),
        obs,
    )


def packed_cached_autoreset_step(
    env: PackedQuadXHoverEnv,
    ars: PackedAutoResetState,
    action: Array,
    refresh: int = 64,
) -> tuple[PackedAutoResetState, StepOut]:
    """cached_autoreset_step (envs/base.py:143-201) on the packed layout:
    finished lanes substitute their cached packed column."""
    state, out = env.step(ars.env_state, action)
    done = out.termination | out.truncation

    mask = _fold(done[None, :].astype(state.packed.dtype))  # (1, 8, N/8)
    packed = jnp.where(mask > 0.5, ars.cache_packed, state.packed)
    obs = jnp.where(done[:, None], ars.cache_obs, out.obs)
    terminal_obs = out.obs

    num_envs = done.shape[0]
    key, sub = jax.random.split(ars.key)

    def do_refresh(_):
        st, ob = env.reset(jax.random.split(sub, num_envs))
        return st.packed, ob

    def keep(_):
        return ars.cache_packed, ars.cache_obs

    cache_packed, cache_obs = jax.lax.cond(
        ars.step_idx % refresh == refresh - 1, do_refresh, keep, None
    )
    return (
        PackedAutoResetState(
            env_state=PackedHoverState(packed=packed, key=state.key),
            cache_packed=cache_packed,
            cache_obs=cache_obs,
            step_idx=ars.step_idx + 1,
            key=key,
        ),
        out.replace(
            obs=obs, info={**out.info, "terminal_observation": terminal_obs}
        ),
    )
