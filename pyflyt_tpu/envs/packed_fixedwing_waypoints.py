"""Packed-state Fixedwing Waypoints env: the whole agent step is ONE kernel.

The quadx packed-hover treatment (envs/packed_hover.py) applied to the
fixed-wing waypoints task: the batch state lives permanently in the kernel's
``(ROWS, 8, N/8)`` layout (ops/pallas_fixedwing.py), ``step`` runs
``env_step_ratio`` aviary steps PLUS the waypoint task update (distance
tracking, progress/proximity reward shaping, target advancement,
termination/truncation, done-freeze) register-resident in one
``pallas_call``, and XLA only assembles the observation from packed rows.

Semantics match ``FixedwingWaypointsEnv`` exactly with noise off (asserted in
tests/test_pallas_fixedwing.py); with noise on the motor-noise PRNG stream
differs (kernel counter-hash normals), same distribution.

Reference semantics covered (cited against the upstream tree):
- agent-step loop: fixedwing_base_env.py:170-205
- reward/termination: fixedwing_base_env.py:236-252,
  fixedwing_waypoints_env.py:154-173
- waypoint bookkeeping: gym_envs/utils/waypoint_handler.py:105-183

The target buffer is stored CYCLICALLY ROLLED so the current target is always
row 0 (no runtime gather in the kernel); the handler's cursor form is
recovered as ``idx = num_targets - remaining`` plus an inverse roll.

Multi-chip: same recipe as the packed hover env — wrap ``step`` in
``jax.shard_map`` with the packed state in ``P(None, None, 'env')`` and flat
(N,) quantities in ``P('env')``; all reshapes stay shard-local and the
rollout lowers with zero collectives.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.core import math as pm
from pyflyt_tpu.envs.base import StepOut
from pyflyt_tpu.envs.fixedwing_waypoints import (
    FixedwingWaypointsEnv,
    FixedwingWaypointsState,
)
from pyflyt_tpu.ops import pallas_fixedwing as pf


@struct.dataclass
class PackedWaypointsState:
    packed: Array  # (ROWS, 8, N/8) — drone rows + env rows + waypoint rows
    key: Array  # scalar PRNG key driving the kernel noise seeds


def _fold(x: Array) -> Array:
    """(k, N) -> (k, 8, N/8)."""
    return x.reshape(x.shape[0], pf.SUBLANES, -1)


@dataclasses.dataclass(frozen=True)
class PackedFixedwingWaypointsEnv:
    """Batch-level functional env (reset takes (N, 2) keys)."""

    base: FixedwingWaypointsEnv = dataclasses.field(
        default_factory=FixedwingWaypointsEnv
    )

    def __post_init__(self):
        assert self.base.flight_mode in (-1, 0)
        assert self.base.num_targets * 3 <= 12

    @property
    def obs_size(self) -> int:
        return self.base.obs_size

    @property
    def action_size(self) -> int:
        return self.base.action_size

    def action_bounds(self):
        return self.base.action_bounds()

    # ----- layout conversions ---------------------------------------------
    def pack_env_state(self, st: FixedwingWaypointsState) -> Array:
        """Batched FixedwingWaypointsState -> packed array."""
        nt = self.base.num_targets
        packed = pf.pack_state(st.drone).reshape(pf.ROWS, -1)
        f32 = packed.dtype
        n = packed.shape[1]
        env_rows = jnp.stack(
            [
                st.reward.astype(f32),
                st.termination.astype(f32),
                st.truncation.astype(f32),
                st.collision.astype(f32),
                st.out_of_bounds.astype(f32),
                st.step_count.astype(f32),
                st.env_complete.astype(f32),
            ]
        )
        packed = packed.at[pf._RWD : pf._CPLT + 1].set(env_rows)

        # roll each env's target buffer so the current target is row 0
        rolled = jax.vmap(lambda t, i: jnp.roll(t, -i, axis=0))(
            st.wp.targets, st.wp.idx
        )
        pad = jnp.zeros((n, 12 - 3 * nt), f32)
        packed = packed.at[pf._TGT : pf._TGT + 12].set(
            jnp.concatenate([rolled.reshape(n, 3 * nt), pad], axis=-1).T
        )
        packed = packed.at[pf._REM].set((nt - st.wp.idx).astype(f32))
        packed = packed.at[pf._NDIST].set(st.wp.new_distance.astype(f32))
        packed = packed.at[pf._ODIST].set(st.wp.old_distance.astype(f32))
        packed = packed.at[pf._TDLT : pf._TDLT + 12].set(
            jnp.concatenate(
                [st.target_deltas.reshape(n, 3 * nt), pad], axis=-1
            ).T
        )
        return _fold(packed)

    def unpack_env_state(
        self, packed: Array, template: FixedwingWaypointsState
    ) -> FixedwingWaypointsState:
        """Packed array -> batched FixedwingWaypointsState (parity checks)."""
        nt = self.base.num_targets
        drone = pf.unpack_state(packed, template.drone)
        flat = packed.reshape(pf.ROWS, -1)
        n = flat.shape[1]
        idx = (nt - flat[pf._REM]).astype(jnp.int32)
        rolled = flat[pf._TGT : pf._TGT + 3 * nt].T.reshape(n, nt, 3)
        targets = jax.vmap(lambda t, i: jnp.roll(t, i, axis=0))(rolled, idx)
        return template.replace(
            drone=drone,
            reward=flat[pf._RWD],
            termination=flat[pf._TERM] > 0.5,
            truncation=flat[pf._TRUNC] > 0.5,
            collision=flat[pf._COLL] > 0.5,
            out_of_bounds=flat[pf._OOB] > 0.5,
            step_count=flat[pf._STEP].astype(jnp.int32),
            env_complete=flat[pf._CPLT] > 0.5,
            action=flat[pf._SP : pf._SP + self.action_size].T,
            wp=template.wp.replace(
                targets=targets,
                idx=idx,
                new_distance=flat[pf._NDIST],
                old_distance=flat[pf._ODIST],
            ),
            target_deltas=flat[pf._TDLT : pf._TDLT + 3 * nt].T.reshape(
                n, nt, 3
            ),
        )

    def _obs(self, flat: Array) -> dict:
        """attitude_obs (fixedwing_base.py:104-117) + target deltas from
        packed rows."""
        nt = self.base.num_targets
        ang_vel = flat[pf._VIEW : pf._VIEW + 3].T
        euler = flat[pf._VIEW + 3 : pf._VIEW + 6].T
        att = (
            pm.euler_to_quat(euler)
            if self.base.angle_representation == "quaternion"
            else euler
        )
        lin_vel = flat[pf._VIEW + 6 : pf._VIEW + 9].T
        lin_pos = flat[pf._VIEW + 9 : pf._VIEW + 12].T
        action = flat[pf._SP : pf._SP + self.action_size].T
        aux = flat[pf._ACT : pf._ACT + 6].T  # 5 surfaces + throttle
        attitude = jnp.concatenate(
            [ang_vel, att, lin_vel, lin_pos, action, aux], axis=-1
        )
        deltas = flat[pf._TDLT : pf._TDLT + 3 * nt].T.reshape(-1, nt, 3)
        return {"attitude": attitude, "target_deltas": deltas}

    # ----- functional env API ---------------------------------------------
    def reset(self, keys: Array) -> tuple[PackedWaypointsState, dict]:
        """Batched reset: the XLA reset path (10 stabilization steps) packed."""
        st, obs = jax.vmap(self.base.reset)(keys)
        return (
            PackedWaypointsState(
                packed=self.pack_env_state(st),
                key=jax.random.fold_in(keys[0], 0x9ACD),
            ),
            obs,
        )

    def step(
        self, state: PackedWaypointsState, action: Array
    ) -> tuple[PackedWaypointsState, StepOut]:
        b = self.base
        key, sub = jax.random.split(state.key)
        seed = jax.random.randint(sub, (), 0, 2**31 - 1)
        flat = state.packed.reshape(pf.ROWS, -1)
        # setpoint := action, applied unconditionally before the inner loop
        # (fixedwing_base.py:173-178)
        act = jnp.asarray(action, dtype=flat.dtype).T
        flat = flat.at[pf._SP : pf._SP + self.action_size].set(act)
        out = pf.packed_waypoints_step(
            _fold(flat),
            seed,
            b.params,
            b.cfg,
            mode=b.flight_mode,
            noisy=b.noisy_motors,
            inner_steps=b.env_step_ratio,
            dome=b.flight_dome_size,
            max_steps=b.max_steps,
            goal_dist=b.goal_reach_distance,
            num_targets=b.num_targets,
            sparse=b.sparse_reward,
        )
        oflat = out.reshape(pf.ROWS, -1)
        step_out = StepOut(
            obs=self._obs(oflat),
            reward=oflat[pf._RWD],
            termination=oflat[pf._TERM] > 0.5,
            truncation=oflat[pf._TRUNC] > 0.5,
            info={
                "collision": oflat[pf._COLL] > 0.5,
                "out_of_bounds": oflat[pf._OOB] > 0.5,
                "env_complete": oflat[pf._CPLT] > 0.5,
                "num_targets_reached": (
                    b.num_targets - oflat[pf._REM]
                ).astype(jnp.int32),
            },
        )
        return PackedWaypointsState(packed=out, key=key), step_out
