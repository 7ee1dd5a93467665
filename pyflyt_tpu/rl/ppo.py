"""PPO on vectorized on-device environments.

Replaces the reference's SB3 PPO + SubprocVecEnv training stack
(/root/reference/PyFlyt/rl_training/hovering/training.py:159-206): instead of
one OS process per environment with pickle pipes, the whole
rollout-collection + GAE + minibatch-SGD loop is ONE jitted program over the
batched functional env. Scaling is data parallelism over the env axis of a
``jax.sharding.Mesh`` (SURVEY.md §2.4): env state sharded ``P('env')``,
parameters replicated, gradient all-reduce inserted by XLA.

Hyperparameter defaults mirror SB3's PPO defaults used by the reference
(lr 3e-4, γ 0.99, λ 0.95, clip 0.2, vf 0.5, grad-norm 0.5) with the
reference's batch sizing (training.py:81-101: batch=control_hz,
n_steps=32·batch, n_epochs=15 — here expressed per-env).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax
from pyflyt_tpu.core import struct
from jax import Array

from pyflyt_tpu.envs.base import FunctionalEnv, autoreset_step
from pyflyt_tpu.rl.networks import (
    ActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 1024
    rollout_steps: int = 32  # env steps collected per iteration per env
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.0
    value_coef: float = 0.5
    max_grad_norm: float = 0.5
    num_epochs: int = 15  # training.py:85
    num_minibatches: int = 32
    feature_sizes: tuple = (256, 256)  # custom_feature_extractor.py:18-23
    pi_sizes: tuple = ()
    vf_sizes: tuple = ()
    # initial Gaussian log-std (SB3 default 0.0 = std 1; envs whose useful
    # action region is small — e.g. raw-mix flight modes 8/9 — learn far
    # faster with a tighter initial exploration, e.g. -1.6 => std 0.2)
    init_log_std: float = 0.0
    # optional (min, max) clamp on the learned log_std (None = free, the SB3
    # behavior). See networks.ActorCritic.log_std_range.
    log_std_range: tuple | None = None
    # amortized auto-reset (envs/base.py AutoResetState): ~3× faster rollouts
    # for envs with reset-time stabilization; 0 disables (exact per-step
    # resets). Value = the cache refresh PERIOD in steps.
    cached_reset_refresh: int = 0
    # network matmul dtype ("float32" | "bfloat16"); params/grads/Adam stay
    # float32 and the loss math is float32 (networks.ActorCritic.dtype)
    compute_dtype: str = "float32"
    # Time-limit bootstrap strategy. The rollout scan needs V(terminal_obs)
    # only at truncated-not-terminated steps, and an env whose episode
    # length exceeds rollout_steps truncates AT MOST ONCE per rollout — so
    # instead of a per-step vf apply on the whole batch (~1/3 of the
    # rollout's network flops, all but ~0.1% of it discarded), each env
    # carries ONE (obs, step-index) slot through the scan and a single
    # post-scan vf apply scatter-adds γ·V into the stored rewards. Per-row
    # results match the in-scan apply to FMA-rounding level (same (B, obs)
    # matmul shapes; the reward add rounds once vs twice — see
    # tests/test_ppo.py::test_slot_bootstrap_matches_inscan).
    # True/False force the path; None (default) auto-selects the
    # slot when ``env.max_steps > rollout_steps`` is statically known.
    slot_bootstrap: bool | None = None
    # minibatch-shuffle granularity: the per-epoch uniform permutation runs
    # over BLOCKS of this many consecutive samples instead of single rows,
    # so the epoch gather moves contiguous rows. Samples inside a block
    # share a rollout timestep (adjacent envs), a negligible correlation at
    # >=1024-sample minibatches; 1 recovers the exact SB3-style per-sample
    # permutation (set shuffle_block=1 and shuffle_block_auto=False).
    shuffle_block: int = 16
    # auto-raise the block with the batch: the effective block is
    # max(shuffle_block, batch_size // 8192) clipped to a divisor of the
    # minibatch, so the correlated fraction per minibatch stays at
    # num_minibatches/8192 (<1% for <=80 minibatches) at every batch size.
    shuffle_block_auto: bool = True

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.rollout_steps

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches


@struct.dataclass
class RunnerState:
    params: Any
    opt_state: Any
    env_state: Any
    obs: Array  # (num_envs, obs_dim)
    key: Array
    update_idx: Array  # scalar int32


@struct.dataclass
class Transition:
    obs: Array
    action: Array
    log_prob: Array
    value: Array
    reward: Array
    done: Array


def _shuffle_gather(
    packed: Array,
    perm: Array,
    num_blocks: int,
    blk: int,
    feat: int,
    num_minibatches: int,
    minibatch_size: int,
) -> Array:
    """Block-permutes the packed (batch, feat) buffer into
    (num_minibatches, minibatch_size, feat) minibatches.

    When a block is a whole number of 128-float rows, the gather runs on a
    (num_blocks, blk·feat/128, 128) VIEW of the same bytes instead of the
    narrow natural minor dim ``feat`` (typically ~23 floats). The
    row-major reshapes are bit-exact views, so both branches produce
    identical minibatches.
    """
    rows = blk * feat
    if rows % 128 == 0:
        g = packed.reshape((num_blocks, rows // 128, 128))[perm]
    else:
        g = packed.reshape((num_blocks, blk, feat))[perm]
    return g.reshape((num_minibatches, minibatch_size, feat))


def _flat_obs(obs: Any) -> Array:
    """Dict observations are flattened (sorted keys) for the MLP policy."""
    if isinstance(obs, dict):
        return jnp.concatenate(
            [obs[k].reshape(obs[k].shape[0], -1) for k in sorted(obs)], axis=-1
        )
    return obs


class PPO:
    """Functional PPO trainer bound to one env + config."""

    def __init__(
        self,
        env: FunctionalEnv,
        config: PPOConfig = PPOConfig(),
        action_low: Array | None = None,
        action_high: Array | None = None,
        network=None,
    ):
        self.env = env
        self.config = config
        low, high = env.action_bounds()
        self.action_low = jnp.asarray(low if action_low is None else action_low)
        self.action_high = jnp.asarray(high if action_high is None else action_high)
        self.action_dim = int(self.action_low.shape[-1])
        # custom policy (e.g. networks.VisionActorCritic for the
        # image-observation Gates task); must keep ActorCritic's init/apply
        # contract, apply returning (mean, log_std, value)
        self.network = network or ActorCritic(
            action_dim=self.action_dim,
            feature_sizes=config.feature_sizes,
            pi_sizes=config.pi_sizes,
            vf_sizes=config.vf_sizes,
            init_log_std=config.init_log_std,
            log_std_range=config.log_std_range,
            dtype=jnp.dtype(config.compute_dtype),
        )
        # optax.flatten: run clip+Adam on ONE concatenated vector instead of
        # ~12 per-tensor elementwise chains inside the sequential minibatch
        # scan. Mathematically identical (both transforms are elementwise /
        # whole-tree norms).
        base_opt = optax.chain(
            optax.clip_by_global_norm(config.max_grad_norm),
            optax.adam(config.learning_rate, eps=1e-5),
        )
        self.optimizer = optax.flatten(base_opt)

    # ------------------------------------------------------------------ init
    def init(self, key: Array) -> RunnerState:
        key, net_key, env_key = jax.random.split(key, 3)
        env_keys = jax.random.split(env_key, self.config.num_envs)
        if getattr(self.env, "native_batch", False):
            # natively-batched env (e.g. the packed fast paths): reset/step
            # take the whole batch, auto-reset is env-provided. Single-chip
            # (the folded layout doesn't shard on axis 0 — use the XLA env
            # under a mesh).
            if self.config.cached_reset_refresh > 0:
                assert hasattr(self.env, "cached_autoreset_init"), (
                    f"{type(self.env).__name__} has no cached auto-reset "
                    "fast path; set cached_reset_refresh=0"
                )
                env_state, obs = self.env.cached_autoreset_init(env_keys)
            else:
                env_state, obs = self.env.reset(env_keys)
        elif self.config.cached_reset_refresh > 0:
            from pyflyt_tpu.envs.base import autoreset_init

            env_state, obs = autoreset_init(self.env, env_keys)
        else:
            env_state, obs = jax.vmap(self.env.reset)(env_keys)
        obs = _flat_obs(obs)
        params = self.network.init(net_key, obs[:1])
        opt_state = self.optimizer.init(params)
        return RunnerState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            obs=obs,
            key=key,
            update_idx=jnp.zeros((), jnp.int32),
        )

    # ------------------------------------------------------------- policies
    def act(self, params: Any, obs: Array, key: Array) -> tuple[Array, Array, Array]:
        """Sample (action, log_prob, value); actions clipped to bounds at the
        env boundary (SB3 semantics: log-prob of the unclipped sample)."""
        mean, log_std, value = self.network.apply(params, obs)
        noise = jax.random.normal(key, mean.shape, mean.dtype)
        action = mean + jnp.exp(log_std) * noise
        log_prob = gaussian_log_prob(mean, log_std, action)
        return action, log_prob, value

    def act_deterministic(self, params: Any, obs: Array) -> Array:
        mean, _, _ = self.network.apply(params, obs)
        return jnp.clip(mean, self.action_low, self.action_high)

    # ------------------------------------------------------------- rollout
    def _env_step(self, env_state, action):
        if getattr(self.env, "native_batch", False):
            if self.config.cached_reset_refresh > 0:
                return self.env.cached_autoreset_step(
                    env_state, action, self.config.cached_reset_refresh
                )
            return self.env.autoreset_step(env_state, action)
        if self.config.cached_reset_refresh > 0:
            from pyflyt_tpu.envs.base import cached_autoreset_step

            return cached_autoreset_step(
                self.env, env_state, action, self.config.cached_reset_refresh
            )
        return autoreset_step(self.env, env_state, action)

    def _use_slot(self) -> bool:
        """Resolves ``PPOConfig.slot_bootstrap`` (None = auto).

        The slot path stores at most ONE truncation per env per rollout, so
        auto only selects it when the env's truncations come solely from its
        time limit AND the limit exceeds the rollout window. Envs whose
        truncation can fire more than once per rollout (e.g.
        ``SelfPlayDogfightEnv``: partner death truncates arbitrarily often)
        declare ``time_limit_truncation_only = False`` and fall back to the
        exact in-scan vf(term_obs) apply. Plain ``FunctionalEnv``s driven via
        ``envs.base`` truncate only on the time limit, so they default True;
        ``native_batch`` adapters must declare the attribute to opt in.
        """
        cfg = self.config
        if cfg.slot_bootstrap is not None:
            return cfg.slot_bootstrap
        max_steps = getattr(self.env, "max_steps", None)
        time_limit_only = getattr(
            self.env,
            "time_limit_truncation_only",
            not getattr(self.env, "native_batch", False),
        )
        return (
            max_steps is not None
            and max_steps > cfg.rollout_steps
            and time_limit_only
        )

    def _rollout(self, runner: RunnerState):
        cfg = self.config
        use_slot = self._use_slot()
        saw_term = [False]  # set during tracing of the scan body

        def body(carry, t_idx):
            env_state, obs, key, slot_obs, slot_t, slot_has = carry
            key, act_key = jax.random.split(key)
            action, log_prob, value = self.act(runner.params, obs, act_key)
            clipped = jnp.clip(action, self.action_low, self.action_high)
            env_state, out = self._env_step(env_state, clipped)
            done = out.termination | out.truncation
            # time-limit bootstrap (SB3 semantics): truncated-but-not-
            # terminated steps get γ·V(terminal_obs) folded into the reward,
            # using the pre-reset observation the autoreset paths surface.
            # Slot path (PPOConfig.slot_bootstrap): stash the one possible
            # truncation row per env and defer the vf apply past the scan.
            # In-scan path: apply vf(term_obs) every step.
            reward = out.reward
            term_obs = out.info.get("terminal_observation")
            if term_obs is not None:
                saw_term[0] = True
                trunc_only = out.truncation & ~out.termination
                if use_slot:
                    slot_obs = jnp.where(
                        trunc_only[:, None], _flat_obs(term_obs), slot_obs
                    )
                    slot_t = jnp.where(trunc_only, t_idx, slot_t)
                    slot_has = slot_has | trunc_only
                else:
                    _, _, v_term = self.network.apply(
                        runner.params, _flat_obs(term_obs)
                    )
                    reward = reward + cfg.gamma * v_term * trunc_only
            t = Transition(
                obs=obs,
                action=action,
                log_prob=log_prob,
                value=value,
                reward=reward,
                done=done,
            )
            return (
                env_state, _flat_obs(out.obs), key, slot_obs, slot_t, slot_has
            ), t

        n_envs = runner.obs.shape[0]
        init = (
            runner.env_state,
            runner.obs,
            runner.key,
            jnp.zeros_like(runner.obs),
            jnp.zeros((n_envs,), jnp.int32),
            jnp.zeros((n_envs,), bool),
        )
        (env_state, obs, key, slot_obs, slot_t, slot_has), traj = jax.lax.scan(
            body, init, jnp.arange(cfg.rollout_steps, dtype=jnp.int32)
        )
        if use_slot and saw_term[0]:
            # one vf apply on the gathered truncation rows; per-row
            # results match the in-scan apply to FMA-rounding level
            _, _, v_slot = self.network.apply(runner.params, slot_obs)
            adj = cfg.gamma * v_slot * slot_has
            traj = traj.replace(
                reward=traj.reward.at[
                    slot_t, jnp.arange(n_envs)
                ].add(adj)
            )
        return runner.replace(env_state=env_state, obs=obs, key=key), traj

    # ----------------------------------------------------------------- GAE
    def _gae(self, params: Any, traj: Transition, last_obs: Array):
        _, _, last_value = self.network.apply(params, last_obs)

        def body(carry, t):
            gae, next_value = carry
            delta = (
                t.reward
                + self.config.gamma * next_value * (1.0 - t.done)
                - t.value
            )
            gae = (
                delta
                + self.config.gamma
                * self.config.gae_lambda
                * (1.0 - t.done)
                * gae
            )
            return (gae, t.value), gae

        _, advantages = jax.lax.scan(
            body,
            (jnp.zeros_like(last_value), last_value),
            traj,
            reverse=True,
        )
        returns = advantages + traj.value
        return advantages, returns

    # ---------------------------------------------------------------- loss
    def _loss(self, params, obs, action, old_log_prob, advantages, returns):
        mean, log_std, value = self.network.apply(params, obs)
        log_prob = gaussian_log_prob(mean, log_std, action)
        ratio = jnp.exp(log_prob - old_log_prob)

        adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1.0 - self.config.clip_eps, 1.0 + self.config.clip_eps) * adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))

        v_loss = 0.5 * jnp.mean((value - returns) ** 2)
        ent = jnp.mean(gaussian_entropy(log_std))

        total = (
            pg_loss
            + self.config.value_coef * v_loss
            - self.config.entropy_coef * ent
        )
        metrics = {
            "loss": total,
            "pg_loss": pg_loss,
            "v_loss": v_loss,
            "entropy": ent,
            "approx_kl": jnp.mean(old_log_prob - log_prob),
        }
        return total, metrics

    # ------------------------------------------------------- train iteration
    def train_iteration(self, runner: RunnerState) -> tuple[RunnerState, dict]:
        """One fused PPO update: rollout → GAE → epochs × minibatch SGD.

        Pure and jittable; shard ``runner.env_state``/``runner.obs`` over an
        ``('env',)`` mesh axis for multi-chip training.
        """
        cfg = self.config
        runner, traj = self._rollout(runner)
        advantages, returns = self._gae(runner.params, traj, runner.obs)

        # flatten (T, B, ...) -> (T*B, ...) and PACK the five SGD-phase
        # tensors into ONE (batch, F) buffer: the epoch shuffle then moves a
        # single contiguous-row array instead of a tree of narrow members.
        flat = jax.tree.map(
            lambda x: x.reshape((cfg.batch_size,) + x.shape[2:]), traj
        )
        obs_dim = flat.obs.shape[-1]
        act_dim = flat.action.shape[-1]
        packed = jnp.concatenate(
            [
                flat.obs,
                flat.action,
                flat.log_prob[:, None],
                advantages.reshape(-1, 1),
                returns.reshape(-1, 1),
            ],
            axis=1,
        )
        feat = obs_dim + act_dim + 3

        # effective block size: largest divisor of the minibatch size not
        # exceeding the target (small configs degrade gracefully toward the
        # exact per-sample permutation). gcd would under-shoot when the two
        # share few factors (16 vs 24 -> 8, not 12).
        if int(cfg.shuffle_block) < 1:
            raise ValueError(
                f"shuffle_block must be >= 1, got {cfg.shuffle_block} "
                "(1 = exact per-sample permutation)"
            )
        target = int(cfg.shuffle_block)
        if cfg.shuffle_block_auto:
            target = max(target, cfg.batch_size // 8192)
        blk = max(
            d for d in range(1, target + 1) if cfg.minibatch_size % d == 0
        )
        num_blocks = cfg.batch_size // blk

        def epoch(carry, _):
            params, opt_state, key = carry
            key, perm_key = jax.random.split(key)
            perm = jax.random.permutation(perm_key, num_blocks)

            # ONE whole-batch BLOCK gather per epoch, then the SGD scan walks
            # contiguous minibatch slices. blk=1 is the exact SB3-style
            # per-sample permutation (see PPOConfig.shuffle_block).
            mbs = _shuffle_gather(
                packed, perm, num_blocks, blk, feat,
                cfg.num_minibatches, cfg.minibatch_size,
            )

            def minibatch(carry, mb):
                params, opt_state = carry
                (loss, metrics), grads = jax.value_and_grad(
                    self._loss, has_aux=True
                )(
                    params,
                    mb[:, :obs_dim],
                    mb[:, obs_dim : obs_dim + act_dim],
                    mb[:, obs_dim + act_dim],
                    mb[:, obs_dim + act_dim + 1],
                    mb[:, obs_dim + act_dim + 2],
                )
                updates, opt_state = self.optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), metrics

            (params, opt_state), metrics = jax.lax.scan(
                minibatch, (params, opt_state), mbs
            )
            return (params, opt_state, key), metrics

        (params, opt_state, key), metrics = jax.lax.scan(
            epoch,
            (runner.params, runner.opt_state, runner.key),
            None,
            length=cfg.num_epochs,
        )
        runner = runner.replace(
            params=params,
            opt_state=opt_state,
            key=key,
            update_idx=runner.update_idx + 1,
        )
        metrics = jax.tree.map(jnp.mean, metrics)
        metrics["mean_reward"] = jnp.mean(traj.reward)
        metrics["mean_episode_done"] = jnp.mean(traj.done.astype(jnp.float32))
        return runner, metrics

    # ------------------------------------------------------------- sharding
    def shard_runner(self, runner: RunnerState, mesh) -> RunnerState:
        """Places env state/obs on P('env'), everything else replicated.

        Leaves without a num_envs-sized leading axis (e.g. the cached
        auto-reset counters) are replicated.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        env_sharding = NamedSharding(mesh, P("env"))
        replicated = NamedSharding(mesh, P())
        n = self.config.num_envs

        def shard_env(tree):
            return jax.tree.map(
                lambda x: jax.device_put(
                    x,
                    env_sharding
                    if jnp.ndim(x) >= 1 and x.shape[0] == n
                    else replicated,
                ),
                tree,
            )

        return RunnerState(
            params=jax.device_put(runner.params, replicated),
            opt_state=jax.device_put(runner.opt_state, replicated),
            env_state=shard_env(runner.env_state),
            obs=jax.device_put(runner.obs, env_sharding),
            key=jax.device_put(runner.key, replicated),
            update_idx=jax.device_put(runner.update_idx, replicated),
        )

    # ----------------------------------------------------------------- eval
    def evaluate(
        self, params: Any, key: Array, num_episodes: int = 8
    ) -> dict[str, Array]:
        """Deterministic-policy evaluation (CustomEvalCallback equivalent,
        rl_training/custom_eval_callback.py:46-108): mean/std episode reward
        and length over ``num_episodes`` fresh episodes."""
        keys = jax.random.split(key, num_episodes)
        if getattr(self.env, "native_batch", False):
            env_state, obs = self.env.reset(keys)
        else:
            env_state, obs = jax.vmap(self.env.reset)(keys)
        obs = _flat_obs(obs)

        def body(carry, _):
            env_state, obs, done, ep_rew, ep_len = carry
            action = self.act_deterministic(params, obs)
            if getattr(self.env, "native_batch", False):
                env_state, out = self.env.step(env_state, action)
            else:
                env_state, out = jax.vmap(self.env.step)(env_state, action)
            step_done = out.termination | out.truncation
            ep_rew = ep_rew + out.reward * (1.0 - done)
            ep_len = ep_len + (1.0 - done)
            done = jnp.maximum(done, step_done.astype(jnp.float32))
            return (env_state, _flat_obs(out.obs), done, ep_rew, ep_len), None

        init = (
            env_state,
            obs,
            jnp.zeros(num_episodes),
            jnp.zeros(num_episodes),
            jnp.zeros(num_episodes),
        )
        # envs first report time-limit truncation on call max_steps+2 (the
        # reference's post-increment counter), so the horizon must cover it
        if not hasattr(self.env, "max_steps"):
            raise AttributeError(
                "evaluate() needs env.max_steps to size the episode horizon; "
                f"{type(self.env).__name__} does not define it. Set a "
                "max_steps attribute on the env (the per-episode step limit)."
            )
        max_len = int(self.env.max_steps) + 2
        (_, _, done, ep_rew, ep_len), _ = jax.lax.scan(
            body, init, None, length=max_len
        )
        return {
            "mean_reward": jnp.mean(ep_rew),
            "std_reward": jnp.std(ep_rew),
            "mean_length": jnp.mean(ep_len),
            "std_length": jnp.std(ep_len),
        }
