"""High-level training loop: PPO over sharded on-device envs.

The reference's training entry point (rl_training/hovering/training.py) wires
SubprocVecEnv + SB3 PPO + eval callback + CSV/tensorboard logging. This is
its on-device equivalent: one jitted train iteration per loop tick, metrics
to JSONL/CSV, periodic deterministic eval, best-model + periodic ``.npz``
checkpoints, multi-device data parallelism via a 1-D ('env',) mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np

from pyflyt_tpu.rl import checkpoint
from pyflyt_tpu.rl.ppo import PPO, PPOConfig, RunnerState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_timesteps: int = 100_000_000  # training.py:86-101 budget
    eval_every_updates: int = 20
    eval_episodes: int = 16
    log_dir: str | None = None
    checkpoint_every_updates: int = 0  # 0 = only best-model checkpoints
    use_mesh: bool = False  # shard env axis over all local devices
    seed: int = 0
    # Warm start: checkpoint path whose policy/value params seed this run
    # (fresh optimizer + env states). The reference fine-tunes the same way
    # via PPO.load(path=".../best_model_*.zip") in both trajectory training
    # scripts (rl_training/trajectory_following_slow/training.py:206-211,
    # trajectory_following_fast/training.py:202-207) — its slow variant was
    # never trained from scratch, only from an 801-step-episode checkpoint.
    init_from: str | None = None
    # Polyak-averaged parameter shadow (0.0 = off). With decay d, after each
    # update ema = d*ema + (1-d)*params; at eval time BOTH parameter sets are
    # evaluated (`eval_*` vs `eval_ema_*` metric keys) and each keeps its own
    # best-model checkpoint (`best_model_*` / `best_model_ema_*`). Smooths the
    # late-training eval instability seen on trajectory_following_slow.
    param_ema: float = 0.0
    # Stop when the best eval reward (over raw and EMA params) has not
    # improved for this many consecutive evals (0 = never stop early).
    early_stop_patience: int = 0


def train(
    ppo: PPO,
    tcfg: TrainConfig = TrainConfig(),
    on_metrics: Callable[[int, dict], None] | None = None,
) -> RunnerState:
    """Runs PPO until ``total_timesteps`` env steps are consumed."""
    key = jax.random.PRNGKey(tcfg.seed)
    runner = ppo.init(key)
    if tcfg.init_from:
        runner = runner.replace(
            params=checkpoint.restore_params(tcfg.init_from, runner.params)
        )

    if tcfg.use_mesh:
        from pyflyt_tpu.parallel import env_mesh

        assert not getattr(ppo.env, "native_batch", False), (
            "native-batch (packed folded-layout) envs are single-chip: their "
            "(rows, 8, N/8) state does not shard over an ('env',) mesh — use "
            "the XLA env with use_mesh, or drop use_mesh"
        )
        mesh = env_mesh()
        assert ppo.config.num_envs % mesh.size == 0
        runner = ppo.shard_runner(runner, mesh)

    train_it = jax.jit(ppo.train_iteration, donate_argnums=(0,))
    eval_fn = jax.jit(ppo.evaluate, static_argnums=2)

    ema_params = None
    if tcfg.param_ema:
        assert 0.0 < tcfg.param_ema < 1.0, "param_ema must be in (0, 1)"
        # deep copy: train_it donates the runner, so aliasing its params
        # would leave the shadow pointing at deleted buffers
        ema_params = jax.tree.map(jnp.copy, runner.params)

        @jax.jit
        def ema_step(ema, params):
            return jax.tree.map(
                lambda e, p: tcfg.param_ema * e + (1.0 - tcfg.param_ema) * p,
                ema, params,
            )

    steps_per_update = ppo.config.batch_size
    num_updates = max(1, tcfg.total_timesteps // steps_per_update)

    log_f = None
    if tcfg.log_dir:
        os.makedirs(tcfg.log_dir, exist_ok=True)
        log_f = open(os.path.join(tcfg.log_dir, "metrics.jsonl"), "a")

    best_reward = -np.inf
    best_ema_reward = -np.inf
    evals_since_improvement = 0
    eval_history: list[dict] = []
    t_start = time.perf_counter()
    try:
        for update in range(num_updates):
            runner, metrics = train_it(runner)
            if ema_params is not None:
                ema_params = ema_step(ema_params, runner.params)

            if (update + 1) % tcfg.eval_every_updates == 0 or update == num_updates - 1:
                jax.block_until_ready(runner.params)
                eval_key = jax.random.fold_in(jax.random.PRNGKey(tcfg.seed), update)
                stats = eval_fn(runner.params, eval_key, tcfg.eval_episodes)
                stats = {k: float(v) for k, v in stats.items()}
                ema_stats = None
                if ema_params is not None:
                    ema_stats = eval_fn(ema_params, eval_key, tcfg.eval_episodes)
                    ema_stats = {k: float(v) for k, v in ema_stats.items()}
                elapsed = time.perf_counter() - t_start
                row = {
                    "update": update + 1,
                    "env_steps": (update + 1) * steps_per_update,
                    "steps_per_s": (update + 1) * steps_per_update / elapsed,
                    **{k: float(v) for k, v in metrics.items()},
                    **{f"eval_{k}": v for k, v in stats.items()},
                    **(
                        {f"eval_ema_{k}": v for k, v in ema_stats.items()}
                        if ema_stats is not None
                        else {}
                    ),
                }
                eval_history.append(row)
                if on_metrics is not None:
                    on_metrics(update + 1, row)
                if log_f:
                    log_f.write(json.dumps(row) + "\n")
                    log_f.flush()

                improved = False
                # best-model checkpoint (custom_eval_callback.py:88-105)
                if stats["mean_reward"] > best_reward:
                    best_reward = stats["mean_reward"]
                    improved = True
                    if tcfg.log_dir:
                        name = checkpoint.best_model_name(
                            update + 1,
                            stats["mean_length"],
                            stats["std_length"],
                            stats["mean_reward"],
                            stats["std_reward"],
                        )
                        checkpoint.save(os.path.join(tcfg.log_dir, name), runner)
                if ema_stats is not None and ema_stats["mean_reward"] > best_ema_reward:
                    best_ema_reward = ema_stats["mean_reward"]
                    improved = True
                    if tcfg.log_dir:
                        name = "best_model_ema" + checkpoint.best_model_name(
                            update + 1,
                            ema_stats["mean_length"],
                            ema_stats["std_length"],
                            ema_stats["mean_reward"],
                            ema_stats["std_reward"],
                        ).removeprefix("best_model")
                        checkpoint.save(
                            os.path.join(tcfg.log_dir, name),
                            runner.replace(params=ema_params),
                        )
                evals_since_improvement = (
                    0 if improved else evals_since_improvement + 1
                )
                if (
                    tcfg.early_stop_patience
                    and evals_since_improvement >= tcfg.early_stop_patience
                ):
                    break

            if (
                tcfg.checkpoint_every_updates
                and tcfg.log_dir
                and (update + 1) % tcfg.checkpoint_every_updates == 0
            ):
                checkpoint.save(
                    os.path.join(tcfg.log_dir, f"ckpt_{update + 1}"), runner
                )
    finally:
        if log_f:
            log_f.close()
        if tcfg.log_dir:
            np.savez(
                os.path.join(tcfg.log_dir, "evaluations.npz"),
                history=np.asarray(
                    [json.dumps(r) for r in eval_history], dtype=object
                ),
            )
    return runner
