"""Hovering PPO training / evaluation pipeline (CLI).

Batched-JAX equivalent of /root/reference/PyFlyt/rl_training/hovering/
{training.py,evaluation.py,evaluation_pid_expert.py}: same env
hyperparameters and CLI shape, but the SubprocVecEnv process pool becomes a
vmapped on-device env batch and SB3 PPO becomes pyflyt_tpu.rl.PPO (one jitted
rollout+learn program, mesh-shardable).

Usage::

    python -m pyflyt_tpu.rl_training.hovering train --flight_mode 8 \
        --num_envs 2048 --total_timesteps 100000000 --log_dir runs/hover
    python -m pyflyt_tpu.rl_training.hovering eval --checkpoint runs/hover/best_model_*
    python -m pyflyt_tpu.rl_training.hovering eval-pid-expert
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_env(args, eval_scenario: bool = False, logger=None):
    from pyflyt_tpu.envs.quadx_mod import QuadXModHoveringEnv

    kwargs = dict(
        control_hz=args.control_hz,
        orn_conv=args.orn_conv,
        noisy_motors=args.noisy_motors,
        min_pwm=args.min_pwm,
        max_pwm=args.max_pwm,
        drone_model=args.drone_model,
        simulate_wind=args.simulate_wind,
        flight_mode=args.flight_mode,
        flight_dome_size=args.flight_dome_size,
        max_duration_seconds=args.max_duration_seconds,
        normalize_obs=args.normalize_obs,
        normalize_actions=args.normalize_actions,
        alpha=args.alpha,
        beta=args.beta,
        gamma=args.gamma,
        delta=args.delta,
    )
    if eval_scenario:
        # the fork's fixed eval scenario (rl_training/hovering/evaluation.py:42-68)
        kwargs.update(
            randomize_start=False,
            target_pos=(10.0, -10.0, -5.0),
            target_psi=float(np.deg2rad(-90)),
            start_pos=((19.0, -19.0, -14.0),),
            start_orn=(tuple(np.deg2rad([-10.0, 10.0, 90.0])),),
            simulate_wind=True,
            base_wind_velocities=(5.0, -5.0, -1.0),
            max_gust_strength=7.0,
            orn_conv="NED_FRD",
            control_hz=80,
        )
    return QuadXModHoveringEnv(**kwargs)


def add_env_args(p: argparse.ArgumentParser):
    """Mirrors rl_training/hovering/training.py:49-103 defaults."""
    p.add_argument("--control_hz", type=int, default=80)
    p.add_argument("--orn_conv", type=str, default="NED_FRD")
    p.add_argument("--min_pwm", type=float, default=0.0)
    p.add_argument("--max_pwm", type=float, default=1.0)
    p.add_argument("--noisy_motors", type=lambda v: v != "False", default=True)
    p.add_argument("--drone_model", type=str, default="cf2x")
    p.add_argument("--flight_mode", type=int, default=8)
    p.add_argument("--simulate_wind", type=lambda v: v != "False", default=True)
    p.add_argument("--flight_dome_size", type=float, default=100)
    p.add_argument("--max_duration_seconds", type=float, default=10.0)
    p.add_argument("--normalize_obs", type=lambda v: v != "False", default=True)
    p.add_argument("--normalize_actions", type=lambda v: v != "False", default=True)
    p.add_argument("--alpha", type=float, default=2.0)
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--gamma", type=float, default=4.0)
    p.add_argument("--delta", type=float, default=0.1)


def cmd_train(args):
    from pyflyt_tpu.rl import PPO, PPOConfig, TrainConfig, train

    env = build_env(args)
    ppo = PPO(
        env,
        PPOConfig(
            num_envs=args.num_envs,
            rollout_steps=args.rollout_steps,
            num_epochs=args.n_epochs,
            num_minibatches=args.num_minibatches,
            learning_rate=args.learning_rate,
            feature_sizes=tuple([args.layer_size] * args.num_of_layers),
            clip_eps=args.clip_eps,
            init_log_std=args.init_log_std,
            log_std_range=(
                None
                if args.log_std_min is None and args.log_std_max is None
                else (
                    -20.0 if args.log_std_min is None else args.log_std_min,
                    20.0 if args.log_std_max is None else args.log_std_max,
                )
            ),
            entropy_coef=args.entropy_coef,
            cached_reset_refresh=args.cached_reset_refresh,
        ),
    )
    runner = train(
        ppo,
        TrainConfig(
            total_timesteps=args.total_timesteps,
            eval_every_updates=args.eval_every_updates,
            eval_episodes=args.eval_episodes,
            log_dir=args.log_dir,
            use_mesh=args.use_mesh,
            seed=args.seed,
            init_from=args.init_from,
            param_ema=args.param_ema,
            early_stop_patience=args.early_stop_patience,
        ),
        on_metrics=lambda u, row: print(json.dumps(row)),
    )
    return runner


def _run_eval_episode(env, policy_fn, log_dir=None):
    """One deterministic episode on the fixed eval scenario, with the
    reference's episode logger attached (evaluation.py:42-85)."""
    import jax

    from pyflyt_tpu.utils.hovering_logger import HoveringLogger

    logger = HoveringLogger(log_dir) if log_dir else None
    state, obs = env.reset(jax.random.PRNGKey(0))
    step = jax.jit(env.step)
    total, length = 0.0, 0
    while True:
        action = policy_fn(state, obs)
        old16 = np.asarray(state.state16)
        state, out = step(state, action)
        total += float(out.reward)
        length += 1
        if logger:
            logger.add(length - 1, np.asarray(state.target_pos),
                       float(state.target_psi), old16,
                       np.asarray(state.drone.pwm), float(out.reward))
        if bool(out.termination) or bool(out.truncation):
            break
    if logger:
        logger.log_episode()
    return total, length


def cmd_eval(args):
    import jax

    from pyflyt_tpu.rl import PPO, PPOConfig, checkpoint

    env = build_env(args, eval_scenario=True)
    ppo = PPO(
        env,
        PPOConfig(feature_sizes=tuple([args.layer_size] * args.num_of_layers)),
    )
    template = ppo.init(jax.random.PRNGKey(0))
    runner = checkpoint.restore(args.checkpoint, template)

    def policy(state, obs):
        return ppo.act_deterministic(runner.params, obs[None, :])[0]

    total, length = _run_eval_episode(env, policy, args.log_dir)
    print(json.dumps({"episode_reward": total, "episode_length": length}))


def cmd_eval_pid_expert(args):
    """The PID-expert baseline on the same scenario (mode 7/10)
    (rl_training/hovering/evaluation_pid_expert.py)."""
    from pyflyt_tpu.envs.quadx_mod import hovering_pid_expert

    args.flight_mode = args.expert_mode
    args.normalize_obs = False
    args.normalize_actions = False
    env = build_env(args, eval_scenario=True)

    def policy(state, obs):
        return hovering_pid_expert(state.state16)

    total, length = _run_eval_episode(env, policy, args.log_dir)
    print(json.dumps({"episode_reward": total, "episode_length": length}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=2048)
    t.add_argument("--rollout_steps", type=int, default=32)
    t.add_argument("--n_epochs", type=int, default=15)
    t.add_argument("--num_minibatches", type=int, default=32)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    # the decisive exploration knob for the raw-mix modes 8/9 (see CLAUDE.md):
    # useful actions live in a ~±0.05 band, so SB3's default unit std never
    # leaves the tumble regime
    t.add_argument("--init_log_std", type=float, default=0.0)
    # SB3 ent_coef; negative values PENALIZE entropy — useful when the free
    # log_std inflates during training (observed on raw-PWM mode 8)
    t.add_argument("--entropy_coef", type=float, default=0.0)
    # hard clamp on the learned log_std (unset = free, the SB3 behavior)
    t.add_argument("--log_std_min", type=float, default=None)
    t.add_argument("--log_std_max", type=float, default=None)
    # amortized auto-reset period in steps (0 = exact per-step resets)
    t.add_argument("--cached_reset_refresh", type=int, default=0)
    t.add_argument("--num_of_layers", type=int, default=2)
    t.add_argument("--layer_size", type=int, default=256)
    # warm start from a saved checkpoint (the reference's PPO.load curriculum)
    t.add_argument("--init_from", type=str, default=None)
    t.add_argument("--total_timesteps", type=int, default=100_000_000)
    t.add_argument("--eval_every_updates", type=int, default=20)
    t.add_argument("--eval_episodes", type=int, default=16)
    # Polyak-averaged parameter shadow, evaluated alongside the raw params
    # (0 = off); see rl/train.py TrainConfig.param_ema
    t.add_argument("--param_ema", type=float, default=0.0)
    # stop after this many evals without a new best (0 = run the full budget)
    t.add_argument("--early_stop_patience", type=int, default=0)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--use_mesh", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--num_of_layers", type=int, default=2)
    e.add_argument("--layer_size", type=int, default=256)
    e.add_argument("--log_dir", type=str, default=None)
    e.set_defaults(fn=cmd_eval)

    x = sub.add_parser("eval-pid-expert")
    add_env_args(x)
    x.add_argument("--expert_mode", type=int, default=7, choices=(7, 10))
    x.add_argument("--log_dir", type=str, default=None)
    x.set_defaults(fn=cmd_eval_pid_expert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
