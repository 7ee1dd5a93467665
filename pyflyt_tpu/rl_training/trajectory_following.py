"""Trajectory-following PPO training / evaluation pipeline (CLI).

Batched-JAX equivalent of /root/reference/PyFlyt/rl_training/
trajectory_following_{fast,slow}/{training.py,evaluation.py}: same env
defaults and the reference's ``net_arch pi/vf=[64, 64, 32, 32]`` policy heads
(trajectory_following_fast/training.py:112-122).

Usage::

    python -m pyflyt_tpu.rl_training.trajectory_following train --variant fast \
        --num_envs 2048 --log_dir runs/traj_fast
    python -m pyflyt_tpu.rl_training.trajectory_following eval \
        --variant slow --checkpoint runs/traj_slow/best_model_*
"""

from __future__ import annotations

import argparse
import json
import math


def build_env(args):
    from pyflyt_tpu.envs.quadx_mod import (
        QuadXTrajectoryFollowingFastEnv,
        QuadXTrajectoryFollowingSlowEnv,
    )

    cls = (
        QuadXTrajectoryFollowingFastEnv
        if args.variant == "fast"
        else QuadXTrajectoryFollowingSlowEnv
    )
    return cls(
        control_hz=args.control_hz,
        flight_mode=args.flight_mode,
        noisy_motors=args.noisy_motors,
        simulate_wind=args.simulate_wind,
        flight_dome_size=args.flight_dome_size,
        max_duration_seconds=args.max_duration_seconds,
    )


def _make_ppo(args, env):
    from pyflyt_tpu.rl import PPO, PPOConfig

    lo = getattr(args, "log_std_min", None)
    hi = getattr(args, "log_std_max", None)
    log_std_range = (
        None
        if lo is None and hi is None
        else (-20.0 if lo is None else lo, 20.0 if hi is None else hi)
    )
    return PPO(
        env,
        PPOConfig(
            num_envs=getattr(args, "num_envs", 16),
            rollout_steps=getattr(args, "rollout_steps", 32),
            num_epochs=getattr(args, "n_epochs", 15),
            num_minibatches=getattr(args, "num_minibatches", 32),
            learning_rate=getattr(args, "learning_rate", 3e-4),
            clip_eps=getattr(args, "clip_eps", 0.2),
            init_log_std=getattr(args, "init_log_std", 0.0),
            log_std_range=log_std_range,
            cached_reset_refresh=getattr(args, "cached_reset_refresh", 0),
            # the reference's MlpPolicy: net_arch pi/vf=[64,64,32,32]
            # DIRECTLY on the observation — its CustomFeatureExtractor is
            # commented out (trajectory_following_fast/training.py:113-120,
            # trajectory_following_slow/training.py:136-145), so there is
            # NO wide trunk. (Round-3 note: the round-2 CLI added a 256x256
            # trunk here; that 7-tanh-deep stack trains far slower on the
            # slow variant.)
            feature_sizes=tuple(getattr(args, "feature_sizes", ()) or ()),
            pi_sizes=(64, 64, 32, 32),
            vf_sizes=(64, 64, 32, 32),
        ),
    )


def cmd_train(args):
    from pyflyt_tpu.rl import TrainConfig, train

    env = build_env(args)
    ppo = _make_ppo(args, env)
    return train(
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


def cmd_eval(args):
    import jax
    import numpy as np

    from pyflyt_tpu.rl import checkpoint

    env = build_env(args)
    ppo = _make_ppo(args, env)
    template = ppo.init(jax.random.PRNGKey(0))
    if len(args.checkpoint) == 1:
        runner = checkpoint.restore(args.checkpoint[0], template)
        params = runner.params
    else:
        # checkpoint averaging: mean of the params of several best-model
        # checkpoints (see rl/checkpoint.py:average_params)
        params = checkpoint.average_params(args.checkpoint, template.params)
        runner = template.replace(params=params)
    stats = jax.jit(ppo.evaluate, static_argnums=2)(
        params, jax.random.PRNGKey(args.seed), args.episodes
    )
    print(json.dumps({k: float(v) for k, v in stats.items()}))

    if args.log_dir:
        # one logged deterministic episode with the reference's CSV/plot
        # logger (rl_training/trajectory_following_*/evaluation.py)
        from pyflyt_tpu.utils.trajectory_logger import (
            TrajectoryFastLogger,
            TrajectorySlowLogger,
        )

        logger = (
            TrajectoryFastLogger(args.log_dir)
            if args.variant == "fast"
            else TrajectorySlowLogger(args.log_dir)
        )
        state, obs = env.reset(jax.random.PRNGKey(args.seed))
        step = jax.jit(env.step)
        i = 0
        while True:
            action = ppo.act_deterministic(runner.params, obs[None, :])[0]
            if args.variant == "fast":
                raw = np.asarray(state.state19)
            else:
                raw = np.asarray(state.state16)
                tgt = np.asarray(state.target_pos)
                psi = float(state.target_psi)
            state, out = step(state, action)
            pwm = np.asarray(state.drone.pwm)
            if args.variant == "fast":
                logger.add(i, raw, pwm, float(out.reward))
            else:
                logger.add(i, tgt, psi, raw, pwm, float(out.reward))
            i += 1
            obs = out.obs
            if bool(out.termination) or bool(out.truncation):
                break
        logger.log_episode()


# The three fixed evaluation scenarios of the reference's slow-variant
# PID-expert evaluation (rl_training/trajectory_following_slow/
# evaluation_pid_expert.py:27-83): NED start pose, (n, 4) [x, y, z, psi]
# waypoint list, base wind vector.
_EXPERT_SCENARIOS = {
    1: dict(
        start_pos=((5.0, 0.0, -5.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (4.05, 2.94, -6.0, 0), (1.55, 4.76, -7.0, 20),
                (-1.55, 4.76, -8.0, 40), (-4.05, 2.94, -9.0, 60),
                (-5.0, 0.0, -10.0, 80), (-4.05, -2.94, -9.0, 100),
                (-1.55, -4.76, -8.0, 120), (1.55, -4.76, -7.0, 140),
                (4.05, -2.94, -6.0, 160), (5.0, 0.0, -5.0, 175),
            ]
        ),
        base_wind_velocities=(-2.0, -2.0, 0.5),
    ),
    2: dict(
        start_pos=((0.0, 0.0, -5.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (0.0, 5.0, -5.0, 35), (5.0, 5.0, -5.0, 70),
                (5.0, 0.0, -5.0, 105), (0.0, 0.0, -5.0, 140),
                (0.0, 0.0, -10.0, 175), (0.0, 5.0, -10.0, 140),
                (5.0, 5.0, -10.0, 105), (5.0, 0.0, -10.0, 70),
                (0.0, 0.0, -10.0, 35), (0.0, 0.0, -5.0, 0),
            ]
        ),
        base_wind_velocities=(2.0, 2.0, -0.5),
    ),
    3: dict(
        start_pos=((5.0, 5.0, -10.0),),
        start_orn=((0.0, 0.0, 0.0),),
        waypoints=tuple(
            (x, y, z, math.radians(psi))
            for x, y, z, psi in [
                (-5.0, -5.0, -10.0, 25), (5.0, 5.0, -10.0, 50),
                (-5.0, -5.0, -10.0, 75), (5.0, 5.0, -10.0, 100),
                (-5.0, -5.0, -10.0, 125), (5.0, 5.0, -10.0, 150),
                (-5.0, -5.0, -10.0, 175), (5.0, 5.0, -10.0, 150),
                (-5.0, -5.0, -10.0, 125), (5.0, 5.0, -10.0, 100),
            ]
        ),
        base_wind_velocities=(0.0, 0.0, 0.0),
    ),
}


def cmd_eval_pid_expert(args):
    """The PID-expert baseline on the reference's fixed slow-variant scenario
    (trajectory_following_slow/evaluation_pid_expert.py:85-138): mode 10,
    unnormalized obs/actions, fixed waypoint list, gusty wind."""
    import jax
    import numpy as np

    from pyflyt_tpu.envs.quadx_mod import QuadXTrajectoryFollowingSlowEnv
    from pyflyt_tpu.envs.quadx_mod.pid_expert import trajectory_pid_expert
    from pyflyt_tpu.utils.trajectory_logger import TrajectorySlowLogger

    scen = _EXPERT_SCENARIOS[args.scenario]
    env = QuadXTrajectoryFollowingSlowEnv(
        control_hz=80,
        orn_conv="NED_FRD",
        randomize_start=False,
        random_trajectory=False,
        goal_reach_distance=0.3,
        goal_reach_angle=float(np.deg2rad(5)),
        noisy_motors=True,
        drone_model="cf2x",
        flight_mode=10,
        simulate_wind=True,
        max_gust_strength=7.0,
        flight_dome_size=100,
        max_duration_seconds=args.max_duration_seconds,
        normalize_obs=False,
        normalize_actions=False,
        **scen,
    )
    logger = TrajectorySlowLogger(args.log_dir) if args.log_dir else None
    state, obs = env.reset(jax.random.PRNGKey(args.seed))
    step = jax.jit(env.step)
    total, length = 0.0, 0
    while True:
        action = trajectory_pid_expert(state.state16)
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
    print(json.dumps({
        "episode_reward": total,
        "episode_length": length,
        "targets_reached": int(state.current_target_index),
    }))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--variant", choices=("fast", "slow"), default="fast")
        p.add_argument("--control_hz", type=int, default=80)
        p.add_argument("--flight_mode", type=int, default=9)
        p.add_argument("--noisy_motors", type=lambda v: v != "False", default=False)
        p.add_argument("--simulate_wind", type=lambda v: v != "False", default=False)
        p.add_argument("--flight_dome_size", type=float, default=100)
        p.add_argument("--max_duration_seconds", type=float, default=30.0)
        p.add_argument("--seed", type=int, default=0)

    t = sub.add_parser("train")
    add_common(t)
    t.add_argument("--num_envs", type=int, default=2048)
    t.add_argument("--rollout_steps", type=int, default=32)
    t.add_argument("--n_epochs", type=int, default=15)
    t.add_argument("--num_minibatches", type=int, default=32)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    # exploration scale; -1.6 is the solved mode-8/9 recipe (see CLAUDE.md)
    t.add_argument("--init_log_std", type=float, default=0.0)
    # hard clamp on the learned log_std (unset = free, the SB3 behavior);
    # raw-mix modes need it — see CLAUDE.md
    t.add_argument("--log_std_min", type=float, default=None)
    t.add_argument("--log_std_max", type=float, default=None)
    # amortized auto-reset period in steps (0 = exact per-step resets)
    t.add_argument("--cached_reset_refresh", type=int, default=0)
    # warm start from a saved checkpoint (the reference's PPO.load curriculum,
    # trajectory_following_slow/training.py:206-211)
    t.add_argument("--init_from", type=str, default=None)
    # optional extra trunk widths before the reference heads (empty = the
    # reference-exact MlpPolicy)
    t.add_argument("--feature_sizes", type=int, nargs="*", default=[])
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
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_common(e)
    # one checkpoint, or several to evaluate their parameter average
    e.add_argument("--checkpoint", type=str, nargs="+", required=True)
    e.add_argument("--feature_sizes", type=int, nargs="*", default=[])
    e.add_argument("--episodes", type=int, default=16)
    e.add_argument("--log_dir", type=str, default=None)
    e.set_defaults(fn=cmd_eval)

    x = sub.add_parser("eval-pid-expert")
    x.add_argument("--scenario", type=int, default=3, choices=(1, 2, 3))
    x.add_argument("--max_duration_seconds", type=float, default=30.0)
    x.add_argument("--seed", type=int, default=0)
    x.add_argument("--log_dir", type=str, default=None)
    x.set_defaults(fn=cmd_eval_pid_expert)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
