"""Vision-based Gates PPO training / evaluation pipeline (CLI).

The reference ships a vision env (QuadX-Gates) but no training pipeline
for it — and the env itself crashes upstream on a missing asset directory
(/root/reference/PyFlyt/gym_envs/quadx_envs/quadx_gates_env.py:93-94), so
this CLI is the capability the reference intended but never ran: FPV-
camera gate racing, with the ray-cast render (core/camera.py) inside the
env step and a conv policy (rl.networks.VisionActorCritic — SB3
``MultiInputPolicy`` layout) in the learner, everything on device.

Usage::

    python -m pyflyt_tpu.rl_training.gates_vision train \
        --num_envs 256 --camera_res 32 --total_timesteps 150000000 \
        --log_dir runs/gates
    python -m pyflyt_tpu.rl_training.gates_vision eval \
        --checkpoint runs/gates/best_model_*
"""

from __future__ import annotations

import argparse
import json


def build_env(args):
    from pyflyt_tpu.envs.quadx_gates import QuadXGatesEnv

    return QuadXGatesEnv(
        num_targets=args.num_targets,
        camera_resolution=(args.camera_res, args.camera_res),
        camera_fov_degrees=args.camera_fov,
        agent_hz=args.agent_hz,
    )


def build_net(args, env):
    from pyflyt_tpu.rl.networks import VisionActorCritic

    return VisionActorCritic(
        action_dim=4,
        image_offset=env.combined_size,
        image_shape=(4, args.camera_res, args.camera_res),
        conv_features=tuple(args.conv_features),
        feature_sizes=tuple([args.layer_size] * args.num_of_layers),
        init_log_std=args.init_log_std,
    )


def add_env_args(p: argparse.ArgumentParser):
    p.add_argument("--num_targets", type=int, default=5)
    p.add_argument("--camera_res", type=int, default=32)
    p.add_argument("--camera_fov", type=float, default=90.0)
    p.add_argument("--agent_hz", type=int, default=40)
    p.add_argument("--conv_features", type=int, nargs="+",
                   default=[16, 32, 32])
    p.add_argument("--layer_size", type=int, default=128)
    p.add_argument("--num_of_layers", type=int, default=1)
    p.add_argument("--init_log_std", type=float, default=-0.5)


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
            clip_eps=args.clip_eps,
            init_log_std=args.init_log_std,
            entropy_coef=args.entropy_coef,
            cached_reset_refresh=args.cached_reset_refresh,
        ),
        network=build_net(args, env),
    )
    return train(
        ppo,
        TrainConfig(
            total_timesteps=args.total_timesteps,
            eval_every_updates=args.eval_every_updates,
            eval_episodes=args.eval_episodes,
            log_dir=args.log_dir,
            seed=args.seed,
            init_from=args.init_from,
        ),
        on_metrics=lambda u, row: print(json.dumps(row)),
    )


def cmd_eval(args):
    import jax
    import numpy as np

    from pyflyt_tpu.rl import PPO, PPOConfig, checkpoint

    env = build_env(args)
    ppo = PPO(env, PPOConfig(), network=build_net(args, env))
    template = ppo.init(jax.random.PRNGKey(0))
    runner = checkpoint.restore_params(args.checkpoint, template)
    metrics = jax.jit(ppo.evaluate, static_argnums=2)(
        runner.params, jax.random.PRNGKey(args.seed), args.eval_episodes
    )
    print(json.dumps({k: float(np.asarray(v)) for k, v in metrics.items()}))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=256)
    t.add_argument("--rollout_steps", type=int, default=128)
    # 0 = exact per-step resets (repo convention). With 0 the gates rollout
    # recomputes the reset (10-step stabilization + render) every step;
    # training runs use --cached_reset_refresh 64.
    t.add_argument("--cached_reset_refresh", type=int, default=0,
                   help="reset-pool refresh period; 0 = exact per-step "
                        "resets (default), 64 = the training value")
    t.add_argument("--n_epochs", type=int, default=4)
    t.add_argument("--num_minibatches", type=int, default=8)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    t.add_argument("--entropy_coef", type=float, default=0.0)
    t.add_argument("--total_timesteps", type=int, default=150_000_000)
    t.add_argument("--eval_every_updates", type=int, default=40)
    t.add_argument("--eval_episodes", type=int, default=8)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init_from", type=str, default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--eval_episodes", type=int, default=8)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
