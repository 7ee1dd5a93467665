"""Self-play dogfight PPO training / evaluation pipeline (CLI).

The reference ships the MA fixedwing dogfight as a PettingZoo env with no
training pipeline at all; this CLI trains it by SELF-PLAY through the
standard single-agent PPO — both drones of every arena are rows of one
flat agent batch driven by the same policy, stepped by the fused dogfight
kernel (envs/packed_dogfight.py, envs/selfplay_dogfight.py).

Usage::

    python -m pyflyt_tpu.rl_training.dogfight_selfplay train \
        --num_envs 4096 --total_timesteps 500000000 --log_dir runs/dogfight
    python -m pyflyt_tpu.rl_training.dogfight_selfplay eval-vs \
        --checkpoint runs/dogfight/best_model_* [--opponent <ckpt>]

``eval-vs`` pits the checkpoint (drone 0) against an opponent policy
(drone 1): another checkpoint if given, else the UNTRAINED init — and
reports win rate (higher end-of-match health) and mean health margin
over full matches.
"""

from __future__ import annotations

import argparse
import json


def build_env(args):
    from pyflyt_tpu.envs.ma_fixedwing_dogfight import MAFixedwingDogfightEnv
    from pyflyt_tpu.envs.packed_dogfight import PackedMAFixedwingDogfightEnv
    from pyflyt_tpu.envs.selfplay_dogfight import SelfPlayDogfightEnv

    base = MAFixedwingDogfightEnv(
        sparse_reward=args.sparse_reward,
        damage_per_hit=args.damage_per_hit,
        max_duration_seconds=args.max_duration_seconds,
        agent_hz=args.agent_hz,
        noisy_motors=args.noisy_motors,
    )
    return SelfPlayDogfightEnv(penv=PackedMAFixedwingDogfightEnv(base=base))


def add_env_args(p: argparse.ArgumentParser):
    p.add_argument("--sparse_reward", type=lambda v: v != "False",
                   default=False)
    # motor noise (the reference default)
    p.add_argument("--noisy_motors", type=lambda v: v != "False",
                   default=True)
    p.add_argument("--damage_per_hit", type=float, default=0.02)
    p.add_argument("--max_duration_seconds", type=float, default=60.0)
    p.add_argument("--agent_hz", type=int, default=30)
    # 0 = exact per-step arena resets (repo convention: exact semantics by
    # default). 64 amortizes the arena-spawn work over a reset pool and is
    # the value training runs used; pass --cached_reset_refresh 64.
    p.add_argument("--cached_reset_refresh", type=int, default=0,
                   help="reset-pool refresh period; 0 = exact per-step "
                        "resets (default), 64 = the training value")
    p.add_argument("--layer_size", type=int, default=256)
    p.add_argument("--num_of_layers", type=int, default=2)
    p.add_argument("--init_log_std", type=float, default=-1.0)


def mk_ppo(args, env):
    from pyflyt_tpu.rl import PPO, PPOConfig

    return PPO(
        env,
        PPOConfig(
            num_envs=args.num_envs,
            rollout_steps=args.rollout_steps,
            num_epochs=args.n_epochs,
            num_minibatches=args.num_minibatches,
            learning_rate=args.learning_rate,
            clip_eps=args.clip_eps,
            entropy_coef=args.entropy_coef,
            init_log_std=args.init_log_std,
            feature_sizes=tuple([args.layer_size] * args.num_of_layers),
            # arenas reset mid-rollout many times early on: the slot
            # bootstrap's one-truncation invariant doesn't hold here
            slot_bootstrap=False,
            # amortized arena-spawn pool (selfplay_dogfight.
            # cached_autoreset_step); 0 = exact per-step resets
            cached_reset_refresh=args.cached_reset_refresh,
        ),
    )


def cmd_train(args):
    from pyflyt_tpu.rl import TrainConfig, train

    env = build_env(args)
    ppo = mk_ppo(args, env)
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


def evaluate_versus(env, apply_a, apply_b, key, num_matches):
    """Full matches of policy A (drone 0) vs policy B (drone 1) on the
    packed kernel; returns win/loss/draw rates by end-of-match health and
    the mean health margin for A."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    penv = env.penv
    keys = jax.random.split(key, num_matches)

    @jax.jit
    def run(keys):
        st, obs = penv.reset(keys)

        def body(carry, _):
            st, obs, done, health_end, dead_end = carry
            act = jnp.stack(
                [apply_a(obs[:, 0]), apply_b(obs[:, 1])], axis=1
            )
            st, out = penv.step(st, act)
            own_done = out.termination | out.truncation
            now = jnp.any(own_done, axis=1)
            fresh = (now & ~done)[:, None]
            healths = out.info["healths"][:, 0, :]  # (N, 2)
            health_end = jnp.where(fresh, healths, health_end)
            # who actually DIED: shot down, collided, or flew out of the
            # dome. NOT the termination flag — the env terminates the
            # SURVIVOR via other_dead when its opponent's health empties
            # (ma_fixedwing_dogfight.py:357), which would invert the score
            dead_now = (
                (healths <= 0.0)
                | out.info["collision"]
                | out.info["out_of_bounds"]
            )
            dead_end = jnp.where(fresh, dead_now, dead_end)
            return (st, out.obs, done | now, health_end, dead_end), None

        init = (
            st,
            obs,
            jnp.zeros(num_matches, bool),
            jnp.ones((num_matches, 2)),
            jnp.zeros((num_matches, 2), bool),
        )
        (st, obs, done, health_end, dead_end), _ = jax.lax.scan(
            body, init, None, length=env.max_steps + 2
        )
        return done, health_end, dead_end

    done, health_end, dead_end = run(keys)
    done = np.asarray(done)
    h = np.asarray(health_end)
    dead = np.asarray(dead_end)
    margin = h[:, 0] - h[:, 1]
    # primary: who died at match end; health margin breaks survivor ties
    wins = (dead[:, 1] & ~dead[:, 0]) | (
        (dead[:, 1] == dead[:, 0]) & (margin > 1e-6)
    )
    losses = (dead[:, 0] & ~dead[:, 1]) | (
        (dead[:, 0] == dead[:, 1]) & (margin < -1e-6)
    )
    return {
        "matches": int(num_matches),
        "finished": int(done.sum()),
        "win_rate_a": float(wins.mean()),
        "loss_rate_a": float(losses.mean()),
        "draw_rate": float((~wins & ~losses).mean()),
        "mean_health_margin_a": float(np.mean(margin)),
        "a_died": int(dead[:, 0].sum()),
        "b_died": int(dead[:, 1].sum()),
    }


def cmd_eval_vs(args):
    import jax

    from pyflyt_tpu.rl import checkpoint

    env = build_env(args)
    ppo = mk_ppo(args, env)
    template = ppo.init(jax.random.PRNGKey(0))
    params_a = checkpoint.restore_params(
        args.checkpoint, template
    ).params
    if args.opponent:
        params_b = checkpoint.restore_params(
            args.opponent, template
        ).params
    else:
        params_b = template.params  # the untrained init

    apply_a = lambda o: ppo.act_deterministic(params_a, o)  # noqa: E731
    apply_b = lambda o: ppo.act_deterministic(params_b, o)  # noqa: E731
    out = evaluate_versus(
        env, apply_a, apply_b, jax.random.PRNGKey(args.seed),
        args.num_matches,
    )
    print(json.dumps(out))
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    add_env_args(t)
    t.add_argument("--num_envs", type=int, default=4096,
                   help="agent ROWS (= 2x arenas); arenas must be %% 8")
    t.add_argument("--rollout_steps", type=int, default=128)
    t.add_argument("--n_epochs", type=int, default=4)
    t.add_argument("--num_minibatches", type=int, default=16)
    t.add_argument("--learning_rate", type=float, default=3e-4)
    t.add_argument("--clip_eps", type=float, default=0.2)
    t.add_argument("--entropy_coef", type=float, default=0.0)
    t.add_argument("--total_timesteps", type=int, default=500_000_000)
    t.add_argument("--eval_every_updates", type=int, default=50)
    t.add_argument("--eval_episodes", type=int, default=16)
    t.add_argument("--log_dir", type=str, default=None)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--init_from", type=str, default=None)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval-vs")
    add_env_args(e)
    e.add_argument("--checkpoint", type=str, required=True)
    e.add_argument("--opponent", type=str, default=None)
    e.add_argument("--num_matches", type=int, default=64)
    e.add_argument("--seed", type=int, default=0)
    e.set_defaults(fn=cmd_eval_vs)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
