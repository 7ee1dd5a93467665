"""Checkpointing of the full training state as one ``.npz`` file.

The reference only checkpoints SB3 model zips via its eval callback
(/root/reference/PyFlyt/rl_training/custom_eval_callback.py:88-105). Here the
checkpoint covers params + optimizer state + env state + PRNG key
(SURVEY.md §5), so training resumes bit-exactly. Each leaf is stored under
its key path (``jax.tree_util.keystr``, e.g.
``.params['params']['pi_trunk']['Dense_0']['kernel']``); the file is written
to a temporary name and renamed into place, so a reader never sees a partial
checkpoint.
"""

from __future__ import annotations

import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_PARAMS = ".params"  # key-path prefix of RunnerState.params


def checkpoint_file(path: str) -> str:
    """``path`` with the ``.npz`` suffix the file carries."""
    return path if path.endswith(".npz") else path + ".npz"


def _named_leaves(tree: Any, prefix: str = "") -> dict[str, Any]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {prefix + jax.tree_util.keystr(k): v for k, v in flat}


def save_arrays(path: str, arrays: dict[str, Any]) -> str:
    """Writes named arrays atomically; returns the file written."""
    final = os.path.abspath(checkpoint_file(path))
    os.makedirs(os.path.dirname(final), exist_ok=True)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{k: np.asarray(v) for k, v in arrays.items()})
    os.replace(tmp, final)
    return final


def save(path: str, runner: Any) -> str:
    """Saves a RunnerState pytree to ``path`` (+ ``.npz``; overwrites)."""
    return save_arrays(path, _named_leaves(runner))


def _load(path: str) -> dict[str, np.ndarray]:
    with np.load(checkpoint_file(path)) as z:
        return {k: z[k] for k in z.files}


def _fill(template: Any, arrays: dict[str, np.ndarray], prefix: str) -> Any:
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    for keypath, t in flat:
        name = prefix + jax.tree_util.keystr(keypath)
        if name not in arrays:
            raise ValueError(
                f"checkpoint has no leaf {name!r} — the model or state "
                "structure differs from the one saved"
            )
        r = arrays[name]
        if tuple(np.shape(t)) != tuple(r.shape):
            raise ValueError(
                f"shape mismatch at {name}: checkpoint {r.shape} vs model "
                f"{np.shape(t)} — observation/action sizes must agree"
            )
        leaves.append(jnp.asarray(r, jnp.asarray(t).dtype))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def restore(path: str, template: Any) -> Any:
    """Restores a RunnerState saved by :func:`save`.

    ``template`` is a matching pytree (e.g. a fresh ``PPO.init`` output)
    that gives the structure, dtypes and shapes. A template built with a
    different config (another env batch, network or optimizer) raises; use
    :func:`restore_params` to recover only the policy.
    """
    return _fill(template, _load(path), "")


def restore_params(path: str, params_template: Any) -> Any:
    """Restores ONLY the ``params`` subtree of a saved RunnerState.

    Used for warm-start fine-tuning across run configs (different num_envs /
    episode horizon / optimizer state), the counterpart of the reference's
    ``PPO.load(path=".../best_model_*.zip")`` curriculum step
    (rl_training/trajectory_following_slow/training.py:206-211). The network
    must match leaf for leaf; everything else (env states, optimizer
    moments, PRNG) starts fresh.
    """
    return _fill(params_template, _load(path), _PARAMS)


def average_params(paths: list[str], params_template: Any) -> Any:
    """Uniform parameter average over several saved checkpoints.

    Classic checkpoint averaging: restore the ``params`` subtree of each
    checkpoint (same architecture required) and return the element-wise
    mean. Used to stabilize the trajectory_following_slow deterministic
    eval, whose per-checkpoint scores are high-variance late in training;
    pass several
    ``best_model_*`` checkpoints to the eval CLI to combine them.
    """
    assert paths, "average_params needs at least one checkpoint path"
    trees = [restore_params(p, params_template) for p in paths]
    return jax.tree.map(
        lambda *leaves: jnp.mean(jnp.stack(leaves), axis=0), *trees
    )


def best_model_name(idx: int, mean_len: float, std_len: float,
                    mean_rew: float, std_rew: float) -> str:
    """The reference's best-model naming convention
    (custom_eval_callback.py:88-105)."""
    return (
        f"best_model_{idx}_{mean_len:.0f}_{std_len:.0f}"
        f"_{mean_rew:.0f}_{std_rew:.0f}"
    )
