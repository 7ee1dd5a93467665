"""Actor-critic policy networks.

Replaces the reference's SB3 ``MlpPolicy`` + ``CustomFeatureExtractor``
(/root/reference/PyFlyt/rl_training/custom_feature_extractor.py:14-26: a
2×256 tanh MLP) with plain-JAX init/apply pairs: shared feature extractor, separate
policy/value heads (net_arch mirrors the SB3 ``pi``/``vf`` lists — the
trajectory-following recipes use [64, 64, 32, 32],
rl_training/trajectory_following_fast/training.py:112-122), diagonal
Gaussian action head with state-independent log-std (SB3's default for Box
action spaces).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import jax
import jax.numpy as jnp
from jax import Array

_orthogonal = jax.nn.initializers.orthogonal


def _dense_init(key, din: int, dout: int, scale: float) -> dict:
    return {
        "kernel": _orthogonal(scale)(key, (din, dout), jnp.float32),
        "bias": jnp.zeros((dout,), jnp.float32),
    }


def _dense(p: dict, x: Array, dtype) -> Array:
    return x.astype(dtype) @ p["kernel"].astype(dtype) + p["bias"].astype(dtype)


@dataclasses.dataclass(frozen=True)
class MLP:
    """tanh MLP; params ``{"Dense_i": {"kernel", "bias"}}``."""

    sizes: Sequence[int]
    activate_last: bool = True
    dtype: Any = jnp.float32  # computation dtype (params stay float32)

    def init(self, key: Array, din: int) -> dict:
        keys = jax.random.split(key, len(self.sizes))
        params = {}
        for i, size in enumerate(self.sizes):
            params[f"Dense_{i}"] = _dense_init(keys[i], din, size, jnp.sqrt(2.0))
            din = size
        return params

    def apply(self, params: dict, x: Array) -> Array:
        for i in range(len(self.sizes)):
            x = _dense(params[f"Dense_{i}"], x, self.dtype)
            if self.activate_last or i < len(self.sizes) - 1:
                x = jnp.tanh(x)
        return x


class _Heads:
    """Separate pi/vf trunks over a feature vector, a linear mean head, a
    state-independent log-std and a scalar value head (mixin: the
    subclasses declare the fields)."""

    def _trunks(self):
        pi = MLP((*self.feature_sizes, *self.pi_sizes), dtype=self.dtype)
        vf = MLP((*self.feature_sizes, *self.vf_sizes), dtype=self.dtype)
        return pi, vf

    def init_heads(self, key: Array, din: int) -> dict:
        pi, vf = self._trunks()
        k = jax.random.split(key, 4)
        return {
            "pi_trunk": pi.init(k[0], din),
            "pi_head": _dense_init(k[1], pi.sizes[-1], self.action_dim, 0.01),
            "log_std": jnp.full((self.action_dim,), self.init_log_std, jnp.float32),
            "vf_trunk": vf.init(k[2], din),
            "vf_head": _dense_init(k[3], vf.sizes[-1], 1, 1.0),
        }

    def apply_heads(self, p: dict, feat: Array) -> tuple[Array, Array, Array]:
        pi, vf = self._trunks()
        mean = _dense(p["pi_head"], pi.apply(p["pi_trunk"], feat), self.dtype)
        log_std = p["log_std"]
        if self.log_std_range is not None:
            log_std = jnp.clip(log_std, *self.log_std_range)
        value = _dense(p["vf_head"], vf.apply(p["vf_trunk"], feat), self.dtype)
        mean = mean.astype(jnp.float32)
        value = value.astype(jnp.float32)
        return mean, jnp.broadcast_to(log_std, mean.shape), value[..., 0]


@dataclasses.dataclass(frozen=True)
class ActorCritic(_Heads):
    """Separate actor/critic tanh MLPs + diagonal Gaussian policy.

    Separate trunks match SB3's effective default (independent ``pi``/``vf``
    nets inside ``MlpExtractor``) and keep the enormous early value loss
    (±100-scale returns in these envs) from wrecking the policy features.
    ``pi_sizes``/``vf_sizes`` append extra head layers as in SB3's
    ``net_arch`` lists.

    ``init(key, obs)`` returns ``{"params": {...}}`` and ``apply(params,
    obs)`` returns ``(action_mean, log_std, value)``.
    """

    action_dim: int
    feature_sizes: Sequence[int] = (256, 256)
    pi_sizes: Sequence[int] = ()
    vf_sizes: Sequence[int] = ()
    init_log_std: float = 0.0
    # optional (min, max) clamp on the learned log_std. SB3 leaves the
    # parameter free; on raw-actuator envs (QuadX mode 8) the free std
    # inflates mid-training and destroys the policy — a hard range keeps
    # exploration inside the useful action band. None = unclamped.
    log_std_range: tuple[float, float] | None = None
    # matmul computation dtype; parameters, gradients and Adam state stay
    # float32, and outputs are cast back to float32 for the loss
    dtype: Any = jnp.float32

    def init(self, key: Array, obs: Array) -> dict:
        return {"params": self.init_heads(key, obs.shape[-1])}

    def apply(self, params: dict, obs: Array) -> tuple[Array, Array, Array]:
        return self.apply_heads(params["params"], obs)


def _conv_init(key: Array, cin: int, features: int) -> dict:
    init = jax.nn.initializers.lecun_normal()
    return {
        "kernel": init(key, (3, 3, cin, features), jnp.float32),
        "bias": jnp.zeros((features,), jnp.float32),
    }


def _strided_conv(p: dict, x: Array, dtype) -> Array:
    """One 3x3 stride-2 SAME conv (NHWC, any leading batch dims)."""
    kernel = p["kernel"].astype(dtype)
    x = x.astype(dtype)
    lead = x.shape[:-3]
    x2 = x.reshape((-1,) + x.shape[-3:])
    out = jax.lax.conv_general_dilated(
        x2, kernel, (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + p["bias"].astype(dtype)
    return out.reshape(*lead, *out.shape[1:])


@dataclasses.dataclass(frozen=True)
class VisionActorCritic(_Heads):
    """Actor-critic for image+vector dict observations (the Gates task).

    Consumes the FLAT observation vector PPO's ``_flat_obs`` builds from a
    dict env (keys sorted, each flattened) and re-slices the image out:
    ``[..., :image_offset)`` and ``[..., image_offset+C·H·W:)`` are vector
    features, the middle is the raw uint8-valued ``rgba_cam`` (4, H, W)
    scaled by 1/255 in here. A shared conv encoder (params ``Conv_i``)
    feeds separate pi/vf dense trunks — SB3's ``MultiInputPolicy`` layout
    (CombinedExtractor image branch + ``share_features_extractor=True``
    default) that the reference's vision env would use if it ran
    (/root/reference/PyFlyt/gym_envs/quadx_envs/quadx_gates_env.py:64-79
    declares the dict space; the env itself crashes upstream on a bad
    asset path, :93-94).

    The conv stack is a reduced NatureCNN (stride-2 convs sized for
    32-64 px FPV frames rather than 84 px Atari).
    """

    action_dim: int
    image_offset: int  # flat index where the image block starts
    image_shape: tuple  # (C, H, W) as stored channels-first by the env
    conv_features: Sequence[int] = (16, 32, 32)
    feature_sizes: Sequence[int] = (128,)
    pi_sizes: Sequence[int] = ()
    vf_sizes: Sequence[int] = ()
    init_log_std: float = 0.0
    log_std_range: tuple[float, float] | None = None
    dtype: Any = jnp.float32

    def _split(self, obs: Array) -> tuple[Array, Array]:
        c, h, w = self.image_shape
        i0, n = self.image_offset, c * h * w
        vec = jnp.concatenate([obs[..., :i0], obs[..., i0 + n :]], axis=-1)
        img = obs[..., i0 : i0 + n].reshape(*obs.shape[:-1], c, h, w)
        # NCHW -> NHWC, rank-generically (any number of leading batch dims)
        return jnp.moveaxis(img.astype(self.dtype) / 255.0, -3, -1), vec

    def init(self, key: Array, obs: Array) -> dict:
        c, h, w = self.image_shape
        keys = jax.random.split(key, len(self.conv_features) + 1)
        params, cin = {}, c
        for i, f in enumerate(self.conv_features):
            params[f"Conv_{i}"] = _conv_init(keys[i], cin, f)
            cin, h, w = f, -(-h // 2), -(-w // 2)  # SAME stride-2 extent
        c0, h0, w0 = self.image_shape
        din = cin * h * w + obs.shape[-1] - c0 * h0 * w0
        params.update(self.init_heads(keys[-1], din))
        return {"params": params}

    def apply(self, params: dict, obs: Array) -> tuple[Array, Array, Array]:
        p = params["params"]
        x, vec = self._split(obs)
        for i in range(len(self.conv_features)):
            x = jax.nn.relu(_strided_conv(p[f"Conv_{i}"], x, self.dtype))
        x = x.reshape(*x.shape[:-3], -1)
        feat = jnp.concatenate([x, vec.astype(self.dtype)], axis=-1)
        return self.apply_heads(p, feat)


def gaussian_log_prob(mean: Array, log_std: Array, action: Array) -> Array:
    """Diagonal Gaussian log-density, summed over action dims."""
    var = jnp.exp(2.0 * log_std)
    lp = -0.5 * ((action - mean) ** 2 / var + 2.0 * log_std + jnp.log(2.0 * jnp.pi))
    return jnp.sum(lp, axis=-1)


def gaussian_entropy(log_std: Array) -> Array:
    return jnp.sum(log_std + 0.5 * jnp.log(2.0 * jnp.pi * jnp.e), axis=-1)
