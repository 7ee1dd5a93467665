"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` makes a frozen dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it ``.replace(**changes)``.
A field declared with ``struct.field(pytree_node=False)`` is static: it is
part of the tree's structure (hashed into jit's cache key), not a leaf.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` with a ``pytree_node`` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls=None, /, **kwargs):
    """Frozen dataclass registered as a pytree (see module docstring)."""
    if cls is None:
        return lambda c: dataclass(c, **kwargs)
    kwargs.setdefault("frozen", True)
    cls = dataclasses.dataclass(cls, **kwargs)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )


def tree_select(mask, on_true, on_false):
    """Broadcasting ``where`` over matching pytrees (mask has batch shape)."""
    def pick(t, f):
        m = mask.reshape(mask.shape + (1,) * (jnp.ndim(f) - mask.ndim))
        return jnp.where(m, t, f)

    return jax.tree.map(pick, on_true, on_false)
