"""Dense-tower math as pure functions over explicit param dicts.

``mlp_init`` / ``mlp_apply`` are the flax-free MLP the DLRM path uses.
Params keep flax's layout (``{"Dense_0": {"kernel", "bias"}, ...}``,
kernel (in, out), bias (out,)) and init (LeCun-normal kernel, zero bias),
so trees written by either side line up.  The flax modules for the other
models live in :mod:`recsys_tpu.ops.linen`.
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

_lecun_normal = jax.nn.initializers.lecun_normal()


def resolve_activation(name: str | Callable) -> Callable:
    """Map an activation name to a callable; 'dice'/'prelu' need modules."""
    if callable(name):
        return name
    table = {
        "relu": jax.nn.relu,
        "sigmoid": jax.nn.sigmoid,
        "tanh": jnp.tanh,
        "gelu": jax.nn.gelu,
        "swish": jax.nn.swish,
        "linear": lambda x: x,
        "identity": lambda x: x,
    }
    return table[name]


def dense_init(key, in_dim: int, out_dim: int) -> dict:
    return {
        "kernel": _lecun_normal(key, (in_dim, out_dim), jnp.float32),
        "bias": jnp.zeros((out_dim,), jnp.float32),
    }


def dense_apply(p: dict, x: jnp.ndarray, dtype=None) -> jnp.ndarray:
    """``x @ kernel + bias``; ``dtype`` casts inputs and params to the
    compute dtype (flax ``nn.Dense(dtype=...)`` semantics)."""
    k, b = p["kernel"], p["bias"]
    if dtype is not None:
        x, k, b = x.astype(dtype), k.astype(dtype), b.astype(dtype)
    return jnp.dot(x, k) + b


def mlp_init(key, in_dim: int, hidden_units: Sequence[int],
             out_dim: int) -> dict:
    """Params of ``len(hidden_units)`` activated layers and one linear
    ``out_dim`` projection."""
    dims = [in_dim, *hidden_units, out_dim]
    keys = jax.random.split(key, len(dims) - 1)
    return {
        f"Dense_{i}": dense_init(keys[i], dims[i], dims[i + 1])
        for i in range(len(dims) - 1)
    }


def mlp_apply(params: dict, x: jnp.ndarray, *,
              activation: str | Callable = "relu",
              dropout_rate: float = 0.0, training: bool = False,
              rng=None, dtype=None) -> jnp.ndarray:
    """Activated hidden layers, each followed by dropout in training
    (needs ``rng``), then the linear output layer."""
    act = resolve_activation(activation)
    n_hidden = len(params) - 1
    for i in range(n_hidden):
        x = act(dense_apply(params[f"Dense_{i}"], x, dtype))
        if dropout_rate > 0.0 and training:
            if rng is None:
                raise ValueError("dropout in training needs an rng")
            rng, sub = jax.random.split(rng)
            keep = jax.random.bernoulli(sub, 1.0 - dropout_rate, x.shape)
            x = jnp.where(keep, x / (1.0 - dropout_rate), 0.0).astype(x.dtype)
    return dense_apply(params[f"Dense_{n_hidden}"], x, dtype)
