"""Feature-interaction modules: FM, CrossNetwork, ResidualUnit, SENet.

One shared implementation replacing the reference's duplicated per-package
layers (SURVEY.md §1 duplication note).  All modules are pure functions of
their params (flax.linen), jit/pjit-safe, static shapes only.
"""
from __future__ import annotations


import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.kernels import interactions as ikernels


class FMInteraction(nn.Module):
    """First-order + second-order FM over field embeddings.

    Fixes reference bug §2.6.3 (/root/reference/src/ctr/layers/modules.py:65
    collapses the first-order term over the whole batch): here the
    first-order weight produces a per-example scalar.

    Inputs: field_embs (B, F, D) and optionally the same fields' first-order
    inputs (B, F) — when omitted, a per-field bias embedding path is used.
    Returns (B,) logits contribution.
    """

    use_first_order: bool = True

    @nn.compact
    def __call__(
        self, field_embs: jnp.ndarray, first_order_inputs: jnp.ndarray | None = None
    ) -> jnp.ndarray:
        second = ikernels.fm_pairwise(field_embs)
        if not self.use_first_order:
            return second
        if first_order_inputs is None:
            first_order_inputs = jnp.ones(field_embs.shape[:2], field_embs.dtype)
        w = self.param(
            "w_first", nn.initializers.normal(0.01), (field_embs.shape[1],)
        )
        b = self.param("bias", nn.initializers.zeros, ())
        first = first_order_inputs @ w + b  # (B,)
        return first + second


class CrossNetwork(nn.Module):
    """DCN explicit feature crossing: x_{l+1} = x0 * (x_l . w_l) + b_l + x_l.

    Reference semantics at /root/reference/src/ctr/layers/modules.py:74-112
    (rank-1 DCN-v1 crossing with per-depth weight/bias vectors).
    """

    num_layers: int = 2

    @nn.compact
    def __call__(self, x0: jnp.ndarray) -> jnp.ndarray:
        dim = x0.shape[-1]
        x = x0
        for i in range(self.num_layers):
            w = self.param(f"w{i}", nn.initializers.normal(0.01), (dim,))
            b = self.param(f"b{i}", nn.initializers.zeros, (dim,))
            x = x0 * (x @ w)[:, None] + b + x
        return x


class ResidualUnit(nn.Module):
    """DeepCrossing residual block: x + Dense(relu(Dense(x))), relu on output.

    Reference at /root/reference/src/ctr/layers/modules.py:15-34.
    """

    hidden_dim: int

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        h = nn.relu(nn.Dense(self.hidden_dim)(x))
        h = nn.Dense(x.shape[-1])(h)
        return nn.relu(x + h)


class SEBlock(nn.Module):
    """Squeeze-and-excitation over the field axis.

    Reference SELayer at /root/reference/src/match/layers/modules.py:293-315,
    with bug §2.6.6 fixed (second Dense is a proper owned submodule).
    field_embs (B, F, D) -> re-weighted (B, F, D).
    """

    reduction: int = 2

    @nn.compact
    def __call__(self, field_embs: jnp.ndarray) -> jnp.ndarray:
        num_fields = field_embs.shape[1]
        squeeze = jnp.mean(field_embs, axis=-1)  # (B, F) GAP over embed dim
        h = nn.relu(nn.Dense(max(1, num_fields // self.reduction))(squeeze))
        weights = nn.sigmoid(nn.Dense(num_fields)(h))  # (B, F)
        return field_embs * weights[..., None]


class DotInteraction(nn.Module):
    """DLRM pairwise dot-interaction (stateless wrapper over the kernel)."""

    self_interaction: bool = False

    def __call__(self, vectors: jnp.ndarray) -> jnp.ndarray:
        return ikernels.dot_interaction(
            vectors, self_interaction=self.self_interaction
        )


class LinearLogit(nn.Module):
    """Wide/linear part: dense features -> scalar logit (per example)."""

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return nn.Dense(1)(x)[..., 0]
