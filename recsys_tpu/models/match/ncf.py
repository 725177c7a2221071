"""NCF (NeuMF): GMF branch + MLP branch, pairwise loss over sampled negatives.

Parity target: /root/reference/src/match/ncf/model.py:47-79 — separate GMF
and MLP embedding tables for users and items, GMF = elementwise product, MLP
over the concat, shared final Dense(1) over [gmf, mlp] — trained with the
pos-vs-negs objective, eval per the 101-candidate ranked protocol
(/root/reference/src/match/ncf/train.py:11-26).  The reference's unstable
log(1-sigmoid) loss (bug §2.6.12) is replaced by stable pairwise_bce.

Batch: {'user': (B,), 'pos_item': (B,), 'neg_item': (B, N)}.
``__call__`` returns {'pos_logits': (B,), 'neg_logits': (B, N)}.
``score`` scores arbitrary (user, items) pairs for eval.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.kernels import embedding as ekernels
from recsys_tpu.ops.linen import MLP


class NCF(nn.Module):
    num_users: int
    num_items: int
    gmf_dim: int = 32
    mlp_dim: int = 32
    mlp_units: Sequence[int] = (64, 32, 16)
    dropout_rate: float = 0.0

    def setup(self):
        init = nn.initializers.normal(0.05)
        self.user_gmf = self.param("user_gmf", init, (self.num_users, self.gmf_dim))
        self.item_gmf = self.param("item_gmf", init, (self.num_items, self.gmf_dim))
        self.user_mlp_t = self.param("user_mlp", init, (self.num_users, self.mlp_dim))
        self.item_mlp_t = self.param("item_mlp", init, (self.num_items, self.mlp_dim))
        self.mlp = MLP(self.mlp_units, dropout_rate=self.dropout_rate)
        self.head = nn.Dense(1)

    def score(self, users: jnp.ndarray, items: jnp.ndarray,
              *, training: bool = False) -> jnp.ndarray:
        """users (B,), items (B,) or (B, N) -> logits of the same shape."""
        squeeze = items.ndim == 1
        items2 = items[:, None] if squeeze else items  # (B, N)
        n = items2.shape[1]

        ug = ekernels.gather(self.user_gmf, users)[:, None, :]  # (B, 1, D)
        um = ekernels.gather(self.user_mlp_t, users)[:, None, :]
        ig = ekernels.gather(self.item_gmf, items2)  # (B, N, D)
        im = ekernels.gather(self.item_mlp_t, items2)

        gmf = ug * ig  # (B, N, D)
        mlp_in = jnp.concatenate(
            [jnp.broadcast_to(um, im.shape), im], axis=-1
        )
        b = users.shape[0]
        mlp_out = self.mlp(
            mlp_in.reshape(b * n, -1), training=training
        ).reshape(b, n, -1)
        logits = self.head(
            jnp.concatenate([gmf, mlp_out], axis=-1)
        )[..., 0]  # (B, N)
        return logits[:, 0] if squeeze else logits

    def __call__(self, batch: dict, *, training: bool = False) -> dict:
        return {
            "pos_logits": self.score(
                batch["user"], batch["pos_item"], training=training
            ),
            "neg_logits": self.score(
                batch["user"], batch["neg_item"], training=training
            ),
        }
