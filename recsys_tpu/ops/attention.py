"""Attention modules: multi-head self-attention (AutoInt), target attention
(DIN), transformer encoder block (SASRec), positional embeddings.

One shared implementation replacing the reference's two divergent MHA copies
(/root/reference/src/ctr/layers/modules.py:177-325 — whose Q/K/V Denses were
recreated every call and never trained, bug §2.6.4 — and /root/reference/src/
match/layers/modules.py:98-131).  Projections here are persistent params;
scaling is 1/sqrt(head_dim).
"""
from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.kernels import attention as akernels
from recsys_tpu.kernels import dispatch as dkernels


def split_heads(x: jnp.ndarray, num_heads: int) -> jnp.ndarray:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, num_heads, hd // num_heads).transpose(0, 2, 1, 3)


def merge_heads(x: jnp.ndarray) -> jnp.ndarray:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, s, h * d)


class MultiHeadAttention(nn.Module):
    """Standard MHA with persistent learned projections.

    `use_residual` adds a (projected) residual as in AutoInt's interacting
    layer (/root/reference/src/ctr/layers/modules.py:285-325).
    """

    num_heads: int
    model_dim: int | None = None  # default: input dim
    use_residual: bool = True
    out_proj: bool = False
    causal: bool = False

    @nn.compact
    def __call__(
        self,
        q_in: jnp.ndarray,
        k_in: jnp.ndarray | None = None,
        v_in: jnp.ndarray | None = None,
        mask: jnp.ndarray | None = None,
    ) -> jnp.ndarray:
        k_in = q_in if k_in is None else k_in
        v_in = k_in if v_in is None else v_in
        dim = self.model_dim or q_in.shape[-1]
        q = nn.Dense(dim, use_bias=False, name="wq")(q_in)
        k = nn.Dense(dim, use_bias=False, name="wk")(k_in)
        v = nn.Dense(dim, use_bias=False, name="wv")(v_in)
        qh, kh, vh = (split_heads(t, self.num_heads) for t in (q, k, v))
        # mask contract: (B, S_k) key-padding mask (1 = attend) or None;
        # the dispatch layer picks XLA or cuDNN attention from the dtype
        out = merge_heads(dkernels.sdpa(qh, kh, vh, mask, causal=self.causal))
        if self.out_proj:
            out = nn.Dense(dim, name="wo")(out)
        if self.use_residual:
            res = q_in if q_in.shape[-1] == dim else nn.Dense(dim, name="wr")(q_in)
            out = nn.relu(out + res)
        return out


class TargetAttention(nn.Module):
    """DIN-style target attention pooling over a padded behaviour sequence.

    Semantics of the reference's purpose-built AttentionLayer
    (/root/reference/src/ctr/layers/modules.py:137-175): score each history
    item against the candidate via an MLP over [q, k, q-k, q*k], mask padding,
    softmax, weighted-sum the history.  query (B, D), keys (B, L, D),
    mask (B, L) -> (B, D).
    """

    hidden_units: tuple[int, ...] = (32, 16)
    activation: str = "sigmoid"

    @nn.compact
    def __call__(
        self, query: jnp.ndarray, keys: jnp.ndarray, mask: jnp.ndarray
    ) -> jnp.ndarray:
        L = keys.shape[1]
        q = jnp.repeat(query[:, None, :], L, axis=1)  # (B, L, D)
        feats = jnp.concatenate([q, keys, q - keys, q * keys], axis=-1)
        act = nn.sigmoid if self.activation == "sigmoid" else nn.relu
        h = feats
        for w in self.hidden_units:
            h = act(nn.Dense(w)(h))
        scores = nn.Dense(1)(h)[..., 0]  # (B, L)
        scores = jnp.where(mask.astype(bool), scores, akernels.NEG_INF)
        weights = jax_softmax_stable(scores)
        return jnp.einsum("bl,bld->bd", weights.astype(keys.dtype), keys)


def jax_softmax_stable(x: jnp.ndarray) -> jnp.ndarray:
    x = x - jnp.max(x, axis=-1, keepdims=True)
    e = jnp.exp(x)
    return e / jnp.sum(e, axis=-1, keepdims=True)


class PositionalEmbedding(nn.Module):
    """Learned positional embedding added to a (B, S, D) sequence.

    The reference SASRec omits positional embeddings and notes it
    (/root/reference/src/match/sasrec/model.py:74); the published SASRec uses
    them, so the new build includes them (parity rule SURVEY.md §2.6).
    """

    max_len: int

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        pos = self.param(
            "pos", nn.initializers.normal(0.02), (self.max_len, x.shape[-1])
        )
        return x + pos[None, : x.shape[1], :]


class TransformerBlock(nn.Module):
    """SASRec encoder block: MHA + FFN with post-LN residuals & dropout.

    Reference TransformerEncoder at /root/reference/src/match/layers/
    modules.py:152-185 (post-norm residual wiring, conv1x1 FFN == Dense).
    """

    num_heads: int = 1
    ffn_dim: int | None = None
    dropout_rate: float = 0.2
    causal: bool = False

    @nn.compact
    def __call__(
        self,
        x: jnp.ndarray,
        mask: jnp.ndarray | None = None,
        *,
        training: bool = False,
    ) -> jnp.ndarray:
        attn = MultiHeadAttention(
            num_heads=self.num_heads, use_residual=False, causal=self.causal
        )(x, x, x, mask)
        attn = nn.Dropout(self.dropout_rate, deterministic=not training)(attn)
        x = nn.LayerNorm()(x + attn)
        ffn_dim = self.ffn_dim or x.shape[-1]
        h = nn.relu(nn.Dense(ffn_dim)(x))
        h = nn.Dense(x.shape[-1])(h)
        h = nn.Dropout(self.dropout_rate, deterministic=not training)(h)
        return nn.LayerNorm()(x + h)
