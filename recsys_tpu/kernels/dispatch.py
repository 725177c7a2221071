"""Attention route: XLA's materialised softmax or cuDNN's fused kernel.

``sdpa`` runs ``jax.nn.dot_product_attention`` with one of its two GPU
implementations.  cuDNN's fused flash attention takes bf16 and fp16
operands only, so the route is chosen from the operand dtype and the
platform, which the code can observe; everything else (float32, the CPU)
takes XLA's materialised softmax.  Both routes keep XLA's autodiff.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_CUDNN_DTYPES = (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16))


def attention_implementation(dtype) -> str:
    """``'cudnn'`` for bf16/fp16 operands on the GPU, else ``'xla'``."""
    if jax.default_backend() == "gpu" and jnp.dtype(dtype) in _CUDNN_DTYPES:
        return "cudnn"
    return "xla"


def sdpa(q, k, v, mask=None, *, causal: bool = False,
         implementation: str | None = None):
    """Masked attention over (B, H, S, D) operands.

    ``mask`` is a (B, Sk) key-padding mask (1 = attend) or None; it may
    mark any positions, so left-padded histories are expressed exactly.
    ``implementation`` overrides the dtype-based choice (``'xla'`` or
    ``'cudnn'``).  A float32 call runs at the backend's default matmul
    precision; wrap it in ``jax.default_matmul_precision("highest")`` for
    full float32 products on the GPU.
    """
    impl = implementation or attention_implementation(q.dtype)
    sq, sk = q.shape[-2], k.shape[-2]
    m = None
    if mask is not None:
        m = mask[:, None, None, :].astype(bool)
        if impl == "cudnn":
            # cuDNN takes the mask as a bias over the full (Sq, Sk) plane
            m = jnp.broadcast_to(m, (q.shape[0], 1, sq, sk))
    out = jax.nn.dot_product_attention(
        q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), mask=m, is_causal=causal,
        implementation=impl,
    )
    return out.transpose(0, 2, 1, 3)
