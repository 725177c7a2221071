"""Regression: every model-path op must survive TWO grad traces in one
process under two DIFFERENT jits.

A cached value built inside one trace (an ``lru_cache`` returning a jnp
array, say) leaks into the next trace of the same key and dies with
``UnexpectedTracerError``.  These tests pin re-traceability for the op
surface so no future cache can regress it.

Each op is traced via two distinct Python functions (distinct jit cache
entries → two real traces), with identical shapes/dtypes so any trace-local
cached value WOULD be reused across traces if one existed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.kernels import dispatch
from recsys_tpu.kernels import embedding as emb_ops
from recsys_tpu.kernels import interactions as int_ops


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _two_grad_traces(make_loss, *args):
    """Trace make_loss's op under jax.grad twice via two different jits and
    check the results agree (same math, fresh trace each time)."""

    def loss_a(*a):
        return make_loss(*a)

    def loss_b(*a):
        return make_loss(*a)

    g1 = jax.jit(jax.grad(loss_a))(*args)
    g2 = jax.jit(jax.grad(loss_b))(*args)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), rtol=1e-6)
    return g1


def test_dot_interaction_retrace(rng):
    # F=27: the DLRM bench's 26 fields plus the bottom-MLP vector
    x = jnp.asarray(rng.normal(size=(4, 27, 8)), jnp.float32)

    def loss(x):
        return jnp.sum(int_ops.dot_interaction(x) ** 2)

    _two_grad_traces(loss, x)


def test_dot_interaction_self_retrace(rng):
    x = jnp.asarray(rng.normal(size=(4, 11, 8)), jnp.float32)

    def loss(x):
        return jnp.sum(int_ops.dot_interaction(x, self_interaction=True))

    _two_grad_traces(loss, x)


def test_fm_pairwise_retrace(rng):
    x = jnp.asarray(rng.normal(size=(4, 9, 16)), jnp.float32)

    def loss(x):
        return jnp.sum(int_ops.fm_pairwise_vector(x))

    _two_grad_traces(loss, x)


def test_sdpa_retrace(rng):
    q, k, v = (jnp.asarray(rng.normal(size=(2, 2, 16, 8)), jnp.float32)
               for _ in range(3))
    mask = jnp.asarray(rng.random((2, 16)) > 0.25)

    def loss(q, k, v):
        return jnp.sum(dispatch.sdpa(q, k, v, mask) ** 2)

    def loss2(q, k, v):
        return jnp.sum(dispatch.sdpa(q, k, v, mask) ** 2)

    g1 = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    g2 = jax.jit(jax.grad(loss2, argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)


def test_pooled_gather_retrace(rng):
    table = jnp.asarray(rng.normal(size=(32, 128)), jnp.float32)
    rows = jnp.asarray(rng.integers(0, 32, size=(4, 6)), jnp.int32)
    mask = jnp.asarray(rng.random((4, 6)) > 0.3)

    def loss(t):
        return jnp.sum(emb_ops.segment_sum_gather(t, rows, mask) ** 2)

    _two_grad_traces(loss, table)


def test_fused_topk_retrace(rng):
    # eval-only op: two full jit traces (no grad) must both compile, agree
    # with each other and with lax.top_k on the materialised scores
    from recsys_tpu.train.retrieval import topk_scores

    q = jnp.asarray(rng.normal(size=(8, 16)), jnp.float32)
    items = jnp.asarray(rng.normal(size=(64, 16)), jnp.float32)

    v1, i1 = jax.jit(lambda a, b: topk_scores(a, b, k=4))(q, items)
    v2, i2 = jax.jit(lambda a, b: topk_scores(a, b, k=4))(q, items)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    _, want_i = jax.lax.top_k(q @ items.T, 4)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(want_i))


def test_dot_interaction_retrace_unjitted_then_jitted(rng):
    """An eager grad call (populates any trace-local cache) followed by a
    fresh jitted grad trace."""
    x = jnp.asarray(rng.normal(size=(2, 27, 4)), jnp.float32)

    def loss(x):
        return jnp.sum(int_ops.dot_interaction(x))

    g_eager = jax.grad(loss)(x)
    g_jit = jax.jit(jax.grad(loss))(x)
    np.testing.assert_allclose(np.asarray(g_eager), np.asarray(g_jit),
                               rtol=1e-6)
