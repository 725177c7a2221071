"""The model path's compute ops (interactions, attention, pooled gather,
top-k) against float64 numpy references: forward AND gradients (XLA's
autodiff of the plain ops)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.kernels import dispatch
from recsys_tpu.kernels import embedding as emb_ops
from recsys_tpu.kernels import interactions as int_ops


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _attention64(q, k, v, mask):
    """float64 masked softmax attention and the backward of sum(out**2).

    mask broadcastable to (B, H, Sq, Sk); every query row keeps at least
    one visible key.  Returns (out, (dq, dk, dv))."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * scale
    s = np.where(mask, s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    out = np.einsum("bhqk,bhkd->bhqd", p, v)
    d_out = 2.0 * out
    dv = np.einsum("bhqk,bhqd->bhkd", p, d_out)
    dp = np.einsum("bhqd,bhkd->bhqk", d_out, v)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))
    dq = np.einsum("bhqk,bhkd->bhqd", ds, k) * scale
    dk = np.einsum("bhqk,bhqd->bhkd", ds, q) * scale
    return out, (dq, dk, dv)


def _sdpa_grads(q, k, v, mask, causal):
    def loss(q, k, v):
        return jnp.sum(dispatch.sdpa(q, k, v, mask, causal=causal) ** 2)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def test_fm_vector_forward_and_grad(rng):
    x = jnp.asarray(rng.normal(size=(12, 9, 16)), jnp.float32)
    x64 = np.asarray(x, np.float64)
    s = x64.sum(axis=1)
    want = 0.5 * (s ** 2 - (x64 ** 2).sum(axis=1))
    got = int_ops.fm_pairwise_vector(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def loss(x):
        return jnp.sum(jnp.sin(int_ops.fm_pairwise_vector(x)))

    # d/dx_fd sum(sin(y)) = cos(y_d) * (sum_f' x_f'd - x_fd)
    want_g = np.cos(want)[:, None, :] * (s[:, None, :] - x64)
    np.testing.assert_allclose(jax.grad(loss)(x), want_g, rtol=1e-3,
                               atol=1e-4)


def test_dot_interaction_forward_and_grad(rng):
    x = jnp.asarray(rng.normal(size=(8, 11, 8)), jnp.float32)
    x64 = np.asarray(x, np.float64)
    gram = np.einsum("bfd,bgd->bfg", x64, x64)
    rows, cols = np.tril_indices(11, k=-1)
    got = int_ops.dot_interaction(x)
    np.testing.assert_allclose(got, gram[:, rows, cols], rtol=1e-4,
                               atol=1e-4)

    g = rng.normal(size=got.shape)

    def loss(x):
        return jnp.sum(int_ops.dot_interaction(x) * jnp.asarray(g, x.dtype))

    sym = np.zeros((8, 11, 11))
    sym[:, rows, cols] = g
    sym = sym + sym.transpose(0, 2, 1)
    np.testing.assert_allclose(
        jax.grad(loss)(x), np.einsum("bfg,bgd->bfd", sym, x64),
        rtol=1e-3, atol=1e-4,
    )
    # self-interaction variant: the inclusive triangle
    rs, cs = np.tril_indices(11, k=0)
    np.testing.assert_allclose(
        int_ops.dot_interaction(x, self_interaction=True), gram[:, rs, cs],
        rtol=1e-4, atol=1e-4,
    )


def test_sdpa_forward_and_grad(rng):
    B, H, S, D = 2, 2, 40, 16
    q, k, v = (jnp.asarray(rng.normal(size=(B, H, S, D)), jnp.float32)
               for _ in range(3))
    mask = jnp.asarray(rng.random((B, S)) > 0.25).at[:, 0].set(True)
    want, want_g = _attention64(q, k, v, np.asarray(mask)[:, None, None, :])
    with jax.default_matmul_precision("highest"):
        got = dispatch.sdpa(q, k, v, mask)
        got_g = _sdpa_grads(q, k, v, mask, False)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_sdpa_precision_knob(rng):
    """Under ``default_matmul_precision("highest")`` the attention route
    runs full float32 products: gradients within 1e-4 of float64."""
    B, H, S, D = 2, 2, 40, 16
    q, k, v = (jnp.asarray(rng.normal(size=(B, H, S, D)), jnp.float32)
               for _ in range(3))
    mask = jnp.asarray(rng.random((B, S)) > 0.25).at[:, 0].set(True)
    _, want_g = _attention64(q, k, v, np.asarray(mask)[:, None, None, :])
    with jax.default_matmul_precision("highest"):
        got_g = _sdpa_grads(q, k, v, mask, False)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_sdpa_causal(rng):
    B, H, S, D = 1, 1, 24, 8
    q, k, v = (jnp.asarray(rng.normal(size=(B, H, S, D)), jnp.float32)
               for _ in range(3))
    causal = np.arange(S)[:, None] >= np.arange(S)[None, :]
    want, _ = _attention64(q, k, v, causal[None, None])
    with jax.default_matmul_precision("highest"):
        got = dispatch.sdpa(q, k, v, None, causal=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean", "sqrtn"])
def test_segment_sum_gather_forward_and_grad(rng, mode):
    table = jnp.asarray(rng.normal(size=(50, 8)), jnp.float32)
    rows = rng.integers(0, 50, (13, 7))
    mask = rng.random((13, 7)) > 0.4
    m = mask.astype(np.float64)
    count = np.maximum(m.sum(axis=1, keepdims=True), 1.0)
    w = {"sum": m, "mean": m / count, "sqrtn": m / np.sqrt(count)}[mode]
    t64 = np.asarray(table, np.float64)
    want = np.einsum("bl,bld->bd", w, t64[rows])
    got = emb_ops.segment_sum_gather(table, jnp.asarray(rows, jnp.int32),
                                     jnp.asarray(mask), mode=mode)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    g = rng.normal(size=want.shape)

    def loss(t):
        return jnp.sum(emb_ops.segment_sum_gather(
            t, jnp.asarray(rows, jnp.int32), jnp.asarray(mask), mode=mode
        ) * jnp.asarray(g, jnp.float32))

    want_g = np.zeros_like(t64)
    np.add.at(want_g, rows.reshape(-1),
              (w[..., None] * g[:, None, :]).reshape(-1, 8))
    np.testing.assert_allclose(jax.grad(loss)(table), want_g, rtol=1e-3,
                               atol=1e-4)


def test_fused_topk_matches_dense(rng):
    """Brute-force top-k (values and indices) against a float64 argsort."""
    from recsys_tpu.train.retrieval import topk_scores

    q = jnp.asarray(rng.normal(size=(24, 8)), jnp.float32)
    items = jnp.asarray(rng.normal(size=(130, 8)), jnp.float32)
    scores = np.asarray(q, np.float64) @ np.asarray(items, np.float64).T
    want_i = np.argsort(-scores, axis=1, kind="stable")[:, :7]
    with jax.default_matmul_precision("highest"):
        dv, di = topk_scores(q, items, k=7)
    np.testing.assert_array_equal(np.asarray(di), want_i)
    np.testing.assert_allclose(
        np.asarray(dv), np.take_along_axis(scores, want_i, axis=1),
        rtol=1e-5, atol=1e-5,
    )


def test_dlrm_bf16_compute_close_to_f32(rng):
    import jax

    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM

    schema, data = synthetic_ctr(num_examples=16, num_dense=4, num_sparse=5,
                                 vocab_size=11, embed_dim=8)
    batch = {"dense": jnp.asarray(data["dense"]),
             "sparse": jnp.asarray(data["sparse"])}
    m32 = DLRM(schema, bottom_units=(16,), top_units=(16, 8))
    m16 = DLRM(schema, bottom_units=(16,), top_units=(16, 8),
               compute_dtype=jnp.bfloat16)
    v = m32.init(jax.random.PRNGKey(0), batch, training=False)
    o32 = m32.apply(v, batch, training=False)
    o16 = m16.apply(v, batch, training=False)  # same params, bf16 compute
    assert o16.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(o32), np.asarray(o16),
                               rtol=0.1, atol=0.1)


def test_sdpa_causal_backward(rng):
    B, H, S, D = 2, 2, 48, 16
    q, k, v = (jnp.asarray(rng.normal(size=(B, H, S, D)), jnp.float32)
               for _ in range(3))
    # keep key 0 visible so no query row is fully masked
    mask = jnp.asarray(rng.random((B, S)) > 0.2).at[:, 0].set(True)
    cm = np.asarray(mask)[:, None, None, :] & (
        np.arange(S)[:, None] >= np.arange(S)[None, :]
    )
    _, want_g = _attention64(q, k, v, cm)
    with jax.default_matmul_precision("highest"):
        got_g = _sdpa_grads(q, k, v, mask, True)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-4)


def test_sdpa_route_follows_dtype():
    """cuDNN's fused attention takes bf16/fp16 only, and only on the GPU;
    float32 and every CPU call take XLA's route."""
    assert dispatch.attention_implementation(jnp.float32) == "xla"
    want16 = "cudnn" if jax.default_backend() == "gpu" else "xla"
    assert dispatch.attention_implementation(jnp.bfloat16) == want16
