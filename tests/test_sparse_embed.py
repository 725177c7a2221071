"""Sparse (touched-rows) embedding optimizers + row-packed table layout."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.data.synthetic import synthetic_ctr
from recsys_tpu.kernels.embedding import pack_factor, packed_gather
from recsys_tpu.models.ctr.dlrm import DLRM
from recsys_tpu.train import sparse_embed
from recsys_tpu.train.loop import Trainer


def _schema_data(n=512, vocab=50, seed=0):
    return synthetic_ctr(num_examples=n, num_dense=4, num_sparse=6,
                         vocab_size=vocab, embed_dim=8, seed=seed)


# -- packed layout ------------------------------------------------------------

def test_pack_factor_policy():
    assert pack_factor(16) == 8
    assert pack_factor(128) == 1
    assert pack_factor(64) == 2
    # small vocabs refuse to degenerate into 1-row tables
    assert pack_factor(16, vocab=100_000) == 8
    assert pack_factor(16, vocab=100) == 1
    assert pack_factor(1, vocab=10_000) == 128


def test_packed_gather_matches_plain_gather():
    rng = np.random.default_rng(0)
    v, d, p = 40, 16, 8
    vp = -(-v // p)
    packed = jnp.asarray(rng.normal(size=(vp, p * d)).astype(np.float32))
    logical = packed.reshape(vp * p, d)[:v]
    ids = jnp.asarray(rng.integers(0, v, (7, 5), dtype=np.int64).astype(np.int32))
    got = packed_gather(packed, ids, p, d)
    np.testing.assert_allclose(
        np.asarray(got), np.asarray(logical[ids]), rtol=1e-6
    )


def test_packed_gather_grad_is_spread_scatter():
    """d(table) of a packed gather sums cotangents into the right sub-slots."""
    rng = np.random.default_rng(1)
    v, d, p = 16, 4, 4
    packed = jnp.asarray(rng.normal(size=(v // p, p * d)).astype(np.float32))
    ids = jnp.asarray([1, 1, 5])  # duplicate id + one in another row
    cot = jnp.asarray(rng.normal(size=(3, d)).astype(np.float32))

    g = jax.grad(lambda t: jnp.vdot(packed_gather(t, ids, p, d), cot))(packed)
    expect = np.zeros((v, d), np.float32)
    for i, idx in enumerate([1, 1, 5]):
        expect[idx] += np.asarray(cot[i])
    np.testing.assert_allclose(
        np.asarray(g).reshape(v, d), expect, rtol=1e-6
    )


def test_stacked_embedding_packed_lookup_consistency():
    from recsys_tpu.ops.linen import StackedEmbedding

    schema, data = _schema_data(vocab=600)
    mod = StackedEmbedding(schema)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(data["sparse"][:4]))
    f = schema.sparse[2].name
    ids = jnp.asarray([0, 3, 599])
    via_lookup = mod.apply(variables, f, ids, method=mod.lookup)
    logical = mod.apply(variables, f, method=mod.table_logical)
    off = mod.apply(variables, f, method=mod.field_offset)
    np.testing.assert_allclose(
        np.asarray(via_lookup), np.asarray(logical[ids + off]), rtol=1e-6
    )


# -- sparse optimizer semantics ----------------------------------------------

def _paired_trainers(kind, vocab=600, seed=3):
    schema, data = _schema_data(vocab=vocab, seed=seed)
    dense = Trainer(DLRM(schema, bottom_units=(16, 8), top_units=(16,)),
                    seed=seed)
    sparse = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        seed=seed, embedding_optimizer=kind,
    )
    return schema, data, dense, sparse


def test_lazy_adam_first_step_matches_dense_adam():
    """Fresh moments: step 1 of lazy adam == dense adam everywhere (touched
    rows get the same update; untouched rows don't move under either)."""
    schema, data, dense, sparse = _paired_trainers("lazy_adam")
    batch = {k: v[:128] for k, v in data.items()}
    dense.init(batch); dense._build_steps()
    sparse.init(batch); sparse._build_steps()
    # same initial params on both
    sparse.state = sparse.state.replace(params=jax.tree_util.tree_map(
        lambda x: jnp.array(x, copy=True), dense.state.params))
    db = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(0)
    s1, l1, _ = dense._train_step(dense.state, db, rng)
    s2, l2, _ = sparse._train_step(sparse.state, db, rng)
    assert float(l1) == pytest.approx(float(l2), rel=1e-6)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), atol=1e-7
        ),
        s1.params, s2.params,
    )


@pytest.mark.parametrize("kind", ["lazy_adam", "rowwise_adagrad"])
def test_sparse_optimizer_trains(kind):
    schema, data, dense, sparse = _paired_trainers(kind)
    hd = dense.fit(data, batch_size=128, epochs=3, verbose=False)
    hs = sparse.fit(data, batch_size=128, epochs=3, verbose=False)
    assert hs["loss"][-1] < hs["loss"][0]
    # tracks the dense path's optimisation quality on this fixture
    assert hs["loss"][-1] < hd["loss"][0]


def test_sparse_optimizer_rejects_untapped_model():
    schema, data = _schema_data()
    tr = Trainer(DLRM(schema, bottom_units=(16, 8), top_units=(16,)),
                 embedding_optimizer="lazy_adam")
    with pytest.raises(ValueError, match="sparse_embed_grads"):
        tr.init({k: v[:64] for k, v in data.items()})


def test_sparse_optimizer_rejects_unknown_kind():
    schema, _ = _schema_data()
    with pytest.raises(ValueError, match="embedding_optimizer"):
        Trainer(DLRM(schema), embedding_optimizer="adamw")


def test_dedup_sums_duplicates_exactly():
    rows = jnp.asarray([3, 3, 7, 3, 0], jnp.int32)
    cot = jnp.arange(10, dtype=jnp.float32).reshape(5, 2)
    uids, g = sparse_embed._dedup(rows, cot, vocab=8)
    uids, g = np.asarray(uids), np.asarray(g)
    expect = {3: cot[0] + cot[1] + cot[3], 7: cot[2], 0: cot[4]}
    seen = {}
    for i in range(5):
        if uids[i] < 8:
            seen[int(uids[i])] = g[i]
    assert set(seen) == set(expect)
    for k, v in expect.items():
        np.testing.assert_allclose(seen[k], np.asarray(v), rtol=1e-6)


def test_rowwise_adagrad_matches_numpy_reference():
    rng = np.random.default_rng(2)
    v, d, p, n = 8, 4, 2, 6  # packed: (4, 8) table, acc (4, 2)
    table = rng.normal(size=(v // p, p * d)).astype(np.float32)
    rows = np.array([0, 1, 1, 3], np.int32)  # physical rows
    cot = rng.normal(size=(4, p * d)).astype(np.float32)
    acc = np.abs(rng.normal(size=(v // p, p)).astype(np.float32))
    lr = 0.1
    # full physical rows touched -> slot one-hot marks both slots
    nt, nacc = sparse_embed.rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(acc), jnp.asarray(rows),
        jnp.asarray(cot), jnp.ones((4, p), np.float32), lr=lr, pack=p,
    )
    # numpy reference
    et, ea = table.copy(), acc.copy()
    g = {}
    for r, c in zip(rows, cot):
        g[int(r)] = g.get(int(r), 0) + c
    for r, c in g.items():
        slots = c.reshape(p, d)
        ea[r] += (slots ** 2).mean(axis=-1)
        et[r] -= (lr * slots / (np.sqrt(ea[r])[:, None] + 1e-8)).reshape(-1)
    np.testing.assert_allclose(np.asarray(nacc), ea, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(nt), et, rtol=1e-5)


def test_sparse_optimizer_on_mesh():
    from recsys_tpu.parallel.mesh import make_mesh

    schema, data = _schema_data(vocab=1024, seed=5)
    mesh = make_mesh(data=4, model=2)
    tr = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        mesh=mesh, embedding_optimizer="rowwise_adagrad", seed=5,
    )
    h = tr.fit(data, batch_size=128, epochs=2, verbose=False)
    assert np.isfinite(h["loss"][-1])
    assert h["loss"][-1] < h["loss"][0]
    # matches the same model trained without a mesh
    tr2 = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        embedding_optimizer="rowwise_adagrad", seed=5,
    )
    tr2.fit(data, batch_size=128, epochs=2, verbose=False)
    p1 = tr.predict({k: v for k, v in data.items() if k != "label"})
    p2 = tr2.predict({k: v for k, v in data.items() if k != "label"})
    np.testing.assert_allclose(p1, p2, atol=2e-4)


def test_lazy_adam_packed_siblings_stay_untouched():
    """Vocab rows that share a physical row with a touched row must keep
    their params AND moments unchanged (strict lazy semantics), even with
    weight decay on."""
    p, d, vphys = 4, 2, 3  # 12 vocab rows packed into 3 physical rows
    vocab_rows = vphys * p
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(vphys, p * d)).astype(np.float32))
    m = jnp.asarray(rng.normal(size=(vphys, p * d)).astype(np.float32))
    v = jnp.abs(jnp.asarray(rng.normal(size=(vphys, p * d)).astype(np.float32)))
    # touch vocab rows 1 and 5 -> physical rows 0 (slot 1) and 1 (slot 1)
    vrows = np.array([1, 5], np.int32)
    prows = jnp.asarray(vrows // p)
    slot1h = jnp.asarray(np.eye(p, dtype=np.float32)[vrows % p])
    cot = jnp.zeros((2, p * d)).at[0, 1 * d:2 * d].set(1.0).at[
        1, 1 * d:2 * d].set(2.0)
    nt, nm, nv = sparse_embed.lazy_adam_update(
        table, m, v, prows, cot, slot1h,
        lr=0.1, step=jnp.asarray(3), pack=p, weight_decay=0.01,
    )
    tl = np.asarray(table).reshape(vocab_rows, d)
    ntl = np.asarray(nt).reshape(vocab_rows, d)
    ml, nml = np.asarray(m).reshape(-1, d), np.asarray(nm).reshape(-1, d)
    for r in range(vocab_rows):
        if r in (1, 5):
            assert not np.allclose(ntl[r], tl[r]), f"row {r} should move"
            assert not np.allclose(nml[r], ml[r])
        else:
            np.testing.assert_array_equal(ntl[r], tl[r])
            np.testing.assert_array_equal(nml[r], ml[r])
