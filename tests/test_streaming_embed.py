"""fused_adam / fused_rowwise_adagrad table updates (train/streaming_embed.py)
— exactness of the XLA scatter-add + dense optimizer vs a float64 dense
reference, the host prep, and the Trainer integration."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from recsys_tpu.train.streaming_embed import _xla_group_update, host_prep_group


def _adam(p, m, v, cs, ids2d, step, *, pack, d, wd=0.0):
    """One _xla_group_update Adam step on host-prep arrays -> (p, m, v)."""
    new_p, st = _xla_group_update(
        jnp.asarray(p), {"m": jnp.asarray(m), "v": jnp.asarray(v)},
        jnp.asarray(cs), jnp.asarray(ids2d), pack=pack, d=d, lr=1e-3,
        step=jnp.int32(step), wd=wd, kind="adam",
    )
    return new_p, st["m"], st["v"]


def _dense_reference(p, m, v, cot, ids, step, *, pack, d, lr=1e-3,
                     b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """np.float64 dense scatter-add + dense Adam (optax.adam math)."""
    g = np.zeros(p.shape, np.float64)
    for i in range(ids.shape[0]):
        s = ids[i] % pack
        g[ids[i] // pack, s * d:(s + 1) * d] += cot[i]
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    mh = m2 / (1 - b1 ** step)
    vh = v2 / (1 - b2 ** step)
    upd = lr * mh / (np.sqrt(vh) + eps) + lr * wd * p
    return p - upd, m2, v2


def _run_case(vocab, pack, d, n, block, ch, *, wd=0.0, seed=0):
    rng = np.random.default_rng(seed)
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    wide = pack * d
    ids = rng.integers(0, vocab, n).astype(np.int32)
    # bf16-quantize the cotangent ONCE so both impls sum identical values
    # (bf16 x bf16 products are exact in f32; only summation order differs)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32)
    )
    p = rng.uniform(-0.05, 0.05, (vp, wide)).astype(np.float32)
    m = (rng.standard_normal((vp, wide)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vp, wide)).astype(np.float32)
    step = 3

    ids2d, idx, cptr = host_prep_group(ids, pack=pack, vp=vp, block=block,
                                       ch=ch)
    cot_sorted = np.take(cot, idx, axis=0)
    got = _adam(p, m, v, cot_sorted, ids2d, step, pack=pack, d=d, wd=wd)
    want = _dense_reference(
        p.astype(np.float64), m.astype(np.float64), v.astype(np.float64),
        cot, ids, step, pack=pack, d=d, wd=wd,
    )
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=2e-4, atol=1e-7,
            err_msg=f"{name} vocab={vocab} pack={pack} d={d}",
        )


def test_fused_adam_matches_dense_scatter_adam():
    _run_case(vocab=500, pack=8, d=16, n=256, block=16, ch=64)


def test_fused_adam_pack1_wide_rows():
    _run_case(vocab=96, pack=1, d=128, n=128, block=16, ch=64)


def test_fused_adam_weight_decay_and_skew():
    # hot-id traffic: many duplicates land in one block
    rng = np.random.default_rng(3)
    vocab, pack, d, n, block, ch = 300, 8, 16, 256, 8, 32
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    ids = (rng.integers(0, 3, n) * 7).astype(np.int32)  # 3 hot ids only
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)), jnp.bfloat16)
        .astype(jnp.float32)
    )
    p = rng.uniform(-0.05, 0.05, (vp, pack * d)).astype(np.float32)
    m = np.zeros_like(p)
    v = np.zeros_like(p)
    ids2d, idx, cptr = host_prep_group(ids, pack=pack, vp=vp, block=block,
                                       ch=ch)
    got = _adam(p, m, v, np.take(cot, idx, axis=0), ids2d, 1, pack=pack,
                d=d, wd=0.01)
    want = _dense_reference(
        p.astype(np.float64), m.astype(np.float64), v.astype(np.float64),
        cot, ids, 1, pack=pack, d=d, wd=0.01,
    )
    # first-step Adam is sign(g)-like: duplicates summed in different
    # orders can flip near-zero sums, so compare m/v tightly and p loosely
    np.testing.assert_allclose(np.asarray(got[1]), want[1], rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(got[2]), want[2], rtol=1e-4,
                               atol=1e-9)
    bad = np.abs(np.asarray(got[0], np.float64) - want[0]) > 1e-5
    assert bad.mean() < 0.001, f"{bad.sum()} divergent update cells"


def test_host_prep_static_shapes_across_batches():
    """Different id distributions must produce IDENTICAL aux shapes (no
    per-batch recompiles)."""
    rng = np.random.default_rng(0)
    shapes = set()
    for seed in range(4):
        ids = rng.integers(0, 1000, 512).astype(np.int32)
        if seed == 3:
            ids[:] = 5  # extreme skew
        ids2d, idx, cptr = host_prep_group(ids, pack=8, vp=128, block=16,
                                           ch=64)
        shapes.add((ids2d.shape, idx.shape, cptr.shape))
    assert len(shapes) == 1, shapes


def test_trainer_fused_adam_matches_dense_optax():
    """DLRM trained with embedding_optimizer='fused_adam' (f32 matmuls)
    tracks the plain dense-optax path: same loss trajectory within
    numerical tolerance, same AUC ballpark."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=1024, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)

    def run(fused):
        kw = dict(learning_rate=1e-2, seed=11)
        model = DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                     sparse_embed_grads=fused)
        if fused:
            kw.update(embedding_optimizer="fused_adam")
        tr = Trainer(model, **kw)
        hist = tr.fit(data, batch_size=256, epochs=2, verbose=False)
        return hist["loss"]

    dense = run(False)
    fused = run(True)
    np.testing.assert_allclose(fused, dense, rtol=2e-2)


def test_fused_rowwise_adagrad_matches_sparse_path():
    """At wd=0 the fused dense rowwise-AdaGrad must equal the existing
    sparse touched-rows update (untouched rows see g=0) — the two paths
    implement ONE optimizer."""
    from recsys_tpu.train import sparse_embed

    rng = np.random.default_rng(5)
    vocab, pack, d, n, block, ch = 500, 8, 16, 256, 16, 64
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32)
    )
    p = rng.uniform(-0.05, 0.05, (vp, pack * d)).astype(np.float32)
    acc = rng.uniform(0, 1e-4, (vp, pack)).astype(np.float32)

    ids2d, idx, cptr = host_prep_group(ids, pack=pack, vp=vp, block=block,
                                       ch=ch)
    got_p, got_st = _xla_group_update(
        jnp.asarray(p), {"acc": jnp.asarray(acc)},
        jnp.asarray(np.take(cot, idx, axis=0)), jnp.asarray(ids2d),
        pack=pack, d=d, lr=1e-3, step=jnp.int32(1), wd=0.0,
        kind="rowwise_adagrad",
    )
    got_acc = got_st["acc"]

    # the sparse path takes PHYSICAL rows + wide sub-slot-spread cot + slot
    # one-hots (the group_rows_and_cots transform)
    sub = ids % pack
    onehot = np.eye(pack, dtype=np.float32)[sub]  # (n, pack)
    want_p, want_acc = sparse_embed.rowwise_adagrad_update(
        jnp.asarray(p), jnp.asarray(acc), jnp.asarray(ids // pack),
        jnp.asarray((cot[:, None, :] * onehot[:, :, None])
                    .reshape(n, pack * d)),
        jnp.asarray(onehot), lr=1e-3, pack=pack,
    )
    np.testing.assert_allclose(np.asarray(got_acc), np.asarray(want_acc),
                               rtol=1e-4, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got_p), np.asarray(want_p),
                               rtol=1e-3, atol=2e-7)


def test_trainer_fused_rowwise_adagrad_trains():
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=1024, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)
    tr = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        learning_rate=1e-2, embedding_optimizer="fused_rowwise_adagrad",
        seed=11,
    )
    hist = tr.fit(data, batch_size=256, epochs=3, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]


def test_host_prep_sharded_matches_numpy_and_partitions():
    """shards>1: native C++ and numpy host prep are bit-exact, per-shard
    cptr windows partition the non-padding chunks at shard-aligned fences,
    and each shard's chunks hold only its own rows (ADVICE r3 #3)."""
    from recsys_tpu.data import native

    rng = np.random.default_rng(13)
    # vs > block and vs < block cases, vp divisible by shards
    for n, vocab, pack, block, ch, shards in (
        (1000, 5000, 8, 64, 128, 2),
        (513, 2000, 4, 8, 32, 4),
        (256, 60, 1, 64, 32, 2),  # vs=32 < block: blk must clamp to vs
    ):
        vp = ((-(-vocab // pack)) + 7) // 8 * 8
        vp += (-vp) % shards  # make divisible
        vs = vp // shards
        blk = min(block, vs)
        ids = rng.integers(0, vocab, n).astype(np.int32)
        a = host_prep_group(ids, pack=pack, vp=vp, block=blk, ch=ch,
                            shards=shards, use_native=False)
        if native.available():
            b = host_prep_group(ids, pack=pack, vp=vp, block=blk, ch=ch,
                                shards=shards, use_native=True)
            for x, y, name in zip(a, b, ("ids2d", "idx", "cptr")):
                np.testing.assert_array_equal(
                    x, y, err_msg=f"{name} shards={shards} vp={vp}")
        ids2d, idx, cptr = a
        nb_s = -(-vs // blk)
        assert len(cptr) == shards * nb_s + 1
        # per-shard windows tile [0, nc_max] and contain only own-shard rows
        for s in range(shards):
            w = cptr[s * nb_s:(s + 1) * nb_s + 1]
            assert (np.diff(w) >= 0).all()
            sentinel = ids2d.max()
            for k in range(nb_s):
                chunk_ids = ids2d[w[k]:w[k + 1]].reshape(-1)
                real = chunk_ids[chunk_ids < sentinel]
                if real.size:
                    prow = real // pack
                    assert (prow >= s * vs).all() and (prow < (s + 1) * vs).all()
                    # block index within the shard (fences are aligned to
                    # shard starts, so the index is over shard-local rows)
                    assert ((prow - s * vs) // blk == k).all()
        assert cptr[-1] == ids2d.shape[0]


def test_fused_adam_sharded_slices_match_dense_reference():
    """Assembling the update from per-shard calls (local table rows, ids
    rebased so other shards' rows fall outside — exactly what
    apply_updates_fused runs under shard_map on a model axis) must match
    the f64 dense scatter+Adam reference."""
    rng = np.random.default_rng(21)
    vocab, pack, d, n, block, ch, shards = 500, 8, 16, 256, 16, 64, 2
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    assert vp % shards == 0
    vs = vp // shards
    blk = min(block, vs)
    nb_s = -(-vs // blk)
    wide = pack * d
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32)
    )
    p = rng.uniform(-0.05, 0.05, (vp, wide)).astype(np.float32)
    m = (rng.standard_normal((vp, wide)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vp, wide)).astype(np.float32)
    step = 3

    ids2d, idx, cptr = host_prep_group(ids, pack=pack, vp=vp, block=blk,
                                       ch=ch, shards=shards)
    cot_sorted = jnp.asarray(np.take(cot, idx, axis=0))
    outs = []
    for s in range(shards):
        sl = slice(s * vs, (s + 1) * vs)
        outs.append(_adam(p[sl], m[sl], v[sl], cot_sorted,
                          ids2d - s * vs * pack, step, pack=pack, d=d))
    got = tuple(np.concatenate([np.asarray(o[i]) for o in outs])
                for i in range(3))
    want = _dense_reference(
        p.astype(np.float64), m.astype(np.float64), v.astype(np.float64),
        cot, ids, step, pack=pack, d=d,
    )
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-7,
                                   err_msg=f"sharded {name}")


def test_trainer_fused_adam_model_axis_matches_single_chip():
    """fused_adam on a 4x2 (data, model) mesh — row-sharded tables,
    shard-local streaming updates — must track the single-chip run: the
    optimizer is the same dense Adam, differing only in f32 summation
    order at shard-fence chunk splits (VERDICT r3 next-step #2)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train import sparse_embed
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)

    def run(mesh):
        tr = Trainer(
            DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                 sparse_embed_grads=True),
            learning_rate=1e-2, embedding_optimizer="fused_adam",
            seed=11, mesh=mesh,
        )
        hist = tr.fit(data, batch_size=128, epochs=2, verbose=False)
        _, tables = sparse_embed.split_params(tr.state.params,
                                              tr._embed_plan)
        return hist["loss"], {k: np.asarray(v) for k, v in tables.items()}, tr

    loss1, tab1, _ = run(None)
    loss42, tab42, tr42 = run(make_mesh(data=4, model=2))
    # the packed tables in this config divide the model axis -> sharded
    assert any(s > 1 for s in tr42._fused_shards.values()), tr42._fused_shards
    np.testing.assert_allclose(loss42, loss1, rtol=1e-4)
    for k in tab1:
        np.testing.assert_allclose(tab42[k], tab1[k], rtol=1e-3, atol=1e-6)


def test_trainer_fused_rowwise_adagrad_model_axis_trains():
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)
    tr = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        learning_rate=1e-2, embedding_optimizer="fused_rowwise_adagrad",
        seed=11, mesh=make_mesh(data=4, model=2),
    )
    hist = tr.fit(data, batch_size=128, epochs=3, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]


def test_trainer_fused_adam_dp_mesh_matches_single_chip():
    """fused_adam on a pure-DP 8-device mesh is the SAME optimizer as the
    single-chip path: one cotangent all-gather into global sorted order,
    then every device applies the identical streaming update under
    shard_map — so the loss trajectory and the final tables must match the
    unsharded run to float tolerance (loss-mean reduction order is the
    only difference)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train import sparse_embed
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)

    def run(mesh):
        tr = Trainer(
            DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                 sparse_embed_grads=True),
            learning_rate=1e-2, embedding_optimizer="fused_adam",
            seed=11, mesh=mesh,
        )
        hist = tr.fit(data, batch_size=128, epochs=2, verbose=False)
        _, tables = sparse_embed.split_params(tr.state.params,
                                              tr._embed_plan)
        return hist["loss"], {k: np.asarray(v) for k, v in tables.items()}

    loss1, tab1 = run(None)
    loss8, tab8 = run(make_mesh(data=8, model=1))
    np.testing.assert_allclose(loss8, loss1, rtol=1e-5)
    for k in tab1:
        np.testing.assert_allclose(tab8[k], tab1[k], rtol=1e-4, atol=1e-7)


def test_trainer_fused_rowwise_adagrad_dp_mesh_trains():
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)
    tr = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True),
        learning_rate=1e-2, embedding_optimizer="fused_rowwise_adagrad",
        seed=11, mesh=make_mesh(data=8, model=1),
    )
    hist = tr.fit(data, batch_size=128, epochs=3, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]


def test_native_fused_prep_matches_numpy():
    """native/recsys_native.cc fused_prep must be bit-exact with the numpy
    host_prep_group (both stable counting/argsort by physical row)."""
    from recsys_tpu.data import native

    if not native.available():
        import pytest

        pytest.skip("native library unavailable")
    rng = np.random.default_rng(9)
    for n, vocab, pack, block, ch in ((1000, 5000, 8, 64, 128),
                                      (513, 100, 4, 8, 32),
                                      (256, 7, 1, 8, 64)):
        vp = ((-(-vocab // pack)) + 7) // 8 * 8
        ids = rng.integers(0, vocab, n).astype(np.int32)
        a = host_prep_group(ids, pack=pack, vp=vp, block=block, ch=ch,
                            use_native=False)
        b = host_prep_group(ids, pack=pack, vp=vp, block=block, ch=ch,
                            use_native=True)
        for x, y, name in zip(a, b, ("ids2d", "idx", "cptr")):
            np.testing.assert_array_equal(
                x, y, err_msg=f"{name} n={n} vocab={vocab} pack={pack}")


def test_fused_adam_multi_stream_matches_dense_reference():
    """host-LOCAL prep: S independently sorted per-shard chunk streams,
    concatenated, must produce the same dense-Adam result as the global
    sort (O(local) host prep)."""
    rng = np.random.default_rng(5)
    vocab, pack, d, n, block, ch, S = 500, 8, 16, 256, 16, 32, 4
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    wide = pack * d
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32)
    )
    p = rng.uniform(-0.05, 0.05, (vp, wide)).astype(np.float32)
    m = (rng.standard_normal((vp, wide)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vp, wide)).astype(np.float32)
    step = 3

    # per-shard local prep: each stream sorts only its n/S slice
    ns = n // S
    ids2d_l, cs_l, cptr_l = [], [], []
    for s in range(S):
        sl = slice(s * ns, (s + 1) * ns)
        i2, ix, cp = host_prep_group(ids[sl], pack=pack, vp=vp,
                                     block=block, ch=ch)
        ids2d_l.append(i2)
        cs_l.append(np.take(cot[sl], ix, axis=0))
        cptr_l.append(cp)
    got = _adam(p, m, v, np.concatenate(cs_l), np.concatenate(ids2d_l),
                step, pack=pack, d=d)
    want = _dense_reference(
        p.astype(np.float64), m.astype(np.float64), v.astype(np.float64),
        cot, ids, step, pack=pack, d=d,
    )
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=2e-4, atol=1e-7, err_msg=name
        )


def test_trainer_local_contract_matches_global_dp():
    """data_contract='local' on a pure-DP mesh: per-shard host prep +
    shard-local cotangent permute over all streams must track the global-contract run (same batches under one process — only
    f32 summation order across streams differs)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train import sparse_embed
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)

    def run(contract):
        tr = Trainer(
            DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                 sparse_embed_grads=True),
            learning_rate=1e-2, embedding_optimizer="fused_adam",
            seed=11,
            mesh=make_mesh(data=8, model=1), data_contract=contract,
        )
        hist = tr.fit(data, batch_size=128, epochs=2, verbose=False)
        _, tables = sparse_embed.split_params(tr.state.params,
                                              tr._embed_plan)
        return hist["loss"], {k: np.asarray(v) for k, v in tables.items()}

    loss_g, tab_g = run("global")
    loss_l, tab_l = run("local")
    np.testing.assert_allclose(loss_l, loss_g, rtol=1e-5)
    for k in tab_g:
        np.testing.assert_allclose(tab_l[k], tab_g[k], rtol=1e-4,
                                   atol=1e-7)


def test_trainer_local_contract_model_axis():
    """local contract composes with the model axis: per-stream cptr
    windows slice each stream's shard-aligned fences."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train import sparse_embed
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)

    def run(mesh, contract):
        tr = Trainer(
            DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                 sparse_embed_grads=True),
            learning_rate=1e-2, embedding_optimizer="fused_adam",
            seed=11, mesh=mesh,
            data_contract=contract,
        )
        hist = tr.fit(data, batch_size=128, epochs=2, verbose=False)
        _, tables = sparse_embed.split_params(tr.state.params,
                                              tr._embed_plan)
        return hist["loss"], {k: np.asarray(v) for k, v in
                              tables.items()}, tr

    loss1, tab1, _ = run(None, "global")
    loss42, tab42, tr42 = run(make_mesh(data=4, model=2), "local")
    assert any(s > 1 for s in tr42._fused_shards.values())
    np.testing.assert_allclose(loss42, loss1, rtol=1e-4)
    for k in tab1:
        np.testing.assert_allclose(tab42[k], tab1[k], rtol=1e-3, atol=1e-6)


def test_local_contract_evaluate_loss_tail_correction():
    """local-mode evaluate_loss pads each process's tail and subtracts the
    tile term exactly (single-process: must equal the global path)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=300, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=3)

    def run(contract):
        tr = Trainer(
            DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                 sparse_embed_grads=True),
            learning_rate=1e-2, embedding_optimizer="fused_adam",
            seed=1,
            mesh=make_mesh(data=8, model=1), data_contract=contract,
        )
        tr.fit(data, batch_size=64, epochs=1, verbose=False)
        # 300 % 128 != 0 -> tail batch is padded
        return tr.evaluate_loss(data, batch_size=128)

    assert abs(run("local") - run("global")) < 1e-5


def test_fused_adam_bf16_master_tables():
    """bf16 master tables: the update reads p up to f32, keeps the f32
    moments bit-identical to the f32-table run (m/v don't depend on p),
    and writes p back in bf16 — one rounding of the f32 update."""
    rng = np.random.default_rng(11)
    vocab, pack, d, n, block, ch = 500, 8, 16, 256, 16, 64
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    wide = pack * d
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32))
    # p already bf16-representable so both runs read identical values
    p32 = np.asarray(
        jnp.asarray(rng.uniform(-0.05, 0.05, (vp, wide)), jnp.bfloat16)
        .astype(jnp.float32))
    m = (rng.standard_normal((vp, wide)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vp, wide)).astype(np.float32)

    ids2d, idx, cptr = host_prep_group(ids, pack=pack, vp=vp, block=block,
                                       ch=ch)
    cs = np.take(cot, idx, axis=0)

    def run(p_arr):
        return _adam(p_arr, m, v, cs, ids2d, 3, pack=pack, d=d)

    got16 = run(jnp.asarray(p32, jnp.bfloat16))
    got32 = run(p32)
    assert got16[0].dtype == jnp.bfloat16
    # moments: identical inputs -> identical f32 outputs
    np.testing.assert_array_equal(np.asarray(got16[1]), np.asarray(got32[1]))
    np.testing.assert_array_equal(np.asarray(got16[2]), np.asarray(got32[2]))
    # p: equal up to ONE bf16 rounding of the f32 result
    want = np.asarray(jnp.asarray(got32[0], jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(
        np.asarray(got16[0]).astype(np.float32), want, rtol=8e-3, atol=1e-6)


def test_trainer_fused_adam_bf16_tables_trains():
    """DLRM with bf16 master tables + fused_adam trains end to end (the
    opt-in halved-table-bytes layout)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=512, num_dense=4,
                                 num_sparse=5, vocab_size=64, embed_dim=8,
                                 seed=7)
    tr = Trainer(
        DLRM(schema, bottom_units=(16, 8), top_units=(16,),
             sparse_embed_grads=True,
             embed_kw={"param_dtype": jnp.bfloat16}),
        learning_rate=1e-2, embedding_optimizer="fused_adam", seed=11,
    )
    hist = tr.fit(data, batch_size=128, epochs=3, verbose=False)
    assert hist["loss"][-1] < hist["loss"][0], hist["loss"]


def test_xla_tiny_group_update_matches_dense_reference():
    """A small unpacked group (pack=1) through the XLA update is exact
    dense Adam over scatter-added grads."""
    rng = np.random.default_rng(21)
    vocab, pack, d, n, block, ch = 60, 1, 16, 256, 8, 32
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    wide = pack * d
    ids = rng.integers(0, vocab, n).astype(np.int32)
    cot = np.asarray(
        jnp.asarray(rng.standard_normal((n, d)) * 1e-2, jnp.bfloat16)
        .astype(jnp.float32))
    p = rng.uniform(-0.05, 0.05, (vp, wide)).astype(np.float32)
    m = (rng.standard_normal((vp, wide)) * 1e-3).astype(np.float32)
    v = rng.uniform(1e-8, 1e-4, (vp, wide)).astype(np.float32)
    i2, ix, cp = host_prep_group(ids, pack=pack, vp=vp, block=block, ch=ch)
    cs = np.take(cot, ix, axis=0)
    got_p, got_st = _xla_group_update(
        jnp.asarray(p), {"m": jnp.asarray(m), "v": jnp.asarray(v)},
        jnp.asarray(cs), jnp.asarray(i2), pack=pack, d=d, lr=1e-3,
        step=jnp.int32(3), wd=0.0, kind="adam",
    )
    want = _dense_reference(
        p.astype(np.float64), m.astype(np.float64), v.astype(np.float64),
        cot, ids, 3, pack=pack, d=d,
    )
    np.testing.assert_allclose(np.asarray(got_p), want[0], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(got_st["m"]), want[1], rtol=2e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(got_st["v"]), want[2], rtol=2e-4,
                               atol=1e-9)


def test_trainer_fused_adam_big_vocab_kernel_path():
    """Tables large enough to pack 8 vocab rows per physical row train
    through the Trainer's fused_adam update and track the dense-optax
    trajectory."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train import sparse_embed
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=256, num_dense=4,
                                 num_sparse=3, vocab_size=4096,
                                 embed_dim=8, seed=3)

    def run(fused):
        kw = dict(learning_rate=1e-2, seed=1)
        if fused:
            kw["embedding_optimizer"] = "fused_adam"
        tr = Trainer(DLRM(schema, bottom_units=(16, 8), top_units=(16,),
                          sparse_embed_grads=fused), **kw)
        return tr.fit(data, batch_size=128, epochs=2, verbose=False), tr

    hist, tr = run(True)
    assert hist["loss"][-1] < hist["loss"][0]
    assert max(tr._embed_plan.packs) > 1
    _, tables = sparse_embed.split_params(tr.state.params, tr._embed_plan)
    assert all(t.shape[0] >= 64 for t in tables.values())
    dense, _ = run(False)
    np.testing.assert_allclose(hist["loss"], dense["loss"], rtol=2e-2)


@pytest.mark.parametrize("kind", ["adam", "rowwise_adagrad"])
def test_model_axis_sharded_update_matches_dense_reference(kind):
    """apply_updates_fused on a model-axis mesh (shard_map, ids rebased
    per shard, other shards' rows dropped) equals the float64 dense
    scatter-add + optimizer reference for one group."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from recsys_tpu.parallel.mesh import MODEL_AXIS, make_mesh
    from recsys_tpu.train.sparse_embed import EmbedPlan
    from recsys_tpu.train.streaming_embed import (
        apply_updates_fused, make_host_prep,
    )

    rng = np.random.default_rng(17)
    vocab, pack, d, b, shards = 500, 8, 16, 256, 4
    vp = ((-(-vocab // pack)) + 7) // 8 * 8
    plan = EmbedPlan(prefix=("E",), table_names=("table_0",),
                     group_cols=((0,),), group_offsets=((0,),),
                     packs=(pack,), embed_dim=d, group_vocab=(vocab,))
    sparse = rng.integers(0, vocab, (b, 1)).astype(np.int32)
    cot = (rng.standard_normal((b, 1, d)) * 1e-2).astype(np.float32)
    p = rng.uniform(-0.05, 0.05, (vp, pack * d)).astype(np.float32)
    if kind == "adam":
        st = {"m": (rng.standard_normal(p.shape) * 1e-3).astype(np.float32),
              "v": rng.uniform(1e-8, 1e-4, p.shape).astype(np.float32)}
    else:
        st = {"acc": rng.uniform(0, 1e-4, (vp, pack)).astype(np.float32)}
    mesh = make_mesh(data=2, model=shards, devices=jax.devices()[:8])
    row = NamedSharding(mesh, P(MODEL_AXIS, None))
    aux = make_host_prep(plan, shards_by_name={"table_0": shards})(sparse)
    batch = {k: jnp.asarray(v) for k, v in aux.items()}
    new_t, new_st = jax.jit(
        lambda t, s, bt, c: apply_updates_fused(
            {"table_0": t}, {"table_0": s}, plan, bt, c, lr=1e-3,
            step=jnp.int32(3), kind=kind, mesh=mesh,
            shards_by_name={"table_0": shards},
        )
    )(jax.device_put(p, row), {k: jax.device_put(v, row)
                               for k, v in st.items()}, batch,
      jnp.asarray(cot))
    ids = sparse[:, 0]
    if kind == "adam":
        want = _dense_reference(
            p.astype(np.float64), st["m"].astype(np.float64),
            st["v"].astype(np.float64), cot[:, 0], ids, 3, pack=pack, d=d,
        )
        got = (new_t["table_0"], new_st["table_0"]["m"],
               new_st["table_0"]["v"])
    else:
        g = np.zeros(p.shape, np.float64)
        for i, r in enumerate(ids):
            g[r // pack, (r % pack) * d:(r % pack + 1) * d] += cot[i, 0]
        g3 = g.reshape(vp, pack, d)
        acc = st["acc"] + np.mean(g3 * g3, axis=2)
        upd = 1e-3 * g3 / (np.sqrt(acc) + 1e-8)[..., None]
        want = (p - upd.reshape(p.shape), acc)
        got = (new_t["table_0"], new_st["table_0"]["acc"])
    for a, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), w, rtol=2e-4, atol=1e-7)
