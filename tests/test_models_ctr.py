"""Every CTR model: init, jitted forward, correct shapes, gradients flow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from recsys_tpu.data.synthetic import (
    synthetic_ctr,
    synthetic_multitask,
    synthetic_sequence,
)
from recsys_tpu.models.ctr.autoint import AutoInt
from recsys_tpu.models.ctr.dcn import DCN
from recsys_tpu.models.ctr.deep_crossing import DeepCrossing
from recsys_tpu.models.ctr.deepfm import DeepFM
from recsys_tpu.models.ctr.din import DIN
from recsys_tpu.models.ctr.dlrm import DLRM
from recsys_tpu.models.ctr.esmm import ESMM
from recsys_tpu.models.ctr.fm import FM
from recsys_tpu.models.ctr.mmoe import MMoE
from recsys_tpu.models.ctr.ple import PLE
from recsys_tpu.models.ctr.wide_deep import WideDeep

B = 16


def _ctr_batch():
    schema, data = synthetic_ctr(num_examples=B, num_dense=4, num_sparse=5,
                                 vocab_size=11, embed_dim=8)
    batch = {"dense": jnp.asarray(data["dense"]),
             "sparse": jnp.asarray(data["sparse"])}
    return schema, batch


SCALAR_MODELS = [
    lambda s: FM(s),
    lambda s: DeepFM(s, hidden_units=(16, 8)),
    lambda s: WideDeep(s, hidden_units=(16, 8)),
    lambda s: DeepCrossing(s, hidden_units=(16, 16)),
    lambda s: DCN(s, cross_layers=2, hidden_units=(16, 8)),
    lambda s: DLRM(s, bottom_units=(16,), top_units=(16, 8)),
    lambda s: AutoInt(s, num_layers=2, num_heads=2),
]


@pytest.mark.parametrize("make", SCALAR_MODELS)
def test_ctr_forward_and_grad(make):
    schema, batch = _ctr_batch()
    model = make(schema)
    variables = model.init(jax.random.PRNGKey(0), batch, training=False)
    logits = jax.jit(
        lambda v, b: model.apply(v, b, training=False)
    )(variables, batch)
    assert logits.shape == (B,)
    assert np.all(np.isfinite(np.asarray(logits)))

    def loss(params):
        out = model.apply(
            {"params": params, **{k: v for k, v in variables.items() if k != "params"}},
            batch, training=False,
        )
        return jnp.mean(out ** 2)

    grads = jax.grad(loss)(variables["params"])
    gnorm = sum(float(jnp.sum(jnp.abs(g))) for g in jax.tree_util.tree_leaves(grads))
    assert gnorm > 0.0
    # the embedding table must receive gradient in every model
    flat = jax.tree_util.tree_leaves_with_path(grads)
    table_grads = [g for p, g in flat if "table" in jax.tree_util.keystr(p)]
    assert table_grads and float(jnp.sum(jnp.abs(table_grads[0]))) > 0


def test_din_forward():
    schema, data = synthetic_sequence(num_examples=B, num_items=20, max_len=6)
    model = DIN(schema, ffn_hidden_units=(16, 8))
    batch = {"sparse": jnp.asarray(data["sparse"]),
             "hist": jnp.asarray(data["hist"])}
    variables = model.init(
        jax.random.PRNGKey(0), batch, training=True
    )
    out = model.apply(variables, batch, training=False)
    assert out.shape == (B,)
    assert np.all(np.isfinite(np.asarray(out)))


def test_din_attention_ignores_padding():
    """Changing a padded history slot must not change the output."""
    schema, data = synthetic_sequence(num_examples=4, num_items=20, max_len=6)
    model = DIN(schema, ffn_hidden_units=(8,))
    hist = np.asarray(data["hist"]).copy()
    hist[:, -1] = 0  # force last slot to padding
    batch = {"sparse": jnp.asarray(data["sparse"]), "hist": jnp.asarray(hist)}
    variables = model.init(jax.random.PRNGKey(0), batch, training=True)
    out1 = model.apply(variables, batch, training=False)
    hist2 = hist.copy()
    # padding id stays 0 but embedding row it would select changes nothing:
    # instead rewrite a padded slot to a real id — outputs MUST change now
    hist2[:, -1] = 5
    out2 = model.apply(
        variables, {"sparse": batch["sparse"], "hist": jnp.asarray(hist2)},
        training=False,
    )
    assert not np.allclose(np.asarray(out1), np.asarray(out2))


@pytest.mark.parametrize("cls", [MMoE, PLE])
def test_multitask_models(cls):
    schema, data = synthetic_multitask(num_examples=B, num_sparse=4, vocab_size=9)
    model = cls(schema, task_names=("ctr", "cvr"))
    batch = {"sparse": jnp.asarray(data["sparse"])}
    variables = model.init(jax.random.PRNGKey(0), batch, training=False)
    out = model.apply(variables, batch, training=False)
    assert set(out) == {"ctr", "cvr"}
    for v in out.values():
        assert v.shape == (B,)


def test_esmm_probability_structure():
    schema, data = synthetic_multitask(num_examples=B, num_sparse=6, vocab_size=9)
    model = ESMM(schema, num_user_fields=3, user_units=(16,), item_units=(16,),
                 head_units=(8,))
    batch = {"sparse": jnp.asarray(data["sparse"])}
    variables = model.init(jax.random.PRNGKey(0), batch, training=False)
    out = model.apply(variables, batch, training=False)
    ctr, cvr, ctcvr = np.asarray(out["ctr"]), np.asarray(out["cvr"]), np.asarray(out["ctcvr"])
    assert np.all((ctr >= 0) & (ctr <= 1))
    np.testing.assert_allclose(ctcvr, ctr * cvr, rtol=1e-6)
    # entire-space constraint: pCTCVR <= pCTR
    assert np.all(ctcvr <= ctr + 1e-7)


def test_dlrm_bf16_compute_matches_f32_quality():
    """compute_dtype=bfloat16 (bf16 mixed precision; params and loss
    stay f32) reaches the same AUC as full f32 on the planted fixture —
    the parity guard behind the bench's bf16 compute path."""
    import jax.numpy as jnp

    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=3072, num_dense=6,
                                 num_sparse=6, vocab_size=60, embed_dim=8,
                                 seed=11)
    aucs = {}
    for name, dt in [("f32", None), ("bf16", jnp.bfloat16)]:
        tr = Trainer(DLRM(schema, bottom_units=(32, 8), top_units=(32,),
                          compute_dtype=dt), learning_rate=5e-3, seed=0)
        tr.fit(data, batch_size=256, epochs=4, verbose=False)
        aucs[name] = tr.evaluate_auc(data)
    assert aucs["f32"] > 0.65
    assert abs(aucs["f32"] - aucs["bf16"]) < 0.02, aucs


def test_dlrm_dense_microbatch_exact_parity():
    """dense_microbatch slices the tail but shares the module instances:
    logits and gradients must match the unsliced model to float tolerance
    (slicing changes XLA's matmul tiling, so f32 reduction order differs
    at ~1e-7; dropout 0, gather stays whole-batch)."""
    import jax

    from recsys_tpu.data.synthetic import synthetic_ctr

    schema, data = synthetic_ctr(num_examples=64, num_dense=5,
                                 num_sparse=6, vocab_size=50, embed_dim=8,
                                 seed=9)
    batch = {k: jnp.asarray(v[:64]) for k, v in data.items()}
    m1 = DLRM(schema, bottom_units=(16, 8), top_units=(16,))
    m4 = DLRM(schema, bottom_units=(16, 8), top_units=(16,),
              dense_microbatch=4)
    variables = m1.init(jax.random.PRNGKey(0), batch, training=False)
    # identical param trees (same module instances, just sliced calls)
    v4 = m4.init(jax.random.PRNGKey(0), batch, training=False)
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(v4)
    out1 = m1.apply(variables, batch, training=False)
    out4 = m4.apply(variables, batch, training=False)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out4),
                               rtol=2e-6, atol=1e-7)

    def loss(m, v):
        return jnp.mean(
            (m.apply(v, batch, training=False) - batch["label"]) ** 2
        )

    g1 = jax.grad(lambda v: loss(m1, v))(variables)
    g4 = jax.grad(lambda v: loss(m4, v))(variables)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g4)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)

    # non-divisible microbatch falls back to the unsliced tail
    m3 = DLRM(schema, bottom_units=(16, 8), top_units=(16,),
              dense_microbatch=3)
    out3 = m3.apply(variables, batch, training=False)
    np.testing.assert_allclose(np.asarray(out1), np.asarray(out3),
                               rtol=0, atol=0)  # fallback IS the unsliced path
