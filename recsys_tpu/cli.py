"""Experiment runner CLI.

Replaces the reference's per-model ``train.py`` __main__ scripts with ONE
configurable entry point (SURVEY.md §5 config row: the reference hardcodes
hyperparameters and personal data paths in each script, e.g.
/root/reference/src/ctr/fm/train.py:25-34).

    python -m recsys_tpu.cli ctr    --model deepfm --data criteo.csv
    python -m recsys_tpu.cli ctr    --model fm                    # synthetic
    python -m recsys_tpu.cli din    [--reviews r.json --meta m.json]
    python -m recsys_tpu.cli multitask --model esmm|mmoe|ple [--census tr te]
    python -m recsys_tpu.cli match  --model dssm|senet|fm [--ml100k DIR]
    python -m recsys_tpu.cli ncf    [--ratings u.data]
    python -m recsys_tpu.cli sasrec [--ratings ratings.csv]

Defaults follow the reference protocol: Adam lr=1e-3, batch 512 (CTR) / 128
(NCF, multi-task) / 32 (DIN), EarlyStopping(val_loss, patience=1)
(/root/reference/src/ctr/fm/train.py:32-34,58-61).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _ctr_model(name, schema, **kw):
    from recsys_tpu.models.ctr.autoint import AutoInt
    from recsys_tpu.models.ctr.dcn import DCN
    from recsys_tpu.models.ctr.deep_crossing import DeepCrossing
    from recsys_tpu.models.ctr.deepfm import DeepFM
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.models.ctr.fm import FM
    from recsys_tpu.models.ctr.wide_deep import WideDeep

    zoo = {
        "fm": FM,
        "deepfm": DeepFM,
        "widedeep": WideDeep,
        "deepcrossing": DeepCrossing,
        "dcn": DCN,
        "dlrm": DLRM,
        "autoint": AutoInt,
    }
    return zoo[name](schema, **kw)


def run_ctr(args):
    from recsys_tpu.train.loop import Trainer

    stream = None
    if args.data and (args.stream or any(c in args.data for c in "*?[")):
        # out-of-core path: a glob (or --stream) streams criteo-format
        # files chunkwise through the native resumable parser — peak host
        # memory is one chunk, so full-size criteo train.txt fits any host
        from recsys_tpu.data.streaming import CriteoStream

        stream = CriteoStream(
            args.data, batch_size=args.batch_size,
            embed_dim=args.embed_dim,
        )
        schema, train, test = stream.schema, stream, None
    elif args.data:
        from recsys_tpu.data.criteo import create_criteo_dataset

        schema, train, test = create_criteo_dataset(
            args.data, embed_dim=args.embed_dim,
            read_part=args.sample_num > 0, sample_num=args.sample_num,
        )
    else:
        from recsys_tpu.data.synthetic import synthetic_ctr

        schema, data = synthetic_ctr(
            num_examples=20000, embed_dim=args.embed_dim, seed=0
        )
        cut = int(0.8 * len(data["label"]))
        train = {k: v[:cut] for k, v in data.items()}
        test = {k: v[cut:] for k, v in data.items()}

    kw = {}
    if args.embedding_optimizer:
        kw["sparse_embed_grads"] = True
    if args.bf16:
        if args.model != "dlrm":
            raise SystemExit("--bf16 compute is wired for --model dlrm")
        import jax.numpy as jnp

        kw["compute_dtype"] = jnp.bfloat16
    mesh = None
    if args.mesh_model > 1 or args.embedding_engine != "gather":
        from recsys_tpu.parallel.mesh import make_mesh

        mesh = make_mesh(model=max(args.mesh_model, 1))
        if args.embedding_engine != "gather":
            # one group table -> ONE a2a exchange pair per train step
            kw["embed_kw"] = {
                "engine": args.embedding_engine, "mesh": mesh,
                "num_groups": 1,
                "capacity_factor": (
                    args.capacity_factor if args.capacity_factor > 0
                    else None  # <=0 selects the exact (never-drop) mode
                ),
            }
    tr = Trainer(
        _ctr_model(args.model, schema, **kw),
        learning_rate=args.lr,
        embedding_optimizer=args.embedding_optimizer or None,
        mesh=mesh,
    )
    if stream is not None:
        hist = tr.fit(train, epochs=args.epochs)
        print(f"final train loss: {hist['loss'][-1]:.5f}")
        return hist["loss"][-1]
    tr.fit(
        train,
        batch_size=args.batch_size,
        epochs=args.epochs,
        validation_split=0.1,
        early_stopping_patience=1,
    )
    auc = tr.evaluate_auc(test)
    print(f"test AUC: {auc:.4f}")
    return auc


def run_din(args):
    from recsys_tpu.models.ctr.din import DIN
    from recsys_tpu.train.loop import Trainer

    if args.reviews and args.meta:
        from recsys_tpu.data.amazon import create_amazon_electronic_dataset

        schema, train, val, test = create_amazon_electronic_dataset(
            args.reviews, args.meta, embed_dim=args.embed_dim
        )
    else:
        from recsys_tpu.data.amazon import build_amazon_arrays, synthetic_reviews

        reviews, meta = synthetic_reviews(num_users=300, num_items=100)
        schema, train, val, test = build_amazon_arrays(
            reviews, meta, embed_dim=args.embed_dim, maxlen=20
        )
    tr = Trainer(DIN(schema), learning_rate=args.lr)
    tr.fit(train, batch_size=args.batch_size or 32, epochs=args.epochs,
           val_data=val, early_stopping_patience=1)
    print(f"test AUC: {tr.evaluate_auc(test):.4f}")


def run_multitask(args):
    from recsys_tpu.train import losses
    from recsys_tpu.train.loop import Trainer

    if args.census:
        from recsys_tpu.data.census import create_census_dataset

        schema, train, val, test = create_census_dataset(*args.census)
        t1, t2 = "income", "marital"
    else:
        from recsys_tpu.data.synthetic import synthetic_multitask

        schema, data = synthetic_multitask(num_examples=20000)
        flat = {"sparse": data["sparse"],
                **{f"label_{k}": v for k, v in data["labels"].items()}}
        cut = int(0.8 * len(data["sparse"]))
        train = {k: v[:cut] for k, v in flat.items()}
        test = val = {k: v[cut:] for k, v in flat.items()}
        t1, t2 = "ctr", "cvr"

    if args.model == "esmm":
        from recsys_tpu.models.ctr.esmm import ESMM

        model = ESMM(schema, num_user_fields=len(schema.sparse) // 2)

        def loss_fn(out, batch):
            return losses.bce_probs(out["ctr"], batch[f"label_{t1}"]) + \
                losses.bce_probs(out["ctcvr"], batch[f"label_{t2}"])
        heads = ("ctr", "ctcvr")
        from_logits = False
    else:
        if args.model == "mmoe":
            from recsys_tpu.models.ctr.mmoe import MMoE as M
        else:
            from recsys_tpu.models.ctr.ple import PLE as M
        model = M(schema, task_names=(t1, t2))

        def loss_fn(out, batch):
            return losses.multi_task_bce(
                out, {t1: batch[f"label_{t1}"], t2: batch[f"label_{t2}"]}
            )
        heads = (t1, t2)
        from_logits = True

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr)
    tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs,
           val_data=val, early_stopping_patience=1)
    import jax

    preds = tr.predict(test)
    from recsys_tpu.train.metrics import auc_exact

    for head, label in zip(heads, (t1, t2)):
        p = preds[head]
        if from_logits:
            p = np.asarray(jax.nn.sigmoid(p))
        print(f"{head} AUC: {auc_exact(p, test[f'label_{label}']):.4f}")


def run_match(args):
    import jax.numpy as jnp

    from recsys_tpu.models.match.fm_match import FMMatch
    from recsys_tpu.models.match.two_tower import DSSM, SENetDSSM
    from recsys_tpu.train.loop import Trainer
    from recsys_tpu.train.metrics import recall_at_k
    from recsys_tpu.train.retrieval import BruteForceIndex

    if args.ml100k:
        from recsys_tpu.data.movielens import create_ml_100k_dataset

        user_schema, item_schema, train, test = create_ml_100k_dataset(
            args.ml100k, embed_dim=args.embed_dim
        )
    else:
        import pandas as pd

        from recsys_tpu.data.movielens import build_ml100k_arrays, synthetic_ratings

        rng = np.random.default_rng(0)
        nu, ni = 300, 150
        ratings = synthetic_ratings(num_users=nu, num_items=ni)
        users = pd.DataFrame({
            "user_id": np.arange(1, nu + 1),
            "age": rng.integers(10, 70, nu),
            "gender": rng.choice(["M", "F"], nu),
            "occupation": rng.choice(list("abcdefg"), nu),
            "zip": ["0"] * nu,
        })
        items = pd.DataFrame({"item_id": np.arange(1, ni + 1),
                              "release_date": ["1995"] * ni})
        user_schema, item_schema, train, test = build_ml100k_arrays(
            ratings, users, items, embed_dim=args.embed_dim
        )

    use_softmax = args.retrieval_loss == "softmax" and args.model != "fm"
    if args.model == "fm":
        model = FMMatch(user_schema, item_schema)
        dim = user_schema.embed_dim
        normalize = False  # FM-match trains on inner products
    else:
        maker = SENetDSSM if args.model == "senet" else DSSM
        model = maker(
            user_schema, item_schema, out_dim=32, gamma=10.0,
            output_mode="pair" if use_softmax else "score",
        )
        dim = 32
        normalize = True  # towers train/score by cosine

    if use_softmax:
        # retrieval-quality trainer: positives only, in-batch negatives
        # (measured recall@10 0.23 vs 0.06 with the BCE-on-rated-pairs
        # protocol on the synthetic fixture); --retrieval-loss bce restores
        # the reference protocol exactly
        from recsys_tpu.train import losses as losses_lib

        keep = train["label"] > 0.5
        train = {k: v[keep] for k, v in train.items()}
        # logQ correction: in-batch negatives are implicitly drawn from the
        # item-popularity distribution; subtracting log q(item) stops
        # popular items being over-penalised as negatives (default on;
        # --no-logq restores the uncorrected objective)
        log_q = None
        if args.logq:
            counts = np.bincount(
                train["item_sparse"][:, 0],
                minlength=item_schema.sparse[0].vocab_size,
            )
            log_q = jnp.asarray(losses_lib.popularity_log_q(counts))

        def loss_fn(out, batch):
            u = out["user"] / jnp.maximum(
                jnp.linalg.norm(out["user"], axis=-1, keepdims=True), 1e-8)
            i = out["item"] / jnp.maximum(
                jnp.linalg.norm(out["item"], axis=-1, keepdims=True), 1e-8)
            lq = None if log_q is None else log_q[batch["item_sparse"][:, 0]]
            return losses_lib.in_batch_sampled_softmax(
                u, i, item_log_q=lq, temperature=0.1)

        tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr)
        tr.fit(train, batch_size=args.batch_size or 512, epochs=args.epochs)
    else:
        tr = Trainer(model, learning_rate=args.lr)
        tr.fit(train, batch_size=args.batch_size or 512, epochs=args.epochs,
               validation_split=0.1, early_stopping_patience=1)

    variables = {"params": tr.state.params, "batch_stats": tr.state.batch_stats}
    n_items = item_schema.sparse[0].vocab_size
    catalog = {"item_sparse": jnp.arange(n_items)[:, None].astype(jnp.int32)}
    item_embs = model.apply(variables, catalog, method=model.item_embed)
    index = BruteForceIndex(dim, normalize=normalize)
    index.add(item_embs)
    pos = test["label"] > 0.5
    users_q = {"user_sparse": jnp.asarray(test["user_sparse"][pos])}
    u = model.apply(variables, users_q, method=model.user_embed)
    _, I = index.search(u, 10)
    r = recall_at_k(np.asarray(I), test["item_sparse"][pos, 0])
    print(f"recall@10: {r:.4f} over {n_items} items "
          f"(random {10 / n_items:.4f})")


def run_ncf(args):
    import jax

    from recsys_tpu.data.movielens import build_ncf_dataset, synthetic_ratings
    from recsys_tpu.models.match.ncf import NCF
    from recsys_tpu.train import losses
    from recsys_tpu.train.loop import Trainer
    from recsys_tpu.train.metrics import hit_rate_ndcg_at_k

    if args.ratings:
        from recsys_tpu.data.movielens import create_ncf_dataset

        nu, ni, train, val, test = create_ncf_dataset(args.ratings)
    else:
        nu, ni, train, val, test = build_ncf_dataset(
            synthetic_ratings(num_users=300, num_items=150)
        )
    model = NCF(num_users=nu, num_items=ni)

    def loss_fn(out, batch):
        return losses.pairwise_bce(out["pos_logits"], out["neg_logits"])

    def eval_fn(trainer):
        # the reference's every-2-epoch ranked eval (ncf/train.py:64-80)
        out = trainer.predict(test)
        hr, ndcg = hit_rate_ndcg_at_k(
            jax.numpy.asarray(out["pos_logits"]),
            jax.numpy.asarray(out["neg_logits"]), k=10,
        )
        return {"HR@10": float(hr), "NDCG@10": float(ndcg)}

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr)
    tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs,
           eval_fn=eval_fn, eval_every=2)


def run_sasrec(args):
    import jax

    from recsys_tpu.data.movielens import (
        build_sasrec_dataset,
        synthetic_ratings,
    )
    from recsys_tpu.models.match.sasrec import SASRec
    from recsys_tpu.train import losses
    from recsys_tpu.train.loop import Trainer
    from recsys_tpu.train.metrics import hit_rate_ndcg_at_k

    all_pos = not args.sasrec_prefix  # all-position scheme by default
    if args.ratings:
        import pandas as pd

        ratings = pd.read_csv(args.ratings).rename(
            columns={"userId": "user_id", "movieId": "item_id"}
        )
    else:
        ratings = synthetic_ratings(num_users=300, num_items=150)
    ni, train, val, test = build_sasrec_dataset(
        ratings, maxlen=args.maxlen, all_positions=all_pos
    )
    model = SASRec(num_items=ni, embed_dim=64, max_len=args.maxlen)

    def loss_fn(out, batch):
        return losses.pairwise_bce(out["pos_logits"], out["neg_logits"],
                                   mask=out.get("mask"))

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr)
    tr.fit(train, batch_size=args.batch_size or 128, epochs=args.epochs,
           verbose=True)
    out = tr.predict(test)
    hr, ndcg = hit_rate_ndcg_at_k(
        jax.numpy.asarray(out["pos_logits"]),
        jax.numpy.asarray(out["neg_logits"]), k=10,
    )
    print(f"test HR@10={float(hr):.4f} NDCG@10={float(ndcg):.4f}")


def run_seq_retrieval(args):
    """YoutubeDNN / MIND: in-batch sampled-softmax training + recall@10 over
    the full catalog (brute-force top-k engine)."""
    import jax
    import jax.numpy as jnp

    from recsys_tpu.core.features import FeatureSchema, VarLenSparseFeature
    from recsys_tpu.data.movielens import (
        build_seq_retrieval_dataset,
        synthetic_ratings,
    )
    from recsys_tpu.train import losses
    from recsys_tpu.train.loop import Trainer
    from recsys_tpu.train.metrics import recall_at_k
    from recsys_tpu.train.retrieval import topk_scores

    if args.ratings:
        import pandas as pd

        ratings = pd.read_csv(
            args.ratings, sep="\t",
            names=["user_id", "item_id", "rating", "timestamp"],
        ) if args.ratings.endswith(".data") else pd.read_csv(args.ratings)
        ratings = ratings.rename(
            columns={"userId": "user_id", "movieId": "item_id"}
        )
    else:
        ratings = synthetic_ratings(num_users=300, num_items=150)
    ni, train, test = build_seq_retrieval_dataset(ratings, maxlen=args.maxlen)

    if args.model == "mind":
        from recsys_tpu.models.match.mind import MIND

        model = MIND(num_items=ni, embed_dim=args.embed_dim * 4, k_max=4)
    else:
        from recsys_tpu.models.match.youtube_dnn import YoutubeDNN

        schema = FeatureSchema(
            varlen=[VarLenSparseFeature("hist_item", ni, args.embed_dim * 4,
                                        max_len=args.maxlen)]
        )
        model = YoutubeDNN(schema, num_items=ni, embed_dim=args.embed_dim * 4)

    # logQ correction from the train stream's empirical item popularity
    # (ids are 1-based, 0 = pad — counts indexed by raw id)
    log_q = None
    if args.logq:
        counts = np.bincount(train["item_id"], minlength=ni)
        log_q = jnp.asarray(losses.popularity_log_q(counts))

    def loss_fn(out, batch):
        lq = None if log_q is None else log_q[batch["item_id"]]
        return losses.in_batch_sampled_softmax(
            out["user"], out["item"], item_log_q=lq)

    tr = Trainer(model, loss_fn=loss_fn, learning_rate=args.lr)
    tr.fit(train, batch_size=args.batch_size or 256, epochs=args.epochs,
           verbose=True)

    variables = {"params": tr.state.params, "batch_stats": tr.state.batch_stats}
    items = model.apply(variables, method=model.all_item_embeddings)
    if args.model == "mind":
        caps = model.apply(variables, {"hist": jnp.asarray(test["hist"])},
                           method=model.interests)  # (B, K, D)
        scores = jnp.einsum("bkd,nd->bkn", caps, items).max(axis=1)
        _, I = jax.lax.top_k(scores, 10)
    else:
        u = model.apply(variables, {"hist": jnp.asarray(test["hist"])},
                        method=model.user_embed)
        _, I = topk_scores(u, items, k=10)
    r = recall_at_k(np.asarray(I), test["item_id"])
    print(f"recall@10: {r:.4f} over {ni} items (random {10 / ni:.4f})")


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu")
    p.add_argument("task", choices=["ctr", "din", "multitask", "match",
                                    "ncf", "sasrec", "youtube", "mind"])
    p.add_argument("--model", default="fm")
    p.add_argument("--data", default=None,
                   help="criteo csv path; a glob (or --stream) selects "
                   "the out-of-core chunk-streaming loader")
    p.add_argument("--stream", action="store_true",
                   help="stream --data chunkwise (larger-than-RAM files)")
    p.add_argument("--reviews", default=None)
    p.add_argument("--meta", default=None)
    p.add_argument("--census", nargs=2, default=None)
    p.add_argument("--ml100k", default=None)
    p.add_argument("--ratings", default=None)
    p.add_argument("--embed-dim", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--maxlen", type=int, default=50)
    p.add_argument("--sample-num", type=int, default=0)
    p.add_argument("--embedding-optimizer", default="",
                   choices=["", "lazy_adam", "rowwise_adagrad",
                            "fused_adam", "fused_rowwise_adagrad"],
                   help="table-update path (ctr task): lazy_adam/"
                        "rowwise_adagrad are sparse touched-rows updates; "
                        "fused_* apply an exact dense Adam / rowwise "
                        "AdaGrad from the perturbation tap (one "
                        "scatter-add + one elementwise pass per table)")
    p.add_argument("--embedding-engine", default="gather",
                   choices=["gather", "psum", "dedup", "a2a",
                            "a2a_pipelined"],
                   help="sharded-lookup engine for ctr models (a2a = "
                        "explicit all-to-all id exchange over the model "
                        "mesh axis)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="model-axis size for embedding-table row sharding "
                        "(data axis takes the remaining devices)")
    p.add_argument("--capacity-factor", type=float, default=2.0,
                   help="a2a owner-bucket capacity factor; <=0 = exact "
                        "(never drop) mode")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (DLRM)")
    p.add_argument("--retrieval-loss", choices=["softmax", "bce"],
                   default="softmax")
    p.add_argument("--no-logq", dest="logq", action="store_false",
                   help="disable the logQ popularity correction in the "
                        "in-batch softmax retrieval losses")
    p.add_argument("--sasrec-prefix", action="store_true",
                   help="exploded-prefix training instead of all-position")
    args = p.parse_args(argv)
    from recsys_tpu.tools import enable_compile_cache

    enable_compile_cache()
    if args.task in ("youtube", "mind"):
        args.model = "mind" if args.task == "mind" else "youtube"
    return {
        "ctr": run_ctr,
        "din": run_din,
        "multitask": run_multitask,
        "match": run_match,
        "ncf": run_ncf,
        "sasrec": run_sasrec,
        "youtube": run_seq_retrieval,
        "mind": run_seq_retrieval,
    }[args.task](args)


if __name__ == "__main__":
    main()
