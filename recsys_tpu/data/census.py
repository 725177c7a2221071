"""Census-income two-task pipeline (MMoE / PLE protocol).

Reproduces /root/reference/src/ctr/utils/data_process.py:229-294: the
census-income dataset becomes a two-task problem — task 1: income > 50k,
task 2: never-married — with categorical columns label-encoded (the
reference one-hots into a dense frame; this build embeds instead) and the
test file split 1:1 into val/test.
"""
from __future__ import annotations

import numpy as np
import pandas as pd

from recsys_tpu.core.features import DenseFeature, FeatureSchema, SparseFeature

COLUMNS = [
    "age", "class_worker", "det_ind_code", "det_occ_code", "education",
    "wage_per_hour", "hs_college", "marital_stat", "major_ind_code",
    "major_occ_code", "race", "hisp_origin", "sex", "union_member",
    "unemp_reason", "full_or_part_emp", "capital_gains", "capital_losses",
    "stock_dividends", "tax_filer_stat", "region_prev_res",
    "state_prev_res", "det_hh_fam_stat", "det_hh_summ", "instance_weight",
    "mig_chg_msa", "mig_chg_reg", "mig_move_reg", "mig_same",
    "mig_prev_sunbelt", "num_emp", "fam_under_18", "country_father",
    "country_mother", "country_self", "citizenship", "own_or_self",
    "vet_question", "vet_benefits", "weeks_worked", "year", "income_50k",
]
DENSE_COLS = [
    "age", "wage_per_hour", "capital_gains", "capital_losses",
    "stock_dividends", "num_emp", "weeks_worked",
]
DROP_COLS = ["instance_weight"]
LABEL_INCOME = "income_50k"
LABEL_MARITAL = "marital_stat"


def create_census_dataset(train_path: str, test_path: str, embed_dim: int = 8,
                          seed: int = 2020):
    train_df = pd.read_csv(train_path, names=COLUMNS)
    test_df = pd.read_csv(test_path, names=COLUMNS)
    return build_census_arrays(train_df, test_df, embed_dim, seed)


def build_census_arrays(train_df: pd.DataFrame, test_df: pd.DataFrame,
                        embed_dim: int = 8, seed: int = 2020):
    """Returns (schema, train, val, test) with labels dict
    {'income': >50k, 'marital': never married} (reference :241-252)."""
    n_train = len(train_df)
    df = pd.concat([train_df, test_df], ignore_index=True)
    y_income = (
        df[LABEL_INCOME].astype(str).str.strip().str.contains("50000+", regex=False)
    ).astype(np.float32)
    y_marital = (
        df[LABEL_MARITAL].astype(str).str.strip() == "Never married"
    ).astype(np.float32)

    sparse_cols = [
        c for c in COLUMNS
        if c not in DENSE_COLS + DROP_COLS + [LABEL_INCOME, LABEL_MARITAL]
    ]
    sparse = np.empty((len(df), len(sparse_cols)), np.int32)
    vocab = []
    for j, c in enumerate(sparse_cols):
        codes, uniq = pd.factorize(df[c].astype(str).str.strip(), sort=True)
        sparse[:, j] = codes
        vocab.append(len(uniq))
    dense = df[DENSE_COLS].to_numpy(np.float32)
    mn, mx = dense.min(axis=0), dense.max(axis=0)
    dense = (dense - mn) / np.where(mx > mn, mx - mn, 1.0)

    schema = FeatureSchema(
        dense=[DenseFeature(c) for c in DENSE_COLS],
        sparse=[SparseFeature(c, int(v), embed_dim)
                for c, v in zip(sparse_cols, vocab)],
    )

    def pack(sel):
        return {
            "dense": dense[sel],
            "sparse": sparse[sel],
            "label_income": y_income.to_numpy()[sel],
            "label_marital": y_marital.to_numpy()[sel],
        }

    train = pack(np.arange(n_train))
    # reference splits the test file 1:1 into val/test (:286-291)
    rng = np.random.default_rng(seed)
    rest = rng.permutation(np.arange(n_train, len(df)))
    half = len(rest) // 2
    return schema, train, pack(rest[:half]), pack(rest[half:])
