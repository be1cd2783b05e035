"""Boosting parameters of the PyTorch port: aliases and what is not ported.

A minimal, own copy of the part of the reference's parameter registry
(``Config::KeyAliasTransform``; the JAX package's ``gpboost_tpu/config.py``)
that the ported boosting path reads. ``resolve_params`` maps aliases to
canonical names (the canonical name wins when both are given) and refuses
what the port cannot honour:

- a value whose feature is not ported (several GPUs, the device-resident
  loop) raises ``NotImplementedError`` naming the ROADMAP.md queue item;
- a key this module does not know raises ``NotImplementedError`` too (the
  full registry with type and range checks is ROADMAP.md Queue A, item 19).

Nothing that changes results is ever dropped silently.
"""
from __future__ import annotations

from typing import Optional

# canonical name -> aliases (entries copied from the reference registry)
_ALIASES_OF = {
    "objective": ("application", "loss"),
    "boosting": ("boosting_type",),
    "num_iterations": ("num_iteration", "n_iter", "num_tree", "num_trees",
                       "num_round", "num_rounds", "n_estimators"),
    "learning_rate": ("shrinkage_rate", "eta"),
    "num_leaves": ("num_leaf", "max_leaves"),
    "min_data_in_leaf": ("min_data_per_leaf", "min_data",
                         "min_child_samples"),
    "min_sum_hessian_in_leaf": ("min_sum_hessian_per_leaf",
                                "min_child_weight"),
    "lambda_l1": ("reg_alpha",),
    "lambda_l2": ("reg_lambda",),
    "verbose": ("verbosity",),
    "tree_learner": ("tree", "tree_type", "tree_learner_type"),
    "bagging_fraction": ("sub_row", "subsample"),
    "bagging_freq": ("subsample_freq",),
    "feature_fraction": ("sub_feature", "colsample_bytree"),
    "feature_fraction_bynode": ("sub_feature_bynode", "colsample_bynode"),
    "categorical_feature": ("cat_feature", "categorical_column",
                            "cat_column"),
    "max_delta_step": ("max_tree_output", "max_leaf_output"),
    "metric": ("metrics", "metric_types"),
    "enable_bundle": ("is_enable_bundle", "bundle"),
    "early_stopping_round": ("early_stopping_rounds", "early_stopping",
                             "n_iter_no_change"),
    "feature_contri": ("feature_contrib", "fc", "fp", "feature_penalty"),
    "is_provide_training_metric": ("training_metric", "is_training_metric",
                                   "train_metric"),
    "is_unbalance": ("unbalance", "unbalanced_sets"),
    # the query / group column of the ranking objectives (not the grouped
    # random effects of GPModel(group_data=...), which are no parameter)
    "group_column": ("group", "group_id", "query_column", "query",
                     "query_id"),
    "metric_freq": ("output_freq",),
    "eval_at": ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at"),
    "bagging_seed": ("bagging_fraction_seed",),
    "output_model": ("model_output", "model_out"),
}
ALIAS_TABLE = {alias: name for name, aliases in _ALIASES_OF.items()
               for alias in aliases}

# what the ported path reads (``gpu_use_dp``, the reference's key of that
# name: float64 gradients and histograms on the GPU, float32 otherwise)
PORTED = (
    "objective", "boosting", "num_iterations", "learning_rate", "num_leaves",
    "max_depth", "min_data_in_leaf", "min_sum_hessian_in_leaf", "lambda_l1",
    "lambda_l2", "min_gain_to_split", "max_bin", "min_data_in_bin",
    "boost_from_average", "tree_learner", "num_class",
    "train_gp_model_cov_pars", "reuse_learning_rates_gp_model", "gpu_use_dp",
    "sigmoid", "is_unbalance", "scale_pos_weight",
    # sampling: bagging (balanced too) and feature fractions, by tree and by
    # node, each from its own numpy generator when its seed is given
    "bagging_fraction", "bagging_freq", "pos_bagging_fraction",
    "neg_bagging_fraction", "feature_fraction", "feature_fraction_bynode",
    "seed", "bagging_seed", "feature_fraction_seed",
    # validation: metrics, early stopping, the GP in the validation score,
    # snapshots
    "metric", "first_metric_only", "metric_freq", "early_stopping_round",
    "is_provide_training_metric", "use_gp_model_for_validation",
    "multi_error_top_k", "auc_mu_weights", "snapshot_freq", "output_model",
    # the objectives without a GP
    "reg_sqrt", "alpha", "fair_c", "poisson_max_delta_step",
    "tweedie_variance_power", "sigma", "yl", "yu",
    # the tree learner's tail and the data it reads: categorical features,
    # EFB, the missing-value switches, per-feature and forced bins, the
    # grower's constraints and penalties, linear leaves
    "categorical_feature", "max_cat_threshold", "cat_l2", "cat_smooth",
    "min_data_per_group", "max_cat_to_onehot", "enable_bundle",
    "use_missing", "zero_as_missing", "max_bin_by_feature",
    "forcedbins_filename", "monotone_constraints",
    "monotone_constraints_method", "monotone_penalty",
    "interaction_constraints", "forced_splits", "forcedsplits_filename",
    "extra_trees", "extra_seed", "path_smooth", "max_delta_step",
    "feature_contri", "cegb_tradeoff", "cegb_penalty_split",
    "cegb_penalty_feature_lazy", "cegb_penalty_feature_coupled",
    "linear_tree", "linear_lambda",
    # the rest of the boosting tail: DART, GOSS, random forests, Nesterov
    # acceleration, the GP leaf re-solves, ranking (``group_column`` names
    # the query column of a data file: the Python API takes
    # ``Dataset(group=)``, and the JAX package reads the key nowhere), the
    # prediction early stop
    "drop_rate", "max_drop", "skip_drop", "uniform_drop",
    "xgboost_dart_mode", "drop_seed", "top_rate", "other_rate",
    "use_nesterov_acc", "nesterov_acc_rate", "momentum_offset",
    "momentum_schedule_version", "leaves_newton_update",
    "line_search_step_length", "lambdarank_truncation_level",
    "lambdarank_norm", "label_gain", "objective_seed", "eval_at",
    "group_column", "pred_early_stop", "pred_early_stop_freq",
    "pred_early_stop_margin",
)

# accepted without effect on the ported path: logging, host threading, and
# ``deterministic``: training is always deterministic, on the card too (the
# histogram kernel and the float64 histogram sum in fixed point, ``B' v`` of
# the Psi^-1 solve is a gather with a fixed order; no float atomics remain on
# the path)
_NO_EFFECT = ("verbose", "num_threads", "device_type", "deterministic",
              "force_col_wise", "force_row_wise")

BOOSTING_TYPES = ("gbdt", "dart", "goss", "rf")

def _not_ported(key: str, value, queue: str) -> NotImplementedError:
    return NotImplementedError(
        f"parameter '{key}' = {value!r} needs a feature that is not ported "
        f"to gpboost_tpu_torch yet (ROADMAP.md {queue})")


def _refuse_unported(key: str, value) -> None:
    if key == "boosting":
        if value not in BOOSTING_TYPES:
            raise ValueError(f"parameter 'boosting' = {value!r} is not one "
                             f"of {BOOSTING_TYPES}")
    elif key == "num_class":
        if int(value) < 1:
            raise ValueError(f"parameter 'num_class' = {value!r} violates "
                             "constraint > 0")
    elif key == "tree_learner":
        if value not in ("serial", "data"):
            raise _not_ported(key, value, "Queue A, item 20 (multi-GPU)")
    elif key == "device_resident_boosting":
        if str(value).lower() not in ("auto", "true", "false", "none"):
            raise ValueError("device_resident_boosting must be 'auto', "
                             f"'true' or 'false', got {value!r}")
    elif key not in PORTED and key not in _NO_EFFECT:
        raise NotImplementedError(
            f"parameter '{key}' is not known to gpboost_tpu_torch (the full "
            "parameter registry is ROADMAP.md Queue A, item 19); known: "
            f"{sorted(PORTED)}")


def resolve_aliases(params: Optional[dict]) -> dict:
    """``params`` with every alias replaced by its canonical name; when both
    are given the canonical key wins (``Config::KeyAliasTransform``)."""
    params = dict(params or {})
    out = {}
    for key, value in params.items():
        canon = ALIAS_TABLE.get(key, key)
        if canon != key and (canon in params or canon in out):
            continue
        out[canon] = value
    return out


def resolve_params(params: Optional[dict]) -> dict:
    """Canonical parameter dict of a user's ``params``: aliases resolved
    (the canonical key wins when both are present), every key checked
    against what the port supports. Raises ``NotImplementedError`` for a
    key that is unknown or whose feature is not ported."""
    out = resolve_aliases(params)
    for key, value in out.items():
        _refuse_unported(key, value)
    return out
