"""Hyperparameter tuning: grid / random search over CV (reference
``engine.py:868`` ``grid_search_tune_parameters``; the port's copy of the
JAX package's ``tuning.py``). The TPE tuner is not ported (ROADMAP.md
Queue A, item 19).
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np

from gpboost_tpu_torch.boosting.engine import cv


def grid_search_tune_parameters(
        param_grid: Dict[str, list], train_set, params: Optional[dict] = None,
        num_try_random: Optional[int] = None, nfold: int = 5,
        gp_model=None, use_gp_model_for_validation: bool = True,
        train_gp_model_cov_pars: bool = True, folds=None, metric=None,
        num_boost_round: int = 100, early_stopping_rounds: Optional[int] = None,
        seed: int = 0, verbose_eval: int = 1, **kwargs):
    """Exhaustive or random grid search via cross-validation.

    Returns {'best_params', 'best_iter', 'best_score'} like the reference.
    """
    keys = list(param_grid.keys())
    combos = list(itertools.product(*[param_grid[k] for k in keys]))
    rng = np.random.default_rng(seed)
    if num_try_random is not None and num_try_random < len(combos):
        idx = rng.choice(len(combos), size=num_try_random, replace=False)
        combos = [combos[i] for i in idx]
    base = dict(params or {})
    if metric is not None:
        base["metric"] = metric
    best = None
    for combo in combos:
        trial = dict(base)
        trial.update(dict(zip(keys, combo)))
        res = cv(trial, train_set, num_boost_round=num_boost_round,
                 gp_model=gp_model, nfold=nfold, folds=folds, seed=seed,
                 early_stopping_rounds=early_stopping_rounds,
                 use_gp_model_for_validation=use_gp_model_for_validation,
                 train_gp_model_cov_pars=train_gp_model_cov_pars)
        mean_keys = [k for k in res if k.endswith("-mean")]
        if not mean_keys:
            continue
        curve = res[mean_keys[0]]
        higher_better = mean_keys[0].startswith("auc")
        best_iter = (int(np.argmax(curve)) if higher_better
                     else int(np.argmin(curve)))
        score = curve[best_iter]
        is_better = (best is None or
                     (score > best["best_score"] if higher_better
                      else score < best["best_score"]))
        if verbose_eval and verbose_eval > 0:
            from gpboost_tpu_torch.utils.log import log_info
            log_info(f"params {dict(zip(keys, combo))}: {mean_keys[0]}="
                  f"{score:g} @ iter {best_iter + 1}")
        if is_better:
            best = {"best_params": dict(zip(keys, combo)),
                    "best_iter": best_iter + 1,
                    "best_score": score}
    return best
