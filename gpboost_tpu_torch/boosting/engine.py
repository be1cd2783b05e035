"""Training engine: ``train`` and ``cv`` (reference ``engine.py:21,540``).

The JAX package's host loop, in the port's idiom: every Dataset, fold and
fold GPModel lives on the training Dataset's device. ``train`` hands the
whole training to the device-resident loop (``device_loop.py``) where
``device_resident_boosting`` and the configuration allow it, without a
fallback to the host loop. ``init_model`` (continued training) raises: the
JAX package takes the argument and never reads it (ROADMAP.md, "Not
faults").
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.boosting.booster import Booster
from gpboost_tpu_torch.boosting.callback import (CallbackEnv,
                                                 EarlyStopException,
                                                 early_stopping,
                                                 print_evaluation,
                                                 record_evaluation,
                                                 reset_parameter)
from gpboost_tpu_torch.boosting.dataset import Dataset

# continued training is no feature of the JAX package: it takes init_model
# and never reads it (its engine.py:17, :144), so the port refuses the argument
# rather than drop it (ROADMAP.md, "Not faults", the case of item 18c)
_INIT_MODEL = ("{}(init_model=...): continued training is not ported: the "
               "JAX package accepts the argument and never reads it "
               "(ROADMAP.md, Not faults; item 18c)")


def train(params: dict, train_set: Dataset, num_boost_round: int = 100,
          gp_model=None, valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None, fobj=None, feval=None,
          init_model=None, feature_name="auto", categorical_feature="auto",
          early_stopping_rounds: Optional[int] = None,
          evals_result=None, verbose_eval: bool = True, learning_rates=None,
          keep_training_booster: bool = False, callbacks=None,
          train_gp_model_cov_pars: bool = True,
          use_gp_model_for_validation: bool = True) -> Booster:
    """Train a (GP)Boost model (mirrors ``gpboost.train``, ``engine.py:21``)
    with the host-driven loop: ``num_boost_round`` calls of
    ``Booster.update``, or, where ``device_loop.eligible`` says so (no
    snapshots, callbacks, ``evals_result``, ``learning_rates`` or training
    metric either), the device-resident loop ``device_loop.train_device``. With a ``gp_model`` this is the GPBoost algorithm
    (gaussian likelihood) or the LaGaBoost algorithm (the others; the
    objective names no distribution then, e.g. ``"binary"``), the GP's
    parameters refitted every round with its optimizer settings
    (``gp_model.set_optim_params``).

    ``valid_sets`` (the training set itself is skipped) are scored after
    every round with the booster's metrics and ``feval(score, dataset)``;
    early stopping (``early_stopping_rounds`` or the params'
    ``early_stopping_round``) stops after that many rounds without a better
    value and sets ``best_iteration``, keeping the later trees.
    ``snapshot_freq`` > 0 saves the model as JSON every that many rounds to
    ``{output_model}.snapshot_iter_{k}``. ``feature_name`` and
    ``categorical_feature`` other than ``"auto"`` are set on ``train_set``
    (names or indices; the Dataset bins again when its categorical features
    change). ``keep_training_booster`` is taken and has no effect (the
    booster can always train on), as in the JAX package. ``init_model``
    raises: continued training is not in the JAX package, which takes the
    argument and never reads it.
    """
    if init_model is not None:
        raise NotImplementedError(_INIT_MODEL.format("train"))
    params = cfg_mod.resolve_params(params)
    params.setdefault("train_gp_model_cov_pars", train_gp_model_cov_pars)
    params.setdefault("use_gp_model_for_validation",
                      use_gp_model_for_validation)
    num_boost_round = int(params.pop("num_iterations", num_boost_round))
    if feature_name != "auto":
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto":
        train_set.set_categorical_feature(categorical_feature)

    booster = Booster(params=params, train_set=train_set, gp_model=gp_model)
    if valid_sets:
        names = valid_names or [f"valid_{i}" for i in range(len(valid_sets))]
        for vs, name in zip(valid_sets, names):
            if vs is train_set:
                continue
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    # the params form of early stopping (config.h:375 early_stopping_round
    # + :380 first_metric_only); the keyword wins when both are given
    if early_stopping_rounds is None:
        esr = int(params.get("early_stopping_round", 0) or 0)
        if esr > 0:
            early_stopping_rounds = esr
    if early_stopping_rounds is not None and booster.valid_sets:
        cbs.append(early_stopping(
            early_stopping_rounds,
            first_metric_only=bool(params.get("first_metric_only", False)),
            verbose=bool(verbose_eval)))
    if evals_result is not None:
        cbs.append(record_evaluation(evals_result))
    metric_freq = int(params.get("metric_freq", 1))
    if verbose_eval is True and booster.valid_sets:
        cbs.append(print_evaluation(period=metric_freq))
    elif isinstance(verbose_eval, int) and verbose_eval > 1:
        cbs.append(print_evaluation(period=verbose_eval))
    # is_provide_training_metric (config.h:981): evaluate on the training
    # data too, reported as 'training'
    if bool(params.get("is_provide_training_metric", False)):
        booster.set_train_data_name("training")
        booster._eval_train_metric = True
    if learning_rates is not None:
        cbs.append(reset_parameter(learning_rate=learning_rates))
    cbs.sort(key=lambda c: getattr(c, "order", 0))

    # periodic model snapshots (GBDT::Train, reference gbdt.cpp:306-310)
    snapshot_freq = int(params.get("snapshot_freq", -1))
    output_model = params.get("output_model", "gpboost_tpu_model.json")

    # the whole training with its state on the device (device_loop.py):
    # refit, gradient, tree and score update of every round, one fetch at
    # the end. Unlike the JAX package's train, no fallback to the host loop:
    # an exception propagates (ROADMAP.md, Not faults)
    from gpboost_tpu_torch.boosting import device_loop
    if (num_boost_round > 0 and snapshot_freq <= 0 and not cbs
            and evals_result is None and learning_rates is None
            and not booster._eval_train_metric
            and device_loop.eligible(booster, fobj, cbs)):
        device_loop.train_device(booster, num_boost_round)
        return booster
    try:
        for it in range(num_boost_round):
            booster.update(fobj=fobj)
            if snapshot_freq > 0 and (it + 1) % snapshot_freq == 0:
                booster.save_model(f"{output_model}.snapshot_iter_{it + 1}")
            eval_list = []
            if booster._eval_train_metric and (it + 1) % metric_freq == 0:
                eval_list.extend(booster.eval_train())
            if booster.valid_sets or evals_result is not None:
                eval_list.extend(booster.eval_valid())
                if feval is not None:
                    for vset, name, score in zip(booster.valid_sets,
                                                 booster.valid_names,
                                                 booster._valid_scores):
                        res = feval(score, vset)
                        if isinstance(res, tuple):
                            res = [res]
                        for mname, val, hb in res:
                            eval_list.append((name, mname, val, hb))
            env = CallbackEnv(model=booster, params=params, iteration=it,
                              begin_iteration=0, end_iteration=num_boost_round,
                              evaluation_result_list=eval_list)
            for cb in cbs:
                cb(env)
    except EarlyStopException as e:
        booster.best_iteration = e.best_iteration + 1
    return booster


class CVBooster:
    """Container of the folds' boosters (``engine.py:340``)."""

    def __init__(self):
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, b):
        self.boosters.append(b)


def _make_folds(n, nfold, stratified, labels, seed, folds=None,
                gp_model=None, groups=None):
    """The folds' test rows: ``folds`` as given, else a permutation from
    ``seed`` dealt out round-robin (``stratified`` and ``shuffle`` are not
    read, as in the JAX package)."""
    if folds is not None:
        return list(folds)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    return [idx[i::nfold] for i in range(nfold)]


def cv(params: dict, train_set: Dataset, num_boost_round: int = 100,
       gp_model=None, folds=None, nfold: int = 5, stratified: bool = False,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, early_stopping_rounds: Optional[int] = None,
       fit_GP_cov_pars_OOS: bool = False, train_gp_model_cov_pars: bool = True,
       use_gp_model_for_validation: bool = True, verbose_eval: bool = False,
       seed: int = 0, callbacks=None, eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, List[float]]:
    """Cross-validation (``gpboost.cv``, ``engine.py:540``) with GP-aware
    folds: each fold trains on its rows with a GPModel of the same structure
    built on them (:func:`_subset_gp_model`), and validates on the held-out
    rows with the GP's prediction there. ``fit_GP_cov_pars_OOS`` refits
    ``gp_model`` on the out-of-sample residuals at the largest best
    iteration of the folds (GPBoostOOS). Returns ``{metric-mean,
    metric-stdv}`` curves (and the ``cvbooster`` with
    ``return_cvbooster``)."""
    if init_model is not None:
        raise NotImplementedError(_INIT_MODEL.format("cv"))
    n = train_set.num_data
    fold_idx = _make_folds(n, nfold, stratified, train_set.label, seed, folds,
                           gp_model)
    params = dict(params or {})
    if metrics is not None:
        params["metric"] = metrics
    results: Dict[str, List[float]] = {}
    cvb = CVBooster()
    per_fold_curves = []
    for test_idx in fold_idx:
        test_mask = np.zeros(n, dtype=bool)
        test_mask[np.asarray(test_idx, dtype=int)] = True
        tr = ~test_mask
        sub_train = Dataset(train_set.raw_data[tr], label=train_set.label[tr],
                            max_bin=train_set.max_bin,
                            categorical_feature=train_set.categorical_feature,
                            device=train_set.device)
        sub_valid = sub_train.create_valid(train_set.raw_data[test_mask],
                                           label=train_set.label[test_mask])
        fold_gp = None
        if gp_model is not None:
            fold_gp = _subset_gp_model(gp_model, tr)
            fold_gp._valid_pred_data = _subset_gp_pred_kwargs(gp_model,
                                                              test_mask)
        evals = {}
        bst = train(params, sub_train, num_boost_round=num_boost_round,
                    gp_model=fold_gp, valid_sets=[sub_valid],
                    valid_names=["valid"], fobj=fobj, feval=feval,
                    early_stopping_rounds=early_stopping_rounds,
                    evals_result=evals, verbose_eval=verbose_eval,
                    callbacks=callbacks,
                    train_gp_model_cov_pars=train_gp_model_cov_pars,
                    use_gp_model_for_validation=use_gp_model_for_validation)
        cvb.append(bst)
        per_fold_curves.append(evals.get("valid", {}))
    # GPBoostOOS: covariance parameters estimated on out-of-sample errors
    # (reference gpb.cv(fit_GP_cov_pars_OOS=True), engine.py:540)
    if fit_GP_cov_pars_OOS and gp_model is not None:
        best_iters = []
        for c in per_fold_curves:
            if c:
                curve = next(iter(c.values()))
                best_iters.append(int(np.argmin(curve)) + 1)
        nbr = max(best_iters) if best_iters else num_boost_round
        oos_score = np.zeros(n)
        for k, test_idx in enumerate(fold_idx):
            test_idx = np.asarray(test_idx, dtype=int)
            oos_score[test_idx] = cvb.boosters[k]._predict_raw(
                train_set.raw_data[test_idx], num_iteration=nbr)
        if gp_model.is_gaussian:
            gp_model.fit(y=train_set.label - oos_score)
        else:
            gp_model.fit(y=train_set.label, fixed_effects=oos_score)
    for metric in (per_fold_curves[0] or {}):
        curves = [c[metric] for c in per_fold_curves]
        L = min(len(c) for c in curves)
        arr = np.asarray([c[:L] for c in curves])
        results[f"{metric}-mean"] = list(arr.mean(axis=0))
        results[f"{metric}-stdv"] = list(arr.std(axis=0))
    if return_cvbooster:
        results["cvbooster"] = cvb
    return results


def _structure_columns(gp_model):
    """(coordinates, level codes of the grouped effects' base columns,
    cluster codes) of a GPModel's training data on the host; None where the
    model has none."""
    data = getattr(gp_model, "data", None)
    group = None
    if data is not None and data.group_codes is not None:
        n_base = len(gp_model._group_maps)
        group = data.group_codes.cpu().numpy()[:, :n_base]
    if getattr(gp_model, "_approx_codes", None) is not None:
        clusters = np.asarray(gp_model._approx_codes)
    elif data is not None and data.cluster_codes is not None:
        clusters = data.cluster_codes.cpu().numpy()
    else:
        clusters = None
    return gp_model.coords_np, group, clusters


def _subset_gp_model(gp_model, mask):
    """A GPModel of the same structure on a row subset (GP-aware CV folds,
    ``engine.py:380``). As in the JAX package it takes the likelihood, the
    covariance function, its shape and the approximation only: the
    neighbours, the dtype, the inversion method and the optimizer settings
    are the defaults. It lives on ``gp_model``'s device."""
    from gpboost_tpu_torch.models.gp_model import GPModel
    coords, group, clusters = _structure_columns(gp_model)
    kwargs = dict(likelihood=gp_model.likelihood,
                  cov_function=gp_model.cov_function_name,
                  cov_fct_shape=gp_model.cov_fct_shape,
                  gp_approx=gp_model.gp_approx, device=gp_model.device)
    if coords is not None:
        kwargs["gp_coords"] = coords[mask]
    if group is not None:
        kwargs["group_data"] = group[mask]
    if clusters is not None:
        kwargs["cluster_ids"] = clusters[mask]
    return GPModel(**kwargs)


def _subset_gp_pred_kwargs(gp_model, mask):
    """The prediction data of the held-out rows (the structure columns of
    :func:`_subset_gp_model`)."""
    coords, group, clusters = _structure_columns(gp_model)
    out = {}
    if coords is not None:
        out["gp_coords_pred"] = coords[mask]
    if group is not None:
        out["group_data_pred"] = group[mask]
    if clusters is not None:
        out["cluster_ids_pred"] = clusters[mask]
    return out
