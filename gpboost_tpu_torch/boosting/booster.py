"""Booster: the gradient-boosting engine (GBDT core).

The equivalent of the reference's ``GBDT`` class
(``src/LightGBM/boosting/gbdt.cpp``): ``TrainOneIter`` (:404) becomes
``update()`` — gradients from the objective (including the GPBoost and
LaGaBoost couplings) or a custom ``fobj``, bagging and feature sampling,
one leaf-wise tree per model of the iteration (``num_class`` of them for
the multiclass objectives, two for ``mean_scale_regression``), shrinkage,
the training and validation score updates — and the ``Booster`` public
class mirrors ``gpboost.Booster`` (``basic.py:2323``): train / eval /
predict / save, ``gp_model`` attachment, GP-aware validation
(``use_gp_model_for_validation``, the GP metrics) and combined prediction
(``basic.py:3560-3650``).

The score stays a host float64 array (``[n * num_models]``, model-major)
and gradients cross to the device once per tree, as in the JAX package's
host loop; trees grow on the device of the training ``Dataset``. On a GPU
the gradients are float32 there (LightGBM's default histogram precision)
and every histogram goes through the hand-written kernel; ``gpu_use_dp=True``
keeps them float64, which runs the plain histogram on the GPU. On the CPU
they are float64. The random draws (bags, feature sets by tree and by node)
come from numpy generators seeded and drawn as the JAX package draws them,
so both packages grow the same trees from the same parameters.

The grower's options come from ``params`` as in the JAX package
(``booster.py:80-211``): categorical features (the Dataset's), monotone and
interaction constraints, forced splits (``forced_splits`` /
``forcedsplits_filename``, thresholds resolved to bins), CEGB, extra trees
(``extra_seed``'s own generator), path smoothing, ``max_delta_step``,
``feature_contri``, and linear leaves (``linear_tree``, fitted after the
grower). Prediction maps DataFrames through the training category levels,
densifies sparse input, applies the training missing-value policy again, and
takes the trees' categorical and linear routes; the JSON model keeps
``cat_maps``, ``pandas_categorical`` and the linear coefficients.

Not ported (ROADMAP.md Queue A, item 18c): DART / GOSS / RF, Nesterov
acceleration, the leaf re-solves, ranking, continued training, ``refit``,
SHAP, ``pred_leaf``, the text model format; the device-resident loop is
item 10.
"""
from __future__ import annotations

import json
import math
from typing import List, Optional

import numpy as np
import torch

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.boosting import metrics as metrics_mod
from gpboost_tpu_torch.boosting.compat_data import marshal_matrix
from gpboost_tpu_torch.boosting.dataset import Dataset, cat_bins
from gpboost_tpu_torch.boosting.objectives import (GPBoostObjective,
                                                   create_objective)
from gpboost_tpu_torch.boosting.tree import (CEGBState, GrowerParams, Tree,
                                             fit_linear_leaves, grow_tree,
                                             predict_tree_linear,
                                             predict_tree_mixed,
                                             predict_tree_raw)
from gpboost_tpu_torch.utils import resolve_device, same_device
from gpboost_tpu_torch.utils.timer import timed

_TAIL = "ROADMAP.md Queue A, item 18c"
LOG2PI = math.log(2.0 * math.pi)


def _cov_or_var(gp_pred: dict):
    return gp_pred["cov"] if gp_pred.get("cov") is not None \
        else gp_pred["var"]


class Booster:
    """Gradient-boosting model, optionally combined with a GPModel.

    A Booster built from a ``train_set`` computes on that Dataset's device;
    a ``gp_model`` and every validation Dataset must live on the same
    device. A Booster loaded from ``model_file`` / ``model_str`` takes
    ``device`` (default the GPU; a missing GPU raises).
    """

    def __init__(self, params: Optional[dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, gp_model=None,
                 device="cuda"):
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is not None:
            self.device = resolve_device(device)
            self._load_dict(json.loads(model_str))
            return
        if train_set is None:
            raise ValueError("Booster: 'train_set', 'model_file' or "
                             "'model_str' is required")
        self.params = cfg_mod.resolve_params(params)
        self.train_set = train_set
        self.device = train_set.device
        if gp_model is not None and not same_device(gp_model.device,
                                                    self.device):
            raise ValueError(
                f"the train_set lies on {self.device} but the gp_model on "
                f"{gp_model.device}; build both with the same device=")
        self.gp_model = gp_model
        p = self.params
        self.objective_name = p.get("objective", "regression")
        self.num_class = int(p.get("num_class", 1))
        self.objective = create_objective(self.objective_name, p,
                                          gp_model=gp_model)
        self.objective.init(train_set.label, train_set.weight)
        self.learning_rate = float(p.get("learning_rate", 0.1))
        self.grower = GrowerParams(
            num_leaves=int(p.get("num_leaves", 31)),
            max_depth=int(p.get("max_depth", -1)),
            min_data_in_leaf=int(p.get("min_data_in_leaf", 20)),
            min_sum_hessian_in_leaf=float(
                p.get("min_sum_hessian_in_leaf", 1e-3)),
            lambda_l1=float(p.get("lambda_l1", 0.0)),
            lambda_l2=float(p.get("lambda_l2", 0.0)),
            min_gain_to_split=float(p.get("min_gain_to_split", 0.0)),
            path_smooth=float(p.get("path_smooth", 0.0)),
            extra_trees=bool(p.get("extra_trees", False)),
            feature_fraction_bynode=float(
                p.get("feature_fraction_bynode", 1.0)),
            monotone_constraints_method=str(
                p.get("monotone_constraints_method", "basic")),
            monotone_penalty=float(p.get("monotone_penalty", 0.0)),
            cat_l2=float(p.get("cat_l2", 10.0)),
            cat_smooth=float(p.get("cat_smooth", 10.0)),
            min_data_per_group=float(p.get("min_data_per_group", 100)),
            max_cat_to_onehot=int(p.get("max_cat_to_onehot", 4)),
            max_delta_step=float(p.get("max_delta_step", 0.0)),
            feature_contri=(None if p.get("feature_contri") is None else
                            np.asarray(p["feature_contri"], np.float64)))
        self.max_cat_threshold = int(p.get("max_cat_threshold", 32))
        ic = p.get("interaction_constraints", None)
        if isinstance(ic, str) and ic:
            import ast
            ic = ast.literal_eval(ic)
        self._interaction_constraints = ic if ic else None
        fsp = p.get("forced_splits", None)
        fname = p.get("forcedsplits_filename", "")
        if fsp is None and fname:
            with open(fname) as fh:
                fsp = json.load(fh)
        self._forced_splits = self._resolve_forced(fsp) if fsp else None
        mono = p.get("monotone_constraints", None)
        if isinstance(mono, str):
            mono = [int(v) for v in mono.strip("()[] ").split(",")]
        self._monotone = (None if mono is None
                          else np.asarray(mono, dtype=np.int32))
        self.linear_tree = bool(p.get("linear_tree", False))
        self.linear_lambda = float(p.get("linear_lambda", 0.0))
        self._cegb = CEGBState.from_params(
            p, train_set.num_features, train_set.num_data, self.device)
        self._cat_mask = None
        if train_set.categorical_feature:
            self._cat_mask = np.zeros(train_set.num_features, dtype=bool)
            self._cat_mask[list(train_set.categorical_feature)] = True
        # the training rows' raw values and category bins on the device
        # (linear trees evaluate on them)
        self._train_X = None
        self.boosting_type = "gbdt"
        self.bagging_fraction = float(p.get("bagging_fraction", 1.0))
        self.bagging_freq = int(p.get("bagging_freq", 0))
        self.pos_bagging_fraction = float(p.get("pos_bagging_fraction", 1.0))
        self.neg_bagging_fraction = float(p.get("neg_bagging_fraction", 1.0))
        self._bag_mask = None    # host bool [n], reused between re-bags
        self._bag_mask_t = None  # the same on the Dataset's device
        self.feature_fraction = float(p.get("feature_fraction", 1.0))
        self.use_gp_model_for_validation = bool(
            p.get("use_gp_model_for_validation", True))
        self._grad_dtype = (
            torch.float32 if self.device.type == "cuda"
            and not bool(p.get("gpu_use_dp", False)) else torch.float64)
        self._num_bins = np.asarray(train_set.num_bins)
        self._num_bins_t = torch.as_tensor(self._num_bins,
                                           device=self.device)
        # the JAX package's generators: one 'seed' stream, and dedicated
        # ones for bagging and feature sampling when their seeds are given
        # (config.h bagging_seed / feature_fraction_seed)
        self._rng = np.random.default_rng(int(p.get("seed", 0)))
        self._bag_rng = (np.random.default_rng(int(p["bagging_seed"]))
                         if "bagging_seed" in p else self._rng)
        self._ff_rng = (np.random.default_rng(int(p["feature_fraction_seed"]))
                        if "feature_fraction_seed" in p else self._rng)
        self._extra_rng = (np.random.default_rng(int(p["extra_seed"]))
                           if "extra_seed" in p else self._rng)

        self.trees: List[Tree] = []
        n = train_set.num_data
        self.num_models = max(
            1, getattr(self.objective, "num_model_per_iteration", 1))
        self.init_score = np.zeros(self.num_models)
        if train_set.init_score is not None:
            self._score = np.tile(train_set.init_score,
                                  self.num_models).astype(np.float64)
        else:
            self._score = np.zeros(n * self.num_models)
            if bool(p.get("boost_from_average", True)):
                self.init_score = np.asarray(self.objective.init_scores(),
                                             dtype=np.float64)
                for m in range(self.num_models):
                    self._score[m * n:(m + 1) * n] += self.init_score[m]
        self.best_iteration = -1
        self.valid_sets: List[Dataset] = []
        self.valid_names: List[str] = []
        self._valid_scores: List[np.ndarray] = []
        self._valid_X: List[torch.Tensor] = []
        self._train_data_name = "training"
        self._eval_train_metric = False
        metric = p.get("metric", None)
        if metric in (None, "", "auto"):
            metric = metrics_mod.default_metric_for(self.objective_name)
        self.metric_names = ([metric] if isinstance(metric, str)
                             else list(metric))

    def _resolve_forced(self, node):
        """A forced-splits JSON tree with its raw thresholds resolved to
        bins (``forcedsplits_filename``, config.h:512)."""
        out = {"feature": int(node["feature"]),
               "threshold_bin": self.train_set.bin_for_threshold(
                   int(node["feature"]), float(node["threshold"]))}
        for side in ("left", "right"):
            if isinstance(node.get(side), dict):
                out[side] = self._resolve_forced(node[side])
        return out

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str):
        """Add a validation Dataset: its score starts at the initial score
        and every tree grown so far, and follows each new tree."""
        if not same_device(data.device, self.device):
            raise ValueError(
                f"the validation set lies on {data.device} but the booster "
                f"on {self.device}; build it with create_valid")
        self.valid_sets.append(data)
        self.valid_names.append(name)
        nv = data.num_data
        score = np.zeros(nv * self.num_models)
        for m in range(self.num_models):
            score[m * nv:(m + 1) * nv] += self.init_score[m]
        X = self._device_inputs(data.raw_data)
        for k, tree in enumerate(self.trees):
            m = k % self.num_models
            score[m * nv:(m + 1) * nv] += self._tree_raw_pred(
                tree, *X).cpu().numpy()
        self._valid_scores.append(score)
        self._valid_X.append(X)
        return self

    @property
    def num_trees_per_iter(self):
        return self.num_models

    def num_model_per_iteration(self):
        return self.num_models

    def current_iteration(self):
        return len(self.trees) // self.num_models

    def num_trees(self):
        return len(self.trees)

    def set_train_data_name(self, name):
        self._train_data_name = name
        return self

    def _bag(self, it: int, n: int):
        """The row mask of this iteration (``GBDT::Bagging``, gbdt.cpp:255):
        redrawn every ``bagging_freq`` iterations and reused in between;
        ``pos/neg_bagging_fraction`` sample the classes separately
        (``BalancedBaggingHelper``, gbdt.cpp:225). None without bagging."""
        if not (self.bagging_freq > 0 and (
                self.bagging_fraction < 1.0
                or self.pos_bagging_fraction < 1.0
                or self.neg_bagging_fraction < 1.0)):
            return None
        if self._bag_mask is None or it % self.bagging_freq == 0:
            if (self.pos_bagging_fraction < 1.0
                    or self.neg_bagging_fraction < 1.0):
                u = self._bag_rng.random(n)
                is_pos = np.asarray(self.train_set.label) > 0
                keep = np.where(is_pos, u < self.pos_bagging_fraction,
                                u < self.neg_bagging_fraction)
            else:
                keep = self._bag_rng.random(n) < self.bagging_fraction
            self._bag_mask = keep
            self._bag_mask_t = torch.as_tensor(keep, device=self.device)
        return self._bag_mask_t

    def _tree_num_bins(self):
        """The features this tree may split on (``feature_fraction``): the
        ones left out get 0 bins. (device tensor, host copy)."""
        if self.feature_fraction >= 1.0:
            return self._num_bins_t, self._num_bins
        F = self.train_set.num_features
        k = max(1, int(np.ceil(self.feature_fraction * F)))
        chosen = self._ff_rng.choice(F, size=k, replace=False)
        mask = np.zeros(F, dtype=bool)
        mask[chosen] = True
        return (torch.where(torch.as_tensor(mask, device=self.device),
                            self._num_bins_t,
                            torch.zeros_like(self._num_bins_t)),
                np.where(mask, self._num_bins, 0))

    def update(self, train_set=None, fobj=None):
        """One boosting iteration (``GBDT::TrainOneIter``, gbdt.cpp:404):
        ``num_models`` trees. ``fobj(score, train_set)`` returns the
        gradients and hessians in place of the objective's."""
        if train_set is not None:
            raise NotImplementedError(
                "update(train_set=...) is not ported to gpboost_tpu_torch "
                f"yet ({_TAIL})")
        ds = self.train_set
        n = ds.num_data
        with timed("Booster: gradients", sync=True):
            if fobj is not None:
                grad, hess = fobj(self._score, ds)
            else:
                grad, hess = self.objective.get_gradients(self._score)
            grad = np.asarray(grad, dtype=np.float64)
            hess = np.asarray(hess, dtype=np.float64)
        it = self.current_iteration()
        # the JAX package's order of draws: the bag, then the tree's
        # features, then the nodes' features inside each grower call
        row_mask = self._bag(it, n)
        num_bins, num_bins_host = self._tree_num_bins()
        nan_mask = ds.has_nan if bool(np.any(ds.has_nan)) else None
        for m in range(self.num_models):
            with timed("Booster: gradients to the device", sync=True):
                g = torch.as_tensor(grad[m * n:(m + 1) * n],
                                    dtype=self._grad_dtype,
                                    device=self.device)
                h = torch.as_tensor(hess[m * n:(m + 1) * n],
                                    dtype=self._grad_dtype,
                                    device=self.device)
            with timed("Booster: grow_tree", sync=True):
                tree, row_leaf = grow_tree(
                    ds.binned, num_bins, g, h, ds.max_num_bins, self.grower,
                    row_mask=row_mask, nan_mask=nan_mask,
                    binned_t=ds.binned_t,
                    rng=(self._extra_rng if self.grower.extra_trees
                         else self._rng),
                    categorical_mask=self._cat_mask,
                    max_cat_threshold=self.max_cat_threshold,
                    monotone_constraints=self._monotone,
                    forced_splits=self._forced_splits, cegb=self._cegb,
                    efb=ds.efb,
                    interaction_constraints=self._interaction_constraints,
                    num_bins_host=num_bins_host)
            # real-valued thresholds for raw prediction
            for node in tree.internal_nodes():
                if tree.is_categorical[node]:
                    continue
                tree.threshold[node] = ds.threshold_value(
                    int(tree.split_feature[node]),
                    int(tree.threshold_bin[node]))
            if self.linear_tree:
                with timed("Booster: linear leaves", sync=True):
                    fit_linear_leaves(
                        tree, self._train_inputs()[0], row_leaf,
                        torch.as_tensor(grad[m * n:(m + 1) * n],
                                        device=self.device),
                        torch.as_tensor(hess[m * n:(m + 1) * n],
                                        device=self.device),
                        self.linear_lambda)
            tree.add_shrinkage(self.learning_rate)
            self.trees.append(tree)
            with timed("Booster: score update", sync=True):
                if tree.lin_features is not None:
                    # linear leaves: the tree evaluated on the raw rows
                    self._score[m * n:(m + 1) * n] += self._tree_raw_pred(
                        tree, *self._train_inputs()).cpu().numpy()
                else:
                    # the grower's final row->leaf assignment IS the
                    # training prediction: a host gather replaces a tree
                    # traversal. Under a bag too: the partition moves the
                    # rows outside the bag with the others (the JAX package
                    # traverses the tree there, which gives the same leaves)
                    self._score[m * n:(m + 1) * n] += tree.leaf_value[
                        row_leaf.cpu().numpy()]
            with timed("Booster: validation scores", sync=True):
                for vi, vset in enumerate(self.valid_sets):
                    nv = vset.num_data
                    self._valid_scores[vi][m * nv:(m + 1) * nv] += \
                        self._tree_raw_pred(tree,
                                            *self._valid_X[vi]).cpu().numpy()
        if isinstance(self.objective, GPBoostObjective):
            # end-of-iteration covariance refit at the UPDATED score
            # (gbdt.cpp:536-542 calls Boosting() again after UpdateScore):
            # get_cov_pars() and the validation metrics reflect the
            # post-iteration residual, and the next iteration reuses this
            # refit and its gradient
            with timed("Booster: gradients", sync=True):
                self.objective.get_gradients(self._score)
        return False

    # ------------------------------------------------------------------
    def eval(self, data, name, feval=None):
        """Evaluate on an added validation Dataset (or the train set)."""
        if data is self.train_set:
            return self.eval_train()
        for vset, vname, score in zip(self.valid_sets, self.valid_names,
                                      self._valid_scores):
            if data is vset or name == vname:
                return self._eval(vset, name, score)
        raise ValueError("data must be the train set or an added valid set")

    def eval_train(self):
        return self._eval(self.train_set, "training", self._score)

    def eval_valid(self):
        out = []
        for vset, name, score in zip(self.valid_sets, self.valid_names,
                                     self._valid_scores):
            out.extend(self._eval(vset, name, score))
        return out

    def _eval(self, dset: Dataset, name: str, score: np.ndarray):
        """``(name, metric, value, higher_better)`` of every metric."""
        res = []
        pred = None
        for metric in self.metric_names:
            if metric in metrics_mod.GP_METRICS:
                val = self._eval_gp_metric(metric, dset, score)
                res.append((name, metric, val, False))
                continue
            base, ks = metrics_mod.resolve_metric_name(metric)
            spec = metrics_mod.METRICS[base]
            if spec.kind == "raw":
                # auc_mu: RAW scores (linear discriminants, not softmax)
                val = spec.fn(dset.label, score, dset.weight,
                              num_class=self.num_class,
                              class_weights=self.params.get("auc_mu_weights"))
                res.append((name, base, val, spec.higher_better))
                continue
            if spec.kind == "rank":
                spec.fn()                     # raises: item 18c
            if pred is None:
                pred = self._convert_for_metric(dset, score)
            kwargs = {}
            if base in ("multi_logloss", "multi_error"):
                kwargs["num_class"] = self.num_class
            if base == "multi_error":
                kwargs["top_k"] = int(
                    self.params.get("multi_error_top_k", 1))
            val = spec.fn(dset.label, pred, dset.weight, **kwargs)
            res.append((name, base, val, spec.higher_better))
        return res

    def _residual_variance(self) -> float:
        """Training residual variance for Gaussian predictive metrics
        without a gp_model (the reference regression objective's
        ``residual_variance_``)."""
        n = self.train_set.num_data
        resid = self.train_set.label - self._score[:n]
        return float(np.var(resid))

    def _gp_valid_prediction(self, score: np.ndarray, nv: int,
                             predict_response: bool):
        """The GP's prediction at the validation data that
        ``gp_model.set_prediction_data`` stored: (mean, variance) of the
        response (Gaussian: the random effects' mean added to the trees'
        score; otherwise the Laplace prediction with the trees' score as
        the fixed effects)."""
        gp = self.gp_model
        pd = getattr(gp, "_valid_pred_data", None)
        n = self.train_set.num_data
        ns = getattr(gp, "num_sets_re", 1)
        if gp.is_gaussian:
            resid = self.train_set.label - self._score[:n]
            pred = gp.predict(y=resid, predict_var=True,
                              predict_response=True, **pd)
            mu = score[:nv] + np.asarray(pred["mu"])
        else:
            pred = gp.predict(
                y=self.train_set.label, fixed_effects=self._score[:n * ns],
                fixed_effects_pred=score[:nv * ns], predict_var=True,
                predict_response=predict_response, **pd)
            mu = np.asarray(pred["mu"])
        return mu, np.asarray(pred["var"]).ravel()

    def _eval_gp_metric(self, metric: str, dset: Dataset, score: np.ndarray):
        """GP-aware metrics (``random_effects_metric.hpp:25,69``,
        ``regression_metric.hpp:373`` TestNegLogLikelihood, ``:499``
        CRPSGaussian)."""
        gp = self.gp_model
        is_train = dset is self.train_set
        if metric in ("neg_log_likelihood",
                      "approx_neg_marginal_log_likelihood"):
            # training data only: the (approximate) negative marginal
            # log-likelihood at the current covariance parameters
            if not is_train:
                raise ValueError(f"The metric '{metric}' cannot be used for "
                                 "validation data, only for training data")
            if gp is None:
                raise ValueError(f"The metric '{metric}' requires an "
                                 "attached gp_model")
            n = self.train_set.num_data
            if gp.is_gaussian:
                resid = dset.label - self._score[:n]
                return float(gp.neg_log_likelihood(cov_pars=gp.cov_pars_,
                                                   y=resid))
            ns = getattr(gp, "num_sets_re", 1)
            return float(gp.neg_log_likelihood(
                cov_pars=gp.cov_pars_, y=dset.label,
                fixed_effects=self._score[:n * ns]))
        # validation-only metrics
        if is_train:
            raise ValueError(f"Cannot use the metric '{metric}' on the "
                             "training data")
        label = dset.label
        nv = dset.num_data
        raw = score[:nv]
        if gp is not None and self.use_gp_model_for_validation:
            if getattr(gp, "_valid_pred_data", None) is None:
                raise ValueError(
                    "gp_model.set_prediction_data(...) must be called before "
                    f"using the metric '{metric}' with "
                    "use_gp_model_for_validation=True")
            mu, var = self._gp_valid_prediction(
                score, nv, predict_response=(metric == "crps_gaussian"))
            if not gp.is_gaussian and metric == "test_neg_log_likelihood":
                # adaptive-GH integral of the response likelihood over the
                # latent predictive Gaussian (likelihoods.h:7931)
                from gpboost_tpu_torch.models import laplace
                t = gp._tensor
                nlls = laplace.test_nll_adaptive_gh(
                    gp.likelihood, t(np.asarray(label, np.float64)),
                    t(mu), t(np.maximum(var, 1e-12)), gp._aux_tensor())
                return float(np.mean(nlls.detach().cpu().numpy()))
            if metric == "test_neg_log_likelihood":
                return float(np.mean(
                    0.5 * ((label - mu) ** 2 / var + np.log(var) + LOG2PI)))
            return metrics_mod.crps_gaussian(label, mu, var)
        # no gp_model (or not used for validation): Gaussian with the
        # training residual variance / the mean-scale two-parameter score
        if self.objective_name == "mean_scale_regression":
            if metric == "crps_gaussian":
                return metrics_mod.crps_gaussian(label, raw,
                                                 np.exp(score[nv:2 * nv]))
            raise ValueError(f"The metric '{metric}' cannot be used for the "
                             "objective 'mean_scale_regression'")
        if self.objective_name not in ("regression", "regression_gp"):
            raise ValueError(
                f"The metric '{metric}' can only be used with a gp_model or "
                "the 'regression' objective")
        rv = max(self._residual_variance(), 1e-300)
        if metric == "test_neg_log_likelihood":
            return float(np.mean(
                0.5 * ((raw - label) ** 2 / rv + math.log(rv) + LOG2PI)))
        return metrics_mod.crps_gaussian(label, raw, np.full(nv, rv))

    def _convert_for_metric(self, dset: Dataset, score: np.ndarray):
        """Scores converted for a metric; with an attached gp_model and
        ``use_gp_model_for_validation``, the predicted random effects added
        (``regression_metric.hpp:86-129``)."""
        if (self.gp_model is not None and self.use_gp_model_for_validation
                and dset is not self.train_set):
            return self._predict_combined(dset.raw_data, dset)
        return self.objective.convert_output(score)

    def _predict_combined(self, data_raw, dset: Dataset):
        """Tree + GP prediction on a validation set whose GP prediction
        data the GPModel holds (``gp_model.set_prediction_data``)."""
        raw = self._predict_raw(data_raw)
        gp = self.gp_model
        pd = getattr(gp, "_valid_pred_data", None)
        if pd is None:
            return self.objective.convert_output(raw)
        n = self.train_set.num_data
        if gp.is_gaussian:
            resid = self.train_set.label - self._score[:n]
            gp_pred = gp.predict(y=resid, predict_response=True, **pd)
            return raw + gp_pred["mu"]
        ns = getattr(gp, "num_sets_re", 1)
        gp_pred = gp.predict(y=self.train_set.label,
                             fixed_effects=self._score[:n * ns],
                             predict_response=True, **pd)
        return gp_pred["mu"]

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                start_iteration: int = 0, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                group_data_pred=None, group_rand_coef_data_pred=None,
                gp_coords_pred=None, gp_rand_coef_data_pred=None,
                cluster_ids_pred=None, predict_var=False, pred_latent=False):
        """Predict on raw features. ``num_iteration=None`` uses
        ``best_iteration`` when early stopping set one (the reference's
        default). With an attached gp_model and its prediction data
        (``group_data_pred`` / ``group_rand_coef_data_pred`` for grouped
        random effects, ``gp_coords_pred`` for a GP, with
        ``gp_rand_coef_data_pred`` / ``cluster_ids_pred`` for an exact GP
        that has them), returns the combined tree + random-effects
        prediction as a dict (``basic.py:3560-3650``): ``fixed_effect``,
        ``random_effect_mean``, ``random_effect_cov`` (the variances with
        ``predict_var``), ``response_mean``, ``response_var``; for a
        non-Gaussian gp_model the response mean and variance (or, with
        ``pred_latent``, the fixed effect and the latent random effect's
        mean and variance). Without a gp_model the objective's converted
        output unless ``raw_score`` (``[n * num_models]`` model-major for
        the multiclass objectives; ``mean_scale_regression`` gives a dict
        of ``pred_mean`` and ``pred_var``)."""
        if pred_leaf or pred_contrib:
            raise NotImplementedError(
                "pred_leaf / pred_contrib are not ported to "
                f"gpboost_tpu_torch yet ({_TAIL})")
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        data = self._marshal_pred(data)
        if data.ndim == 1:
            data = data[:, None]
        raw = self._predict_raw(data, num_iteration,
                                start_iteration=start_iteration)
        if self.gp_model is not None and (gp_coords_pred is not None
                                          or group_data_pred is not None):
            return self._predict_with_gp(
                raw, dict(group_data_pred=group_data_pred,
                          group_rand_coef_data_pred=group_rand_coef_data_pred,
                          gp_coords_pred=gp_coords_pred,
                          gp_rand_coef_data_pred=gp_rand_coef_data_pred,
                          cluster_ids_pred=cluster_ids_pred,
                          predict_var=predict_var), pred_latent)
        if raw_score:
            return raw
        if self.objective_name == "mean_scale_regression":
            # (pred_mean, pred_var) dict (reference basic.py:3674-3680)
            n = data.shape[0]
            return {"pred_mean": raw[:n], "pred_var": np.exp(raw[n:])}
        return self.objective.convert_output(raw)

    def _predict_raw(self, data, num_iteration=None, start_iteration=0):
        """Raw scores ``[n * num_models]``: the initial score and the trees
        of iterations ``start_iteration`` up to ``num_iteration``."""
        n = data.shape[0]
        K = self.num_models
        limit = (len(self.trees) if num_iteration in (None, -1, 0)
                 else min(num_iteration * K, len(self.trees)))
        # start_iteration (config.h:647): predict from a tree-range suffix;
        # the boost-from-average base belongs to iteration 0
        start = max(0, int(start_iteration or 0)) * K
        X = self._device_inputs(data)
        score = torch.zeros(K, n, dtype=torch.float64, device=self.device)
        if start == 0:
            score += torch.as_tensor(self.init_score, dtype=torch.float64,
                                     device=self.device)[:, None]
        for k in range(start, limit):
            score[k % K] += self._tree_raw_pred(self.trees[k], *X)
        return score.reshape(-1).cpu().numpy()

    def _marshal_pred(self, data):
        """Prediction input as a float64 array: a DataFrame mapped through
        the training category levels, a sparse matrix densified
        (reference ``_InnerPredictor.predict``, basic.py:788), then the
        training missing-value policy (``use_missing`` / ``zero_as_missing``)
        applied again."""
        arr, _, _, _ = marshal_matrix(
            data, "auto", "auto", pandas_categorical=self._training_levels())
        if not bool(self.params.get("use_missing", True)):
            arr = np.where(np.isfinite(arr), arr, 0.0)
        elif bool(self.params.get("zero_as_missing", False)):
            arr = np.where(arr == 0.0, np.nan, arr)
        return arr

    def _pandas_categorical_levels(self):
        """The training category levels in a JSON-safe form (the reference
        keeps ``pandas_categorical`` in the model file, basic.py:3321)."""
        pc = self._training_levels()
        if not pc:
            return None

        def conv(v):
            if isinstance(v, (bool, int, float, str)):
                return v
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            return str(v)

        return [[conv(v) for v in levels] for levels in pc]

    def _training_levels(self):
        """The training DataFrame's category levels (``pandas_categorical``)
        of the training Dataset or of the loaded model."""
        if self.train_set is not None:
            return self.train_set.pandas_categorical
        return getattr(self, "_pandas_categorical", None)

    def _cat_maps(self) -> dict:
        if self.train_set is not None:
            return self.train_set.cat_maps or {}
        return getattr(self, "_loaded_cat_maps", None) or {}

    def _device_inputs(self, data):
        """(raw values [n, F] float64, category bins [n, F] int32 or None)
        of prediction data on the booster's device: the categorical columns
        mapped through ``cat_maps`` (unseen values and NaN to bin 0)."""
        data = np.asarray(data, np.float64)
        X = torch.tensor(data, device=self.device)
        maps = self._cat_maps()
        if not maps:
            return X, None
        bins = np.zeros(data.shape, dtype=np.int32)
        for f, lookup in maps.items():
            bins[:, int(f)] = cat_bins(data[:, int(f)], lookup)
        return X, torch.as_tensor(bins, device=self.device)

    def _train_inputs(self):
        if self._train_X is None:
            self._train_X = self._device_inputs(self.train_set.raw_data)
        return self._train_X

    def _tree_raw_pred(self, tree: Tree, X: torch.Tensor,
                       cat_bins_t: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        """One tree on raw values ``X`` (and the category bins of its
        categorical columns): the plain, categorical or linear traversal."""
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        dl = None if tree.default_left is None else dev(tree.default_left)
        depth = int(tree.max_depth_used)
        if tree.lin_features is not None or tree.has_categorical():
            M = len(tree.is_leaf)
            is_cat = dev(tree.is_categorical if tree.is_categorical
                         is not None else np.zeros(M, bool))
            cmask = dev(tree.cat_mask if tree.cat_mask is not None
                        else np.zeros((M, 1), bool))
            cb = (cat_bins_t if cat_bins_t is not None else torch.zeros(
                X.shape, dtype=torch.int32, device=self.device))
            common = (X, cb, dev(tree.split_feature), dev(tree.threshold),
                      is_cat, cmask, dev(tree.left), dev(tree.right), depth,
                      dev(tree.leaf_value))
            if tree.lin_features is not None:
                vals, _ = predict_tree_linear(
                    *common, dev(tree.lin_features), dev(tree.lin_coefs),
                    default_left=dl)
            else:
                vals, _ = predict_tree_mixed(*common, default_left=dl)
            return vals
        vals, _ = predict_tree_raw(
            X, dev(tree.split_feature), dev(tree.threshold), dev(tree.left),
            dev(tree.right), dev(tree.leaf_value), depth, default_left=dl)
        return vals

    def _predict_with_gp(self, raw, pred_kwargs, pred_latent):
        gp = self.gp_model
        if self.train_set is not None:
            train_score = self._score
            train_label = self.train_set.label
        else:  # loaded model: embedded training label/score
            train_score = self._loaded_train_score
            train_label = self._loaded_train_label
        if not gp.is_gaussian:
            # LaGaBoost (the JAX package's booster.py:1305-1324): the
            # latent random effect given the trees' training score, or the
            # response mean and variance with the trees' prediction as the
            # fixed effect
            if pred_latent:
                gp_pred = gp.predict(y=train_label,
                                     fixed_effects=train_score,
                                     predict_response=False, **pred_kwargs)
                return {"fixed_effect": raw,
                        "random_effect_mean": gp_pred["mu"],
                        "random_effect_cov": _cov_or_var(gp_pred),
                        "response_mean": None, "response_var": None}
            gp_pred = gp.predict(y=train_label, fixed_effects=train_score,
                                 fixed_effects_pred=raw,
                                 predict_response=True, **pred_kwargs)
            return {"response_mean": gp_pred["mu"],
                    "response_var": gp_pred["var"],
                    "fixed_effect": raw,
                    "random_effect_mean": None, "random_effect_cov": None}
        resid = train_label - train_score
        gp_pred = gp.predict(y=resid, predict_response=not pred_latent,
                             **pred_kwargs)
        return {"response_mean": raw + gp_pred["mu"],
                "response_var": gp_pred["var"],
                "fixed_effect": raw,
                "random_effect_mean": gp_pred["mu"],
                # reference: with predict_var=TRUE random_effect_cov
                # carries the predictive VARIANCES (basic.py:3560-3650)
                "random_effect_cov": _cov_or_var(gp_pred)}

    # ------------------------------------------------------------------
    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None):
        F = self.num_feature()
        imp = np.zeros(F)
        limit = (len(self.trees) if iteration in (None, -1, 0)
                 else min(iteration, len(self.trees)))
        for tree in self.trees[:limit]:
            for node in tree.internal_nodes():
                if importance_type == "gain":
                    if tree.split_gain is None:
                        raise ValueError(
                            "gain importance unavailable: model has no "
                            "recorded split gains (legacy save file)")
                    imp[tree.split_feature[node]] += tree.split_gain[node]
                else:
                    imp[tree.split_feature[node]] += 1
        return imp

    def num_feature(self):
        if self.train_set is not None:
            return self.train_set.num_features
        return int(max(int(np.max(t.split_feature[t.internal_nodes()],
                                  initial=0)) for t in self.trees)) + 1

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration=None, format: str = "json"):
        """Serialize the model in the JSON format that this package and the
        JAX package share."""
        if format != "json":
            raise NotImplementedError(
                f"model format '{format}' is not ported to "
                f"gpboost_tpu_torch yet ({_TAIL}); ported: 'json'")
        return json.dumps(self._to_dict())

    def save_model(self, filename, num_iteration=None, start_iteration=0,
                   format: Optional[str] = None):
        """Save the model as JSON (a ``.txt`` name asks for the reference's
        text format, which is not ported)."""
        if format is None:
            format = "text" if str(filename).endswith(".txt") else "json"
        content = self.model_to_string(num_iteration, format=format)
        with open(filename, "w") as f:
            f.write(content)
        return self

    def _to_dict(self):
        d = {
            "version": "gpboost_tpu_v1",
            "params": {k: v for k, v in self.params.items()
                       if isinstance(v, (int, float, str, bool, list))},
            "objective": self.objective_name,
            "boosting_type": self.boosting_type,
            "num_class": self.num_class,
            "num_models": self.num_models,
            "init_score": self.init_score.tolist(),
            "trees": [t.to_dict() for t in self.trees],
            "best_iteration": self.best_iteration,
            "cat_maps": ({str(f): {str(k): int(v) for k, v in mp.items()}
                          for f, mp in self._cat_maps().items()}
                         or None),
            "attrs": {},
            "feature_names": (list(self.train_set.feature_name)
                              if self.train_set is not None else
                              self._feature_names),
            "pandas_categorical": self._pandas_categorical_levels(),
        }
        if self.gp_model is not None:
            d["gp_model"] = self.gp_model.model_to_dict()
            # combined prediction needs the training label and raw score
            if self.train_set is not None:
                d["train_label"] = self.train_set.label.tolist()
                d["train_score"] = self._score[
                    :self.train_set.num_data].tolist()
            else:
                d["train_label"] = self._loaded_train_label.tolist()
                d["train_score"] = self._loaded_train_score.tolist()
        return d

    def _load_dict(self, d):
        """Load ``_to_dict`` output — this package's or the JAX package's.
        A model that uses a feature which is not ported raises."""
        self.params = cfg_mod.resolve_params(d.get("params", {}))
        self.objective_name = d["objective"]
        self.boosting_type = d.get("boosting_type", "gbdt")
        self.num_class = d.get("num_class", 1)
        self.num_models = d.get("num_models", 1)
        if self.boosting_type != "gbdt":
            raise NotImplementedError(
                f"a saved model with boosting_type='{self.boosting_type}' "
                f"is not ported ({_TAIL})")
        cm = d.get("cat_maps")
        self._loaded_cat_maps = (
            None if not cm else
            {int(f): {float(k): int(v) for k, v in mp.items()}
             for f, mp in cm.items()})
        self._pandas_categorical = d.get("pandas_categorical")
        self._feature_names = d.get("feature_names")
        self.init_score = np.asarray(d["init_score"], dtype=np.float64)
        self.trees = [Tree.from_dict(td) for td in d["trees"]]
        self.best_iteration = d.get("best_iteration", -1)
        self.train_set = None
        self.gp_model = None
        if d.get("gp_model") is not None:
            from gpboost_tpu_torch.models.gp_model import GPModel
            self.gp_model = GPModel.from_dict(d["gp_model"],
                                              device=self.device)
            self._loaded_train_label = np.asarray(d.get("train_label"),
                                                  dtype=np.float64)
            self._loaded_train_score = np.asarray(d.get("train_score"),
                                                  dtype=np.float64)
        self.objective = create_objective(self.objective_name, self.params)
        self.valid_sets, self.valid_names = [], []
        self._valid_scores, self._valid_X = [], []
        self._train_data_name = "training"
        self._eval_train_metric = False
        self.use_gp_model_for_validation = bool(
            self.params.get("use_gp_model_for_validation", True))
        self.metric_names = [
            metrics_mod.default_metric_for(self.objective_name)]
