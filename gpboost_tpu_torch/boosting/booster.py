"""Booster: the gradient-boosting engine (GBDT core).

The equivalent of the reference's ``GBDT`` class
(``src/LightGBM/boosting/gbdt.cpp``): ``TrainOneIter`` (:404) becomes
``update()`` — gradients from the objective (including the GPBoost and
LaGaBoost couplings), one leaf-wise tree per round, shrinkage, score update — and the
``Booster`` public class mirrors ``gpboost.Booster`` (``basic.py:2323``):
train / predict / save, ``gp_model`` attachment and combined prediction
(``basic.py:3560-3650``).

The score stays a host float64 array and gradients cross to the device once
per round, as in the reference's host loop; trees grow on the device of the
training ``Dataset``. On a GPU the gradients are float32 there (LightGBM's
default histogram precision) and every histogram goes through the
hand-written kernel; ``gpu_use_dp=True`` keeps them float64, which runs the
plain histogram on the GPU. On the CPU they are float64.

Not ported (ROADMAP.md Queue A, item 18): validation sets, metrics,
callbacks, DART / GOSS / RF, bagging, ``refit``, SHAP, the text model
format; the device-resident loop is item 10.
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from gpboost_tpu_torch import config as cfg_mod
from gpboost_tpu_torch.boosting.dataset import Dataset
from gpboost_tpu_torch.boosting.objectives import (GPBoostObjective,
                                                   create_objective)
from gpboost_tpu_torch.boosting.tree import (GrowerParams, Tree, grow_tree,
                                             predict_tree_raw)
from gpboost_tpu_torch.utils import resolve_device, same_device
from gpboost_tpu_torch.utils.timer import timed

_TAIL = "ROADMAP.md Queue A, item 18"


def _cov_or_var(gp_pred: dict):
    return gp_pred["cov"] if gp_pred.get("cov") is not None \
        else gp_pred["var"]


class Booster:
    """Gradient-boosting model, optionally combined with a GPModel.

    A Booster built from a ``train_set`` computes on that Dataset's device;
    a ``gp_model`` must live on the same device. A Booster loaded from
    ``model_file`` / ``model_str`` takes ``device`` (default the GPU; a
    missing GPU raises).
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
        self.num_class = 1
        self.num_models = 1
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
            min_gain_to_split=float(p.get("min_gain_to_split", 0.0)))
        self.boosting_type = "gbdt"
        self._grad_dtype = (
            torch.float32 if self.device.type == "cuda"
            and not bool(p.get("gpu_use_dp", False)) else torch.float64)
        self._num_bins_t = torch.as_tensor(
            np.asarray(train_set.num_bins), device=self.device)

        self.trees: List[Tree] = []
        n = train_set.num_data
        self.init_score = np.zeros(1)
        if train_set.init_score is not None:
            self._score = np.array(train_set.init_score, dtype=np.float64)
        else:
            self._score = np.zeros(n)
            if bool(p.get("boost_from_average", True)):
                self.init_score = np.asarray(self.objective.init_scores(),
                                             dtype=np.float64)
                self._score += self.init_score[0]
        self.best_iteration = -1

    # ------------------------------------------------------------------
    def current_iteration(self):
        return len(self.trees)

    def num_trees(self):
        return len(self.trees)

    def update(self, train_set=None, fobj=None):
        """One boosting iteration (``GBDT::TrainOneIter``, gbdt.cpp:404)."""
        if train_set is not None or fobj is not None:
            raise NotImplementedError(
                "update(train_set=..., fobj=...) is not ported to "
                f"gpboost_tpu_torch yet ({_TAIL})")
        ds = self.train_set
        with timed("Booster: gradients", sync=True):
            grad, hess = self.objective.get_gradients(self._score)
        with timed("Booster: gradients to the device", sync=True):
            g = torch.as_tensor(np.asarray(grad, dtype=np.float64),
                                dtype=self._grad_dtype, device=self.device)
            h = torch.as_tensor(np.asarray(hess, dtype=np.float64),
                                dtype=self._grad_dtype, device=self.device)
        nan_mask = ds.has_nan if bool(np.any(ds.has_nan)) else None
        with timed("Booster: grow_tree", sync=True):
            tree, row_leaf = grow_tree(
                ds.binned, self._num_bins_t, g, h, ds.max_num_bins,
                self.grower, nan_mask=nan_mask, binned_t=ds.binned_t)
        # real-valued thresholds for raw prediction
        for node in tree.internal_nodes():
            tree.threshold[node] = ds.threshold_value(
                int(tree.split_feature[node]), int(tree.threshold_bin[node]))
        tree.add_shrinkage(self.learning_rate)
        self.trees.append(tree)
        # the grower's final row->leaf assignment IS the training
        # prediction: a host gather replaces a tree traversal
        with timed("Booster: score update", sync=True):
            self._score += tree.leaf_value[row_leaf.cpu().numpy()]
        if isinstance(self.objective, GPBoostObjective):
            # end-of-iteration covariance refit at the UPDATED score
            # (gbdt.cpp:536-542 calls Boosting() again after UpdateScore):
            # get_cov_pars() reflects the post-iteration residual, and the
            # next iteration reuses this refit and its gradient
            with timed("Booster: gradients", sync=True):
                self.objective.get_gradients(self._score)
        return False

    # ------------------------------------------------------------------
    def predict(self, data, num_iteration: Optional[int] = None,
                start_iteration: int = 0, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                group_data_pred=None, group_rand_coef_data_pred=None,
                gp_coords_pred=None, gp_rand_coef_data_pred=None,
                cluster_ids_pred=None, predict_var=False, pred_latent=False):
        """Predict on raw features. With an attached gp_model and its
        prediction data (``group_data_pred`` / ``group_rand_coef_data_pred``
        for grouped random effects, ``gp_coords_pred`` for a GP, with
        ``gp_rand_coef_data_pred`` / ``cluster_ids_pred`` for an exact GP
        that has them), returns
        the combined tree + random-effects prediction as a dict
        (``basic.py:3560-3650``): ``fixed_effect``, ``random_effect_mean``,
        ``random_effect_cov`` (the variances with ``predict_var``),
        ``response_mean``, ``response_var``; for a non-Gaussian gp_model
        the response mean and variance (or, with ``pred_latent``, the fixed
        effect and the latent random effect's mean and variance). Without a
        gp_model, ``binary`` returns probabilities unless ``raw_score``."""
        if pred_leaf or pred_contrib:
            raise NotImplementedError(
                "pred_leaf / pred_contrib are not ported to "
                f"gpboost_tpu_torch yet ({_TAIL})")
        data = np.asarray(data, dtype=np.float64)
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
        return self.objective.convert_output(raw)

    def _predict_raw(self, data, num_iteration=None, start_iteration=0):
        n = data.shape[0]
        limit = (len(self.trees) if num_iteration in (None, -1, 0)
                 else min(num_iteration, len(self.trees)))
        # start_iteration (config.h:647): predict from a tree-range suffix;
        # the boost-from-average base belongs to iteration 0
        start = max(0, int(start_iteration or 0))
        X = torch.as_tensor(data, device=self.device)
        score = torch.zeros(n, dtype=torch.float64, device=self.device)
        if start == 0:
            score += float(self.init_score[0])
        for tree in self.trees[start:limit]:
            score += self._tree_raw_pred(tree, X)
        return score.cpu().numpy()

    def _tree_raw_pred(self, tree: Tree, X: torch.Tensor) -> torch.Tensor:
        def dev(a):
            return torch.as_tensor(a, device=self.device)

        vals, _ = predict_tree_raw(
            X, dev(tree.split_feature), dev(tree.threshold), dev(tree.left),
            dev(tree.right), dev(tree.leaf_value), int(tree.max_depth_used),
            default_left=(None if tree.default_left is None
                          else dev(tree.default_left)))
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
            "cat_maps": None,
            "attrs": {},
            "feature_names": (list(self.train_set.feature_name)
                              if self.train_set is not None else
                              self._feature_names),
            "pandas_categorical": None,
        }
        if self.gp_model is not None:
            d["gp_model"] = self.gp_model.model_to_dict()
            # combined prediction needs the training label and raw score
            if self.train_set is not None:
                d["train_label"] = self.train_set.label.tolist()
                d["train_score"] = self._score.tolist()
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
        if self.boosting_type != "gbdt" or self.num_models != 1:
            raise NotImplementedError(
                f"a saved model with boosting_type='{self.boosting_type}', "
                f"num_models={self.num_models} is not ported ({_TAIL})")
        if d.get("cat_maps") or d.get("pandas_categorical"):
            raise NotImplementedError(
                f"a saved model with categorical features is not ported "
                f"({_TAIL})")
        self._feature_names = d.get("feature_names")
        self.init_score = np.asarray(d["init_score"], dtype=np.float64)
        self.trees = [Tree.from_dict(td) for td in d["trees"]]
        for t in self.trees:
            if (t.lin_features is not None or (
                    t.is_categorical is not None
                    and bool(np.any(t.is_categorical)))):
                raise NotImplementedError(
                    "a saved model with categorical splits or linear leaves "
                    f"is not ported ({_TAIL})")
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
