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
host loop; trees grow on the device of the training ``Dataset``: on a GPU by
the fixed-shape grower (``tree.grow_tree_fast``: one captured CUDA graph
and one fetch a tree) wherever it covers the tree's options, else, and on
the CPU, by the host grower (``tree.grow_tree``), which gives the same tree
from the same gradients. On a GPU
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

The boosting variants and the GPBoost leaf steps are the JAX package's
(``booster.py:33``, ``:335-455``, ``:591-731``): DART (trees dropped and
renormalised from the ``drop_seed`` generator), GOSS (the top gradients and
a ``seed``-stream sample of the rest, amplified, from iteration
``1 / learning_rate`` on), random forests (gradients at the initial score,
unshrunk trees averaged, bagging forced on), Nesterov acceleration (a
momentum step before the gradients, replayed by prediction), the Newton leaf
re-solve ``(H' Psi^-1 H)^-1 H' Psi^-1 r`` and the step-length line search
(closed form for a Gaussian GP, golden section otherwise). Prediction also
gives leaf indices, SHAP contributions (``shap.py``, on the host) and the
early-stopped scores of ``pred_early_stop``; models save and load in the
JSON format and the reference's text format (``model_text.py``) and export
to C (``convert.py``). Continued training (``init_model``) is not ported:
the JAX package takes the argument and never reads it. The device-resident
training loop is ``boosting/device_loop.py``, which ``train`` engages.
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
                                             fit_linear_leaves,
                                             fixed_grower_gaps, grow_tree,
                                             grow_tree_fast,
                                             predict_tree_linear,
                                             predict_tree_mixed,
                                             predict_tree_raw)
from gpboost_tpu_torch.utils import resolve_device, same_device
from gpboost_tpu_torch.utils.timer import timed

LOG2PI = math.log(2.0 * math.pi)


def nesterov_schedule(it: int, version: int, rate: float, offset: int):
    """Momentum schedule for Nesterov-accelerated boosting
    (``REModelTemplate::NesterovSchedule``, re_model_template.h:5643)."""
    if it < offset:
        return 0.0
    if version == 0:
        return rate
    if version == 1:
        return 1.0 - 3.0 / (6.0 + it)
    raise ValueError(
        f"momentum_schedule_version = {version} is not supported")


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
            self._load_model_content(model_str)
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
                                          gp_model=gp_model,
                                          device=self.device)
        self.objective.init(train_set.label, train_set.weight,
                            group=train_set.group)
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
        self._read_boosting_params(p)
        # DART (reference dart.hpp): the drop generator and the weights of
        # the trees
        self.drop_rate = float(p.get("drop_rate", 0.1))
        self.max_drop = int(p.get("max_drop", 50))
        self.skip_drop = float(p.get("skip_drop", 0.5))
        self.uniform_drop = bool(p.get("uniform_drop", False))
        self.xgboost_dart_mode = bool(p.get("xgboost_dart_mode", False))
        self._dart_rng = np.random.default_rng(int(p.get("drop_seed", 4)))
        self._tree_weights: List[float] = []
        # GOSS (goss.hpp)
        self.top_rate = float(p.get("top_rate", 0.2))
        self.other_rate = float(p.get("other_rate", 0.1))
        self._score_lag1 = None        # Nesterov: the scores of the last step
        self._valid_lag1: List[np.ndarray] = []
        self.bagging_fraction = float(p.get("bagging_fraction", 1.0))
        self.bagging_freq = int(p.get("bagging_freq", 0))
        self.pos_bagging_fraction = float(p.get("pos_bagging_fraction", 1.0))
        self.neg_bagging_fraction = float(p.get("neg_bagging_fraction", 1.0))
        self._bag_mask = None    # host bool [n], reused between re-bags
        self._bag_mask_t = None  # the same on the Dataset's device
        self.feature_fraction = float(p.get("feature_fraction", 1.0))
        if self.boosting_type == "rf":
            # random forests bag every iteration (rf.hpp)
            if not (self.bagging_freq > 0 and self.bagging_fraction < 1.0):
                self.bagging_freq = 1
                self.bagging_fraction = min(self.bagging_fraction, 0.632)
        self.use_gp_model_for_validation = bool(
            p.get("use_gp_model_for_validation", True))
        self.leaves_newton_update = bool(p.get("leaves_newton_update", False))
        self.line_search_step_length = bool(
            p.get("line_search_step_length", False))
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
        self._attrs = {}
        self._feature_names = None       # a loaded model's
        metric = p.get("metric", None)
        if metric in (None, "", "auto"):
            metric = metrics_mod.default_metric_for(self.objective_name)
        self.metric_names = ([metric] if isinstance(metric, str)
                             else list(metric))

    def _read_boosting_params(self, p: dict):
        """The settings that prediction reads too: the boosting type and
        Nesterov's schedule (a trained and a loaded model alike)."""
        self.boosting_type = p.get("boosting", "gbdt")
        self.use_nesterov_acc = bool(p.get("use_nesterov_acc", False))
        self.nesterov_acc_rate = float(p.get("nesterov_acc_rate", 0.5))
        self.momentum_offset = int(p.get("momentum_offset", 0))
        self.momentum_schedule_version = int(
            p.get("momentum_schedule_version", 1))

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

    def _tree_train_pred(self, tree: Tree) -> np.ndarray:
        """One tree on the training rows (host float64): a traversal of
        their raw values, which lands every row in the leaf the grower's
        partition gave it."""
        return self._tree_raw_pred(tree, *self._train_inputs()).cpu().numpy()

    def _dart_drop(self):
        """Select the trees to drop and take them out of the training score
        (``DART::DroppingTrees``, dart.hpp:97-147); the JAX package's draws
        from the ``drop_seed`` generator. Returns the dropped iterations."""
        it = self.current_iteration()
        drop = []
        if it > 0 and self._dart_rng.random() >= self.skip_drop:
            drop_rate = self.drop_rate
            if self.uniform_drop:
                if self.max_drop > 0:
                    drop_rate = min(drop_rate, self.max_drop / max(it, 1))
                for i in range(it):
                    if self._dart_rng.random() < drop_rate:
                        drop.append(i)
                        if len(drop) >= self.max_drop:
                            break
            else:
                sum_w = sum(self._tree_weights) or 1.0
                inv_avg = len(self._tree_weights) / sum_w
                if self.max_drop > 0:
                    drop_rate = min(drop_rate,
                                    self.max_drop * inv_avg / sum_w)
                for i in range(it):
                    if self._dart_rng.random() < (
                            drop_rate * self._tree_weights[i] * inv_avg):
                        drop.append(i)
                        if len(drop) >= self.max_drop:
                            break
        n = self.train_set.num_data
        with timed("Booster: DART drops", sync=True):
            for i in drop:
                self._score[:n] -= self._tree_train_pred(self.trees[i])
        return drop

    def _dart_normalize(self, drop):
        """Scale the dropped trees by k / (k + 1) and put them back into the
        scores (``DART::Normalize``, dart.hpp:158-200, non-xgboost mode)."""
        k = float(len(drop))
        n = self.train_set.num_data
        with timed("Booster: DART drops", sync=True):
            for i in drop:
                tree = self.trees[i]
                factor = k / (k + 1.0)
                # the validation scores see the change (factor - 1) * old
                for vi in range(len(self.valid_sets)):
                    self._valid_scores[vi] += (factor - 1.0) * \
                        self._tree_raw_pred(tree,
                                            *self._valid_X[vi]).cpu().numpy()
                tree.leaf_value = tree.leaf_value * factor
                tree.shrinkage *= factor
                self._score[:n] += self._tree_train_pred(tree)
                self._tree_weights[i] *= factor

    def _momentum_step(self):
        """Nesterov acceleration: the scores moved by the momentum before
        the gradients are taken (gbdt.cpp:414-419)."""
        if self._score_lag1 is None:
            self._score_lag1 = self._score.copy()
        while len(self._valid_lag1) < len(self._valid_scores):
            self._valid_lag1.append(
                self._valid_scores[len(self._valid_lag1)].copy())
        mu = nesterov_schedule(
            self.current_iteration(), self.momentum_schedule_version,
            self.nesterov_acc_rate, self.momentum_offset)
        for arr, lag in ([(self._score, self._score_lag1)]
                         + list(zip(self._valid_scores, self._valid_lag1))):
            momentum = (mu + 1.0) * arr - mu * lag
            lag[:] = arr
            arr[:] = momentum

    def _goss(self, it: int, n: int, grad, hess):
        """Gradient one-side sampling (goss.hpp:108-150) from iteration
        ``1 / learning_rate`` on: the rows of the ``top_rate`` largest
        |g| sqrt(h) and a ``seed``-stream sample of ``other_rate`` of the
        rest, whose gradients and hessians are multiplied by
        (n - top_k) / other_k. Returns (row mask or None, grad, hess); the
        histogram kernel's fixed-point scales then come from the amplified
        gradients."""
        if it < int(1.0 / max(self.learning_rate, 1e-10)):
            return None, grad, hess
        g_abs = np.abs(grad[:n]) * np.sqrt(np.maximum(hess[:n], 0))
        top_k = max(1, int(self.top_rate * n))
        other_k = max(1, int(self.other_rate * n))
        order = np.argsort(-g_abs)
        rest = order[top_k:]
        sampled = self._rng.choice(rest, size=min(other_k, len(rest)),
                                   replace=False)
        keep = np.zeros(n, dtype=bool)
        keep[order[:top_k]] = True
        keep[sampled] = True
        mult = (n - top_k) / max(other_k, 1)
        grad = grad.copy()
        hess = hess.copy()
        grad[sampled] *= mult
        hess[sampled] *= mult
        return torch.as_tensor(keep, device=self.device), grad, hess

    def update(self, train_set=None, fobj=None):
        """One boosting iteration (``GBDT::TrainOneIter``, gbdt.cpp:404):
        ``num_models`` trees. ``fobj(score, train_set)`` returns the
        gradients and hessians in place of the objective's. ``train_set``
        must be the booster's own (the JAX package trains on that one
        whatever it is given)."""
        if train_set is not None and train_set is not self.train_set:
            raise ValueError(
                "update(train_set=...) takes only the booster's own training "
                "Dataset")
        ds = self.train_set
        n = ds.num_data
        dart_drop = self._dart_drop() if self.boosting_type == "dart" \
            else None
        if self.use_nesterov_acc and self.boosting_type == "gbdt":
            self._momentum_step()
        # random forests: the gradients at the constant initial score (rf.hpp)
        score_for_grad = (np.repeat(self.init_score, n)
                          if self.boosting_type == "rf" else self._score)
        with timed("Booster: gradients", sync=True):
            if fobj is not None:
                grad, hess = fobj(score_for_grad, ds)
            else:
                grad, hess = self.objective.get_gradients(score_for_grad)
            grad = np.asarray(grad, dtype=np.float64)
            hess = np.asarray(hess, dtype=np.float64)
        it = self.current_iteration()
        # the JAX package's order of draws: GOSS's sample or the bag, then
        # the tree's features, then the nodes' features inside each grower
        # call
        if self.boosting_type == "goss":
            row_mask, grad, hess = self._goss(it, n, grad, hess)
        else:
            row_mask = self._bag(it, n)
        num_bins, num_bins_host = self._tree_num_bins()
        nan_mask = ds.has_nan if bool(np.any(ds.has_nan)) else None
        # on the card the fixed-shape grower (one captured graph a tree, one
        # fetch) wherever it covers the options, as the JAX package's
        # accelerator route (booster.py:522-558); the host grower elsewhere
        grower = (grow_tree_fast if self.device.type == "cuda"
                  and not fixed_grower_gaps(self.grower, self._cegb)
                  else grow_tree)
        for m in range(self.num_models):
            with timed("Booster: gradients to the device", sync=True):
                g = torch.as_tensor(grad[m * n:(m + 1) * n],
                                    dtype=self._grad_dtype,
                                    device=self.device)
                h = torch.as_tensor(hess[m * n:(m + 1) * n],
                                    dtype=self._grad_dtype,
                                    device=self.device)
            with timed("Booster: grow_tree", sync=True):
                tree, row_leaf = grower(
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
            # the GPBoost Newton leaf re-solve (gbdt.cpp:463-473)
            if (self.leaves_newton_update
                    and isinstance(self.objective, GPBoostObjective)
                    and self.gp_model.is_gaussian):
                with timed("Booster: leaf re-solve", sync=True):
                    self._newton_update_leaves(tree, row_leaf)
            if self.line_search_step_length and self.num_models == 1:
                with timed("Booster: line search", sync=True):
                    self._line_search_scale(tree, row_leaf)
            if self.boosting_type == "dart":
                k = len(dart_drop)
                shrink = (self.learning_rate / (1.0 + k)
                          if not self.xgboost_dart_mode else
                          (self.learning_rate if k == 0 else
                           self.learning_rate / (self.learning_rate + k)))
                tree.add_shrinkage(shrink)
                self._tree_weights.append(shrink)
            elif self.boosting_type != "rf":   # random forests: unshrunk
                tree.add_shrinkage(self.learning_rate)
            self.trees.append(tree)
            with timed("Booster: score update", sync=True):
                vals = self._train_vals(tree, row_leaf)
                if self.boosting_type == "rf":
                    self._rf_update(m, n, vals)
                else:
                    self._score[m * n:(m + 1) * n] += vals
            with timed("Booster: validation scores", sync=True):
                for vi, vset in enumerate(self.valid_sets):
                    nv = vset.num_data
                    vvals = self._tree_raw_pred(
                        tree, *self._valid_X[vi]).cpu().numpy()
                    if self.boosting_type == "rf":
                        self._rf_valid_sums[vi][m * nv:(m + 1) * nv] += vvals
                        self._valid_scores[vi] = (
                            self._rf_base()
                            + self._rf_valid_sums[vi]
                            / self.current_iteration())
                    else:
                        self._valid_scores[vi][m * nv:(m + 1) * nv] += vvals
        if dart_drop is not None:
            self._dart_normalize(dart_drop)
        if (isinstance(self.objective, GPBoostObjective)
                and not (self.use_gp_model_for_validation
                         and self.use_nesterov_acc)):
            # end-of-iteration covariance refit at the UPDATED score
            # (gbdt.cpp:536-542 calls Boosting() again after UpdateScore):
            # get_cov_pars() and the validation metrics reflect the
            # post-iteration residual, and the next iteration reuses this
            # refit and its gradient. Skipped with Nesterov acceleration and
            # the GP in the validation, as in the JAX package
            with timed("Booster: gradients", sync=True):
                self.objective.get_gradients(self._score)
        return False

    def _train_vals(self, tree: Tree, row_leaf: torch.Tensor) -> np.ndarray:
        """The new tree's values on the training rows. The grower's final
        row->leaf assignment is the training prediction: a host gather
        replaces a traversal (under a bag or GOSS's sample too: the
        partition moves the rows outside it with the others; the JAX
        package traverses the tree there, which gives the same leaves).
        Linear leaves: the tree evaluated on the raw rows. The fixed-shape
        grower fetched ``row_leaf`` with the tree (``tree.row_leaf_host``,
        taken off the tree here)."""
        host = tree.__dict__.pop("row_leaf_host", None)
        if tree.lin_features is not None:
            return self._tree_train_pred(tree)
        if host is None:
            host = row_leaf.cpu().numpy()
        return tree.leaf_value[host]

    def _rf_base(self) -> float:
        return float(self.init_score[0]) if self.num_models == 1 else 0.0

    def _rf_update(self, m: int, n: int, vals: np.ndarray):
        """Random forests: the training score is the initial score plus the
        average of the unshrunk trees (rf.hpp; the JAX package's running
        sums)."""
        if not hasattr(self, "_rf_tree_sum"):
            self._rf_tree_sum = np.zeros_like(self._score)
            self._rf_valid_sums = [np.zeros_like(s)
                                   for s in self._valid_scores]
        self._rf_tree_sum[m * n:(m + 1) * n] += vals
        self._score = self._rf_base() + (self._rf_tree_sum
                                         / self.current_iteration())

    def _line_search_scale(self, tree: Tree, row_leaf: torch.Tensor):
        """The step length of the new tree (``LineSearchLearningRate``,
        gbdt.cpp:475-485): its leaf values scaled by the argmin over
        [0, 10] of loss(F + a t(x)).

        A Gaussian GP objective's loss is a quadratic in the step length
        (the log-determinant does not depend on it): a* = v' Psi^-1 r /
        v' Psi^-1 v, one ``Psi^-1`` solve. Other objectives: 20
        golden-section steps on the GP's NLL (LaGaBoost) or on the sum of
        the squared gradients."""
        vals = self._train_vals(tree, row_leaf)
        n = self.train_set.num_data
        base = self._score[:n]
        gp = self.gp_model
        is_gp = isinstance(self.objective, GPBoostObjective)
        if is_gp and gp.is_gaussian:
            u = gp._psi_solve(gp.cov_pars_, vals)
            v = gp._tensor(vals)
            r0 = gp._tensor(self.train_set.label - base)
            denom = float(torch.dot(u, v))
            alpha = float(torch.dot(u, r0)) / max(denom, 1e-300)
            alpha = min(max(alpha, 0.0), 10.0)  # the reference's [0, 10]
            tree.leaf_value = tree.leaf_value * alpha
            tree.shrinkage *= alpha
            return

        def loss(alpha):
            score = base + alpha * vals
            if is_gp:
                return gp.neg_log_likelihood(
                    cov_pars=gp.cov_pars_, y=self.train_set.label,
                    fixed_effects=score)
            g, _ = self.objective.get_gradients(score)
            return float(np.sum(g * g))

        lo, hi = 0.0, 10.0
        invphi = (math.sqrt(5.0) - 1) / 2
        c = hi - invphi * (hi - lo)
        d = lo + invphi * (hi - lo)
        fc, fd = loss(c), loss(d)
        for _ in range(20):
            if fc < fd:
                hi, d, fd = d, c, fc
                c = hi - invphi * (hi - lo)
                fc = loss(c)
            else:
                lo, c, fc = c, d, fd
                d = lo + invphi * (hi - lo)
                fd = loss(d)
        alpha = 0.5 * (lo + hi)
        tree.leaf_value = tree.leaf_value * alpha
        tree.shrinkage *= alpha

    def _newton_update_leaves(self, tree: Tree, row_leaf: torch.Tensor):
        """The leaf values re-solved as a = (H' Psi^-1 H)^-1 H' Psi^-1 r
        with the one-hot leaf matrix H [n, leaves]
        (``REModelTemplate::NewtonUpdateLeafValues``,
        re_model_template.h:4518): one ``Psi^-1`` solve of the leaves'
        columns through the GP's approximation (one ``vecchia_factors``
        launch on the kernel route), the small system on the host."""
        gp = self.gp_model
        n = self.train_set.num_data
        leaf_nodes = tree.leaf_index_order()
        H = (row_leaf.to(gp.device)[:, None] == torch.as_tensor(
            leaf_nodes, device=gp.device)[None, :]).to(gp.dtype)
        PiH = gp._psi_solve(gp.cov_pars_, H)
        r = gp._tensor(self.train_set.label - self._score[:n])
        A = (H.T @ PiH).double().cpu().numpy()
        b = (PiH.T @ r).double().cpu().numpy()
        tree.leaf_value[leaf_nodes] = np.linalg.solve(
            A + 1e-10 * np.eye(len(leaf_nodes)), b)

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

    def _default_eval_at(self):
        """The ``eval_at`` positions (config.h:968; DCGCalculator's default
        1..5)."""
        at = self.params.get("eval_at", None)
        if at is None:
            return [1, 2, 3, 4, 5]
        return list(at) if isinstance(at, (list, tuple)) else [int(at)]

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
                if ks is None:
                    ks = self._default_eval_at()
                kwargs = {}
                if base == "ndcg":
                    kwargs["label_gain"] = self.params.get("label_gain")
                vals = spec.fn(dset.label, score[:dset.num_data],
                               dset.group, ks, **kwargs)
                for k, v in zip(ks, vals):
                    res.append((name, f"{base}@{k}", v, spec.higher_better))
                continue
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
                cluster_ids_pred=None, predict_var=False, pred_latent=False,
                **kwargs):
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
        of ``pred_mean`` and ``pred_var``).

        ``pred_leaf``: the leaf index of every row in every tree
        ``[n, trees]``; ``pred_contrib``: the SHAP contributions ``[n, F + 1]``
        (the last column the expected value; TreeSHAP on the host, rows sum
        to the raw score). ``params["pred_early_stop"]`` stops a binary or
        multiclass row's sum once its margin passes
        ``pred_early_stop_margin`` (checked every ``pred_early_stop_freq``
        iterations). Other keywords are taken and dropped, as in the JAX
        package."""
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        data = self._marshal_pred(data)
        if data.ndim == 1:
            data = data[:, None]
        if pred_leaf:
            return self._predict_leaf(data, num_iteration)
        if pred_contrib:
            from gpboost_tpu_torch.boosting.shap import predict_contrib
            limit = self._tree_limit(num_iteration)
            base = self.init_score[0] if self.num_models == 1 else 0.0
            return predict_contrib(self.trees[:limit], data, base)
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

    def _tree_limit(self, num_iteration) -> int:
        """The number of trees of the first ``num_iteration`` iterations
        (all for None, -1 or 0)."""
        if num_iteration in (None, -1, 0):
            return len(self.trees)
        return min(num_iteration * self.num_models, len(self.trees))

    def _predict_raw(self, data, num_iteration=None, start_iteration=0):
        """Raw scores ``[n * num_models]``: the initial score and the trees
        of iterations ``start_iteration`` up to ``num_iteration``; the
        prediction early stop, Nesterov's momentum steps replayed between
        iterations (gbdt_prediction.cpp:20-35) or the random forest's
        average as the model asks, in the JAX package's order."""
        n = data.shape[0]
        K = self.num_models
        limit = self._tree_limit(num_iteration)
        # start_iteration (config.h:647): predict from a tree-range suffix;
        # the boost-from-average base belongs to iteration 0
        start = max(0, int(start_iteration or 0)) * K
        X = self._device_inputs(data)
        score = torch.zeros(K, n, dtype=torch.float64, device=self.device)
        if start == 0:
            score += torch.as_tensor(self.init_score, dtype=torch.float64,
                                     device=self.device)[:, None]
        early = None
        if bool(self.params.get("pred_early_stop", False)):
            if K == 1 and self.objective_name == "binary":
                early = "binary"
            elif K > 1:
                early = "multiclass"
        if early is not None and start == 0:
            return self._predict_early_stop(score, X, limit, early)
        if self.use_nesterov_acc and start == 0 \
                and self.boosting_type == "gbdt":
            lag = None
            for i in range(limit // K):
                if i == 1:
                    lag = score.clone()
                elif i > 1:
                    mu = nesterov_schedule(
                        i, self.momentum_schedule_version,
                        self.nesterov_acc_rate, self.momentum_offset)
                    score, lag = (mu + 1.0) * score - mu * lag, score
                for m in range(K):
                    score[m] += self._tree_raw_pred(self.trees[i * K + m],
                                                    *X)
            return score.reshape(-1).cpu().numpy()
        for k in range(start, limit):
            score[k % K] += self._tree_raw_pred(self.trees[k], *X)
        if self.boosting_type == "rf" and limit > 0:
            base = self._rf_base()
            score = base + (score - base) / (limit // K)
        return score.reshape(-1).cpu().numpy()

    def _predict_early_stop(self, score, X, limit: int, kind: str):
        """Row-wise prediction early stopping (prediction_early_stop.cpp:25,
        54): a row stops taking trees once its margin (binary 2|score|,
        multiclass top1 - top2) exceeds ``pred_early_stop_margin`` at a
        check every ``pred_early_stop_freq`` iterations."""
        K = self.num_models
        freq = int(self.params.get("pred_early_stop_freq", 10))
        thresh = float(self.params.get("pred_early_stop_margin", 10.0))
        active = torch.ones(score.shape[1], dtype=torch.bool,
                            device=self.device)
        for k in range(limit):
            m = k % K
            vals = self._tree_raw_pred(self.trees[k], *X)
            score[m] = torch.where(active, score[m] + vals, score[m])
            if m == K - 1 and ((k // K) + 1) % freq == 0:
                if kind == "binary":
                    margin = 2.0 * torch.abs(score[0])
                else:
                    top2 = torch.sort(score, dim=0).values[-2:]
                    margin = top2[1] - top2[0]
                active &= margin <= thresh
                if not bool(active.any()):
                    break
        return score.reshape(-1).cpu().numpy()

    def _predict_leaf(self, data, num_iteration=None) -> np.ndarray:
        """The leaf index (the leaf's ordinal in ``leaf_index_order``) of
        every row in each of the first trees, ``[n, trees]`` int32."""
        X = self._device_inputs(data)
        cols = []
        for tree in self.trees[:self._tree_limit(num_iteration)]:
            _, nodes = self._tree_eval(tree, *X)
            remap = np.zeros(len(tree.is_leaf), dtype=np.int32)
            leaf_nodes = tree.leaf_index_order()
            remap[leaf_nodes] = np.arange(len(leaf_nodes))
            cols.append(torch.as_tensor(remap, device=self.device)[nodes])
        if not cols:
            return np.zeros((data.shape[0], 0), dtype=np.int32)
        return torch.stack(cols, dim=1).cpu().numpy()

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
        """One tree's values on raw values ``X`` (and the category bins of
        its categorical columns)."""
        return self._tree_eval(tree, X, cat_bins_t)[0]

    def _tree_eval(self, tree: Tree, X: torch.Tensor,
                   cat_bins_t: Optional[torch.Tensor] = None):
        """One tree on raw values ``X``: the plain, categorical or linear
        traversal. Returns (values [n], node ids [n])."""
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
                return predict_tree_linear(
                    *common, dev(tree.lin_features), dev(tree.lin_coefs),
                    default_left=dl)
            return predict_tree_mixed(*common, default_left=dl)
        return predict_tree_raw(
            X, dev(tree.split_feature), dev(tree.threshold), dev(tree.left),
            dev(tree.right), dev(tree.leaf_value), depth, default_left=dl)

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
    # the convenience surface (reference ``Booster``, basic.py:2323)
    def feature_name(self):
        """The training Dataset's feature names, or a loaded model's (the
        JAX package names a loaded model's features ``Column_i`` whatever
        the model holds)."""
        if self.train_set is not None:
            return list(self.train_set.feature_name)
        if self._feature_names:
            return list(self._feature_names)
        return [f"Column_{i}" for i in range(self.num_feature())]

    def attr(self, key):
        """A model attribute string (``Booster.attr``), or None."""
        return self._attrs.get(key)

    def set_attr(self, **kwargs):
        """Set model attribute strings (``Booster.set_attr``); None deletes
        one."""
        for k, v in kwargs.items():
            if v is None:
                self._attrs.pop(k, None)
            else:
                self._attrs[k] = str(v)
        return self

    def free_dataset(self):
        """Drop the reference to the training Dataset (the booster still
        predicts on raw data)."""
        if self.train_set is not None:
            self._feature_names = list(self.train_set.feature_name)
        self.train_set = None
        self._train_X = None
        return self

    def free_network(self):
        """No-op: one process drives one card (several GPUs: ROADMAP.md
        Queue A, item 20)."""
        return self

    def set_network(self, *args, **kwargs):
        raise NotImplementedError(
            "set_network (training over several machines or GPUs) is not "
            "ported to gpboost_tpu_torch yet (ROADMAP.md Queue A, item 20)")

    def reset_parameter(self, params):
        """Update training parameters between iterations
        (``Booster.reset_parameter``)."""
        for k, v in cfg_mod.resolve_params(params).items():
            if k == "learning_rate":
                self.learning_rate = float(v)
            else:
                self.params[k] = v
        return self

    def rollback_one_iter(self):
        """Undo the last boosting iteration (``Booster.rollback_one_iter``):
        its trees leave the model and their values the training and
        validation scores."""
        n = self.train_set.num_data if self.train_set is not None else None
        for _ in range(self.num_models):
            if not self.trees:
                break
            tree = self.trees.pop()
            m = len(self.trees) % self.num_models
            if n is not None:
                self._score[m * n:(m + 1) * n] -= self._tree_train_pred(tree)
            for vi, vset in enumerate(self.valid_sets):
                nv = vset.num_data
                self._valid_scores[vi][m * nv:(m + 1) * nv] -= \
                    self._tree_raw_pred(tree, *self._valid_X[vi]).cpu().numpy()
        return self

    def shuffle_models(self, start_iteration=0, end_iteration=-1):
        """Permute the trees of iterations [start, end) at random
        (``Booster.shuffle_models``; the ``seed`` generator of the JAX
        package)."""
        lo = start_iteration * self.num_models
        hi = (len(self.trees) if end_iteration < 0
              else end_iteration * self.num_models)
        rng = np.random.default_rng(int(self.params.get("seed", 0)))
        idx = np.arange(lo, hi)
        rng.shuffle(idx)
        self.trees[lo:hi] = [self.trees[i] for i in idx]
        return self

    def get_leaf_output(self, tree_id, leaf_id):
        tree = self.trees[tree_id]
        return float(tree.leaf_value[tree.leaf_index_order()[leaf_id]])

    def get_split_value_histogram(self, feature, bins=None):
        """Histogram of the numerical split thresholds on ``feature``
        (``Booster.get_split_value_histogram``; a name or an index)."""
        if isinstance(feature, str):
            feature = self.feature_name().index(feature)
        thresholds = []
        for tree in self.trees:
            for node in tree.internal_nodes():
                if (int(tree.split_feature[node]) == feature
                        and (tree.is_categorical is None
                             or not tree.is_categorical[node])):
                    thresholds.append(float(tree.threshold[node]))
        thresholds = np.asarray(thresholds)
        if bins is None:
            bins = max(1, min(32, len(thresholds)))
        return np.histogram(thresholds[np.isfinite(thresholds)], bins=bins)

    def _pred_bound(self, reduce_fn):
        total = 0.0
        for tree in self.trees:
            leaves = tree.leaf_value[tree.is_leaf]
            total += float(reduce_fn(leaves)) if len(leaves) else 0.0
        return total + float(reduce_fn(np.atleast_1d(self.init_score)))

    def lower_bound(self):
        """Lower bound of the raw predictions (the trees' smallest leaves
        summed)."""
        return self._pred_bound(np.min)

    def upper_bound(self):
        """Upper bound of the raw predictions (the trees' largest leaves
        summed)."""
        return self._pred_bound(np.max)

    def trees_to_dataframe(self):
        """The trees' nodes as a pandas DataFrame
        (``Booster.trees_to_dataframe``)."""
        import pandas as pd
        rows = []
        names = self.feature_name()
        for k, tree in enumerate(self.trees):
            internal = tree.internal_nodes()
            reached = {0} | set(tree.left[internal]) | set(tree.right[internal])
            count = (lambda nd: None if tree.node_count is None
                     else float(tree.node_count[nd]))
            for node in range(len(tree.is_leaf)):
                if node not in reached:
                    continue
                if tree.is_leaf[node]:
                    rows.append(dict(
                        tree_index=k, node_index=node, split_feature=None,
                        threshold=None, decision_type=None,
                        left_child=None, right_child=None,
                        value=float(tree.leaf_value[node]),
                        count=count(node)))
                else:
                    f = int(tree.split_feature[node])
                    rows.append(dict(
                        tree_index=k, node_index=node,
                        split_feature=names[f] if f < len(names) else f,
                        threshold=float(tree.threshold[node]),
                        decision_type="<=", left_child=int(tree.left[node]),
                        right_child=int(tree.right[node]), value=0.0,
                        count=count(node)))
        return pd.DataFrame(rows)

    def refit(self, data, label, decay_rate: float = 0.9, **kwargs):
        """Refit the leaf values on new data, keeping the trees' structure
        (``Booster.refit``, basic.py:3686): each leaf's new value is
        ``decay_rate`` times the old one plus ``1 - decay_rate`` times its
        Newton step from the new data's gradients (at the scores of the
        trees before it), shrunk as the tree is. Host sums over the leaves'
        rows in the JAX package's order; the traversals on the device."""
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        label = np.asarray(label, dtype=np.float64).ravel()
        obj = create_objective(self.objective_name, self.params,
                               device=self.device)
        obj.init(label, None)
        n = data.shape[0]
        score = np.zeros(n * self.num_models)
        for m in range(self.num_models):
            score[m * n:(m + 1) * n] += self.init_score[m]
        X = self._device_inputs(data)
        for k, tree in enumerate(self.trees):
            grad, hess = obj.get_gradients(score)
            m = k % self.num_models
            g = grad[m * n:(m + 1) * n]
            h = hess[m * n:(m + 1) * n]
            nodes = self._tree_eval(tree, *X)[1].cpu().numpy()
            for ln in tree.leaf_index_order():
                mask = nodes == ln
                if mask.sum() > 0:
                    new_val = (-g[mask].sum()
                               / (h[mask].sum() + 1e-15)) * tree.shrinkage
                    tree.leaf_value[ln] = (decay_rate * tree.leaf_value[ln]
                                           + (1 - decay_rate) * new_val)
            score[m * n:(m + 1) * n] += self._tree_raw_pred(
                tree, *X).cpu().numpy()
        return self

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
        if self._feature_names:
            return len(self._feature_names)
        return int(max(int(np.max(t.split_feature[t.internal_nodes()],
                                  initial=0)) for t in self.trees)) + 1

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration=None, format: str = "json"):
        """The model as a string: ``format='json'`` (the format this package
        and the JAX package share) or ``'text'`` (the reference's ``.txt``
        model format, ``model_text.py``; the first ``num_iteration``
        iterations)."""
        if format == "text":
            from gpboost_tpu_torch.boosting.model_text import booster_to_text
            return booster_to_text(self, num_iteration)
        return json.dumps(self._to_dict())

    def dump_model(self, num_iteration=None, start_iteration=0):
        """The model as a python dict (``Booster.dump_model``: the JSON
        model's content)."""
        return self._to_dict()

    @classmethod
    def model_from_string(cls, model_str, device="cuda"):
        """A Booster from a JSON or text model string."""
        return cls(model_str=model_str, device=device)

    def model_to_c(self, num_iteration=None):
        """Standalone C source of this model (``task=convert_model``,
        reference ``Tree::ToIfElse`` io/tree.cpp:527; ``convert.py``)."""
        from gpboost_tpu_torch.boosting.convert import booster_to_c
        return booster_to_c(self, num_iteration)

    def save_model_to_c(self, filename, num_iteration=None):
        """Write :meth:`model_to_c`'s source to ``filename``."""
        from gpboost_tpu_torch.boosting.convert import save_model_to_c
        save_model_to_c(self, filename, num_iteration)
        return self

    def save_model(self, filename, num_iteration=None, start_iteration=0,
                   format: Optional[str] = None):
        """Save the model: ``format=None`` chooses by the name, ``.txt`` the
        reference's text format, anything else JSON."""
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
            "attrs": dict(self._attrs),
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

    def _load_model_content(self, content: str):
        """Load the JSON model format or the reference's text model format
        (``gbdt_model_text.cpp`` SaveModelToString), whichever it is."""
        from gpboost_tpu_torch.boosting import model_text
        if model_text.looks_like_model_text(content):
            self._load_dict(model_text.parse_model_text(content))
        else:
            self._load_dict(json.loads(content))

    def _load_dict(self, d):
        """Load ``_to_dict`` output — this package's or the JAX package's."""
        self.params = cfg_mod.resolve_params(d.get("params", {}))
        self.objective_name = d["objective"]
        self._read_boosting_params(self.params)
        self.boosting_type = d.get("boosting_type", self.boosting_type)
        self.num_class = d.get("num_class", 1)
        self.num_models = d.get("num_models", 1)
        cm = d.get("cat_maps")
        self._loaded_cat_maps = (
            None if not cm else
            {int(f): {float(k): int(v) for k, v in mp.items()}
             for f, mp in cm.items()})
        self._pandas_categorical = d.get("pandas_categorical")
        self._feature_names = d.get("feature_names")
        self._attrs = dict(d.get("attrs") or {})
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
        self.objective = create_objective(self.objective_name, self.params,
                                          device=self.device)
        self.valid_sets, self.valid_names = [], []
        self._valid_scores, self._valid_X = [], []
        self._train_data_name = "training"
        self._eval_train_metric = False
        self.use_gp_model_for_validation = bool(
            self.params.get("use_gp_model_for_validation", True))
        self.metric_names = [
            metrics_mod.default_metric_for(self.objective_name)]
