"""gpboost_tpu_torch — PyTorch/CUDA port of gpboost_tpu for NVIDIA Hopper.

The port grows module by module beside the JAX package, which stays the
reference. Ported so far:

- the Gaussian Vecchia GP (``GPModel`` with ``gp_approx="vecchia"``:
  construct, NLL, fit by every optimizer of the reference's route, std
  errors, prediction) with its two fused kernels written by hand in CUDA
  C++ (``csrc/vecchia_factors.cu``);
- tree boosting and the GPBoost algorithm (``Dataset``, ``Booster``,
  ``train(params, dataset, gp_model=gp)``, ``Booster.predict``): the
  host-driven leaf-wise learner, every histogram through a hand-written
  CUDA kernel (``csrc/histogram.cu``), on numeric and categorical
  features, pandas DataFrames and scipy.sparse input, with EFB bundles,
  the grower's options (monotone and interaction constraints, forced
  splits and bins, extra trees, path smoothing, ``max_delta_step``, CEGB,
  ``feature_contri``, linear leaves, the missing-value switches), the
  objectives without a GP (regression and its L1 / huber / fair / quantile
  / mape / tobit / mean-scale variants, poisson, gamma, tweedie, binary,
  the cross-entropies, multiclass and one-vs-all), bagging and feature
  sampling, validation sets with the metrics and the GP-aware validation
  (``use_gp_model_for_validation``, ``set_prediction_data``), callbacks and
  early stopping, ``cv`` with GP-aware folds and
  ``grid_search_tune_parameters``; DART, GOSS, random forests, Nesterov
  acceleration, the GPBoost leaf re-solve and line search, the ranking
  objectives and metrics (``Dataset(group=)``), SHAP contributions, leaf
  indices, the prediction early stop, the reference's text model format, C
  export, ``refit`` and the rest of the Booster's surface;
- the non-Gaussian Vecchia GP (the likelihood families of ``likelihoods/``,
  Laplace approximation, dense or ``matrix_inversion_method="iterative"``:
  CG + stochastic Lanczos log-determinant, ``ops/cg.py``) and the LaGaBoost
  algorithm (``train({"objective": "binary"}, dataset, gp_model=gp)`` with
  a ``bernoulli_logit`` GP). Its heavy work is plain PyTorch, as in the JAX
  package: no kernel of its own; its trees go through the histogram kernel;
- grouped random effects (``GPModel(group_data=...)`` with random slopes,
  or ``num_data`` for the iid model): the Woodbury route in q-space for the
  gaussian likelihood (NLL, fit, std errors, prediction), the GPBoost
  algorithm with them, and the b-space Laplace approximation for the other
  likelihoods; no kernel of their own either (their sums over rows go
  through a fixed-order plan on the GPU, their dense work is
  ``torch.linalg`` on [q, q] matrices);
- the exact GP (``gp_approx="none"``, the default), alone or with grouped
  effects, GP random coefficients and ``cluster_ids`` (batched per-cluster
  blocks): NLL, the profiled, masked, Fisher-scoring and Newton fits, std
  errors, prediction, the dense Laplace approximation, GPBoost and
  LaGaBoost with it, and LaGaBoost with grouped effects (in b-space); its
  dense work is ``torch.linalg``'s Cholesky, as in the JAX package;
- the low-rank and full-scale approximations (``gp_approx="fitc"``,
  ``"full_scale_tapering"``, ``"full_scale_vecchia"`` and its
  residual-correlation variant; inducing points by kmeans++, random or
  cover tree), alone or with ``cluster_ids``, Gaussian and Laplace, inside
  GPBoost and LaGaBoost: Woodbury solves over [k, k] Cholesky factors, a
  dense Cholesky for full-scale tapering, and for full-scale Vecchia a
  Vecchia residual whose factors and precision products gather forward and
  backward; no kernel of their own either.

There is no global dtype switch: models take ``dtype=`` (default
``torch.float64``) and ``device=`` (default ``"cuda"``; a missing GPU raises,
``device="cpu"`` runs the plain PyTorch versions).

On the card the trees grow by the fixed-shape grower (one captured CUDA
graph and one fetch a tree) wherever it covers the options, and ``train``
runs the GPBoost / LaGaBoost rounds with their state on the device
(``boosting/device_loop.py``, ``device_resident_boosting``); the
profiler's glue is ``utils/profiler.py``.

The fixed-shape grower takes categorical features, monotone and
interaction constraints and forced splits; the categorical scan's group
boundaries are a kernel of their own (``ops/kernels/cat_group_scan.py``).

Not ported yet: the fixed-shape grower's CEGB, extra-trees and per-node
sampling options (ROADMAP.md Queue A, item 10b), the parameter registry and the TPE tuner
(item 19), several GPUs (item 20). Continued training (``init_model``) is
not in the JAX package.
"""
from gpboost_tpu_torch.models.gp_model import GPModel
from gpboost_tpu_torch.boosting.dataset import Dataset
from gpboost_tpu_torch.boosting.booster import Booster
from gpboost_tpu_torch.boosting.engine import train, cv, CVBooster
from gpboost_tpu_torch.boosting import callback
from gpboost_tpu_torch.boosting.callback import (
    early_stopping, record_evaluation, print_evaluation, log_evaluation,
    reset_parameter)
from gpboost_tpu_torch.tuning import grid_search_tune_parameters
from gpboost_tpu_torch.utils.log import register_logger

__version__ = "0.1.0"

__all__ = ["GPModel", "Dataset", "Booster", "train", "cv", "CVBooster",
           "callback", "early_stopping", "record_evaluation",
           "print_evaluation", "log_evaluation", "reset_parameter",
           "grid_search_tune_parameters", "register_logger", "__version__"]
