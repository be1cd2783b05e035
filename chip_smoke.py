#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gpboost_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--n 100000] [--m 20] [--n-pred 10000]
                          [--rounds 30] [--grouped-n 1000000]

Needs one NVIDIA GPU with ``nvcc`` on the machine; exits non-zero without
one. It

1. builds the CUDA kernels of ``gpboost_tpu_torch/csrc`` from source and
   checks by ptxas's report that no instance of the Vecchia kernels, the
   histogram kernel or the group-scan kernel has a stack frame or spills;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main paths use, and times both: the Vecchia kernels for all
   four covariance shapes, isotropic and ARD, neighbour sets with -1
   padding, two launches bit-identical, and the NLL kernel also at m = 40
   and m = 64 on the same points (its other rows-per-block choices); the
   histogram kernel at the boosting path's shape with a full, a 3 %, an
   empty and a one-bin mask, and at F = 50, B = 64 and n = 1 000 003, each
   through both of its entries (scales by value and read from device
   memory: the same bits), and the operations one call puts on the stream
   (phase 16's ``torch.profiler`` trace: one, the kernel);
3. drives the GP path once through the public API at full size:
   ``GPModel`` construct (ordering + neighbour search), NLL, L-BFGS fit,
   prediction with variances — a Gaussian Vecchia GP with n = 100 000 points,
   m = 20 neighbours (40 for prediction), exponential covariance, float32;
4. drives the boosting path once through the public API at full size: the
   GPBoost algorithm, ``Dataset`` -> ``train(params, ds, gp_model=gp,
   num_boost_round=30)`` -> ``Booster.predict(..., predict_var=True)`` at
   n = 100 000 rows, 5 features, 31 leaves, and the same training without a
   GP; then holds five rounds of it against the float64 plain path on the
   card, with the package's named timers on for a breakdown of a round;
5. drives the reference's default fit route (no optimizer parameters:
   gradient descent, whole loop on the device) at the GP path's size and
   holds it against the same descent on the float64 plain route on the
   card, then the std errors of the fitted parameters (p + 1 launches of
   the NLL kernel) against the same computation in float64; and 30 rounds
   of the GPBoost algorithm with that optimizer (its learning-rate reuse
   from the second refit on);
6. checks that training is bit-reproducible on the card: two trainings of
   the boosting path's L-BFGS recipe give the same scores, parameters and
   evaluation counts to the bit, as do two launches of the histogram kernel
   (full and 3 % mask), two float64 histograms and two ``Psi^-1 r`` solves
   (whose ``B' v`` is a gather with a fixed order, measured beside the
   scatter it replaces);
7. drives the non-Gaussian path of the reference's benchmark
   (``bench.py:323-385``) at its width — a ``bernoulli_logit`` Vecchia GP
   with ``matrix_inversion_method="iterative"`` at n = 100 000, m = 20,
   200 probes, 100 Lanczos steps, float32 (``ng_path``): construct, NLL, one
   timed value-and-gradient with its breakdown (Newton steps, mode-CG
   iterations, Lanczos, gradient CG, backward, host reads), one LaGaBoost
   gradient, the L-BFGS fit cut to NG_MAXIT iterations, prediction with
   simulated variances at 10 000 points; a profiler trace showing that the
   precision product (forward and backward) and diag(Q) add with no
   colliding indices; the float32 path against float64 on the card at
   n = 10 000 with the same probes (``ng_precision``); the LaGaBoost
   algorithm, ``Dataset`` -> ``train({"objective": "binary"}, ds,
   gp_model=gp, num_boost_round=NG_ROUNDS)`` -> ``Booster.predict(...,
   predict_var=True)`` (``lagaboost``), whose second training must give the
   same bits (``determinism``);
8. drives grouped random effects at full width: the Gaussian LMM
   (``grouped_lmm``: n = 1 000 000 rows, two crossed random intercepts of
   1 000 and 10 000 levels, the second Zipf-skewed, a random slope on the
   first, q = 12 000, X an intercept and two covariates, float64 —
   construct, NLL, the default fit, an L-BFGS fit, std errors, prediction
   at 10 000 rows of which 10 % at unseen levels; the L-BFGS optimum
   within 15 % of the simulation's truth), the same NLL and gradient on
   the card against the float64 CPU run on 20 000 rows
   (``grouped_vs_cpu``), the GPBoost algorithm with a grouped random
   intercept of 1 000 levels at the boosting path's size, 30 rounds with
   the default optimizer and with L-BFGS (``grouped_boosting``), a
   ``bernoulli_logit`` GLMM on the LMM's design without the slope (the
   b-space Laplace approximation, ``grouped_glmm``: fit, prediction of the
   response mean and variance), a profiler trace of the grouped NLL
   (forward and backward) and Z' v with no scatter
   (``grouped_ops_trace``), and a second grouped GPBoost training and GLMM
   fit that must give the same bits (``determinism``);
9. drives the exact GP (``gp_approx="none"``, the README's first example) at
   full width, float64: ``exact_gp`` (Matern 1.5 with X at n = 10 000 —
   construct, NLL, value-and-gradient, the default fit, L-BFGS and Fisher
   scoring, std errors, ``predict`` with variances and with the covariance
   at 1 000 points, training-data effects, the dense pieces' times, the
   peak memory; the L-BFGS optimum within EX_TRUTH_RTOL of the truth),
   ``exact_vs_cpu`` (n = 2 000: NLL, gradients, Fisher information and a
   prediction against the float64 CPU run within 1e-9; a Newton fit),
   ``exact_clustered`` (1 000 clusters of 100 on the batched blocks: the
   default fit, ``predict`` with 10 % of the points in unseen clusters, at
   their prior), ``exact_combined`` (with a 100-level random intercept, and
   with a GP random coefficient, n = 5 000), ``exact_laplace``
   (``bernoulli_logit`` at n = 5 000; card vs CPU at n = 1 000 within 1e-9),
   30 rounds of GPBoost and of LaGaBoost with it at n = 5 000
   (``exact_boosting``, ``exact_lagaboost``) and of LaGaBoost with 1 000
   grouped levels at n = 100 000 (``grouped_lagaboost``), a second run of
   the three trainings and of the clustered fit that must give the same bits
   (``determinism_exact``) and a profiler trace of the dense and the
   clustered value-and-gradient with no scatter (``exact_ops_trace``);
   after each of the three trainings the histogram kernel is held against
   its plain version on that path's own Dataset (all rows, 3 %) and timed
   there (the kernels line's histogram ``other_shapes``);
10. drives the low-rank and full-scale approximations at full width,
   float64, num_ind_points = 500 (kmeans++), FSVA m = 30: ``fitc_gp`` and
   ``fsva_gp`` (n = 100 000: inducing points timed apart, construct, NLL,
   a value-and-gradient, the default and the L-BFGS fit, prediction with
   variances at 10 000 points, FSVA also with nsim_var_pred = 100, and its
   peak memory), ``lowrank_vs_cpu`` (FITC, full-scale tapering and FSVA at
   n = 2 000 against the float64 CPU run within 1e-9), ``fsa_gp``
   (full-scale tapering at n = 10 000, taper range 0.1: NLL, L-BFGS fit,
   prediction), ``fsva_laplace`` (``bernoulli_logit``, iterative, n =
   100 000: a value-and-gradient with its breakdown, the fit cut to
   LR_NG_MAXIT, prediction), ``lowrank_clustered`` (FITC and FSVA with 100
   clusters of 1 000 points, 50 inducing points each, batched: fit and
   prediction, unseen clusters at the prior exactly), ``fsva_boosting``
   (LR_FSVA_ROUNDS rounds) and ``fitc_lagaboost`` (30 rounds; the
   histogram kernel held against its plain version on their Datasets),
   second runs of the FSVA
   fit and of both trainings that must give the same bits
   (``determinism_lowrank``) and a profiler trace of the FSVA
   value-and-gradient with no scatter (``lowrank_ops_trace``);
11. drives the iterative methods (``matrix_inversion_method="iterative"``)
   at full width: ``grouped_iterative`` (the LMM of 8 — the public NLL, the
   iterative one, a value-and-gradient with its CG and Lanczos counts, the
   L-BFGS fit within IT_GR_RTOL / IT_GR_ATOL of 8's Cholesky fit,
   prediction with simulated variances, ``get_num_cg_steps``; the GLMM fit
   within IT_GLMM_RTOL / IT_GLMM_ATOL of 8's, prediction, a second fit to
   the same bits), ``vecchia_laplace_lowrank`` (7's non-Gaussian GP with
   ``cg_preconditioner_type="pivoted_cholesky"``: NLL, a value-and-gradient
   within IT_PRECOND_RTOL of the Jacobi one, the fit cut to
   IT_LOWRANK_MAXIT, CG-step counts at ranks IT_RANKS beside the Jacobi
   one), ``fsa_iterative``
   (full-scale tapering by CG at n = 100 000, taper range FSA_IT_TAPER:
   construct, NLL, a value-and-gradient with its breakdown, the fit cut to
   FSA_IT_MAXIT, prediction; at n = FSA_N the NLL and the fit's exact NLL
   against the Cholesky route), ``grouped_poisson_lagaboost``
   (fault C3: ``objective="poisson"`` with a Poisson grouped GLMM,
   IT_POISSON_ROUNDS rounds), ``iterative_keyword_cholesky`` (fault C4: the
   exact and the Gaussian Vecchia GP with the keyword give the Cholesky
   NLLs' bits) and a profiler trace of the iterative value-and-gradients
   with no scatter (``iterative_ops_trace``);
12. drives the rest of the Vecchia GP (phase 11): ``vecchia_clustered``
   (VR_CLUSTERS clusters of VR_CLUSTER_SIZE, float32: construct, NLL,
   L-BFGS fit, prediction with unseen clusters at the prior; both Vecchia
   kernels launched, held against their plain versions on the path's
   cluster-padded neighbour matrices and timed there; a second fit to the
   same bits; card vs CPU at VR_CPU_CLUSTERS clusters), ``vecchia_pred_types``
   (the five ``vecchia_pred_type`` values in float64 at the main path's
   fitted parameters, each against cond_obs_only and, at PT_CPU_N points,
   against the exact posterior and the CPU), ``vecchia_svc`` (one GP random
   coefficient, float32, the plain build), ``vecchia_combined`` (CB_LEVELS
   grouped levels beside the GP: Cholesky and iterative fits within the
   grouped gate, prediction with unseen levels, CB_ROUNDS GPBoost rounds
   twice to the same bits; no scatter in its traced value-and-gradients
   nor the coefficient model's, ``vecchia_rest_ops_trace``),
   ``vecchia_laplace_cluster_svc`` (``bernoulli_logit``, iterative, with
   clusters and with a coefficient: fits cut to LCS_MAXIT, prediction by
   Newton-CG and CG) and ``heteroscedastic_latent`` (the two-set model and
   ``gp_approx="vecchia_latent"`` at HET_N points, card vs CPU);
13. before the second runs of 6 and 9, so that those pairs span it, drives
   the rest of the covariance families and the likelihood tail (phase 12,
   ``cov_likelihood_tail_paths``): ``space_time_vecchia``
   (``matern_space_time`` under Vecchia with the time orderings at
   ST_TIMES x ST_LOCS = 1e5 points, float32: fit, forecasting at the next
   ST_PRED_TIMES times, ST_ROUNDS GPBoost rounds twice to the same bits,
   card vs CPU at ST_CPU_N), ``matern_shape_vecchia`` (nu = 1 and the
   estimated shape on the GP data, float64, fits cut to MS_MAXIT, peak
   memory), ``tapering_exact`` (``gp_approx="tapering"`` and the wendland
   covariance at n = EX_N), ``cov_tail_exact`` (powered exponential,
   linear, hurst, Gneiting, ARD estimated shape at n = CT_N, fits cut to
   CT_MAXIT) and ``censored_glmm`` (both censored families at CENS_N rows,
   fits cut to CENS_MAXIT, one ``set_likelihood`` switch, a binomial with
   trial counts as weights, a weighted LMM at the LMM recipe's width), each
   card vs CPU within 1e-9; then, before those second runs too, validation,
   the objectives without a GP and ``cv`` (phase 13,
   ``boosting_tail_paths``): ``gpboost_validation`` (the boosting recipe
   with a validation set of the 10 000 prediction points, the float32 GP's
   prediction in its score every round, three metrics, bagging, feature
   fraction and early stopping; the histogram kernel held against its plain
   version under the round's bag; trained twice to the same bits; card vs
   CPU at VAL_CPU_N points within 1e-9), ``objectives_tail`` (the fourteen
   objectives without a GP, OBJ_ROUNDS rounds at the full n with a
   validation set; float32 vs ``gpu_use_dp`` within CMP_SCORE_TOL; card vs
   CPU at OBJ_CPU_N rows within 1e-9 up to the first exact tie of split
   gains, which the card's fixed-point sums and the CPU's sequential ones
   break apart) and ``cv_grouped`` (``cv`` with GB_LEVELS grouped levels,
   CV_NFOLD folds, early stopping and ``fit_GP_cov_pars_OOS``; the README's
   ``grid_search_tune_parameters`` on the card and the CPU, the same best
   parameters, README_ROUNDS rounds); then, before those second runs too,
   the tree learner's tail and its data (phase 14, ``tree_tail_paths``):
   ``categorical_gpboost`` (the recipe with a 30-level and a 400-level
   Zipf categorical column, 10 % NaN in X1, the float32 GP, TT_ROUNDS
   rounds; prediction with 5 % unseen levels; the histogram kernel on its
   Dataset; twice to the same bits; card vs CPU at TT_CPU_N points),
   ``efb_onehot`` (the recipe's features and a one-hot 60-level factor:
   EFB's bundles, the kernel on the bundle panel, the training against the
   one without bundling, one histogram call's device time with and
   without), ``tree_options`` (one training a grower option: the monotone
   methods and penalty, interaction constraints, forced splits and bins,
   extra trees, path smoothing, ``max_delta_step``, ``feature_contri``, the
   three CEGB penalties, linear leaves, ``max_bin_by_feature`` and the
   missing-value switches; each option's gate, card vs CPU at TT_CPU_N
   rows, two trainings to the same bits for CEGB (lazy) and linear leaves)
   and ``sparse_and_files`` (sparse input, ``save_binary``, a model with
   categorical and linear trees saved and reloaded); then, before those
   second runs too, the rest of the boosting tail (phase 15,
   ``boosting_tail_2_paths``): ``boosting_types_gp`` (GPBoost with the
   float32 GP as DART, GOSS past its first sampled round, a random forest
   and with Nesterov acceleration; prediction with the GP; DART and GOSS
   twice to the same bits; the histogram kernel against its plain version
   on a sampled GOSS round's amplified gradients), ``leaf_updates_gp`` (the
   Newton leaf re-solve and the line search, one ``vecchia_factors`` launch
   a round each), ``gp_card_vs_cpu`` (those six trainings at BT_CPU_N rows,
   float64, on the card and on the CPU), ``ranking``
   (``lambdarank`` and ``rank_xendcg`` on 1 000 queries of skewed lengths,
   1e5 rows, labels mostly 0, ndcg@1,3,5 and map@5 on 200 validation
   queries, LambdaRank twice to the same bits, its padded pairs) and
   ``model_io`` (the text format, the C export compiled by the host's
   compiler, SHAP, ``pred_leaf``, the prediction early stop,
   ``rollback_one_iter`` and ``refit``); then, before those second runs
   too, the device-resident GPBoost loop (phase 16,
   ``device_loop_paths``): ``fixed_grower`` (the fixed-shape grower on the
   boosting path's Dataset with the round-1 gradients: the same bits as the
   host grower, its CUDA-graph replay the same bits as its eager run, no
   host read inside a tree, ms a tree of each), ``device_loop``
   (``train(..., device_resident_boosting="true")`` for ``--rounds``
   rounds, cold and warm, the same bits twice and as a stepwise
   orchestration of its primitives, host reads = the refits' evaluations
   and one fetch, the trees and scores within DL_HOST_RTOL of phase 4's
   host loop's), ``device_lagaboost`` (its LaGaBoost branch on the
   non-Gaussian path's Dataset, DL_NG_ROUNDS rounds, refits at
   DL_NG_MAXIT) and ``device_loop_trace`` (one ``utils.profiler.trace``
   session over a histogram call, a host-grower tree, a graph replay, a
   host-loop round and a device-loop round: the device's idle share in
   each, the CUDA memory snapshot's size, and ``num_leaves`` launches of
   the histogram kernel's device-scales instance in each of the last
   three, as the grower's replay count says); then, before those second
   runs too, the fixed-shape grower's options (phase 17,
   ``grower_options_paths``): on phase 14's categorical recipe at n, with
   the GPBoost recipe's round-1 gradients, categorical splits, the three
   monotone methods with the penalty, interaction constraints, forced
   splits, forced splits with a monotone constraint, and categorical +
   interaction + forced (``grower_options``: the replay the same bits as
   the eager run and the host grower, no host read inside a tree under
   CUDA's sync debug mode "error", histogram launches num_leaves + one a
   forced split and group-scan launches 2 num_leaves - 1 a categorical
   tree, replay and host-grower ms), the group-scan kernel against its
   plain version on the categorical Dataset's root scan (``cat_group_scan``,
   float32 and float64), and ``train(..., device_resident_boosting=
   "true")`` for GO_ROUNDS rounds with a categorical feature, a monotone
   constraint and a forced split beside the float32 Vecchia GP, the same
   trees and scores to the bit as the host loop's
   (``grower_options_loop``);
14. checks by the kernels' launch counters (set to 0 before each path, read
   after it) that each path went through its kernels — the histogram kernel
   once a leaf on the LaGaBoost path and on the grouped GPBoost path, the
   Vecchia kernels never on the non-Gaussian path (the latent factors have
   no nugget, outside the kernel gate), no kernel on the grouped LMM and
   GLMM and the exact GP (their work is ``torch.linalg`` and gathers, as in
   the JAX package), the histogram kernel once a leaf on the three boosting
   paths of 9, the two of 10, the Poisson LaGaBoost of 11 and the GPBoost
   rounds of 12 and 13, both Vecchia kernels on 12's clustered path, no
   kernel on the low-rank GPs, the iterative routes, 12's other paths and
   13's GPs, all three on phase 13's validation path and the histogram
   kernel once a leaf (``num_models`` trees a round) on its objectives and
   folds, all three on phase 14's categorical GPBoost path and the
   histogram kernel once a leaf on its other paths (once more a forced
   split), all three on phase 15's GP paths and the histogram kernel once a
   leaf on its ranking and binary trainings, all four (the group scan
   too) on phase 14's categorical GPBoost path and on phase 17's
   device-loop training — and the results against float64 plain versions.

One JSON object per line; any failed check raises (exit code non-zero). The
second to last line lists the kernels with their measurements, the last line
is ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, NVIDIA H100 SXM data sheet
H100_F32_FLOPS = 67e12         # float32 outside the tensor cores
REPLACES = {
    "vecchia_factors":
        "gpboost_tpu/ops/kernels/vecchia_factors.py:309",
    "vecchia_nll_grad":
        "gpboost_tpu/ops/kernels/vecchia_factors.py:235",
    "histogram":
        "gpboost_tpu/ops/kernels/histogram.py:81",
    # no Pallas kernel: the categorical scan's jax.lax.scan
    "cat_group_scan": "gpboost_tpu/boosting/tree.py:328",
}
SOURCE = {
    "vecchia_factors": "gpboost_tpu_torch/csrc/vecchia_factors.cu",
    "vecchia_nll_grad": "gpboost_tpu_torch/csrc/vecchia_factors.cu",
    "histogram": "gpboost_tpu_torch/csrc/histogram.cu",
    "cat_group_scan": "gpboost_tpu_torch/csrc/cat_group_scan.cu",
}
# the kernels of a GPBoost path with a Gaussian Vecchia GP
GP_BOOST_KERNELS = ("vecchia_factors", "vecchia_nll_grad", "histogram")
# the earlier paths check the host loop's own counters (a refit a round,
# the grower's reads): they keep it; phase 16 runs the device-resident loop
# that "auto" engages on the card (boosting/device_loop.py)
BOOST_PARAMS = {"objective": "regression", "num_leaves": 31,
                "learning_rate": 0.1, "min_data_in_leaf": 20, "verbose": -1,
                "device_resident_boosting": "false"}
# what the kernel path and the float64 plain path may differ by after
# CMP_ROUNDS rounds (float32 vs float64 sums, splits that flip on near ties)
CMP_ROUNDS = 5
CMP_SCORE_TOL = 5e-2      # RMS score difference / std of the score
CMP_COV_PARS_RTOL = 5e-2
HIST_SUM_TOL = 1e-5       # x (sum of |v| over the bin)
SHAPES = (0.5, 1.5, 2.5, -1.0)
NLL_OTHER_M = (40, 64)    # the NLL kernel's other shapes: 16 and 8 rows a block
# the non-Gaussian path (the reference package's benchmark, bench.py:323-385):
# a bernoulli_logit Vecchia GP, iterative Laplace, at the full width of the
# bench (n = 1e5, m = 20, 200 probes, 100 Lanczos steps); only the depth is
# cut: the fit's L-BFGS iterations (bench: maxit 50), the LaGaBoost rounds
# (bench: 30), each LaGaBoost refit's iterations (bench: the default 1000)
# and the predictions' simulated draws (NG_NSIM)
NG_COV_PARS = [1.0, 0.1]
NG_MAXIT = 2
NG_ROUNDS = 2                     # 3 until phase 15 took the script
#                                   past its 1 200 s
NG_REFIT_MAXIT = 1
# simulated draws of the non-Gaussian predictions' variances (the package
# default 1 000; the one depth cut of an earlier path that phase 12 forced:
# it saves ~49 s of the script's 1 200 s, PERF.md section 4)
NG_NSIM = 250
NG_PARAMS = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.1,
             "min_data_in_leaf": 20, "verbose": -1,
             "device_resident_boosting": "false"}
# float32 vs float64 on the card at n = 1e4, same structure, same probes;
# the H100 reads about 1e-5 (NLL) and 3e-6 (gradient), a float32 gradient
# off by a lost term or a bad adjoint solve reads percents
NG_PRECISION_N = 10_000
NG_NLL_RTOL = 1e-4
NG_GRAD_RTOL = 1e-3
# a Bernoulli response variance is at most 1/4; in float32 the 30-node
# quadrature's sums may round it up by at most ~30 units in the last place
VAR_TOP = 0.25 * (1.0 + 30 * 2.0 ** -24)
# grouped random effects (path A: the Gaussian LMM at n = 1e6, two crossed
# intercepts of 1 000 and 10 000 levels, the second Zipf-skewed, a slope on
# the first, q = 12 000; path C: bernoulli_logit on that design without the
# slope; path B: GPBoost with 1 000 levels at the boosting path's size)
GR_N = 1_000_000
GR_LEVELS = (1000, 10000)
GR_ZIPF = 1.1
GR_TRUTH = [1.0, 0.5, 0.3, 0.2]   # error, intercept 1, intercept 2, slope 1
GR_BETA = [1.0, 0.5, -0.3]
GR_UNSEEN = 0.1                   # share of prediction rows at unseen levels
GR_TRUTH_RTOL = 0.15              # fitted cov_pars vs the simulation's truth
GR_CPU_N = 20_000                 # rows of the card-vs-CPU check
GR_CPU_RTOL = 1e-9
GB_LEVELS = 1000
# names of operations that add with colliding indices (float atomics)
SCATTERS = ("index_add", "scatter_add", "index_put", "scatter_reduce",
            "indexFunc", "put_")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def clock():
    torch.cuda.synchronize()
    return time.perf_counter()


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Device time of ``fn`` per call with the host out of the way: ``reps``
    calls captured into one CUDA graph, one replay timed (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_data(seed, n, n_pred):
    """The data recipe of the reference package's benchmark: uniform
    coordinates on the unit square, a smooth signal plus noise."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float64)
    y = (np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
         + 0.5 * rng.standard_normal(n))
    pred = rng.uniform(size=(n_pred, 2)).astype(np.float64)
    return coords, y, pred


def make_ng_data(seed, n, n_pred):
    """The non-Gaussian recipe of the reference package's benchmark
    (bench.py:325-361, the same draws for seed 0): coordinates and a binary
    response from f = sin(6 x1) + cos(4 x2), then 5 features, a fixed effect
    and a second binary response from the same generator; prediction
    coordinates and features."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float64)
    f_lat = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    yb = rng.binomial(1, 1.0 / (1.0 + np.exp(-f_lat))).astype(np.float64)
    rng_x = np.random.default_rng(seed + 1)
    Xn = rng_x.uniform(size=(n, 5))
    Fb = 2.0 * np.sin(5 * Xn[:, 0]) + Xn[:, 1] ** 2 + Xn[:, 2]
    Fb = Fb - Fb.mean()
    ybb = rng.binomial(1, 1.0 / (1.0 + np.exp(-(Fb + f_lat)))).astype(
        np.float64)
    pred = np.random.default_rng(seed + 2).uniform(size=(n_pred, 2))
    X_pred = np.random.default_rng(seed + 3).uniform(size=(n_pred, 5))
    return dict(coords=coords, yb=yb, Xn=Xn, ybb=ybb, pred=pred,
                X_pred=X_pred)


def make_boost_data(seed, y, n_pred):
    """The boosting recipe of the reference package's benchmark: 5 uniform
    features, a non-linear fixed effect added to the GP data's response."""
    rng = np.random.default_rng(seed + 1)
    n = len(y)
    X = rng.uniform(size=(n, 5))
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    return X, f + y, rng.uniform(size=(n_pred, 5))


def reset_counts():
    from gpboost_tpu_torch.boosting.tree import grow_tree
    from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    vk.reset_launch_counts()
    hk.histogram.launches = 0
    gk.group_boundaries.launches = 0
    grow_tree.host_reads = 0


def read_counts():
    """The kernels' launch counts since :func:`reset_counts` (the group
    scan's, ``cat_group_scan``, is 0 off the paths with categorical
    features)."""
    from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    return dict(vk.launch_counts(), histogram=hk.histogram.launches,
                cat_group_scan=gk.group_boundaries.launches)


# what a path that runs no kernel reads back
NO_LAUNCHES = {"vecchia_factors": 0, "vecchia_nll_grad": 0, "histogram": 0,
               "cat_group_scan": 0}


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def _row_flops(valid, d, n_ranges, with_grad):
    """FLOPs the per-row algorithm needs for rows with ``valid`` neighbours
    (tensor of counts): covariance entries (3 d for the scaled distance,
    8 for sqrt + exp + polynomial + scale), Cholesky v^3/3, two triangular
    solves 2 v^2, D 2 v; with the gradient a second solve pair, the
    residual dot and a second pass over the entries with 4 bilinear forms
    per parameter."""
    v = valid.double()
    entries = v * (v + 1) / 2 + v
    flops = entries * (3 * d + 8) + v ** 3 / 3 + 2 * v ** 2 + 2 * v
    if with_grad:
        flops = flops + 2 * v ** 2 + 2 * v \
            + entries * (3 * d + 10 + 8 * (1 + n_ranges))
    return float(flops.sum())


def bound(name, neighbors, d, n_obs, shared_rows, n_ranges):
    """(bound_ms, bound_by) from this run's inputs: bytes moved once over
    the memory rate vs. operations over the float32 peak."""
    n, m = neighbors.shape
    valid = (neighbors >= 0).sum(1)
    rows = 0 if shared_rows else n * d
    if name == "vecchia_factors":
        nbytes = 4 * ((2 + d) + n_obs * d + n * m + rows + n * m + n)
        flops = _row_flops(valid, d, n_ranges, False)
    else:
        from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
        grid = vk.nll_blocks(n, vk._lib().vf_nll_rows_per_block(m, d))
        nbytes = 4 * ((2 + n_ranges) + n_obs * d + n * m + rows + n_obs
                      + grid * (3 + n_ranges))
        flops = _row_flops(valid, d, n_ranges, True)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version, on the card
# ---------------------------------------------------------------------------

def check_kernels(coords, y, pred, m, seed, dev):
    from gpboost_tpu_torch.ops import vecchia as vops
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

    n, d = coords.shape
    perm = vops.apply_ordering(n, "random", seed)
    c32 = torch.as_tensor(coords[perm], dtype=torch.float32, device=dev)
    r32 = torch.as_tensor(y[perm], dtype=torch.float32, device=dev)
    nb = vops.find_neighbors(c32, m)
    obs32 = torch.as_tensor(coords, dtype=torch.float32, device=dev)
    pred32 = torch.as_tensor(pred, dtype=torch.float32, device=dev)
    nb_pred = vops.find_neighbors_cross(pred32, obs32, 2 * m)
    check(bool((nb[:m] < 0).any()), "the first rows must carry -1 padding")

    def pars(ard, dtype):
        ranges = [0.1, 0.15] if ard else [0.1]
        return torch.tensor([0.25, 1.0] + ranges, dtype=dtype, device=dev)

    cases = {"vecchia_factors": [], "vecchia_nll_grad": []}
    for shape in SHAPES:
        for ard in (False, True):
            cp = pars(ard, torch.float32)
            # factors: training shape and prediction shape (row_coords)
            for tag, tab, nbrs, rows in (("train", c32, nb, None),
                                         ("predict", obs32, nb_pred, pred32)):
                a_k, d_k = vk.vecchia_factors(cp[1:], tab, nbrs, cp[0], True,
                                              shape, ard=ard, row_coords=rows)
                torch.cuda.synchronize()
                a_k2, d_k2 = vk.vecchia_factors(cp[1:], tab, nbrs, cp[0], True,
                                                shape, ard=ard,
                                                row_coords=rows)
                check(torch.equal(a_k, a_k2) and torch.equal(d_k, d_k2),
                      f"vecchia_factors[{tag}] shape={shape} ard={ard}: two "
                      "launches differ bit-wise")
                a_p, d_p = vk.vecchia_factors_plain(
                    cp[1:], tab, nbrs, cp[0], True, shape, ard=ard,
                    row_coords=rows)
                err = max(float((a_k - a_p).abs().max()),
                          float((d_k - d_p).abs().max()))
                check(math.isfinite(err) and err <= 2e-5,
                      f"vecchia_factors[{tag}] shape={shape} ard={ard}: "
                      f"max abs err {err} > 2e-5 vs the float32 plain version")
                cases["vecchia_factors"].append(
                    dict(case=tag, shape=shape, ard=ard, max_abs_err=err))
            # NLL + gradient
            cases["vecchia_nll_grad"].append(check_nll_grad(
                torch.log(cp), c32, nb, r32, shape, ard))
    torch.cuda.empty_cache()

    # timings at the main path's shapes: exponential, isotropic
    cp = pars(False, torch.float32)
    lp = torch.log(cp)
    timed = {}
    for tag, tab, nbrs, rows in (("train", c32, nb, None),
                                 ("predict", obs32, nb_pred, pred32)):
        ms = time_ms(lambda: vk.vecchia_factors(
            cp[1:], tab, nbrs, cp[0], True, 0.5, row_coords=rows), 20)
        plain = time_ms(lambda: vk.vecchia_factors_plain(
            cp[1:], tab, nbrs, cp[0], True, 0.5, row_coords=rows), 5)
        b_ms, b_by = bound("vecchia_factors", nbrs, d, tab.shape[0],
                           rows is None, 1)
        r_blk, smem = vk.factors_launch_geometry(int(nbrs.shape[1]), d)
        timed[tag] = dict(case=tag, n=int(nbrs.shape[0]),
                          m=int(nbrs.shape[1]), ms=ms, plain_ms=plain,
                          padded_row_share=float(
                              (nbrs < 0).any(1).double().mean()),
                          bound_ms=b_ms, bound_by=b_by, rows_per_block=r_blk,
                          smem_bytes_per_block=smem)
    ms = time_ms(lambda: vk.vecchia_nll_grad(lp, c32, nb, r32, 0.5), 20)
    plain = time_ms(lambda: vk.vecchia_nll_grad_plain(lp, c32, nb, r32, 0.5),
                    5)
    b_ms, b_by = bound("vecchia_nll_grad", nb, d, n, True, 1)
    timed["nll_grad"] = dict(n=n, m=m, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by, other_shapes=[],
                             padded_row_share=float(
                                 (nb < 0).any(1).double().mean()))
    # the NLL kernel's other rows-per-block choices, on the same points:
    # checked against float64 (in row shards, to bound the plain version's
    # memory) and timed
    for m_o in NLL_OTHER_M:
        nb_o = vops.find_neighbors(c32, m_o)
        case = check_nll_grad(lp, c32, nb_o, r32, 0.5, False, shards=4)
        cases["vecchia_nll_grad"].append(dict(case, m=m_o))
        rows, smem = vk.nll_launch_geometry(m_o, d)
        b_ms, b_by = bound("vecchia_nll_grad", nb_o, d, n, True, 1)
        timed["nll_grad"]["other_shapes"].append(dict(
            n=n, m=m_o, rows_per_block=rows, smem_bytes_per_block=smem,
            ms=time_ms(lambda: vk.vecchia_nll_grad(lp, c32, nb_o, r32, 0.5),
                       20),
            bound_ms=b_ms, bound_by=b_by))
        del nb_o
        torch.cuda.empty_cache()
    emit({"phase": "kernels_vs_plain", "cases": cases})
    return cases, timed


def check_nll_grad(lp, coords, nb, r, shape, ard, shards=1):
    """The NLL kernel against autograd of the plain version in float32 and
    float64 (the plain versions summed over ``shards`` row shards): NLL
    within 1e-4 relative of float64, gradient within 2e-2 x n / 1500
    absolute plus 2e-3 (float32) / 1e-3 (float64) relative; two launches
    bit-identical."""
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

    n, m = nb.shape
    v_k, g_k = vk.vecchia_nll_grad(lp, coords, nb, r, shape, ard=ard)
    torch.cuda.synchronize()
    v_k2, g_k2 = vk.vecchia_nll_grad(lp, coords, nb, r, shape, ard=ard)
    check(torch.equal(v_k, v_k2) and torch.equal(g_k, g_k2),
          f"vecchia_nll_grad m={m}: two runs differ bit-wise")

    def plain(dtype):
        lp_t, c_t, r_t = lp.to(dtype), coords.to(dtype), r.to(dtype)
        v, g = 0.5 * n * math.log(2.0 * math.pi), 0.0
        for rows in torch.arange(n, device=nb.device).chunk(shards):
            vs, gs = vk.vecchia_nll_grad_plain(
                lp_t, c_t, nb[rows], r_t, shape, ard=ard, row_r=r_t[rows],
                row_coords=c_t[rows], include_const=False)
            v, g = v + vs, g + gs
        return v, g

    _, g32 = plain(torch.float32)
    v64, g64 = plain(torch.float64)
    tag = f"vecchia_nll_grad m={m} shape={shape} ard={ard}"
    rel = abs(float(v_k) - float(v64)) / abs(float(v64))
    check(rel < 1e-4, f"{tag}: relative NLL error {rel} vs float64 >= 1e-4")
    atol = 2e-2 * (n / 1500)
    e32 = (g_k - g32).abs()
    e64 = (g_k.double() - g64).abs()
    check(bool((e32 <= atol + 2e-3 * g32.abs()).all()),
          f"{tag}: gradient {g_k.tolist()} vs float32 autograd "
          f"{g32.tolist()}")
    check(bool((e64 <= atol + 1e-3 * g64.abs()).all()),
          f"{tag}: gradient {g_k.tolist()} vs float64 autograd "
          f"{g64.tolist()}")
    return dict(shape=shape, ard=ard, nll_rel_err_vs_f64=rel,
                grad_max_abs_err_vs_f64=float(e64.max()),
                grad_max_rel_err_vs_f64=float((e64 / g64.abs()).max()),
                max_abs_err=float(e64.max()))


def ptxas_report(log, kernel):
    """Registers, stack frame and spills of every instance of ``kernel``, as
    ``nvcc -Xptxas -v`` printed them into the build log."""
    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.rsplit(" ", 1)[-1]
            continue
        if name is None or kernel not in name:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        smem = re.search(r"(\d+) bytes smem", line)
        if frame:
            cap = re.search(r"IL[ib](\d+)E", name)
            out.append(dict(instance=f"{kernel}<{cap.group(1)}>" if cap
                            else kernel,
                            stack_frame_bytes=int(frame.group(1)),
                            spill_store_bytes=int(frame.group(2)),
                            spill_load_bytes=int(frame.group(3))))
        elif regs and out:
            out[-1]["registers"] = int(regs.group(1))
            if smem:
                out[-1]["static_smem_bytes"] = int(smem.group(1))
            name = None
    return out


def hist_bound(n, n_masked, F, B):
    """(bound_ms, bound_by): what this run's data needs — the mask read
    once, grad, hess and the F bin bytes of the rows inside it, the three
    histograms written once — vs. the additions of those rows."""
    nbytes = n + n_masked * (4 + 4 + F) + F * B * 12
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 3.0 * n_masked * F / H100_F32_FLOPS * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations"))


def _hist_values(gen, n, dev):
    g = torch.randn(n, generator=gen, device=dev)
    h = torch.rand(n, generator=gen, device=dev) + 0.5
    return g, h


def _hist_compare(tag, binned, panel, g, h, mask, B):
    """One launch of each entry (scales by value, scales from device
    memory; the same bits) against the float64 plain version: counts exact,
    sums within HIST_SUM_TOL x the sum of |v| over the bin."""
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    got = hk.histogram(binned, g, h, mask, B, binned_t=panel,
                       scales=hk.fixed_point_scales(g, h))
    # the entry that reads the scales from device memory: the same bits
    got_dev = hk.histogram(binned, g, h, mask, B, binned_t=panel,
                           scales=hk.fixed_point_scales_device(g, h))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, got_dev)),
          f"histogram[{tag}]: the device-scales entry differs from the "
          "by-value one")
    want = hk.histogram_plain(binned, g.double(), h.double(), mask, B)
    scale = hk.histogram_plain(binned, g.double().abs(),
                               h.double().abs(), mask, B)
    check(torch.equal(got[2].double(), want[2]),
          f"histogram[{tag}]: counts differ from the plain version "
          "(they must be exact)")
    errs = []
    for k, what in ((0, "gradient"), (1, "hessian")):
        err = (got[k].double() - want[k]).abs()
        check(bool((err <= HIST_SUM_TOL * scale[k] + 1e-30).all()),
              f"histogram[{tag}]: {what} sums off by up to "
              f"{float(err.max())}, more than {HIST_SUM_TOL} x the sum "
              "of |v| over the bin, vs the float64 plain version")
        errs.append(float(err.max()))
    n, F = binned.shape
    return dict(case=tag, n=n, F=F, B=B, rows_in_mask=int(mask.sum()),
                max_abs_err=max(errs), device_scales_same_bits=True)


def check_histogram_on(ds, seed, dev, path):
    """The histogram kernel against its float64 plain version on a boosting
    path's own Dataset (:func:`check_histogram_on_panel` on its panel)."""
    return check_histogram_on_panel(ds.binned, ds.binned_t, ds.max_num_bins,
                                    seed, dev, path)


def check_histogram_on_panel(binned, panel, B, seed, dev, path):
    """The histogram kernel against its float64 plain version on a path's
    own bins (``binned`` [n, F] and its uint8 panel), all rows and 3 % of
    them in the mask, and its time there (all rows) beside the plain
    version's and the bound."""
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    gen = torch.Generator(device=dev).manual_seed(seed)
    n, F = binned.shape
    g, h = _hist_values(gen, n, dev)
    full = torch.ones(n, dtype=torch.bool, device=dev)
    small = torch.rand(n, generator=gen, device=dev) < 0.03
    cases = [_hist_compare(f"{path}_full_mask", binned, panel, g, h, full, B),
             _hist_compare(f"{path}_3pct_mask", binned, panel, g, h, small,
                           B)]
    scales = hk.fixed_point_scales(g, h)

    def kernel():
        return hk.histogram(binned, g, h, full, B, binned_t=panel,
                            scales=scales)

    b_ms, b_by = hist_bound(n, n, F, B)
    timed = dict(case=f"{path}_full_mask", n=n, F=F, B=B, rows_in_mask=n,
                 ms=time_ms(kernel, 50), device_ms=graph_ms(kernel, 50),
                 plain_ms=time_ms(lambda: hk.histogram_plain(
                     binned, g, h, full, B), 5),
                 bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "histogram_vs_plain", "path": path, "tolerance":
          f"counts exact; sums within {HIST_SUM_TOL} x sum|v| of the bin",
          "cases": cases})
    return cases, timed


def check_histogram(ds, seed, dev):
    """The histogram kernel against its float64 plain version on the card:
    counts exact, gradient / hessian sums within HIST_SUM_TOL x the sum of
    |v| over the bin."""
    from gpboost_tpu_torch.ops.kernels import histogram as hk

    gen = torch.Generator(device=dev).manual_seed(seed)

    def random_bins(n, F, B):
        panel = torch.randint(0, B, (F, n), generator=gen,
                              device=dev).to(torch.uint8)
        return panel.t().contiguous().int(), panel

    n, F, B = ds.num_data, ds.num_features, ds.max_num_bins
    binned, panel = ds.binned, ds.binned_t
    g, h = _hist_values(gen, n, dev)
    full = torch.ones(n, dtype=torch.bool, device=dev)
    small = torch.rand(n, generator=gen, device=dev) < 0.03
    cases = [_hist_compare("full_mask", binned, panel, g, h, full, B),
             _hist_compare("3pct_mask", binned, panel, g, h, small, B),
             _hist_compare("empty_mask", binned, panel, g, h, ~full, B)]
    check(cases[2]["rows_in_mask"] == 0, "the empty mask is not empty")
    # worst contention: every row of the mask in one bin of one feature
    one_bin = binned[:, 2] == binned[0, 2]
    case = _hist_compare("one_bin_mask", binned, panel, g, h, one_bin, B)
    check(case["rows_in_mask"] >= n // (2 * B), "one-bin mask too small")
    cases.append(case)
    squeezed = panel.clone()
    squeezed[2] = 7
    cases.append(_hist_compare("one_bin_all_rows",
                               squeezed.t().contiguous().int(), squeezed, g,
                               h, full, B))
    b50, p50 = random_bins(n, 50, B)
    cases.append(_hist_compare("F50", b50, p50, g, h, full, B))
    b64, p64 = random_bins(n, F, 64)
    cases.append(_hist_compare("B64", b64, p64, g, h, full, 64))
    del b50, p50, b64, p64, squeezed
    n_big = 1_000_003
    bb, pb = random_bins(n_big, F, 256)
    gb, hb = _hist_values(gen, n_big, dev)
    mb = torch.rand(n_big, generator=gen, device=dev) < 0.9
    cases.append(_hist_compare("n1000003", bb, pb, gb, hb, mb, 256))
    del bb, pb, gb, hb, mb
    torch.cuda.empty_cache()

    # two launches on the same inputs, full and 3 % mask: the fixed-point
    # sums must be the same bits; and the float64 route (gpu_use_dp)
    scales = hk.fixed_point_scales(g, h)
    t0 = time.perf_counter()
    for _ in range(20):
        hk.fixed_point_scales(g, h)
    scales_ms = (time.perf_counter() - t0) / 20 * 1e3
    g64, h64 = g.double(), h.double()
    run_to_run, equal = 0.0, {}
    for tag, mask in (("full_mask", full), ("3pct_mask", small)):
        a = hk.histogram(binned, g, h, mask, B, binned_t=panel, scales=scales)
        b = hk.histogram(binned, g, h, mask, B, binned_t=panel, scales=scales)
        run_to_run = max(run_to_run, max(float((a[k] - b[k]).abs().max())
                                         for k in range(3)))
        equal[tag] = all(torch.equal(x, y) for x, y in zip(a, b))
        a64 = hk.histogram_plain(binned, g64, h64, mask, B)
        b64 = hk.histogram_plain(binned, g64, h64, mask, B)
        equal[tag + "_f64_plain"] = all(torch.equal(x, y)
                                        for x, y in zip(a64, b64))
    check(all(equal.values()) and run_to_run == 0.0,
          f"histogram: two launches on the same inputs differ "
          f"({equal}, max abs difference {run_to_run})")
    a = hk.histogram(binned, g, h, full, B, binned_t=panel, scales=scales)

    # times at the boosting path's shape
    def host_ms(fn, reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e3

    def kernel(mask):
        return lambda: hk.histogram(binned, g, h, mask, B, binned_t=panel,
                                    scales=scales)

    # the entry that reads its scales from device memory: the one the
    # fixed-shape grower launches, so the one of the main path's trees
    scales_dev = hk.fixed_point_scales_device(g, h)

    def kernel_dev(mask):
        return lambda: hk.histogram(binned, g, h, mask, B, binned_t=panel,
                                    scales=scales_dev)

    # the library yardstick: ONE index_add_ on a prepared flat index
    flat = (binned.long() + torch.arange(F, device=dev) * B).reshape(-1)
    src = torch.stack([g, h, torch.ones_like(g)])[:, :, None].expand(
        3, n, F).reshape(3, -1).contiguous()
    out = torch.zeros((3, F * B), device=dev)

    def library():
        out.zero_()
        out.index_add_(1, flat, src)

    library()
    lib_err = max(float((out.view(3, F, B)[k] - a[k]).abs().max())
                  for k in range(3))
    check(lib_err <= 1e-2, f"the index_add_ yardstick computes something "
          f"else (max abs difference {lib_err})")
    b_ms, b_by = hist_bound(n, n, F, B)
    timed = dict(
        n=n, F=F, B=B, ms=time_ms(kernel(full), 50),
        enqueue_ms=host_ms(kernel(full), 50),
        device_ms=graph_ms(kernel(full), 50),
        plain_ms=time_ms(lambda: hk.histogram_plain(binned, g, h, full, B),
                         5),
        plain_f64_ms=time_ms(lambda: hk.histogram_plain(binned, g64, h64,
                                                        full, B), 5),
        library_ms=time_ms(library, 20),
        dev_scales_ms=time_ms(kernel_dev(full), 50),
        dev_scales_device_ms=graph_ms(kernel_dev(full), 50),
        dev_scales_with_frexp_device_ms=graph_ms(lambda: hk.histogram(
            binned, g, h, full, B, binned_t=panel,
            scales=hk.fixed_point_scales_device(g, h)), 50),
        empty_launch_ms=time_ms(hk.empty_launch, 200),
        empty_launch_device_ms=graph_ms(hk.empty_launch, 200),
        bound_ms=b_ms, bound_by=b_by, run_to_run_max_abs_diff=run_to_run,
        run_to_run_bit_identical=equal, scales_host_ms=scales_ms,
        cluster_blocks=hk._lib().hist_cluster_blocks())
    sb_ms, sb_by = hist_bound(n, cases[1]["rows_in_mask"], F, B)
    timed["other_shapes"] = [dict(
        case="3pct_mask", n=n, F=F, B=B, rows_in_mask=cases[1]["rows_in_mask"],
        ms=time_ms(kernel(small), 50), device_ms=graph_ms(kernel(small), 50),
        plain_ms=time_ms(lambda: hk.histogram_plain(binned, g, h, small, B),
                         5),
        bound_ms=sb_ms, bound_by=sb_by)]
    emit({"phase": "histogram_vs_plain", "tolerance":
          f"counts exact; sums within {HIST_SUM_TOL} x sum|v| of the bin",
          "cases": cases, "run_to_run_max_abs_diff": run_to_run,
          "run_to_run_bit_identical": equal})
    return cases, timed, kernel(full)


# ---------------------------------------------------------------------------
# phase 3: the main path through the public API
# ---------------------------------------------------------------------------

def main_path(coords, y, pred, m, seed, dev):
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import vecchia as vops

    reset_counts()
    t0 = clock()
    model = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=m,
                        vecchia_ordering="random", seed=seed,
                        dtype=torch.float32, device=dev)
    t_construct = clock() - t0
    init = model._default_init_cov_pars(y)
    t0 = clock()
    nll_init = model.neg_log_likelihood(init, y)
    t_nll = clock() - t0
    t0 = clock()
    model.fit(y, params={"optimizer_cov": "lbfgs"})
    t_fit = clock() - t0
    t0 = clock()
    out = model.predict(gp_coords_pred=pred, predict_var=True)
    t_predict = clock() - t0
    launches = read_counts()

    res = model._fit_result
    cov_pars = model.get_cov_pars()
    nll_fit = model.get_current_neg_log_likelihood()
    check(math.isfinite(nll_init) and math.isfinite(nll_fit),
          f"NLL not finite: {nll_init}, {nll_fit}")
    check(nll_fit < nll_init, f"fit did not lower the NLL: {nll_init} -> "
          f"{nll_fit}")
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"cov_pars not positive: {cov_pars}")
    check(res.aux is not None and res.aux.shape == (len(y),)
          and bool(np.all(np.isfinite(res.aux))),
          "the fit's Psi^-1 r output is missing or not finite")
    check(launches["vecchia_nll_grad"] >= res.num_evals >= 2,
          f"launch counter {launches} vs {res.num_evals} evaluations")
    check(launches["vecchia_factors"] >= 2,
          f"vecchia_factors launched {launches['vecchia_factors']} times")

    # float64 plain versions on the same structure, outside the counted run
    vec = model._approx
    tab64 = vec.coords_perm.double()
    cp64 = torch.as_tensor(cov_pars, dtype=torch.float64, device=dev)
    y64 = torch.as_tensor(y, dtype=torch.float64, device=dev)
    a64, d64 = vops.build_factors(vec.cov_fn, cp64[1:], tab64, vec.neighbors,
                                  cp64[0], True)
    nll64 = float(vops.vecchia_nll(a64, d64, vec.neighbors,
                                   y64[vec._perm_t]))
    del a64, d64
    rel = abs(nll_fit - nll64) / abs(nll64)
    check(rel < 1e-4, f"reported NLL {nll_fit} vs float64 plain {nll64}")

    mu, var = out["mu"], out["var"]
    check(mu.shape == (len(pred),) and var.shape == (len(pred),),
          f"prediction shapes {mu.shape}, {var.shape}")
    check(bool(np.all(np.isfinite(mu)) and np.all(np.isfinite(var))),
          "predictions not finite")
    top = float(cov_pars[0] + cov_pars[1])
    check(bool(np.all(var > 0) and np.all(var <= top * (1 + 1e-5))),
          f"variances outside (0, var + nugget]: {var.min()}, {var.max()}")
    pred_t = torch.as_tensor(pred, dtype=torch.float32, device=dev)
    nb_pred = vec._pred_neighbors(cp64[1:].float(), pred_t)
    mu64, var64 = vops.predict_vecchia_response(
        vec.cov_fn, cp64[1:], cp64[0], vec.coords.double(), pred_t.double(),
        nb_pred, y64, True)
    err_mu = float(np.abs(mu - mu64.cpu().numpy()).max())
    err_var = float(np.abs(var - var64.cpu().numpy()).max())
    check(err_mu <= 1e-4 and err_var <= 1e-4,
          f"predict vs the float64 plain version: {err_mu}, {err_var}")

    emit({"phase": "main_path", "n": len(y), "m": m, "n_pred": len(pred),
          "nll_init": nll_init, "nll_fit": nll_fit, "nll_fit_f64_plain": nll64,
          "cov_pars": cov_pars.tolist(), "num_it": res.num_it,
          "num_evals": res.num_evals, "launches": launches,
          "predict_max_abs_err_mu": err_mu, "predict_max_abs_err_var": err_var})
    timings = {"construct_s": t_construct, "nll_ms": t_nll * 1e3,
               "fit_s": t_fit, "fit_iterations": res.num_it,
               "fit_evaluations": res.num_evals,
               "host_reads_per_fit": res.num_evals, "predict_s": t_predict}
    return launches, timings, model


# ---------------------------------------------------------------------------
# phase 4: the boosting path through the public API
# ---------------------------------------------------------------------------

def _gp_model(coords, m, seed, dtype, dev):
    import gpboost_tpu_torch as gpt
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=m,
                     vecchia_ordering="random", seed=seed, dtype=dtype,
                     device=dev)
    gp.set_optim_params({"optimizer_cov": "lbfgs",
                         "init_cov_pars": [0.25, 1.0, 0.1]})
    return gp


def _check_trees(bst, tag):
    p = BOOST_PARAMS
    for k, tree in enumerate(bst.trees):
        check(1 < tree.num_leaves <= p["num_leaves"],
              f"{tag}: tree {k} has {tree.num_leaves} leaves")
        used = np.flatnonzero(tree.is_leaf)
        check(bool(np.all(tree.node_count[used] >= p["min_data_in_leaf"])),
              f"{tag}: tree {k} has a leaf with fewer than "
              f"{p['min_data_in_leaf']} rows: {tree.node_count[used].min()}")
        check(bool(np.all(np.isfinite(tree.leaf_value))),
              f"{tag}: tree {k} has a leaf value that is not finite")


def boosting_path(ds_args, coords, pred, m, seed, rounds, dev):
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    from gpboost_tpu_torch.utils import timer

    X, yb, X_pred = ds_args
    n = len(yb)

    # ---- the GPBoost algorithm: trees and a GP in one training loop ----
    reset_counts()
    t0 = clock()
    ds = gpt.Dataset(X, label=yb, device=dev)
    t_dataset = clock() - t0
    gp = _gp_model(coords, m, seed, torch.float32, dev)
    t0 = clock()
    bst = gpt.train(BOOST_PARAMS, ds, gp_model=gp, num_boost_round=rounds)
    t_train = clock() - t0
    t0 = clock()
    out = bst.predict(X_pred, gp_coords_pred=pred, predict_var=True)
    t_predict = clock() - t0
    launches = read_counts()
    reads = grow_tree.host_reads

    fits = bst.objective.fits
    evals = sum(f["num_evals"] for f in fits)
    leaves = sum(t.num_leaves for t in bst.trees)
    check(bst.num_trees() == rounds, f"{bst.num_trees()} trees, {rounds} "
          "rounds")
    _check_trees(bst, "gpboost")
    want_launches, want_reads = grower_counts(bst.trees,
                                              BOOST_PARAMS["num_leaves"])
    check(launches["histogram"] == want_launches,
          f"histogram launched {launches['histogram']} times for {leaves} "
          f"leaves, {want_launches} expected (the root and one child a "
          "split; the fixed-shape grower's steps that do not split too)")
    check(reads == want_reads,
          f"{reads} grower host reads in {rounds} trees, {want_reads} "
          "expected (the fixed-shape grower's one fetch a tree; the host "
          "grower's read a leaf and its scales' a tree)")
    check(len(fits) == rounds + 1,
          f"{len(fits)} covariance refits in {rounds} rounds (expected one "
          "before the first tree and one after each round: the gradient "
          "cache must serve the next round)")
    check(launches["vecchia_nll_grad"] >= evals >= len(fits),
          f"vecchia_nll_grad launched {launches['vecchia_nll_grad']} times, "
          f"the fits made {evals} evaluations")
    check(launches["vecchia_factors"] >= len(fits) + 1,
          f"vecchia_factors launched {launches['vecchia_factors']} times "
          f"for {len(fits)} Psi^-1 r solves and the prediction")
    nlls = [f["nll"] for f in fits]
    check(all(math.isfinite(v) for v in nlls), f"NLL not finite: {nlls}")
    check(nlls[-1] < nlls[1], f"the Vecchia NLL did not fall from round 1 "
          f"({nlls[1]}) to round {rounds} ({nlls[-1]})")
    cov_pars = gp.get_cov_pars()
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"cov_pars not positive: {cov_pars}")
    mu, var = out["response_mean"], out["response_var"]
    check(mu.shape == (len(pred),) and var.shape == (len(pred),),
          f"prediction shapes {mu.shape}, {var.shape}")
    check(bool(np.all(np.isfinite(mu)) and np.all(np.isfinite(var))),
          "boosting predictions not finite")
    top = float(cov_pars[0] + cov_pars[1])
    check(bool(np.all(var > 0) and np.all(var <= top * (1 + 1e-5))),
          f"variances outside (0, nugget + variance]: {var.min()}, "
          f"{var.max()}, {top}")
    mse_gp = float(np.mean((yb - bst._score) ** 2))

    # ---- the same trees without a GP (L2 boosting) ----
    reset_counts()
    t0 = clock()
    bst0 = gpt.train(BOOST_PARAMS, ds, num_boost_round=rounds)
    t_train0 = clock() - t0
    launches0 = read_counts()
    leaves0 = sum(t.num_leaves for t in bst0.trees)
    _check_trees(bst0, "l2")
    check(launches0["histogram"] == grower_counts(
        bst0.trees, BOOST_PARAMS["num_leaves"])[0],
          f"l2: histogram launched {launches0['histogram']} times for "
          f"{leaves0} leaves")
    check(launches0["vecchia_nll_grad"] == 0, "l2 boosting fitted a GP")
    score = np.zeros(n)
    mses = [float(np.mean((yb - yb.mean()) ** 2))]
    for k in range(rounds):
        score += bst0.predict(X, start_iteration=k, num_iteration=k + 1,
                              raw_score=True)
        mses.append(float(np.mean((yb - score) ** 2)))
    check(all(b < a for a, b in zip(mses, mses[1:])),
          f"l2: the training MSE does not fall every round: {mses}")
    check(float(np.abs(score - bst0._score).max()) < 1e-9,
          "l2: the trees' raw predictions do not add up to the training "
          "score")

    # ---- CMP_ROUNDS rounds against the float64 plain path on the card ----
    # (the kernel path's run doubles as the breakdown of a round: named
    # scopes that synchronise around each step, off everywhere else)
    k = min(CMP_ROUNDS, rounds)
    gp_k = _gp_model(coords, m, seed, torch.float32, dev)
    timer.clear()
    timer.enable(True)
    t0 = clock()
    b_k = gpt.train(BOOST_PARAMS, ds, num_boost_round=k, gp_model=gp_k)
    t_traced = clock() - t0
    timer.enable(False)
    breakdown = {name: {"seconds": sec, "calls": calls}
                 for name, (sec, calls) in sorted(timer.totals().items())}
    emit({"phase": "boosting_breakdown", "rounds": k,
          "train_s_with_scopes": t_traced, "scopes": breakdown})
    reset_counts()
    b_p = gpt.train(dict(BOOST_PARAMS, gpu_use_dp=True), ds,
                    num_boost_round=k,
                    gp_model=_gp_model(coords, m, seed, torch.float64, dev))
    check(read_counts() == NO_LAUNCHES,
          f"the float64 path launched kernels: {read_counts()}")
    root_k = (int(b_k.trees[0].split_feature[0]),
              int(b_k.trees[0].threshold_bin[0]))
    root_p = (int(b_p.trees[0].split_feature[0]),
              int(b_p.trees[0].threshold_bin[0]))
    check(root_k == root_p, f"root split of the first tree: kernel path "
          f"{root_k}, float64 plain path {root_p}")
    rms = float(np.sqrt(np.mean((b_k._score - b_p._score) ** 2))
                / np.std(b_p._score))
    check(rms <= CMP_SCORE_TOL, f"training scores after {k} rounds: RMS "
          f"difference {rms} of the score's standard deviation, more than "
          f"{CMP_SCORE_TOL}")
    cp_k, cp_p = b_k.gp_model.get_cov_pars(), b_p.gp_model.get_cov_pars()
    cp_rel = float(np.max(np.abs(cp_k / cp_p - 1.0)))
    check(cp_rel <= CMP_COV_PARS_RTOL, f"covariance parameters after {k} "
          f"rounds: {cp_k} vs {cp_p}, relative difference {cp_rel} > "
          f"{CMP_COV_PARS_RTOL}")
    same_splits = sum(
        int(np.array_equal(a.split_feature, b.split_feature)
            and np.array_equal(a.threshold_bin, b.threshold_bin))
        for a, b in zip(b_k.trees, b_p.trees))

    emit({"phase": "boosting", "n": n, "features": X.shape[1],
          "max_num_bins": ds.max_num_bins, "rounds": rounds,
          "trees": bst.num_trees(), "leaves": leaves, "fits": len(fits),
          "evaluations": evals, "launches": launches,
          "host_reads_per_tree": reads / rounds,
          "nll_round_1": nlls[1], "nll_last_round": nlls[-1],
          "cov_pars": cov_pars.tolist(), "train_mse": mse_gp,
          "l2": {"leaves": leaves0, "launches": launches0,
                 "mse_first": mses[0], "mse_last": mses[-1]},
          "vs_float64_plain": {
              "rounds": k, "root_split": list(root_k),
              "score_rms_diff_over_std": rms, "score_tolerance": CMP_SCORE_TOL,
              "cov_pars_kernel": cp_k.tolist(), "cov_pars_plain": cp_p.tolist(),
              "cov_pars_max_rel_diff": cp_rel,
              "cov_pars_tolerance": CMP_COV_PARS_RTOL,
              "trees_with_identical_splits": same_splits}})
    timings = {"dataset_construct_s": t_dataset,
               f"train_{rounds}r_s": t_train,
               f"train_{rounds}r_no_gp_s": t_train0,
               "boost_predict_s": t_predict}
    return launches, timings, bst, ds


# ---------------------------------------------------------------------------
# phase 5: the reference's default fit route, std errors, GPBoost with it
# ---------------------------------------------------------------------------

def gp_default_route(coords, y, m, seed, dev):
    """``fit(y)`` with no optimizer parameters (gradient descent, the whole
    loop on the device) against the same descent on the float64 plain
    route; then the std errors against the same computation in float64."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import optimizers as opt

    model = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=m,
                        vecchia_ordering="random", seed=seed,
                        dtype=torch.float32, device=dev)
    init = model._default_init_cov_pars(y)
    reset_counts()
    reads0 = opt.gd_device.host_reads
    t0 = clock()
    model.fit(y)
    t_fit = clock() - t0
    launches = read_counts()
    reads = opt.gd_device.host_reads - reads0
    res = model._fit_result
    cov_pars = model.get_cov_pars()
    nll = model.get_current_neg_log_likelihood()
    check(model.optim_cfg.optimizer_cov == "gradient_descent",
          "the default optimizer is not gradient descent")
    check(reads == res.num_evals >= 2,
          f"gd_device: {reads} host reads for {res.num_evals} evaluations")
    check(launches["vecchia_nll_grad"] == res.num_evals,
          f"{launches['vecchia_nll_grad']} NLL kernel launches for "
          f"{res.num_evals} evaluations")
    check(res.aux is not None and bool(np.all(np.isfinite(res.aux))),
          "the fit's Psi^-1 r output is missing or not finite")
    check(math.isfinite(nll) and bool(np.all(cov_pars > 0)),
          f"default route: NLL {nll}, cov_pars {cov_pars}")

    # the same descent, float64 plain objective on the card, same structure
    vec = model._approx
    m64 = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                      gp_approx="vecchia", num_neighbors=m,
                      vecchia_ordering="random", seed=seed, device=dev)
    m64._approx.load_structure(vec.perm, vec.neighbors.cpu().numpy())
    y64 = torch.as_tensor(y, dtype=torch.float64, device=dev)
    t0 = clock()
    ref = opt.gd_device(lambda th, r: m64._approx._vg_gaussian(th, r, None),
                        np.log(init), opt.OptimConfig(), torch.float64, y64,
                        device=dev)
    t_ref = clock() - t0
    nll_rel = abs(nll - ref.nll) / abs(ref.nll)
    cp_rel = float(np.max(np.abs(cov_pars / ref.params - 1.0)))
    check(nll_rel <= 1e-4, f"default route NLL {nll} vs float64 {ref.nll}")
    check(cp_rel <= 5e-2, f"default route cov_pars {cov_pars} vs float64 "
          f"{ref.params}: relative difference {cp_rel}")

    # std errors: p + 1 NLL kernel launches (forward differences, n > 8192)
    reset_counts()
    t0 = clock()
    se = model.get_cov_pars(std_err=True)[1]
    t_se = clock() - t0
    se_launches = read_counts()["vecchia_nll_grad"]
    m64.cov_pars_ = cov_pars.copy()
    m64.y = y64
    t0 = clock()
    se64 = m64.get_cov_pars(std_err=True)[1]
    t_se64 = clock() - t0
    se_rel = float(np.max(np.abs(se / se64 - 1.0)))
    check(bool(np.all(np.isfinite(se)) and np.all(se > 0)),
          f"std errors not finite and positive: {se}")
    check(se_launches >= len(cov_pars) + 1,
          f"std errors made {se_launches} NLL kernel launches, fewer than "
          f"p + 1 = {len(cov_pars) + 1}")
    check(se_rel <= 5e-2, f"std errors {se} vs float64 {se64}: relative "
          f"difference {se_rel}")
    emit({"phase": "gp_default_route", "optimizer": "gradient_descent",
          "launches": launches, "nll": nll, "nll_f64_plain": ref.nll,
          "nll_rel_diff": nll_rel, "cov_pars": cov_pars.tolist(),
          "cov_pars_f64_plain": ref.params.tolist(),
          "cov_pars_max_rel_diff": cp_rel, "iterations": res.num_it,
          "evaluations": res.num_evals, "host_reads": reads,
          "lr_after_first": res.lr_after_first,
          "f64_plain_iterations": ref.num_it,
          "f64_plain_evaluations": ref.num_evals, "f64_plain_fit_s": t_ref,
          "std_err": se.tolist(), "std_err_f64_plain": se64.tolist(),
          "std_err_max_rel_diff": se_rel, "std_err_launches": se_launches,
          "std_err_f64_plain_s": t_se64})
    timings = {"fit_gd_s": t_fit, "fit_gd_iterations": res.num_it,
               "fit_gd_evaluations": res.num_evals,
               "fit_gd_host_reads": reads, "std_err_s": t_se}
    return launches, timings


def boosting_default_route(ds, X, yb, coords, m, seed, rounds, dev):
    """``train(..., gp_model=gp)`` with the GP at the default optimizer:
    the refits from the second on start at the first refit's learning rate
    after its first iteration (``lr_start`` of ``objective.fits``)."""
    import gpboost_tpu_torch as gpt

    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=m,
                     vecchia_ordering="random", seed=seed,
                     dtype=torch.float32, device=dev)
    gp.set_optim_params({"init_cov_pars": [0.25, 1.0, 0.1]})
    reset_counts()
    t0 = clock()
    bst = gpt.train(BOOST_PARAMS, ds, gp_model=gp, num_boost_round=rounds)
    t_train = clock() - t0
    launches = read_counts()
    fits = bst.objective.fits
    evals = sum(f["num_evals"] for f in fits)
    leaves = sum(t.num_leaves for t in bst.trees)
    _check_trees(bst, "gpboost_gd")
    check(len(fits) == rounds + 1, f"{len(fits)} refits in {rounds} rounds")
    check(launches["histogram"] == grower_counts(
        bst.trees, BOOST_PARAMS["num_leaves"])[0],
          f"histogram launched {launches['histogram']} times for {leaves} "
          "leaves")
    check(launches["vecchia_nll_grad"] == evals,
          f"vecchia_nll_grad launched {launches['vecchia_nll_grad']} times "
          f"for {evals} evaluations")
    lr1 = fits[0]["lr_after_first"]
    check(lr1 is not None and bst.objective.lr_after_first == lr1
          and fits[0]["lr_start"] is None
          and all(f["lr_start"] == lr1 for f in fits[1:]),
          f"learning-rate reuse: first refit's lr after one iteration "
          f"{lr1}, starts {[f['lr_start'] for f in fits]}")
    score = np.zeros(len(yb))
    mses = []
    for k in range(rounds):
        score += bst.predict(X, start_iteration=k, num_iteration=k + 1,
                             raw_score=True)
        mses.append(float(np.mean((yb - score) ** 2)))
    check(all(b < a for a, b in zip(mses, mses[1:])),
          f"gpboost_gd: the training MSE does not fall every round: {mses}")
    cov_pars = gp.get_cov_pars()
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"cov_pars not positive: {cov_pars}")
    emit({"phase": "boosting_default_route", "optimizer": "gradient_descent",
          "rounds": rounds, "leaves": leaves, "fits": len(fits),
          "evaluations": evals,
          "evaluations_per_fit": [f["num_evals"] for f in fits],
          "lr_after_first": lr1,
          "lr_start_by_fit": [f["lr_start"] for f in fits],
          "launches": launches, "mse_first": mses[0], "mse_last": mses[-1],
          "cov_pars": cov_pars.tolist()})
    return launches, {f"train_{rounds}r_gd_s": t_train,
                      f"train_{rounds}r_gd_evaluations": evals}


def incoming_bt(model, dev):
    """The gather-only ``B' v`` of the ``Psi^-1 r`` solve at the GP path's
    shape: its structure (the maximum in-degree K, the bytes of the padded
    [n, K] form and of the slices the model keeps) and its time beside the
    scatter (``index_add_``) it replaces; same bits on two calls, within
    1e-5 x (|v| + sum |A v|) of the float64 scatter."""
    from gpboost_tpu_torch.ops import vecchia as vops
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

    vec = model._approx
    nb, slices = vec.neighbors, vec._incoming
    n, m = nb.shape
    cp = torch.tensor([0.25, 1.0, 0.1], device=dev)
    a, _ = vk.vecchia_factors(cp[1:], vec.coords_perm, nb, cp[0], True, 0.5)
    gen = torch.Generator(device=dev).manual_seed(1)
    v = torch.randn(n, generator=gen, device=dev)
    inc_row, inc_slot = vops.build_incoming(nb)
    K = int(inc_row.shape[1])
    first = vops.apply_Bt_sliced(a, slices, v)
    same = all(torch.equal(vops.apply_Bt_sliced(a, slices, v), first)
               for _ in range(3))
    check(same, "gather B'v: two calls differ bit-wise")
    want = vops.apply_Bt(a.double(), nb, v.double())
    scale = 2 * v.abs().double() - vops.apply_Bt_sliced(
        a.abs().double(), slices, v.abs().double())
    errs = {}
    for tag, got in (("sliced", first),
                     ("padded", vops.apply_Bt_gather(a, inc_row, inc_slot,
                                                     v)),
                     ("scatter_f32", vops.apply_Bt(a, nb, v))):
        err = (got.double() - want).abs()
        check(bool((err <= 1e-5 * scale).all()),
              f"B'v {tag}: off by {float(err.max())} vs the float64 scatter")
        errs[tag] = float(err.max())
    nnz = int((nb >= 0).sum())
    out = {"n": n, "m": m, "nnz": nnz, "max_in_degree_K": K,
           "mean_in_degree": nnz / n,
           "padded_bytes": 8 * n * K,
           "sliced_bytes": sum(t.numel() * t.element_size() + 8 * r.numel()
                               for t, r, _ in slices),
           "plan_bytes": slices.nbytes(),
           "slices": [list(shape) for shape in slices.shapes],
           "sliced_ms": time_ms(lambda: vops.apply_Bt_sliced(a, slices, v),
                                20),
           "padded_ms": time_ms(lambda: vops.apply_Bt_gather(
               a, inc_row, inc_slot, v), 20),
           "scatter_ms": time_ms(lambda: vops.apply_Bt(a, nb, v), 20),
           "max_abs_err_vs_f64": errs, "bit_identical": same}
    del inc_row, inc_slot
    torch.cuda.empty_cache()
    emit(dict(phase="incoming_bt", **out))
    return out


def determinism(first, ds, yb, coords, m, seed, dev, ng_first=None,
                ng_ds=None, ng_coords=None, grouped=None, glmm=None):
    """A second training of the boosting path's L-BFGS recipe: the same
    scores, covariance parameters and evaluation counts to the bit; two
    ``Psi^-1 r`` solves the same bits; with ``ng_first``, a second LaGaBoost
    training the same bits too; with ``grouped`` (the first training and
    its data), a second grouped GPBoost training, and with ``glmm`` (the
    fitted model and its data), a second GLMM fit, the same bits."""
    import gpboost_tpu_torch as gpt

    gp = _gp_model(coords, m, seed, torch.float32, dev)
    bst = gpt.train(BOOST_PARAMS, ds, gp_model=gp,
                    num_boost_round=first.num_trees())
    evals = ([f["num_evals"] for f in first.objective.fits],
             [f["num_evals"] for f in bst.objective.fits])
    same_scores = bool(np.array_equal(first._score, bst._score))
    same_cov = bool(np.array_equal(first.gp_model.get_cov_pars(),
                                   gp.get_cov_pars()))
    r = torch.as_tensor(yb - bst._score,
                        dtype=torch.float32, device=dev)
    cp = torch.as_tensor(gp.get_cov_pars(), dtype=torch.float32, device=dev)
    p1 = gp._approx.psi_inv_resid(cp, r)
    p2 = gp._approx.psi_inv_resid(cp, r)
    same_psi = bool(torch.equal(p1, p2))
    out = {"train_scores_bit_identical": same_scores,
           "train_cov_pars_bit_identical": same_cov,
           "train_evaluations_identical": evals[0] == evals[1],
           "psi_inv_resid_bit_identical": same_psi,
           "score_max_abs_diff": float(np.abs(first._score
                                              - bst._score).max()),
           "evaluations": [sum(evals[0]), sum(evals[1])]}
    same_ng = True
    if ng_first is not None:
        gp_ng = _ng_model(ng_coords, m, seed, torch.float32, dev,
                          NG_REFIT_MAXIT)
        bst_ng = gpt.train(NG_PARAMS, ng_ds, gp_model=gp_ng,
                           num_boost_round=ng_first.num_trees())
        ev_ng = ([f["num_evals"] for f in ng_first.objective.fits],
                 [f["num_evals"] for f in bst_ng.objective.fits])
        ng_out = {
            "scores_bit_identical": bool(np.array_equal(ng_first._score,
                                                        bst_ng._score)),
            "cov_pars_bit_identical": bool(np.array_equal(
                ng_first.gp_model.get_cov_pars(), gp_ng.get_cov_pars())),
            "evaluations_identical": ev_ng[0] == ev_ng[1],
            "score_max_abs_diff": float(np.abs(ng_first._score
                                               - bst_ng._score).max()),
            "evaluations": ev_ng}
        out["lagaboost"] = ng_out
        same_ng = (ng_out["scores_bit_identical"]
                   and ng_out["cov_pars_bit_identical"]
                   and ng_out["evaluations_identical"])
    same_grouped = True
    if grouped is not None:
        g_first, bd = grouped
        gp_g = _grouped_gp(bd["g"], dev)
        bst_g = gpt.train(BOOST_PARAMS, gpt.Dataset(bd["X"], label=bd["y"],
                                                    device=dev),
                          gp_model=gp_g, num_boost_round=g_first.num_trees())
        ev_g = ([f["num_evals"] for f in g_first.objective.fits],
                [f["num_evals"] for f in bst_g.objective.fits])
        g_out = {
            "scores_bit_identical": bool(np.array_equal(g_first._score,
                                                        bst_g._score)),
            "cov_pars_bit_identical": bool(np.array_equal(
                g_first.gp_model.get_cov_pars(), gp_g.get_cov_pars())),
            "evaluations_identical": ev_g[0] == ev_g[1],
            "score_max_abs_diff": float(np.abs(g_first._score
                                               - bst_g._score).max()),
            "evaluations": [sum(ev_g[0]), sum(ev_g[1])]}
        out["grouped_boosting"] = g_out
        same_grouped = (g_out["scores_bit_identical"]
                        and g_out["cov_pars_bit_identical"]
                        and g_out["evaluations_identical"])
    same_glmm = True
    if glmm is not None:
        m_first, gd = glmm
        m2 = _glmm_model(gd, dev)
        m2.fit(gd["yb"])
        c_out = {
            "cov_pars_bit_identical": bool(np.array_equal(
                m_first.get_cov_pars(), m2.get_cov_pars())),
            "nll_bit_identical": (m_first.get_current_neg_log_likelihood()
                                  == m2.get_current_neg_log_likelihood()),
            "evaluations": [m_first._fit_result.num_evals,
                            m2._fit_result.num_evals]}
        out["glmm"] = c_out
        same_glmm = (c_out["cov_pars_bit_identical"]
                     and c_out["nll_bit_identical"]
                     and c_out["evaluations"][0] == c_out["evaluations"][1])
        del m2
    emit(dict(phase="determinism", **out))
    check(same_scores and same_cov and evals[0] == evals[1] and same_psi
          and same_ng and same_grouped and same_glmm,
          f"training on the card is not bit-reproducible: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 6: the non-Gaussian Vecchia GP and LaGaBoost (bench.py:323-385)
# ---------------------------------------------------------------------------

def _ng_model(coords, m, seed, dtype, dev, maxit):
    import gpboost_tpu_torch as gpt
    gp = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                     gp_approx="vecchia", num_neighbors=m,
                     vecchia_ordering="random", seed=seed,
                     likelihood="bernoulli_logit",
                     matrix_inversion_method="iterative", dtype=dtype,
                     device=dev)
    gp.set_optim_params({"optimizer_cov": "lbfgs",
                         "init_cov_pars": NG_COV_PARS, "maxit": maxit})
    return gp


def _laplace_vg(model, y, timed_scopes):
    """One value-and-gradient of the iterative Laplace NLL at the fit's
    settings (200 probes, 100 Lanczos steps) at NG_COV_PARS, through the
    model's ``nll_laplace_iterative`` and autograd; with ``timed_scopes``
    the package's named scopes and counters give its breakdown."""
    from gpboost_tpu_torch.models.vecchia_model import LAPLACE_COUNTS
    from gpboost_tpu_torch.ops import cg as cgops
    from gpboost_tpu_torch.utils import timer
    kw = model._iter_kwargs(fit=True)
    y_t = model._y_tensor(y)
    th = torch.log(torch.tensor(NG_COV_PARS, dtype=model.dtype,
                                device=model.device)).requires_grad_(True)
    timer.clear()
    timer.enable(timed_scopes)
    LAPLACE_COUNTS.clear()
    reads0 = cgops.pcg.host_reads
    t0 = clock()
    with timer.timed("forward", sync=True):
        nll = model._approx.nll_laplace_iterative(torch.exp(th), y_t, None,
                                                  None, **kw)
    with timer.timed("backward", sync=True):
        (grad,) = torch.autograd.grad(nll, th)
    t_vg = clock() - t0
    timer.enable(False)
    counts = dict(LAPLACE_COUNTS)
    counts["host_reads"] = (cgops.pcg.host_reads - reads0
                            + counts.get("newton_reads", 0))
    scopes = {name: {"seconds": sec, "calls": calls}
              for name, (sec, calls) in sorted(timer.totals().items())}
    return (float(nll.detach()), grad.double().cpu().numpy(), t_vg, scopes,
            counts)


def ng_path(ng, m, seed, dev):
    """The non-Gaussian GP path through the public API at the bench's width:
    construct, NLL, one timed value-and-gradient with its breakdown, one
    LaGaBoost gradient d NLL / dF, the L-BFGS fit at NG_MAXIT iterations,
    prediction (response mean and simulated variance) at the prediction
    points. No Vecchia kernel may run: the latent factors have no nugget."""
    from gpboost_tpu_torch.models.vecchia_model import LAPLACE_COUNTS
    coords, yb, pred = ng["coords"], ng["yb"], ng["pred"]
    reset_counts()
    t0 = clock()
    model = _ng_model(coords, m, seed, torch.float32, dev, NG_MAXIT)
    t_construct = clock() - t0
    t0 = clock()
    nll_init = model.neg_log_likelihood(NG_COV_PARS, yb)
    t_nll = clock() - t0
    # the first value-and-gradient in a process pays one-time costs (its
    # first backward); timed alone, then the breakdown of a second one
    _, _, t_vg_first, _, _ = _laplace_vg(model, yb, False)
    nll_vg, grad, t_vg, scopes, counts = _laplace_vg(model, yb, True)
    LAPLACE_COUNTS.clear()
    t0 = clock()
    g_f = model._approx.grad_F_laplace(
        torch.tensor(NG_COV_PARS, dtype=torch.float32, device=dev),
        model._y_tensor(yb), None,
        torch.zeros(len(yb), dtype=torch.float32, device=dev))
    t_grad_f = clock() - t0
    counts_grad_f = dict(LAPLACE_COUNTS)
    LAPLACE_COUNTS.clear()
    t0 = clock()
    model.fit(y=yb)
    t_fit = clock() - t0
    counts_fit = dict(LAPLACE_COUNTS)
    LAPLACE_COUNTS.clear()
    t0 = clock()
    model.set_prediction_data(nsim_var_pred=NG_NSIM)
    out = model.predict(gp_coords_pred=pred, predict_var=True,
                        predict_response=True)
    t_pred = clock() - t0
    counts_pred = dict(LAPLACE_COUNTS)
    launches = read_counts()

    res = model._fit_result
    cov_pars = model.get_cov_pars()
    nll_fit = model.get_current_neg_log_likelihood()
    check(launches == NO_LAUNCHES,
          f"the non-Gaussian GP path launched a kernel: {launches}")
    check(math.isfinite(nll_init) and math.isfinite(nll_vg)
          and bool(np.all(np.isfinite(grad))),
          f"NLL or gradient not finite: {nll_init}, {nll_vg}, {grad}")
    check(bool(torch.isfinite(g_f).all()) and g_f.shape == (len(yb),),
          "d NLL / dF not finite or of the wrong shape")
    check(math.isfinite(nll_fit) and nll_fit < nll_vg,
          f"the fit did not lower the NLL (200 probes): {nll_vg} -> "
          f"{nll_fit}")
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"cov_pars not positive: {cov_pars}")
    check(res.num_evals >= 2, f"{res.num_evals} evaluations in the fit")
    mu, var = out["mu"], out["var"]
    check(mu.shape == (len(pred),) and var.shape == (len(pred),),
          f"prediction shapes {mu.shape}, {var.shape}")
    check(bool(np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                       & (var <= VAR_TOP))),
          f"response means outside (0, 1) or variances outside (0, 0.25]: "
          f"{mu.min()}, {mu.max()}, {var.min()}, {var.max()}")
    emit({"phase": "ng_path", "n": len(yb), "m": m, "n_pred": len(pred),
          "likelihood": "bernoulli_logit",
          "matrix_inversion_method": "iterative",
          "iterative_settings": model._iter_kwargs(fit=True),
          "nll_init_50_probes": nll_init, "nll_vg_200_probes": nll_vg,
          "grad": grad.tolist(), "nll_fit": nll_fit,
          "cov_pars": cov_pars.tolist(), "maxit": NG_MAXIT,
          "num_it": res.num_it, "num_evals": res.num_evals,
          "launches": launches, "vg_first_s": t_vg_first, "vg_s": t_vg,
          "vg_scopes": scopes,
          "vg_counts": counts, "grad_f_s": t_grad_f,
          "grad_f_counts": counts_grad_f, "fit_counts": counts_fit,
          "predict_counts": counts_pred,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "pred_mu_range": [float(mu.min()), float(mu.max())],
          "pred_var_range": [float(var.min()), float(var.max())]})
    timings = {"ng_construct_s": t_construct, "ng_nll_s": t_nll,
               "ng_vg_first_s": t_vg_first, "ng_vg_s": t_vg,
               "ng_grad_f_s": t_grad_f, "ng_fit_s": t_fit,
               "ng_fit_evaluations": res.num_evals,
               "ng_predict_s": t_pred}
    return launches, timings, model


def ng_precision(ng, m, seed, dev):
    """The float32 path against the same computation in float64 on the
    card at NG_PRECISION_N points: same ordering and neighbours, same probes
    (drawn in float64 by both), the NLL and its gradient at the fit's
    settings; the float64 iterative NLL beside the exact dense one
    (reported)."""
    import gpboost_tpu_torch as gpt
    n = NG_PRECISION_N
    coords, yb = ng["coords"][:n], ng["yb"][:n]
    m32 = _ng_model(coords, m, seed, torch.float32, dev, NG_MAXIT)
    m64 = _ng_model(coords, m, seed, torch.float64, dev, NG_MAXIT)
    m64._approx.load_structure(m32._approx.perm,
                               m32._approx.neighbors.cpu().numpy())
    v32, g32, t32, _, c32 = _laplace_vg(m32, yb, False)
    v64, g64, t64, _, c64 = _laplace_vg(m64, yb, False)
    nll_rel = abs(v32 - v64) / abs(v64)
    grad_rel = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    dense = gpt.GPModel(gp_coords=coords, cov_function="exponential",
                        gp_approx="vecchia", num_neighbors=m,
                        likelihood="bernoulli_logit", device=dev)
    dense._approx.load_structure(m32._approx.perm,
                                 m32._approx.neighbors.cpu().numpy())
    t0 = clock()
    exact = dense.neg_log_likelihood(NG_COV_PARS, yb)
    t_exact = clock() - t0
    del dense
    torch.cuda.empty_cache()
    out = {"n": n, "nll_f32": v32, "nll_f64": v64, "nll_rel_diff": nll_rel,
           "nll_tolerance": NG_NLL_RTOL, "grad_f32": g32.tolist(),
           "grad_f64": g64.tolist(), "grad_max_rel_diff": grad_rel,
           "grad_tolerance": NG_GRAD_RTOL, "vg_f32_s": t32, "vg_f64_s": t64,
           "counts_f32": c32, "counts_f64": c64,
           "nll_exact_dense_f64": exact, "dense_s": t_exact,
           "iterative_minus_exact_f64": v64 - exact}
    emit(dict(phase="ng_precision", **out))
    check(nll_rel <= NG_NLL_RTOL, f"float32 NLL {v32} vs float64 {v64}")
    check(grad_rel <= NG_GRAD_RTOL, f"float32 gradient {g32} vs float64 "
          f"{g64}: relative difference {grad_rel}")
    return out


def precision_ops_trace(model, dev):
    """The precision product (forward and backward) and diag(Q) on the
    non-Gaussian path's structure, k = 8 right-hand sides, under the
    profiler (its CPU side: the names of the operations called): no
    operation that adds with colliding indices."""
    from torch.profiler import ProfilerActivity, profile
    from gpboost_tpu_torch.ops import vecchia as vops
    vec = model._approx
    a, d = vec._latent_factors(torch.tensor(NG_COV_PARS, device=dev))
    a = a.detach().requires_grad_(True)
    d = d.detach().requires_grad_(True)
    V = torch.randn(vec.n, 8, device=dev, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = vops.precision_product(a, d, V, vec.neighbors, vec._incoming)
        torch.autograd.grad(out.sum(), (a, d, V))
        vops.precision_diag(a.detach(), vec.neighbors, d.detach(),
                            vec._incoming)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    # device time of one product at the path's right-hand-side counts: one
    # (mode-finder CG), 200 (Lanczos and the gradient CG at the fit's
    # settings), 128 (a chunk of posterior draws)
    with torch.no_grad():
        a0, d0 = a.detach(), d.detach()
        qv_ms = {}
        for k in (1, 128, 200):
            Vk = torch.randn(vec.n, k, device=dev)
            qv_ms[k] = time_ms(lambda: vops.precision_product(
                a0, d0, Vk, vec.neighbors, vec._incoming), 10)
            del Vk
    torch.cuda.empty_cache()
    emit({"phase": "precision_ops_trace", "ops": names, "scatters": bad,
          "qv_ms_by_k": qv_ms})
    check(any("index" in x for x in names), f"empty trace: {names}")
    check(not bad, f"the precision product or diag(Q) scatters: {bad}")
    return names


def lagaboost(ng, m, seed, dev):
    """The LaGaBoost algorithm through the public API at the bench's width:
    ``Dataset`` -> ``train(objective="binary", gp_model=gp)`` with NG_ROUNDS
    rounds (each refit at most NG_REFIT_MAXIT L-BFGS iterations) ->
    ``Booster.predict(X, gp_coords_pred=..., predict_var=True)``."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    from gpboost_tpu_torch.models.vecchia_model import LAPLACE_COUNTS
    from gpboost_tpu_torch.utils import timer
    reset_counts()
    LAPLACE_COUNTS.clear()
    t0 = clock()
    ds = gpt.Dataset(ng["Xn"], label=ng["ybb"], device=dev)
    t_dataset = clock() - t0
    gp = _ng_model(ng["coords"], m, seed, torch.float32, dev, NG_REFIT_MAXIT)
    timer.clear()
    timer.enable(True)
    t0 = clock()
    rounds = NG_ROUNDS
    bst = gpt.train(NG_PARAMS, ds, gp_model=gp, num_boost_round=rounds)
    t_train = clock() - t0
    timer.enable(False)
    scopes = {name: {"seconds": sec, "calls": calls}
              for name, (sec, calls) in sorted(timer.totals().items())}
    counts = dict(LAPLACE_COUNTS)
    LAPLACE_COUNTS.clear()
    t0 = clock()
    gp.set_prediction_data(nsim_var_pred=NG_NSIM)
    out = bst.predict(ng["X_pred"], gp_coords_pred=ng["pred"],
                      predict_var=True)
    t_pred = clock() - t0
    counts_pred = dict(LAPLACE_COUNTS)
    launches = read_counts()
    reads = grow_tree.host_reads

    fits = bst.objective.fits
    leaves = sum(t.num_leaves for t in bst.trees)
    check(bst.num_trees() == rounds, f"{bst.num_trees()} trees")
    _check_trees(bst, "lagaboost")
    want_launches, want_reads = grower_counts(bst.trees,
                                              NG_PARAMS["num_leaves"])
    check(launches["histogram"] == want_launches,
          f"lagaboost: histogram launched {launches['histogram']} times for "
          f"{leaves} leaves, {want_launches} expected")
    check(reads == want_reads, f"lagaboost: {reads} grower host reads for "
          f"{leaves} leaves, {want_reads} expected")
    check(launches["vecchia_factors"] == launches["vecchia_nll_grad"] == 0,
          f"lagaboost launched a Vecchia kernel: {launches}")
    check(len(fits) == rounds + 1, f"{len(fits)} refits in {rounds} rounds")
    nlls = [f["nll"] for f in fits]
    check(all(math.isfinite(v) for v in nlls) and nlls[-1] < nlls[0],
          f"the Laplace NLL did not fall over the rounds: {nlls}")
    cov_pars = gp.get_cov_pars()
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"cov_pars not positive: {cov_pars}")
    mu, var = out["response_mean"], out["response_var"]
    n_p = len(ng["pred"])
    check(mu.shape == (n_p,) and var.shape == (n_p,),
          f"prediction shapes {mu.shape}, {var.shape}")
    check(bool(np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                       & (var <= VAR_TOP))),
          f"lagaboost predictions outside (0, 1) / (0, 0.25]: {mu.min()}, "
          f"{mu.max()}, {var.min()}, {var.max()}")
    emit({"phase": "lagaboost", "n": len(ng["ybb"]), "features": 5,
          "rounds": rounds, "refit_maxit": NG_REFIT_MAXIT, "leaves": leaves,
          "fits": len(fits), "evaluations_per_fit":
              [f["num_evals"] for f in fits], "nll_by_fit": nlls,
          "cov_pars": cov_pars.tolist(), "launches": launches,
          "host_reads_per_tree": reads / rounds, "counts": counts,
          "predict_counts": counts_pred,
          "scopes": scopes, "init_score": float(bst.init_score[0]),
          "pred_mu_range": [float(mu.min()), float(mu.max())]})
    timings = {"lagaboost_dataset_s": t_dataset,
               "lagaboost_train_s": t_train, "lagaboost_rounds": rounds,
               "lagaboost_predict_s": t_pred}
    return launches, timings, bst, ds


# ---------------------------------------------------------------------------
# phase 7: grouped random effects (Woodbury LMM, GPBoost, b-space GLMM)
# ---------------------------------------------------------------------------

def make_grouped_data(seed, n, n_pred):
    """The grouped design: two crossed random intercepts, GR_LEVELS[0]
    levels drawn uniformly and GR_LEVELS[1] levels with Zipf-skewed sizes
    (exponent GR_ZIPF; every level holds one row at least), a random slope
    on the first, X an intercept and two covariates; the response from
    GR_TRUTH and GR_BETA. Prediction rows: a GR_UNSEEN share with labels
    training never saw (in both columns), the rest at training levels."""
    rng = np.random.default_rng(seed + 10)
    l1, l2 = GR_LEVELS
    g1 = rng.integers(0, l1, n)
    p = 1.0 / np.arange(1, l2 + 1) ** GR_ZIPF
    g2 = rng.permutation(np.concatenate(
        [np.arange(l2), rng.choice(l2, n - l2, p=p / p.sum())]))
    xs = rng.uniform(-1.0, 1.0, n)
    X = np.column_stack([np.ones(n), rng.standard_normal(n),
                         rng.uniform(size=n)])
    s2, v1, v2, v3 = GR_TRUTH
    b1 = np.sqrt(v1) * rng.standard_normal(l1)
    b2 = np.sqrt(v2) * rng.standard_normal(l2)
    b3 = np.sqrt(v3) * rng.standard_normal(l1)
    y = (X @ np.asarray(GR_BETA) + b1[g1] + b2[g2] + xs * b3[g1]
         + np.sqrt(s2) * rng.standard_normal(n))
    latent_glmm = b1[g1] + b2[g2]
    yb = rng.binomial(1, 1.0 / (1.0 + np.exp(-latent_glmm))).astype(
        np.float64)
    unseen = rng.random(n_pred) < GR_UNSEEN
    gp1 = np.where(unseen, l1 + rng.integers(0, 37, n_pred),
                   rng.integers(0, l1, n_pred))
    gp2 = np.where(unseen, l2 + rng.integers(0, 41, n_pred),
                   rng.choice(l2, n_pred, p=p / p.sum()))
    return dict(g1=g1, g2=g2, xs=xs, X=X, y=y, yb=yb,
                group_pred=np.column_stack([gp1, gp2]),
                xs_pred=rng.uniform(-1.0, 1.0, n_pred),
                X_pred=np.column_stack([np.ones(n_pred),
                                        rng.standard_normal(n_pred),
                                        rng.uniform(size=n_pred)]),
                unseen=unseen, largest_level=int(np.bincount(g2).max()))


def _lmm_kwargs(gd, rows=slice(None)):
    return dict(group_data=np.column_stack([gd["g1"][rows], gd["g2"][rows]]),
                group_rand_coef_data=gd["xs"][rows],
                ind_effect_group_rand_coef=[1])


def grouped_lmm(gd, seed, dev):
    """Path (A), the Gaussian LMM through the public API at full width:
    construct, NLL, the default fit (gradient descent, GLS coefficients),
    std errors (q-space Fisher information, GLS covariance), prediction
    with variances at GR_N_PRED rows (unseen levels included), an L-BFGS
    fit; no kernel runs on it. Also times one value-and-gradient, the
    [q, q] Cholesky and inverse it is made of, and Z' v through the
    fixed-order plan beside the ``index_add_`` scatter it replaces."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import grouped as tg
    y, X = gd["y"], gd["X"]
    reset_counts()
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    model = gpt.GPModel(device=dev, **_lmm_kwargs(gd))
    t_construct = clock() - t0
    Z = model._Z
    init = model._default_init_cov_pars(y)
    fe_ols = X @ np.linalg.lstsq(X, y, rcond=None)[0]
    nll_init = model.neg_log_likelihood(init, y, fixed_effects=fe_ols)
    t0 = clock()
    model.neg_log_likelihood(init, y, fixed_effects=fe_ols)
    t_nll = clock() - t0
    # one value-and-gradient of the profiled NLL (the unit of a fit), warm,
    # and the two dense [q, q] operations it is made of
    th = torch.as_tensor(np.log(init[1:] / init[0]), dtype=torch.float64,
                         device=dev)
    r = torch.as_tensor(y - fe_ols, dtype=torch.float64, device=dev)
    tg.nll_profiled_value_and_grad(Z, th, r)
    t0 = clock()
    tg.nll_profiled_value_and_grad(Z, th, r)
    t_vg = clock() - t0
    M = Z.ztz().clone()
    M.diagonal().add_(1.0 / tg._sigma_b_diag(Z, torch.exp(th)))
    chol_ms = time_ms(lambda: torch.linalg.cholesky(M), 3)
    L = torch.linalg.cholesky(M)
    cholinv_ms = time_ms(lambda: torch.cholesky_inverse(L), 3)
    # the triangular solve that gives diag(M^-1) too (not used: measured
    # as the alternative to the inverse)
    eye = torch.eye(Z.q, dtype=torch.float64, device=dev)
    trsm_ms = time_ms(lambda: torch.linalg.solve_triangular(
        L, eye, upper=False), 3)
    del M, L, eye
    # Z' v: the plan (a gather, row sums, one copy into place) beside the
    # scatter it replaces, and its bits over 10 calls
    v = torch.as_tensor(np.random.default_rng(seed).standard_normal(Z.n),
                        dtype=torch.float64, device=dev)
    zt_ms = time_ms(lambda: tg.zt_mul(Z, v), 10)

    def scatter():
        out = torch.zeros(Z.q, dtype=v.dtype, device=dev)
        for idx, w in zip(Z.idx, Z.weights):
            out.index_add_(0, idx, v if w is None else w * v)
        return out

    scatter_ms = time_ms(scatter, 10)
    zt_ref = tg.zt_mul(Z, v)
    zt_same = all(torch.equal(zt_ref, tg.zt_mul(Z, v)) for _ in range(10))
    zt_err = float((zt_ref - scatter()).abs().max())
    tg.GROUPED_COUNTS.clear()

    t0 = clock()
    model.fit(y, X=X)
    t_gd = clock() - t0
    res_gd = model._fit_result
    counts_gd = dict(tg.GROUPED_COUNTS)
    nll_gd = model.get_current_neg_log_likelihood()
    cp_gd, coef_gd = model.get_cov_pars(), model.get_coef()
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    cp_sd = model.get_cov_pars(std_err=True)
    coef_sd = model.get_coef(std_err=True)
    t_se = clock() - t0
    counts_se = dict(tg.GROUPED_COUNTS)
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    out = model.predict(group_data_pred=gd["group_pred"],
                        group_rand_coef_data_pred=gd["xs_pred"],
                        X_pred=gd["X_pred"], predict_var=True)
    t_pred = clock() - t0
    counts_pred = dict(tg.GROUPED_COUNTS)
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    model.fit(y, X=X, params={"optimizer_cov": "lbfgs"})
    t_lbfgs = clock() - t0
    res_lb = model._fit_result
    counts_lb = dict(tg.GROUPED_COUNTS)
    nll_lb = model.get_current_neg_log_likelihood()
    cp_lb = model.get_cov_pars()
    launches = read_counts()

    truth = np.asarray(GR_TRUTH)
    check(launches == NO_LAUNCHES,
          f"the grouped LMM path launched a kernel: {launches}")
    for tag, nll in (("gd", nll_gd), ("lbfgs", nll_lb)):
        check(math.isfinite(nll) and nll <= nll_init,
              f"{tag}: the fitted NLL {nll} is above the NLL at the initial "
              f"parameters {nll_init}")
    # the truth gate holds the L-BFGS optimum: the default descent stops at
    # the reference's relative NLL change of 1e-6, at n = 1e6 a change of
    # ~1.4 units, short of the optimum (its distance is reported)
    rel_lb = np.abs(cp_lb / truth - 1.0)
    rel_gd = np.abs(cp_gd / truth - 1.0)
    check(bool(np.all(rel_lb <= GR_TRUTH_RTOL)),
          f"lbfgs: cov_pars {cp_lb} not within {GR_TRUTH_RTOL} of the "
          f"truth {truth}: {rel_lb}")
    check(bool(np.all(np.isfinite(cp_sd[1])) and np.all(cp_sd[1] > 0)
               and np.all(np.isfinite(coef_sd[1]))
               and np.all(coef_sd[1] > 0)),
          f"std errors not finite and positive: {cp_sd}, {coef_sd}")
    check(zt_same, "Z' v through the plan differs between calls")
    check(zt_err <= 1e-9 * float(zt_ref.abs().max()),
          f"Z' v through the plan vs the scatter: {zt_err}")
    mu, var = out["mu"], out["var"]
    n_p = len(gd["unseen"])
    check(mu.shape == (n_p,) and var.shape == (n_p,)
          and bool(np.all(np.isfinite(mu)) and np.all(var > 0)),
          f"predictions: shapes {mu.shape}, {var.shape}, var min "
          f"{np.min(var)}")
    u = gd["unseen"]
    prior = (cp_gd[0] + cp_gd[1] + cp_gd[2]
             + cp_gd[3] * gd["xs_pred"][u] ** 2)
    err_unseen = float(np.max(np.abs(var[u] - prior) / prior))
    err_mu_unseen = float(np.max(np.abs(mu[u] - gd["X_pred"][u] @ coef_gd)))
    check(err_unseen < 1e-10 and err_mu_unseen < 1e-10,
          f"unseen levels: variance {err_unseen}, mean {err_mu_unseen} off "
          "the prior")
    share = ((counts_gd.get("qq_factor", 0) * chol_ms
              + counts_gd.get("qq_inverse", 0) * cholinv_ms)
             / (t_gd * 1e3))
    emit({"phase": "grouped_lmm", "n": Z.n, "q": Z.q,
          "levels": list(GR_LEVELS), "zipf": GR_ZIPF,
          "largest_level_rows": gd["largest_level"],
          "plan_bytes": Z.nbytes(), "truth": GR_TRUTH, "beta": GR_BETA,
          "nll_init": nll_init, "nll_gd": nll_gd, "nll_lbfgs": nll_lb,
          "cov_pars_gd": cp_gd.tolist(), "cov_pars_lbfgs": cp_lb.tolist(),
          "coef_gd": coef_gd.tolist(), "cov_pars_std": cp_sd[1].tolist(),
          "coef_std": coef_sd[1].tolist(),
          "gd": {"iterations": res_gd.num_it,
                 "evaluations": res_gd.num_evals, "counts": counts_gd,
                 "converged": res_gd.converged,
                 "nll_history_tail": res_gd.history[-4:],
                 "rel_to_truth": rel_gd.tolist()},
          "lbfgs": {"iterations": res_lb.num_it,
                    "evaluations": res_lb.num_evals, "counts": counts_lb,
                    "rel_to_truth": rel_lb.tolist()},
          "std_err_counts": counts_se, "predict_counts": counts_pred,
          "vg_ms": t_vg * 1e3, "cholesky_ms": chol_ms,
          "cholesky_inverse_ms": cholinv_ms,
          "triangular_solve_identity_ms": trsm_ms,
          "gd_fit_dense_share_est": share,
          "zt_plan_ms": zt_ms, "zt_scatter_ms": scatter_ms,
          "zt_max_abs_diff_vs_scatter": zt_err,
          "zt_bit_identical_10_calls": zt_same,
          "unseen_rows": int(u.sum()), "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    timings = {"lmm_construct_s": t_construct, "lmm_nll_ms": t_nll * 1e3,
               "lmm_vg_ms": t_vg * 1e3, "lmm_fit_gd_s": t_gd,
               "lmm_fit_gd_evaluations": res_gd.num_evals,
               "lmm_fit_lbfgs_s": t_lbfgs,
               "lmm_fit_lbfgs_evaluations": res_lb.num_evals,
               "lmm_std_err_s": t_se, "lmm_predict_s": t_pred}
    return launches, timings, {"cov_pars": cp_lb, "coef": model.get_coef()}


def grouped_vs_cpu(gd, dev):
    """The grouped NLL and its gradient on the card against the float64 CPU
    run (``index_add_``) on the first GR_CPU_N rows: relative difference at
    most GR_CPU_RTOL. Returns the card's model for the trace."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import grouped as tg
    rows = slice(0, GR_CPU_N)
    y = gd["y"][rows]
    fe = gd["X"][rows] @ np.asarray(GR_BETA)
    out = {}
    for name in ("cuda", "cpu"):
        m = gpt.GPModel(device=dev if name == "cuda" else "cpu",
                        **_lmm_kwargs(gd, rows))
        t0 = clock()
        nll = m.neg_log_likelihood(GR_TRUTH, y, fixed_effects=fe)
        th = torch.as_tensor(np.log(np.asarray(GR_TRUTH[1:]) / GR_TRUTH[0]),
                             dtype=torch.float64, device=m.device)
        _, g, _ = tg.nll_profiled_value_and_grad(
            m._Z, th, torch.as_tensor(y - fe, dtype=torch.float64,
                                      device=m.device))
        out[name] = (nll, g.cpu().numpy(), clock() - t0, m)
    nll_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    g_rel = float(np.max(np.abs(out["cuda"][1] - out["cpu"][1]))
                  / np.max(np.abs(out["cpu"][1])))
    emit({"phase": "grouped_vs_cpu", "n": GR_CPU_N, "q": out["cuda"][3]._Z.q,
          "nll_cuda": out["cuda"][0], "nll_cpu_f64": out["cpu"][0],
          "nll_rel_diff": nll_rel, "grad_max_rel_diff": g_rel,
          "tolerance": GR_CPU_RTOL, "cuda_s": out["cuda"][2],
          "cpu_s": out["cpu"][2]})
    check(nll_rel <= GR_CPU_RTOL and g_rel <= GR_CPU_RTOL,
          f"grouped NLL on the card vs the CPU: {nll_rel}, gradient "
          f"{g_rel}")
    return out["cuda"][3]


def grouped_ops_trace(model, yb, dev):
    """The grouped NLL (forward and backward, Gaussian and Laplace) and
    Z' v on the card under the profiler (its CPU side: the names of the
    operations called): no operation that adds with colliding indices."""
    from torch.profiler import ProfilerActivity, profile
    from gpboost_tpu_torch.models import grouped as tg
    Z = model._Z
    r = model._tensor(np.random.default_rng(1).standard_normal(Z.n))
    th = model._tensor(np.log(np.asarray(GR_TRUTH[1:]) / GR_TRUTH[0]))
    ybt = model._tensor(yb)
    Z.pair_plan()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tg.nll_profiled_value_and_grad(Z, th, r)
        tg.zt_mul(Z, r)
        cp = model._tensor(GR_TRUTH[1:]).requires_grad_(True)
        v = tg.nll_laplace(Z, "bernoulli_logit", cp, None, ybt, None)
        torch.autograd.grad(v, cp)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    emit({"phase": "grouped_ops_trace", "ops": names, "scatters": bad})
    check(any("index" in x for x in names), f"empty trace: {names}")
    check(not bad, f"the grouped NLL or Z' v scatters: {bad}")
    return names


def _grouped_boost_data(seed, n, n_pred):
    rng = np.random.default_rng(seed + 20)
    X = rng.uniform(size=(n, 5))
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    g = rng.integers(0, GB_LEVELS, n)
    y = f + 0.7 * rng.standard_normal(GB_LEVELS)[g] \
        + 0.5 * rng.standard_normal(n)
    gp = rng.integers(0, GB_LEVELS, n_pred)
    unseen = rng.random(n_pred) < GR_UNSEEN
    gp[unseen] = GB_LEVELS + rng.integers(0, 29, int(unseen.sum()))
    return dict(X=X, y=y, g=g, X_pred=rng.uniform(size=(n_pred, 5)),
                group_pred=gp)


def _grouped_gp(g, dev, optimizer=None):
    import gpboost_tpu_torch as gpt
    gp = gpt.GPModel(group_data=g, device=dev)
    if optimizer:
        gp.set_optim_params({"optimizer_cov": optimizer})
    return gp


def grouped_boosting(seed, n, n_pred, rounds, dev):
    """Path (B), the GPBoost algorithm with a grouped random intercept of
    GB_LEVELS levels in the GP's place: ``train(BOOST_PARAMS, ds,
    gp_model=GPModel(group_data=...))`` with the default optimizer (GD,
    learning-rate reuse) and with L-BFGS (memory reuse), then
    ``Booster.predict(X, group_data_pred=..., predict_var=True)``. The
    histogram kernel launches once a leaf; no Vecchia kernel runs."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    from gpboost_tpu_torch.models import grouped as tg
    bd = _grouped_boost_data(seed, n, n_pred)
    out, timings, first = {}, {}, None
    for tag, opt in (("gd", None), ("lbfgs", "lbfgs")):
        reset_counts()
        tg.GROUPED_COUNTS.clear()
        ds = gpt.Dataset(bd["X"], label=bd["y"], device=dev)
        gp = _grouped_gp(bd["g"], dev, opt)
        t0 = clock()
        bst = gpt.train(BOOST_PARAMS, ds, gp_model=gp,
                        num_boost_round=rounds)
        t_train = clock() - t0
        launches = read_counts()
        reads = grow_tree.host_reads
        counts = dict(tg.GROUPED_COUNTS)
        fits = bst.objective.fits
        leaves = sum(t.num_leaves for t in bst.trees)
        check(bst.num_trees() == rounds, f"{bst.num_trees()} trees")
        _check_trees(bst, f"grouped_{tag}")
        want_launches, want_reads = grower_counts(
            bst.trees, bst.grower.num_leaves)
        check(launches["histogram"] == want_launches,
              f"grouped {tag}: histogram launched {launches['histogram']} "
              f"times for {leaves} leaves, {want_launches} expected")
        check(reads == want_reads, f"grouped {tag}: {reads} grower host "
              f"reads for {leaves} leaves, {want_reads} expected")
        check(launches["vecchia_factors"] == launches["vecchia_nll_grad"]
              == 0, f"grouped {tag} launched a Vecchia kernel: {launches}")
        check(len(fits) == rounds + 1, f"grouped {tag}: {len(fits)} refits "
              f"in {rounds} rounds")
        nlls = [f["nll"] for f in fits]
        check(all(math.isfinite(v) for v in nlls) and nlls[-1] < nlls[1],
              f"grouped {tag}: the NLL did not fall from round 1: {nlls}")
        cov_pars = gp.get_cov_pars()
        check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
              f"grouped {tag}: cov_pars not positive: {cov_pars}")
        entry = {"leaves": leaves, "fits": len(fits),
                 "evaluations": sum(f["num_evals"] for f in fits),
                 "nll_round_1": nlls[1], "nll_last_round": nlls[-1],
                 "cov_pars": cov_pars.tolist(), "launches": launches,
                 "counts": counts, "host_reads_per_tree": reads / rounds,
                 "train_mse": float(np.mean((bd["y"] - bst._score) ** 2))}
        timings[f"grouped_train_{rounds}r" + ("_lbfgs" if opt else "")
                + "_s"] = t_train
        if first is None:
            first = (bst, ds, launches)
            t0 = clock()
            pred = bst.predict(bd["X_pred"], group_data_pred=bd["group_pred"],
                               predict_var=True)
            timings["grouped_boost_predict_s"] = clock() - t0
            mu, var = pred["response_mean"], pred["response_var"]
            check(mu.shape == (n_pred,) and bool(
                np.all(np.isfinite(mu)) and np.all(var > 0)),
                "grouped boosting predictions not finite / positive")
            entry["pred_var_range"] = [float(var.min()), float(var.max())]
        out[tag] = entry
    emit({"phase": "grouped_boosting", "n": n, "levels": GB_LEVELS,
          "rounds": rounds, **out})
    return first[2], timings, first[0], bd


def _glmm_model(gd, dev):
    import gpboost_tpu_torch as gpt
    return gpt.GPModel(group_data=np.column_stack([gd["g1"], gd["g2"]]),
                       likelihood="bernoulli_logit", device=dev)


def grouped_glmm(gd, dev):
    """Path (C), the b-space Laplace GLMM: ``bernoulli_logit`` on the LMM's
    design without the slope (q = sum of GR_LEVELS): construct, NLL at the
    initial parameters, the default fit (L-BFGS), prediction of the
    response mean and variance at GR_N_PRED rows."""
    from gpboost_tpu_torch.models import grouped as tg
    reset_counts()
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    model = _glmm_model(gd, dev)
    t_construct = clock() - t0
    init = model._default_init_cov_pars(gd["yb"])
    t0 = clock()
    nll_init = model.neg_log_likelihood(init, gd["yb"])
    t_nll = clock() - t0
    counts_nll = dict(tg.GROUPED_COUNTS)
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    model.fit(gd["yb"])
    t_fit = clock() - t0
    counts_fit = dict(tg.GROUPED_COUNTS)
    res = model._fit_result
    tg.GROUPED_COUNTS.clear()
    t0 = clock()
    out = model.predict(group_data_pred=gd["group_pred"], predict_var=True,
                        predict_response=True)
    t_pred = clock() - t0
    counts_pred = dict(tg.GROUPED_COUNTS)
    launches = read_counts()
    nll_fit = model.get_current_neg_log_likelihood()
    cov_pars = model.get_cov_pars()
    # one Newton step's dense work at the fitted parameters: H = Z'WZ +
    # Sigma_b^-1 (the plan's sums), its Cholesky, the LU the JAX package
    # solves with
    _, w, db = tg.laplace_mode_and_w(model._Z, model.likelihood,
                                     model._tensor(cov_pars), None,
                                     model._tensor(gd["yb"]), None)
    ztwz_ms = time_ms(lambda: model._Z._ztwz(w), 3)
    H = model._Z._ztwz(w)
    H.diagonal().add_(1.0 / db)
    h_chol_ms = time_ms(lambda: torch.linalg.cholesky(H), 3)
    rhs = torch.ones(model._Z.q, 1, dtype=H.dtype, device=dev)
    h_lu_ms = time_ms(lambda: torch.linalg.solve(H, rhs), 3)
    del H, w, rhs
    check(launches == NO_LAUNCHES,
          f"the GLMM path launched a kernel: {launches}")
    check(math.isfinite(nll_fit) and nll_fit <= nll_init,
          f"the GLMM fit did not lower the NLL: {nll_init} -> {nll_fit}")
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"GLMM cov_pars not positive: {cov_pars}")
    mu, var = out["mu"], out["var"]
    check(bool(np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                       & (var <= 0.25))),
          f"GLMM predictions outside (0, 1) / (0, 0.25]: {mu.min()}, "
          f"{mu.max()}, {var.min()}, {var.max()}")
    emit({"phase": "grouped_glmm", "n": model._Z.n, "q": model._Z.q,
          "likelihood": "bernoulli_logit", "truth": GR_TRUTH[1:3],
          "nll_init": nll_init, "nll_fit": nll_fit,
          "cov_pars": cov_pars.tolist(), "iterations": res.num_it,
          "evaluations": res.num_evals, "nll_counts": counts_nll,
          "fit_counts": counts_fit, "predict_counts": counts_pred,
          "launches": launches, "ztwz_ms": ztwz_ms,
          "h_cholesky_ms": h_chol_ms, "h_lu_solve_ms": h_lu_ms,
          "pred_mu_range": [float(mu.min()), float(mu.max())],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    timings = {"glmm_construct_s": t_construct, "glmm_nll_s": t_nll,
               "glmm_fit_s": t_fit, "glmm_fit_evaluations": res.num_evals,
               "glmm_predict_s": t_pred}
    return launches, timings, model


# ---------------------------------------------------------------------------
# phase 8: the exact GP (gp_approx="none", the README's first example)
# ---------------------------------------------------------------------------

EX_N = 10_000                     # the top of where users run the exact GP
EX_N_PRED = 1_000
EX_TRUTH = [0.25, 1.0, 0.1]       # nugget, variance, range (Matern 1.5)
EX_BETA = [1.0, 0.5]
EX_TRUTH_RTOL = 0.35              # L-BFGS cov_pars vs the simulation's truth
EX_CPU_N = 2_000                  # points of the card-vs-CPU check
EX_CPU_RTOL = 1e-9
EX_CLUSTERS, EX_CLUSTER_SIZE = 1_000, 100
EX_SMALL_N = 5_000                # combined, Laplace and boosting phases
EX_LEVELS = 100
EX_LAP_CPU_N = 1_000
EX_UNSEEN = 0.1                   # share of prediction rows in new clusters


def _matern15(coords1, coords2, var, rng_):
    from gpboost_tpu_torch.ops.cov_fns import euclidean_distance
    x = math.sqrt(3.0) * euclidean_distance(coords1, coords2) / rng_
    return var * (1.0 + x) * torch.exp(-x)


def _simulate_gp(coords_t, var, range_, z):
    """A draw of a Matern-1.5 GP at ``coords_t`` on the card: the lower
    Cholesky factor of its covariance (plus 1e-8 I) times ``z``."""
    cov = _matern15(coords_t, coords_t, var, range_)
    cov.diagonal().add_(1e-8)
    out = torch.linalg.cholesky(cov) @ z
    del cov
    return out


def make_exact_data(seed, n, n_pred, dev):
    """The README's first example at size: n points uniform in the unit
    square, X = [1, N(0, 1)], y = X beta + a Matern-1.5 GP (variance,
    range of EX_TRUTH) + noise (the nugget), simulated on the card from
    ``seed``; prediction points and their X."""
    rng = np.random.default_rng(seed + 30)
    coords = rng.uniform(size=(n, 2))
    X = np.column_stack([np.ones(n), rng.standard_normal(n)])
    z = torch.as_tensor(rng.standard_normal(n), device=dev)
    b = _simulate_gp(torch.as_tensor(coords, device=dev), EX_TRUTH[1],
                     EX_TRUTH[2], z).cpu().numpy()
    y = X @ np.asarray(EX_BETA) + b \
        + math.sqrt(EX_TRUTH[0]) * rng.standard_normal(n)
    pred = rng.uniform(size=(n_pred, 2))
    X_pred = np.column_stack([np.ones(n_pred), rng.standard_normal(n_pred)])
    return dict(coords=coords, X=X, y=y, b=b, pred=pred, X_pred=X_pred)


def _exact_model(coords, dev, **kw):
    import gpboost_tpu_torch as gpt
    return gpt.GPModel(gp_coords=coords, cov_function="matern",
                       cov_fct_shape=1.5, device=dev, **kw)


def _timed(fn):
    t0 = clock()
    out = fn()
    return out, clock() - t0


def exact_gp(ex, dev):
    """The README's first example through the public API at n = EX_N,
    float64: construct, NLL, one value-and-gradient (the profiled one a fit
    evaluates, and the full one), the default fit (profiled gradient
    descent, GLS coefficients), an L-BFGS and a Fisher-scoring fit, std
    errors, ``predict`` with variances and with the covariance matrix at
    EX_N_PRED points, ``predict_training_data_random_effects``; the peak
    memory. Gates: the fitted NLL no higher than at the inits, the L-BFGS
    cov_pars within EX_TRUTH_RTOL of the truth, no kernel launched."""
    from gpboost_tpu_torch.models import gaussian as tga
    torch.cuda.empty_cache()
    # earlier phases' tensors still live: the phase's own peak is the
    # peak above what was allocated at its start
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    y, X = ex["y"], ex["X"]
    gp, t_construct = _timed(lambda: _exact_model(ex["coords"], dev))
    init = gp._default_init_cov_pars(y)
    beta_ols = np.linalg.lstsq(X, y, rcond=None)[0]
    nll_init, t_nll = _timed(lambda: gp.neg_log_likelihood(
        init, y, fixed_effects=X @ beta_ols))
    r = gp._tensor(y - X @ beta_ols)
    th_full = gp._tensor(np.log(init))
    vidx = gp._variance_index()
    ratio = np.asarray(init[1:]).copy()
    ratio[vidx] /= init[0]
    th_ratio = gp._tensor(np.log(ratio))
    tga.nll_profiled_value_and_grad(gp.spec, gp.data, th_ratio, r)
    _, t_vg = _timed(lambda: tga.nll_profiled_value_and_grad(
        gp.spec, gp.data, th_ratio, r)[1].cpu())
    _, t_vg_full = _timed(lambda: tga.nll_value_and_grad_log_scale(
        gp.spec, gp.data, th_full, r)[1].cpu())
    _, t_fit = _timed(lambda: gp.fit(y, X=X))
    res_gd = gp._fit_result
    nll_gd, cp_gd = gp.get_current_neg_log_likelihood(), gp.get_cov_pars()
    _, t_lbfgs = _timed(lambda: gp.fit(y, X=X, params={
        "optimizer_cov": "lbfgs"}))
    res_lb = gp._fit_result
    cp_lb, nll_lb = gp.get_cov_pars(), gp.get_current_neg_log_likelihood()
    _, t_fisher = _timed(lambda: gp.fit(y, X=X, params={
        "optimizer_cov": "fisher_scoring"}))
    res_fs = gp._fit_result
    cp_fs, nll_fs = gp.get_cov_pars(), gp.get_current_neg_log_likelihood()
    (sd_cov, sd_coef), t_sd = _timed(lambda: (
        gp.get_cov_pars(std_err=True)[1], gp.get_coef(std_err=True)[1]))
    pred, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=ex["pred"], X_pred=ex["X_pred"], predict_var=True))
    pcov, t_pcov = _timed(lambda: gp.predict(
        gp_coords_pred=ex["pred"], X_pred=ex["X_pred"],
        predict_cov_mat=True))
    tre, t_tre = _timed(lambda: gp.predict_training_data_random_effects(
        predict_var=True))
    peak_gb = (torch.cuda.max_memory_allocated() - mem_start) / 1e9
    # the dense pieces at the fitted parameters: Psi's Cholesky, the
    # inverse of the gradient's backward, one Fisher information
    cp_t = gp._tensor(cp_lb)
    psi = tga.build_psi(gp.spec, gp.data, cp_t)
    chol_ms = time_ms(lambda: torch.linalg.cholesky(psi), 3)
    L = torch.linalg.cholesky(psi)
    del psi
    inv_ms = time_ms(lambda: torch.cholesky_inverse(L), 3)
    eye = torch.eye(EX_N, dtype=L.dtype, device=dev)
    solve_ms = time_ms(lambda: torch.cholesky_solve(eye, L), 2)
    del L, eye
    _, t_fi = _timed(lambda: gp._gauss_ops().fisher(cp_t).cpu())
    launches = read_counts()
    rel = np.abs(cp_lb - np.asarray(EX_TRUTH)) / np.asarray(EX_TRUTH)
    mu, var = pred["mu"], pred["var"]
    check(launches == NO_LAUNCHES, f"exact_gp launched: {launches}")
    check(all(math.isfinite(v) and v <= nll_init
              for v in (nll_gd, nll_lb, nll_fs)),
          f"an exact fit did not lower the NLL from {nll_init}: GD {nll_gd}, "
          f"L-BFGS {nll_lb}, Fisher {nll_fs}")
    check(bool(np.all(rel <= EX_TRUTH_RTOL)),
          f"exact L-BFGS cov_pars {cp_lb} not within {EX_TRUTH_RTOL} of the "
          f"truth {EX_TRUTH}: {rel}")
    check(mu.shape == (EX_N_PRED,) and bool(np.all(np.isfinite(mu))
                                            and np.all(var > 0)),
          "exact predictions not finite / variances not positive")
    check(bool(np.allclose(np.diag(pcov["cov"]), var, rtol=1e-10)
               and np.allclose(pcov["mu"], mu, rtol=1e-12, atol=1e-12)),
          "predict_cov_mat's diagonal is not predict_var's variance")
    check(tre.shape == (EX_N, 2) and bool(np.all(np.isfinite(tre))
                                          and np.all(tre[:, 1] > 0)),
          "training-data random effects not finite")
    check(bool(np.all(np.isfinite(sd_cov)) and np.all(sd_cov > 0)
               and np.all(np.isfinite(sd_coef))), "std errors not finite")
    emit({"phase": "exact_gp", "n": EX_N, "n_pred": EX_N_PRED,
          "cov_function": "matern 1.5", "truth": EX_TRUTH,
          "beta_truth": EX_BETA, "nll_init": nll_init,
          "gd": {"cov_pars": cp_gd.tolist(), "nll": nll_gd,
                 "iterations": res_gd.num_it,
                 "evaluations": res_gd.num_evals},
          "lbfgs": {"cov_pars": cp_lb.tolist(), "nll": nll_lb,
                    "iterations": res_lb.num_it,
                    "evaluations": res_lb.num_evals,
                    "rel_diff_truth": rel.tolist(),
                    "tolerance": EX_TRUTH_RTOL},
          "fisher_scoring": {"cov_pars": cp_fs.tolist(), "nll": nll_fs,
                             "iterations": res_fs.num_it},
          "coef": gp.get_coef().tolist(), "std_dev_cov_pars": sd_cov.tolist(),
          "std_dev_coef": sd_coef.tolist(), "launches": launches,
          "pred_var_range": [float(var.min()), float(var.max())],
          "peak_mem_gb": peak_gb, "mem_at_start_gb": mem_start / 1e9})
    timings = {"exact_construct_s": t_construct, "exact_nll_s": t_nll,
               "exact_vg_ms": 1e3 * t_vg, "exact_vg_full_ms": 1e3 * t_vg_full,
               "exact_fit_gd_s": t_fit,
               "exact_fit_gd_evaluations": res_gd.num_evals,
               "exact_fit_lbfgs_s": t_lbfgs,
               "exact_fit_lbfgs_evaluations": res_lb.num_evals,
               "exact_fit_fisher_s": t_fisher,
               "exact_fit_fisher_iterations": res_fs.num_it,
               "exact_std_err_s": t_sd, "exact_predict_s": t_pred,
               "exact_predict_cov_s": t_pcov,
               "exact_training_effects_s": t_tre,
               "exact_cholesky_ms": chol_ms, "exact_cholesky_inverse_ms": inv_ms,
               "exact_solve_n_columns_ms": solve_ms,
               "exact_fisher_information_s": t_fi,
               "exact_peak_mem_gb": peak_gb}
    del gp
    torch.cuda.empty_cache()
    return launches, timings


def exact_vs_cpu(ex, dev):
    """The exact GP on EX_CPU_N points, card against the float64 CPU run:
    NLL, its gradient (profiled and full) and the Fisher information,
    a prediction's mean and variance, each within EX_CPU_RTOL relative;
    then a Newton fit on the card (the Hessian of the NLL)."""
    from gpboost_tpu_torch.models import gaussian as tga
    rows = slice(0, EX_CPU_N)
    coords, y, X = ex["coords"][rows], ex["y"][rows], ex["X"][rows]
    fe = X @ np.asarray(EX_BETA)
    out = {}
    for name in ("cuda", "cpu"):
        m = _exact_model(coords, dev if name == "cuda" else "cpu")
        t0 = clock()
        nll = m.neg_log_likelihood(EX_TRUTH, y, fixed_effects=fe)
        r = m._tensor(y - fe)
        lp = m._tensor(np.log(EX_TRUTH))
        _, g_full = tga.nll_value_and_grad_log_scale(m.spec, m.data, lp, r)
        _, g_prof, _ = tga.nll_profiled_value_and_grad(
            m.spec, m.data, m._tensor(np.log([4.0, 0.1])), r)
        fi = m._gauss_ops().fisher(m._tensor(EX_TRUTH))
        pred = m.predict(y=y, gp_coords_pred=ex["pred"][:200],
                         cov_pars=EX_TRUTH, fixed_effects=fe,
                         predict_var=True)
        out[name] = dict(nll=nll, g_full=g_full.cpu().numpy(),
                         g_prof=g_prof.cpu().numpy(), fi=fi.cpu().numpy(),
                         mu=pred["mu"], var=pred["var"], s=clock() - t0)
    a, b = out["cuda"], out["cpu"]

    def rel(key):
        return float(np.max(np.abs(np.asarray(a[key]) - np.asarray(b[key])))
                     / np.max(np.abs(np.asarray(b[key]))))

    diffs = {k: rel(k) for k in ("nll", "g_full", "g_prof", "fi", "mu",
                                 "var")}
    m = _exact_model(coords, dev)
    _, t_newton = _timed(lambda: m.fit(y, params={"optimizer_cov": "newton"}))
    nll_newton = m.get_current_neg_log_likelihood()
    nll_init = m.neg_log_likelihood(m._default_init_cov_pars(y), y)
    emit({"phase": "exact_vs_cpu", "n": EX_CPU_N, "rel_diff": diffs,
          "tolerance": EX_CPU_RTOL, "cuda_s": a["s"], "cpu_s": b["s"],
          "newton": {"cov_pars": m.get_cov_pars().tolist(),
                     "nll": nll_newton, "nll_init": nll_init,
                     "iterations": m.num_it_, "seconds": t_newton}})
    check(all(v <= EX_CPU_RTOL for v in diffs.values()),
          f"exact GP on the card vs the CPU: {diffs}")
    check(math.isfinite(nll_newton) and nll_newton <= nll_init,
          f"the Newton fit did not lower the NLL: {nll_init} -> "
          f"{nll_newton}")
    return {"exact_newton_fit_s": t_newton,
            "exact_newton_iterations": m.num_it_}


def make_clustered_data(seed, dev, n_pred):
    """EX_CLUSTERS independent replications of the Matern-1.5 GP, each on
    EX_CLUSTER_SIZE points of its own in the unit square, plus the nugget;
    prediction points in training clusters and (EX_UNSEEN of them) in
    clusters training never saw."""
    rng = np.random.default_rng(seed + 40)
    C, m = EX_CLUSTERS, EX_CLUSTER_SIZE
    coords = rng.uniform(size=(C, m, 2))
    ct = torch.as_tensor(coords, device=dev)
    diff = ct[:, :, None, :] - ct[:, None, :, :]
    x = math.sqrt(3.0) * torch.sqrt(torch.sum(diff * diff, -1)) / EX_TRUTH[2]
    cov = EX_TRUTH[1] * (1.0 + x) * torch.exp(-x)
    cov.diagonal(dim1=1, dim2=2).add_(1e-8)
    z = torch.as_tensor(rng.standard_normal((C, m, 1)), device=dev)
    b = (torch.linalg.cholesky(cov) @ z)[..., 0].cpu().numpy().ravel()
    del cov
    ids = np.repeat(np.arange(C) * 7 + 3, m)      # ids, not codes
    y = b + math.sqrt(EX_TRUTH[0]) * rng.standard_normal(C * m)
    unseen = rng.random(n_pred) < EX_UNSEEN
    ids_pred = np.where(unseen, 7 * C + 5 + rng.integers(0, 50, n_pred),
                        ids[rng.integers(0, C * m, n_pred)])
    return dict(coords=coords.reshape(-1, 2), y=y, ids=ids,
                pred=rng.uniform(size=(n_pred, 2)), ids_pred=ids_pred,
                unseen=unseen)


def exact_clustered(cd, dev):
    """``cluster_ids`` on the batched-block route (EX_CLUSTERS blocks of
    EX_CLUSTER_SIZE, n = 1e5): construct, the default fit, ``predict`` with
    variances; the rows in unseen clusters must be the prior (mean 0,
    variance nugget + GP variance)."""
    reset_counts()
    gp, t_construct = _timed(lambda: _exact_model(
        cd["coords"], dev, cluster_ids=cd["ids"]))
    check(gp._clustered_batched, "cluster_ids model is not batched")
    _, t_fit = _timed(lambda: gp.fit(cd["y"]))
    res = gp._fit_result
    nll_init = gp.neg_log_likelihood(gp._default_init_cov_pars(cd["y"]),
                                     cd["y"])
    pred, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=cd["pred"], cluster_ids_pred=cd["ids_pred"],
        predict_var=True))
    launches = read_counts()
    cp = gp.get_cov_pars()
    mu, var = pred["mu"], pred["var"]
    u = cd["unseen"]
    prior = cp[0] + cp[1]
    check(launches == NO_LAUNCHES, f"exact_clustered launched: {launches}")
    check(math.isfinite(gp.get_current_neg_log_likelihood())
          and gp.get_current_neg_log_likelihood() <= nll_init,
          "the clustered fit did not lower the NLL")
    check(bool(np.all(mu[u] == 0.0)
               and np.allclose(var[u], prior, rtol=1e-14, atol=0)),
          "predictions in unseen clusters are not the prior")
    check(bool(np.all(np.isfinite(mu)) and np.all(var[~u] > cp[0])
               and np.all(var[~u] < prior)),
          "clustered predictions not finite / not between nugget and prior")
    emit({"phase": "exact_clustered", "n": len(cd["y"]),
          "clusters": EX_CLUSTERS, "cluster_size": EX_CLUSTER_SIZE,
          "truth": EX_TRUTH, "cov_pars": cp.tolist(),
          "nll": gp.get_current_neg_log_likelihood(), "nll_init": nll_init,
          "iterations": res.num_it, "evaluations": res.num_evals,
          "n_pred": len(mu), "unseen_rows": int(u.sum()),
          "launches": launches})
    timings = {"clustered_construct_s": t_construct,
               "clustered_fit_s": t_fit,
               "clustered_fit_evaluations": res.num_evals,
               "clustered_predict_s": t_pred}
    return timings, gp


def exact_combined(seed, dev, n_pred):
    """An exact GP plus a EX_LEVELS-level random intercept, and a GP random
    coefficient, each at n = EX_SMALL_N: the default fit and ``predict``
    with variances (unseen levels included)."""
    rng = np.random.default_rng(seed + 50)
    n = EX_SMALL_N
    coords = rng.uniform(size=(n, 2))
    ct = torch.as_tensor(coords, device=dev)
    b_gp = _simulate_gp(ct, EX_TRUTH[1], EX_TRUTH[2], torch.as_tensor(
        rng.standard_normal(n), device=dev)).cpu().numpy()
    g = rng.integers(0, EX_LEVELS, n)
    y_g = b_gp + 0.5 * rng.standard_normal(EX_LEVELS)[g] \
        + math.sqrt(EX_TRUTH[0]) * rng.standard_normal(n)
    zc = rng.standard_normal(n)
    b_rc = _simulate_gp(ct, 0.5, EX_TRUTH[2], torch.as_tensor(
        rng.standard_normal(n), device=dev)).cpu().numpy()
    y_rc = b_gp + zc * b_rc + math.sqrt(EX_TRUTH[0]) * rng.standard_normal(n)
    pred = rng.uniform(size=(n_pred, 2))
    g_pred = np.where(rng.random(n_pred) < EX_UNSEEN, EX_LEVELS + 1,
                      rng.integers(0, EX_LEVELS, n_pred))
    reset_counts()
    out, timings = {}, {}
    for tag, kw, y, pkw in (
            ("grouped", dict(group_data=g), y_g,
             dict(group_data_pred=g_pred)),
            ("rand_coef", dict(gp_rand_coef_data=zc), y_rc,
             dict(gp_rand_coef_data_pred=rng.standard_normal(n_pred)))):
        gp = _exact_model(coords, dev, **kw)
        nll_init = gp.neg_log_likelihood(gp._default_init_cov_pars(y), y)
        _, t_fit = _timed(lambda: gp.fit(y))
        pred_out, t_pred = _timed(lambda: gp.predict(
            gp_coords_pred=pred, predict_var=True, **pkw))
        nll = gp.get_current_neg_log_likelihood()
        check(math.isfinite(nll) and nll <= nll_init,
              f"combined {tag}: the fit did not lower the NLL")
        check(bool(np.all(np.isfinite(pred_out["mu"]))
                   and np.all(pred_out["var"] > 0)),
              f"combined {tag}: predictions not finite / positive")
        out[tag] = {"cov_pars": gp.get_cov_pars().tolist(), "nll": nll,
                    "nll_init": nll_init,
                    "iterations": gp._fit_result.num_it,
                    "evaluations": gp._fit_result.num_evals,
                    "names": gp._cov_par_names()}
        timings[f"combined_{tag}_fit_s"] = t_fit
        timings[f"combined_{tag}_predict_s"] = t_pred
        del gp
    launches = read_counts()
    check(launches == NO_LAUNCHES, f"exact_combined launched: {launches}")
    emit({"phase": "exact_combined", "n": n, "levels": EX_LEVELS,
          "n_pred": n_pred, **out})
    return timings


def exact_laplace(ex, dev):
    """A ``bernoulli_logit`` exact GP (Matern 1.5) at n = EX_SMALL_N on the
    first points of the exact data, latent = its GP draw: NLL, one
    value-and-gradient, the default fit (L-BFGS), a response-scale
    ``predict``; the NLL and gradient on the card against the float64 CPU
    run at EX_LAP_CPU_N points within EX_CPU_RTOL."""
    from gpboost_tpu_torch.models import laplace as tla
    rows = slice(0, EX_SMALL_N)
    coords = ex["coords"][rows]
    rng = np.random.default_rng(31)
    yb = rng.binomial(1, 1.0 / (1.0 + np.exp(-ex["b"][rows]))).astype(float)
    reset_counts()
    gp, t_construct = _timed(lambda: _exact_model(
        coords, dev, likelihood="bernoulli_logit"))
    init = gp._default_init_cov_pars(yb)
    nll_init, t_nll = _timed(lambda: gp.neg_log_likelihood(init, yb))
    ybt = gp._tensor(yb)
    _, t_vg = _timed(lambda: tla.nll_value_and_grad(
        gp.spec, gp.data, gp._tensor(init), None, ybt)[1][0].cpu())
    _, t_fit = _timed(lambda: gp.fit(yb))
    res = gp._fit_result
    pred, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=ex["pred"], predict_var=True, predict_response=True))
    launches = read_counts()
    nll_fit = gp.get_current_neg_log_likelihood()
    mu, var = pred["mu"], pred["var"]
    cpu = {}
    for name in ("cuda", "cpu"):
        m = _exact_model(coords[:EX_LAP_CPU_N], dev if name == "cuda"
                         else "cpu", likelihood="bernoulli_logit")
        v, (g, _, _) = tla.nll_value_and_grad(
            m.spec, m.data, m._tensor([1.0, 0.1]), None,
            m._tensor(yb[:EX_LAP_CPU_N]))
        cpu[name] = (float(v), g.cpu().numpy())
    nll_rel = abs(cpu["cuda"][0] - cpu["cpu"][0]) / abs(cpu["cpu"][0])
    g_rel = float(np.max(np.abs(cpu["cuda"][1] - cpu["cpu"][1]))
                  / np.max(np.abs(cpu["cpu"][1])))
    check(launches == NO_LAUNCHES, f"exact_laplace launched: {launches}")
    check(math.isfinite(nll_fit) and nll_fit <= nll_init,
          f"the exact Laplace fit did not lower the NLL: {nll_init} -> "
          f"{nll_fit}")
    check(bool(np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                       & (var <= 0.25))),
          "exact Laplace predictions outside (0, 1) / (0, 0.25]")
    check(nll_rel <= EX_CPU_RTOL and g_rel <= EX_CPU_RTOL,
          f"exact Laplace NLL on the card vs the CPU: {nll_rel}, gradient "
          f"{g_rel}")
    emit({"phase": "exact_laplace", "n": EX_SMALL_N,
          "likelihood": "bernoulli_logit", "nll_init": nll_init,
          "nll_fit": nll_fit, "cov_pars": gp.get_cov_pars().tolist(),
          "iterations": res.num_it, "evaluations": res.num_evals,
          "cpu_check": {"n": EX_LAP_CPU_N, "nll_rel_diff": nll_rel,
                        "grad_max_rel_diff": g_rel,
                        "tolerance": EX_CPU_RTOL},
          "pred_mu_range": [float(mu.min()), float(mu.max())],
          "launches": launches})
    del gp
    return {"laplace_construct_s": t_construct, "laplace_nll_s": t_nll,
            "laplace_vg_s": t_vg, "laplace_fit_s": t_fit,
            "laplace_fit_evaluations": res.num_evals,
            "laplace_predict_s": t_pred}


def _boost_checks(bst, tag, launches, reads, rounds):
    leaves = sum(t.num_leaves for t in bst.trees)
    fits = bst.objective.fits
    check(bst.num_trees() == rounds, f"{tag}: {bst.num_trees()} trees")
    _check_trees(bst, tag)
    want_launches, want_reads = grower_counts(bst.trees,
                                              bst.grower.num_leaves)
    check(launches["histogram"] == want_launches,
          f"{tag}: histogram launched {launches['histogram']} times for "
          f"{leaves} leaves, {want_launches} expected")
    check(reads == want_reads, f"{tag}: {reads} grower host reads for "
          f"{leaves} leaves, {want_reads} expected")
    check(launches["vecchia_factors"] == launches["vecchia_nll_grad"] == 0,
          f"{tag} launched a Vecchia kernel: {launches}")
    check(len(fits) == rounds + 1, f"{tag}: {len(fits)} refits in {rounds} "
          "rounds")
    nlls = [f["nll"] for f in fits]
    check(all(math.isfinite(v) for v in nlls), f"{tag}: NLLs {nlls}")
    return {"leaves": leaves, "fits": len(fits),
            "evaluations": sum(f["num_evals"] for f in fits),
            "nll_first_fit": nlls[0], "nll_last_fit": nlls[-1],
            "launches": launches, "host_reads_per_tree": reads / rounds}


def make_exact_boost_data(seed, n, n_pred):
    """The boosting recipe (PERF.md section 4) at n points: the GP data's
    coordinates and response plus f(X) on 5 features; a binary response
    from the same latent for LaGaBoost."""
    coords, y, pred = make_data(seed, n, n_pred)
    X, yb, X_pred = make_boost_data(seed, y, n_pred)
    rng = np.random.default_rng(seed + 60)
    f = 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]
    lat = f - f.mean() + np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    ybin = rng.binomial(1, 1.0 / (1.0 + np.exp(-lat))).astype(float)
    return dict(coords=coords, pred=pred, X=X, y=yb, X_pred=X_pred,
                ybin=ybin, seed=seed)


def _exact_boost_gp(coords, dev, likelihood="gaussian"):
    import gpboost_tpu_torch as gpt
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       likelihood=likelihood, device=dev)


def exact_boosting(bd, rounds, dev, binary=False):
    """The GPBoost algorithm (``binary``: LaGaBoost, objective "binary",
    ``bernoulli_logit``) with the exact GP (exponential) in the Vecchia
    GP's place, ``rounds`` rounds, the default optimizer, then
    ``Booster.predict`` with variances. The histogram kernel once a leaf,
    the Vecchia kernels never."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    tag = "exact_lagaboost" if binary else "exact_boosting"
    reset_counts()
    label = bd["ybin"] if binary else bd["y"]
    ds = gpt.Dataset(bd["X"], label=label, device=dev)
    gp = _exact_boost_gp(bd["coords"], dev,
                         "bernoulli_logit" if binary else "gaussian")
    params = NG_PARAMS if binary else BOOST_PARAMS
    bst, t_train = _timed(lambda: gpt.train(params, ds, gp_model=gp,
                                            num_boost_round=rounds))
    launches = read_counts()
    reads = grow_tree.host_reads
    out, t_pred = _timed(lambda: bst.predict(
        bd["X_pred"], gp_coords_pred=bd["pred"], predict_var=True))
    entry = _boost_checks(bst, tag, launches, reads, rounds)
    # the kernel against its plain version at this path's shape (after
    # the path's counts are read: these launches are not the path's)
    hist = check_histogram_on(ds, bd["seed"], dev, tag)
    mu, var = out["response_mean"], out["response_var"]
    ok_mu = (np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                    & (var <= VAR_TOP))
             if binary else np.all(np.isfinite(mu)) and np.all(var > 0))
    check(mu.shape == (len(bd["pred"]),) and bool(ok_mu),
          f"{tag}: predictions out of range")
    emit({"phase": tag, "n": len(label), "rounds": rounds,
          "cov_pars": gp.get_cov_pars().tolist(), **entry,
          "pred_mu_range": [float(mu.min()), float(mu.max())]})
    return (launches, {f"{tag}_train_{rounds}r_s": t_train,
                       f"{tag}_evaluations": entry["evaluations"],
                       f"{tag}_predict_s": t_pred}, bst, hist)


def grouped_lagaboost(seed, n, n_pred, rounds, dev):
    """LaGaBoost with a grouped random intercept (GB_LEVELS levels) at the
    grouped GPBoost recipe's size: a binary response from its features and
    levels, ``train({"objective": "binary"}, ..., gp_model=GPModel(
    group_data=..., likelihood="bernoulli_logit"))`` for ``rounds`` rounds,
    then ``Booster.predict`` (10 % unseen levels). Its gradient d NLL / dF
    runs in b-space; the histogram kernel once a leaf."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    bd = _grouped_boost_data(seed, n, n_pred)
    rng = np.random.default_rng(seed + 21)
    f = 2.0 * np.sin(5 * bd["X"][:, 0]) + bd["X"][:, 1] ** 2 + bd["X"][:, 2]
    lat = f - f.mean() + 0.7 * rng.standard_normal(GB_LEVELS)[bd["g"]]
    bd["ybin"] = rng.binomial(1, 1.0 / (1.0 + np.exp(-lat))).astype(float)
    reset_counts()
    ds = gpt.Dataset(bd["X"], label=bd["ybin"], device=dev)
    gp = gpt.GPModel(group_data=bd["g"], likelihood="bernoulli_logit",
                     device=dev)
    bst, t_train = _timed(lambda: gpt.train(NG_PARAMS, ds, gp_model=gp,
                                            num_boost_round=rounds))
    launches = read_counts()
    reads = grow_tree.host_reads
    out, t_pred = _timed(lambda: bst.predict(
        bd["X_pred"], group_data_pred=bd["group_pred"], predict_var=True))
    entry = _boost_checks(bst, "grouped_lagaboost", launches, reads, rounds)
    hist = check_histogram_on(ds, seed, dev, "grouped_lagaboost")
    mu, var = out["response_mean"], out["response_var"]
    check(bool(np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                       & (var <= VAR_TOP))),
          "grouped_lagaboost: predictions out of range")
    emit({"phase": "grouped_lagaboost", "n": n, "levels": GB_LEVELS,
          "rounds": rounds, "cov_pars": gp.get_cov_pars().tolist(), **entry,
          "pred_mu_range": [float(mu.min()), float(mu.max())]})
    return (launches, {f"grouped_lagaboost_train_{rounds}r_s": t_train,
                       "grouped_lagaboost_evaluations": entry["evaluations"],
                       "grouped_lagaboost_predict_s": t_pred}, bst, bd,
            hist)


def exact_determinism(ex_boost, ex_laga, g_laga, clustered, dev):
    """Second runs of the new paths, each the same bits as the first: the
    exact GPBoost and LaGaBoost trainings, the grouped LaGaBoost training
    (scores, cov_pars, evaluation counts) and the clustered fit (cov_pars,
    NLL)."""
    import gpboost_tpu_torch as gpt
    out = {}
    for tag, (first, data, binary) in (("exact_boosting", ex_boost),
                                       ("exact_lagaboost", ex_laga),
                                       ("grouped_lagaboost", g_laga)):
        if tag == "grouped_lagaboost":
            gp = gpt.GPModel(group_data=data["g"],
                             likelihood="bernoulli_logit", device=dev)
            label = data["ybin"]
        else:
            gp = _exact_boost_gp(data["coords"], dev,
                                 "bernoulli_logit" if binary else "gaussian")
            label = data["ybin"] if binary else data["y"]
        bst = gpt.train(NG_PARAMS if binary else BOOST_PARAMS,
                        gpt.Dataset(data["X"], label=label, device=dev),
                        gp_model=gp, num_boost_round=first.num_trees())
        ev = ([f["num_evals"] for f in first.objective.fits],
              [f["num_evals"] for f in bst.objective.fits])
        out[tag] = {
            "scores_bit_identical": bool(np.array_equal(first._score,
                                                        bst._score)),
            "cov_pars_bit_identical": bool(np.array_equal(
                first.gp_model.get_cov_pars(), gp.get_cov_pars())),
            "evaluations_identical": bool(ev[0] == ev[1]),
            "score_max_abs_diff": float(np.abs(first._score
                                               - bst._score).max()),
            "evaluations": [sum(ev[0]), sum(ev[1])]}
        del bst, gp
    first_gp, cd = clustered
    gp2 = _exact_model(cd["coords"], dev, cluster_ids=cd["ids"])
    gp2.fit(cd["y"])
    out["clustered_fit"] = {
        "cov_pars_bit_identical": bool(np.array_equal(
            first_gp.get_cov_pars(), gp2.get_cov_pars())),
        "nll_bit_identical": bool(
            first_gp.get_current_neg_log_likelihood()
            == gp2.get_current_neg_log_likelihood()),
        "evaluations": [first_gp._fit_result.num_evals,
                        gp2._fit_result.num_evals]}
    emit({"phase": "determinism_exact", **out})
    ok = all(v["scores_bit_identical"] and v["cov_pars_bit_identical"]
             and v["evaluations_identical"]
             for k, v in out.items() if k != "clustered_fit")
    c = out["clustered_fit"]
    ok = ok and c["cov_pars_bit_identical"] and c["nll_bit_identical"] \
        and c["evaluations"][0] == c["evaluations"][1]
    check(ok, f"the new paths are not bit-reproducible on the card: {out}")
    return out


def exact_ops_trace(ex, clustered_gp, dev):
    """The exact value-and-gradient (profiled and full, dense) and the
    clustered one on the card under the profiler (its CPU side): no
    operation that adds with colliding indices."""
    from torch.profiler import ProfilerActivity, profile
    from gpboost_tpu_torch.models import clustered as tcl
    from gpboost_tpu_torch.models import gaussian as tga
    rows = slice(0, EX_CPU_N)
    m = _exact_model(ex["coords"][rows], dev)
    r = m._tensor(ex["y"][rows] - ex["X"][rows] @ np.asarray(EX_BETA))
    rc = clustered_gp._tensor(np.random.default_rng(2).standard_normal(
        clustered_gp.num_data))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tga.nll_profiled_value_and_grad(m.spec, m.data,
                                        m._tensor(np.log([4.0, 0.1])), r)
        tga.nll_value_and_grad_log_scale(m.spec, m.data,
                                         m._tensor(np.log(EX_TRUTH)), r)
        tcl.nll_profiled_value_and_grad(
            clustered_gp.cov_fn, clustered_gp._tensor(np.log([4.0, 0.1])),
            clustered_gp._blocks, rc)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    emit({"phase": "exact_ops_trace", "ops": names, "scatters": bad})
    check(any("cholesky" in x for x in names), f"empty trace: {names}")
    check(not bad, f"the exact value-and-gradient scatters: {bad}")
    return names


def exact_paths(seed, n, n_pred, rounds, dev):
    """Phase 8 in order; returns (launches by path, timings, the first runs
    that ``exact_determinism`` repeats)."""
    timings = {}
    ex = make_exact_data(seed, EX_N, EX_N_PRED, dev)
    l_gp, t = exact_gp(ex, dev)
    timings.update(t)
    timings.update(exact_vs_cpu(ex, dev))
    cd = make_clustered_data(seed, dev, n_pred)
    t, cl_gp = exact_clustered(cd, dev)
    timings.update(t)
    timings.update(exact_combined(seed, dev, EX_N_PRED))
    timings.update(exact_laplace(ex, dev))
    bd = make_exact_boost_data(seed, EX_SMALL_N, EX_N_PRED)
    l_b, t, bst_b, h_b = exact_boosting(bd, rounds, dev)
    timings.update(t)
    l_l, t, bst_l, h_l = exact_boosting(bd, rounds, dev, binary=True)
    timings.update(t)
    l_g, t, bst_g, gbd, h_g = grouped_lagaboost(seed, n, n_pred, rounds, dev)
    timings.update(t)
    launches = {"exact_gp": l_gp, "exact_boosting": l_b,
                "exact_lagaboost": l_l, "grouped_lagaboost": l_g}
    firsts = dict(ex_boost=(bst_b, bd, False), ex_laga=(bst_l, bd, True),
                  g_laga=(bst_g, gbd, True), clustered=(cl_gp, cd), ex=ex)
    hist = ([c for cases, _ in (h_b, h_l, h_g) for c in cases],
            [shape for _, shape in (h_b, h_l, h_g)])
    return launches, timings, firsts, hist


# ---------------------------------------------------------------------------
# phase 9: the low-rank and full-scale approximations (fitc,
# full_scale_tapering, full_scale_vecchia; Gaussian and Laplace; cluster_ids;
# GPBoost and LaGaBoost with them)
# ---------------------------------------------------------------------------

LR_K = 500                        # num_ind_points, the package default
LR_M = 30                         # FSVA neighbours, the package default
LR_INIT = [0.25, 1.0, 0.1]        # the boosting recipe's inits
LR_CPU_N = 2_000                  # points of the card-vs-CPU checks
LR_CPU_N_PRED = 200
LR_CPU_RTOL = 1e-9
LR_NSIM = 100                     # the second prediction's nsim_var_pred
LR_EXACT_VAR_POINTS = 500         # FSVA points with exact variances
FSA_N = 10_000                    # Psi is dense [n, n]: the exact GP's top
FSA_TAPER = 0.1
LRC_CLUSTERS, LRC_SIZE, LRC_K = 100, 1_000, 50
LRC_UNSEEN = 0.1
LR_NG_MAXIT = 1                   # depth cut of the FSVA-Laplace fit
LR_NG_VAR_POINTS = 128            # prediction points with Laplace variances
#                                   (depth cut: 256 until phase 16)
LR_FSVA_ROUNDS = 5                # depth cut of fsva_boosting (recipe: 30;
#                                   10 until phase 15 took the script past
#                                   its 1 200 s)


def _lowrank_model(coords, approx, dev, **kw):
    import gpboost_tpu_torch as gpt
    if approx.startswith("full_scale_vecchia"):
        kw.setdefault("num_neighbors", LR_M)
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       gp_approx=approx, device=dev, **kw)


def lowrank_gp(coords, y, pred, approx, dev):
    """A FITC (``approx="fitc"``) or full-scale Vecchia GP through the public
    API at the main path's size, float64, the package's defaults
    (num_ind_points = LR_K, kmeans++; FSVA m = LR_M): inducing-point
    selection (timed apart), construct, NLL, a value-and-gradient, the
    default fit (gradient descent) and an L-BFGS one, prediction with
    variances at the prediction points (FSVA: simulated, the package's
    rule at this size, and with nsim_var_pred = LR_NSIM); FSVA's peak
    memory above what earlier phases hold. No kernel launches."""
    from gpboost_tpu_torch.ops.inducing import select_inducing_points
    tag = "fitc" if approx == "fitc" else "fsva"
    torch.cuda.empty_cache()
    mem_start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    _, t_ind = _timed(lambda: select_inducing_points(coords, LR_K,
                                                     "kmeans++", 0,
                                                     device=dev))
    gp, t_construct = _timed(lambda: _lowrank_model(coords, approx, dev))
    init = gp._default_init_cov_pars(y)
    nll0, t_nll = _timed(lambda: gp.neg_log_likelihood(init, y))
    th = torch.log(gp._tensor(init))
    y_t = gp._tensor(y)
    gp._approx._vg_gaussian(th, y_t, None)
    _, t_vg = _timed(lambda: gp._approx._vg_gaussian(th, y_t, None))
    _, t_gd = _timed(lambda: gp.fit(y))
    res_gd, nll_gd, cp_gd = gp._fit_result, gp.current_nll_, gp.cov_pars_
    _, t_lb = _timed(lambda: gp.fit(y, params={"optimizer_cov": "lbfgs"}))
    res_lb = gp._fit_result
    check(nll_gd <= nll0 and gp.current_nll_ <= nll0,
          f"{tag}: fitted NLLs {nll_gd}, {gp.current_nll_} above the one at "
          f"the inits {nll0}")
    out, t_pred = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                            predict_var=True))
    mu, var = out["mu"], out["var"]
    # FSVA's variances at this size are simulated (clamped at 0)
    check(mu.shape == (len(pred),) and bool(np.all(np.isfinite(mu))
                                            and np.all(np.isfinite(var))
                                            and np.all(var >= 0)),
          f"{tag}: predictions not finite / variances negative: "
          f"{np.isfinite(mu).all()}, {var.min()}")
    timings = {f"{tag}_inducing_points_s": t_ind,
               f"{tag}_construct_s": t_construct, f"{tag}_nll_s": t_nll,
               f"{tag}_vg_s": t_vg, f"{tag}_fit_gd_s": t_gd,
               f"{tag}_fit_gd_evaluations": res_gd.num_evals,
               f"{tag}_fit_lbfgs_s": t_lb,
               f"{tag}_fit_lbfgs_evaluations": res_lb.num_evals,
               f"{tag}_predict_s": t_pred}
    entry = {"phase": f"{tag}_gp", "n": len(y), "k": LR_K,
             "n_pred": len(pred), "nll_at_inits": nll0,
             "fit_gd": {"cov_pars": np.asarray(cp_gd).tolist(),
                        "nll": nll_gd, "iterations": res_gd.num_it,
                        "evaluations": res_gd.num_evals},
             "fit_lbfgs": {"cov_pars": gp.get_cov_pars().tolist(),
                           "nll": gp.current_nll_,
                           "iterations": res_lb.num_it,
                           "evaluations": res_lb.num_evals},
             "pred_var_range": [float(var.min()), float(var.max())]}
    if tag == "fsva":
        gp.set_prediction_data(nsim_var_pred=LR_NSIM)
        out2, t_pred2 = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                                  predict_var=True))
        gp.nsim_var_pred = None
        check(bool(np.array_equal(out2["mu"], mu) and np.all(
            out2["var"] >= 0)), "fsva: the simulated means moved")
        timings[f"fsva_predict_nsim{LR_NSIM}_s"] = t_pred2
        # the exact variances at the first LR_EXACT_VAR_POINTS points (few
        # enough for the package's exact route) against the simulated ones
        ex, t_ex = _timed(lambda: gp.predict(
            gp_coords_pred=pred[:LR_EXACT_VAR_POINTS], predict_var=True))
        timings[f"fsva_predict_exact_var_{LR_EXACT_VAR_POINTS}_s"] = t_ex
        sl = slice(0, LR_EXACT_VAR_POINTS)
        check(bool(np.allclose(ex["mu"], mu[sl], rtol=1e-9, atol=1e-12)
                   and np.all(ex["var"] > 0)),
              "fsva: the exact route's means differ from the simulated "
              "route's, or its variances are not positive")
        entry["sim_var_vs_exact"] = {
            f"nsim{n_s}": {"mean_abs_err": float(np.mean(np.abs(
                v[sl] - ex["var"]))), "max_rel_err": float(np.max(np.abs(
                    v[sl] - ex["var"]) / ex["var"])),
                "clamped_at_0": int(np.sum(v == 0.0))}
            for n_s, v in ((1000, var), (LR_NSIM, out2["var"]))}
        timings["fsva_peak_mem_gb"] = (torch.cuda.max_memory_allocated()
                                       - mem_start) / 1e9
        entry["peak_mem_gb_above_start"] = timings["fsva_peak_mem_gb"]
    launches = read_counts()
    check(all(v == 0 for v in launches.values()),
          f"{tag}: a kernel launched on the low-rank path: {launches}")
    entry["launches"] = launches
    emit(entry)
    return launches, timings, gp


def lowrank_vs_cpu(coords, y, pred, dev):
    """FITC, full-scale tapering and FSVA on the card against the float64
    CPU run at the first LR_CPU_N points, on the card's inducing points and
    (FSVA) structure: NLL, gradient, prediction mean and variance within
    LR_CPU_RTOL relative; the inducing-point selection of the two devices
    side by side."""
    rows = slice(0, LR_CPU_N)
    c, yy, pp = coords[rows], y[rows], pred[:LR_CPU_N_PRED]
    cp = np.asarray(LR_INIT)
    out = {}
    for approx, kw in (("fitc", {}),
                       ("full_scale_tapering",
                        {"cov_fct_taper_range": FSA_TAPER}),
                       ("full_scale_vecchia", {})):
        g, h = (_lowrank_model(c, approx, d, **kw)
                for d in (dev, torch.device("cpu")))
        ind_diff = float((g._approx.ind_points.cpu()
                          - h._approx.ind_points).abs().max())
        h._approx.ind_points = g._approx.ind_points.cpu()
        if approx == "full_scale_vecchia":
            h._approx.load_structure(g._approx.perm,
                                     g._approx.neighbors.cpu().numpy())
        res = []
        for m in (g, h):
            _, grad = m._approx._vg_gaussian(torch.log(m._tensor(cp)),
                                             m._tensor(yy), None)
            pr = m.predict(y=yy, gp_coords_pred=pp, cov_pars=cp,
                           predict_var=True)
            res.append((m.neg_log_likelihood(cp, yy),
                        grad.cpu().numpy(), pr["mu"], pr["var"]))

        def rel(i):
            a, b = np.asarray(res[0][i]), np.asarray(res[1][i])
            return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)),
                                                     1e-300))
        diffs = {"nll": rel(0), "grad": rel(1), "mu": rel(2), "var": rel(3),
                 "inducing_points_max_abs_diff": ind_diff}
        out[approx] = diffs
        check(all(v <= LR_CPU_RTOL for k, v in diffs.items()
                  if k != "inducing_points_max_abs_diff"),
              f"{approx}: the card differs from the CPU run: {diffs}")
    emit({"phase": "lowrank_vs_cpu", "n": LR_CPU_N, "rel_diff": out,
          "tolerance": LR_CPU_RTOL})


def fsa_gp(coords, y, pred, dev):
    """Full-scale tapering (the Cholesky route, dense Psi) at the first
    FSA_N points, taper range FSA_TAPER, k = LR_K: construct, NLL, an
    L-BFGS fit, prediction with (simulated, the package's rule at this
    size) variances."""
    rows = slice(0, FSA_N)
    c, yy = coords[rows], y[rows]
    reset_counts()
    gp, t_construct = _timed(lambda: _lowrank_model(
        c, "full_scale_tapering", dev, cov_fct_taper_range=FSA_TAPER))
    nll0, t_nll = _timed(lambda: gp.neg_log_likelihood(
        gp._default_init_cov_pars(yy), yy))
    _, t_fit = _timed(lambda: gp.fit(yy, params={"optimizer_cov": "lbfgs"}))
    check(gp.current_nll_ <= nll0, f"fsa: fitted NLL {gp.current_nll_} "
          f"above the one at the inits {nll0}")
    out, t_pred = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                            predict_var=True))
    # simulated at this size (clamped at 0); exact at the first points
    ex, t_ex = _timed(lambda: gp.predict(
        gp_coords_pred=pred[:LR_EXACT_VAR_POINTS], predict_var=True))
    sl = slice(0, LR_EXACT_VAR_POINTS)
    check(bool(np.all(np.isfinite(out["mu"])) and np.all(out["var"] >= 0)
               and np.all(ex["var"] > 0)
               and np.allclose(ex["mu"], out["mu"][sl], rtol=1e-9,
                               atol=1e-12)),
          "fsa: predictions not finite / variances negative / the exact "
          "route's means differ")
    launches = read_counts()
    check(all(v == 0 for v in launches.values()),
          f"fsa: a kernel launched: {launches}")
    emit({"phase": "fsa_gp", "n": FSA_N, "k": LR_K, "taper_range": FSA_TAPER,
          "nll_at_inits": nll0, "cov_pars": gp.get_cov_pars().tolist(),
          "nll": gp.current_nll_, "evaluations": gp._fit_result.num_evals,
          "sim_var_vs_exact": {
              "mean_abs_err": float(np.mean(np.abs(out["var"][sl]
                                                   - ex["var"]))),
              "max_rel_err": float(np.max(np.abs(out["var"][sl] - ex["var"])
                                          / ex["var"])),
              "clamped_at_0": int(np.sum(out["var"] == 0.0))},
          "launches": launches})
    return {"fsa_construct_s": t_construct, "fsa_nll_s": t_nll,
            "fsa_fit_lbfgs_s": t_fit,
            "fsa_fit_lbfgs_evaluations": gp._fit_result.num_evals,
            "fsa_predict_s": t_pred,
            f"fsa_predict_exact_var_{LR_EXACT_VAR_POINTS}_s": t_ex}


def fsva_laplace(ng, dev):
    """``bernoulli_logit`` with FSVA (m = LR_M, k = LR_K), iterative, at the
    non-Gaussian recipe's size: one value-and-gradient at the fit's
    settings with its breakdown (mode, the k-column CG of the exact
    log-determinant term, Lanczos, gradient CG), an L-BFGS fit cut to
    LR_NG_MAXIT iterations, prediction: latent means at every prediction
    point, response mean and variance at the first LR_NG_VAR_POINTS."""
    from gpboost_tpu_torch.models.fsva_model import FSVA_COUNTS
    from gpboost_tpu_torch.utils import timer
    reset_counts()
    gp, t_construct = _timed(lambda: _lowrank_model(
        ng["coords"], "full_scale_vecchia", dev,
        likelihood="bernoulli_logit", matrix_inversion_method="iterative"))
    kw = gp._iter_kwargs(fit=True)
    y_t = gp._tensor(ng["yb"])
    th = torch.log(gp._tensor(NG_COV_PARS)).requires_grad_(True)
    timer.clear()
    timer.enable(True)
    FSVA_COUNTS.clear()
    t0 = clock()
    with timer.timed("forward", sync=True):
        nll = gp._approx.nll_laplace_iterative(torch.exp(th), y_t, None, None,
                                               **kw)
    with timer.timed("backward", sync=True):
        (grad,) = torch.autograd.grad(nll, th)
    t_vg = clock() - t0
    timer.enable(False)
    scopes = {name: {"seconds": sec, "calls": calls}
              for name, (sec, calls) in sorted(timer.totals().items())}
    counts = dict(FSVA_COUNTS)
    check(math.isfinite(float(nll.detach())) and bool(
        torch.all(torch.isfinite(grad))), "fsva_laplace: NLL or gradient "
          "not finite")
    _, t_fit = _timed(lambda: gp.fit(ng["yb"], params={
        "optimizer_cov": "lbfgs", "maxit": LR_NG_MAXIT,
        "init_cov_pars": NG_COV_PARS}))
    check(math.isfinite(gp.current_nll_), "fsva_laplace: fit NLL")
    out, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=ng["pred"], predict_response=False))
    out_v, t_pred_v = _timed(lambda: gp.predict(
        gp_coords_pred=ng["pred"][:LR_NG_VAR_POINTS], predict_var=True))
    mu, var = out_v["mu"], out_v["var"]
    check(bool(np.all(np.isfinite(out["mu"])) and np.all((mu > 0) & (mu < 1))
               and np.all((var > 0) & (var <= VAR_TOP))),
          "fsva_laplace: predictions out of range")
    launches = read_counts()
    check(all(v == 0 for v in launches.values()),
          f"fsva_laplace: a kernel launched: {launches}")
    emit({"phase": "fsva_laplace", "n": len(ng["yb"]), "m": LR_M, "k": LR_K,
          "nll": float(nll.detach()), "grad": grad.cpu().numpy().tolist(),
          "scopes": scopes, "counts": counts, "fit_maxit": LR_NG_MAXIT,
          "fit_cov_pars": gp.get_cov_pars().tolist(),
          "fit_nll": gp.current_nll_,
          "fit_evaluations": gp._fit_result.num_evals,
          "var_points": LR_NG_VAR_POINTS, "launches": launches})
    return {"fsva_laplace_construct_s": t_construct,
            "fsva_laplace_vg_s": t_vg, "fsva_laplace_fit_s": t_fit,
            "fsva_laplace_fit_evaluations": gp._fit_result.num_evals,
            "fsva_laplace_predict_mean_s": t_pred,
            f"fsva_laplace_predict_var_{LR_NG_VAR_POINTS}_s": t_pred_v}


def lowrank_clustered(coords, y, pred, seed, dev):
    """FITC and FSVA with ``cluster_ids``: LRC_CLUSTERS clusters of
    LRC_SIZE points (the main data's points in order), LRC_K inducing
    points a cluster (the equal-size clusters batched): the default fit
    and prediction, LRC_UNSEEN of the prediction points in clusters
    training never saw, which must get the prior exactly."""
    n = LRC_CLUSTERS * LRC_SIZE
    ids = np.repeat(np.arange(LRC_CLUSTERS), LRC_SIZE)
    rng = np.random.default_rng(seed + 90)
    ids_pred = rng.integers(0, LRC_CLUSTERS, len(pred))
    unseen = rng.uniform(size=len(pred)) < LRC_UNSEEN
    ids_pred[unseen] = LRC_CLUSTERS + rng.integers(0, 10, int(unseen.sum()))
    timings, entry = {}, {"phase": "lowrank_clustered", "n": n,
                          "clusters": LRC_CLUSTERS, "k": LRC_K,
                          "unseen_points": int(unseen.sum())}
    reset_counts()
    for approx in ("fitc", "full_scale_vecchia"):
        tag = "fitc" if approx == "fitc" else "fsva"
        gp, t_c = _timed(lambda: _lowrank_model(
            coords[:n], approx, dev, num_ind_points=LRC_K, cluster_ids=ids))
        check(gp._approx.stacked is not None,
              f"{tag}: the equal-size clusters are not batched")
        _, t_fit = _timed(lambda: gp.fit(y[:n]))
        out, t_pred = _timed(lambda: gp.predict(
            gp_coords_pred=pred, cluster_ids_pred=ids_pred,
            predict_var=True))
        cp = gp.get_cov_pars()
        prior_ok = bool(np.all(out["mu"][unseen] == 0.0) and np.all(
            out["var"][unseen] == cp[1] + cp[0]))
        check(prior_ok, f"{tag}: unseen clusters not at the prior")
        check(bool(np.all(np.isfinite(out["mu"])) and np.all(out["var"] > 0)),
              f"{tag}: clustered predictions not finite / not positive")
        timings.update({f"lowrank_clustered_{tag}_construct_s": t_c,
                        f"lowrank_clustered_{tag}_fit_s": t_fit,
                        f"lowrank_clustered_{tag}_fit_evaluations":
                            gp._fit_result.num_evals,
                        f"lowrank_clustered_{tag}_predict_s": t_pred})
        entry[tag] = {"cov_pars": cp.tolist(), "nll": gp.current_nll_,
                      "evaluations": gp._fit_result.num_evals,
                      "unseen_at_prior": prior_ok}
    launches = read_counts()
    check(all(v == 0 for v in launches.values()),
          f"lowrank_clustered: a kernel launched: {launches}")
    entry["launches"] = launches
    emit(entry)
    return timings


def _lowrank_boost_gp(coords, dev, binary):
    gp = _lowrank_model(coords, "fitc" if binary else "full_scale_vecchia",
                        dev, likelihood="bernoulli_logit" if binary
                        else "gaussian")
    if not binary:
        gp.set_optim_params({"optimizer_cov": "lbfgs",
                             "init_cov_pars": LR_INIT})
    return gp


def lowrank_boosting(bd, rounds, dev, binary=False):
    """``fsva_boosting``: the boosting recipe (PERF.md section 4) with the
    FSVA GP (L-BFGS refits from LR_INIT); ``fitc_lagaboost``: the
    non-Gaussian recipe's LaGaBoost (objective "binary") with a
    ``bernoulli_logit`` FITC GP; ``rounds`` rounds, then
    ``Booster.predict`` with variances. The histogram kernel once a leaf,
    the Vecchia kernels never."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    tag = "fitc_lagaboost" if binary else "fsva_boosting"
    reset_counts()
    ds = gpt.Dataset(bd["X"], label=bd["label"], device=dev)
    gp = _lowrank_boost_gp(bd["coords"], dev, binary)
    bst, t_train = _timed(lambda: gpt.train(
        NG_PARAMS if binary else BOOST_PARAMS, ds, gp_model=gp,
        num_boost_round=rounds))
    launches = read_counts()
    reads = grow_tree.host_reads
    out, t_pred = _timed(lambda: bst.predict(
        bd["X_pred"], gp_coords_pred=bd["pred"], predict_var=True))
    entry = _boost_checks(bst, tag, launches, reads, rounds)
    hist = check_histogram_on(ds, bd["seed"], dev, tag)
    mu, var = out["response_mean"], out["response_var"]
    # FSVA's Gaussian variances at this size are simulated (clamped at 0)
    ok_mu = (np.all((mu > 0) & (mu < 1)) and np.all((var > 0)
                                                    & (var <= VAR_TOP))
             if binary else np.all(np.isfinite(mu)) and np.all(var >= 0))
    check(mu.shape == (len(bd["pred"]),) and bool(ok_mu),
          f"{tag}: predictions out of range")
    emit({"phase": tag, "n": len(bd["label"]), "rounds": rounds,
          "cov_pars": gp.get_cov_pars().tolist(), **entry,
          "pred_mu_range": [float(mu.min()), float(mu.max())]})
    return (launches, {f"{tag}_train_{rounds}r_s": t_train,
                       f"{tag}_evaluations": entry["evaluations"],
                       f"{tag}_predict_s": t_pred}, bst, hist)


def lowrank_determinism(fsva_gp, coords, y, boost, dev):
    """Second runs, each the same bits as the first: the FSVA L-BFGS fit
    (cov_pars, NLL, evaluations; a new model from the same inits) and the
    fsva_boosting and fitc_lagaboost trainings (scores, cov_pars,
    evaluation counts)."""
    import gpboost_tpu_torch as gpt
    out = {}
    gp2 = _lowrank_model(coords, "full_scale_vecchia", dev)
    gp2.fit(y, params={"optimizer_cov": "lbfgs"})
    out["fsva_fit"] = {
        "cov_pars_bit_identical": bool(np.array_equal(
            fsva_gp.get_cov_pars(), gp2.get_cov_pars())),
        "nll_bit_identical": bool(fsva_gp.current_nll_ == gp2.current_nll_),
        "evaluations": [fsva_gp._fit_result.num_evals,
                        gp2._fit_result.num_evals]}
    del gp2
    for tag, (first, data, binary) in boost.items():
        gp = _lowrank_boost_gp(data["coords"], dev, binary)
        bst = gpt.train(NG_PARAMS if binary else BOOST_PARAMS,
                        gpt.Dataset(data["X"], label=data["label"],
                                    device=dev),
                        gp_model=gp, num_boost_round=first.num_trees())
        ev = ([f["num_evals"] for f in first.objective.fits],
              [f["num_evals"] for f in bst.objective.fits])
        out[tag] = {
            "scores_bit_identical": bool(np.array_equal(first._score,
                                                        bst._score)),
            "cov_pars_bit_identical": bool(np.array_equal(
                first.gp_model.get_cov_pars(), gp.get_cov_pars())),
            "evaluations_identical": bool(ev[0] == ev[1]),
            "score_max_abs_diff": float(np.abs(first._score
                                               - bst._score).max()),
            "evaluations": [sum(ev[0]), sum(ev[1])]}
        del bst, gp
    emit({"phase": "determinism_lowrank", **out})
    f = out["fsva_fit"]
    ok = (f["cov_pars_bit_identical"] and f["nll_bit_identical"]
          and f["evaluations"][0] == f["evaluations"][1])
    ok = ok and all(v["scores_bit_identical"] and v["cov_pars_bit_identical"]
                    and v["evaluations_identical"]
                    for k, v in out.items() if k != "fsva_fit")
    check(ok, f"the low-rank paths are not bit-reproducible on the card: "
          f"{out}")
    return out


def lowrank_ops_trace(coords, y, dev):
    """The FSVA value-and-gradient (residual factors, Woodbury, Lambda^-1
    products, their backward) on the card at LR_CPU_N points under the
    profiler (its CPU side): no operation that adds with colliding
    indices."""
    from torch.profiler import ProfilerActivity, profile
    gp = _lowrank_model(coords[:LR_CPU_N], "full_scale_vecchia", dev)
    th = torch.log(gp._tensor(LR_INIT))
    y_t = gp._tensor(y[:LR_CPU_N])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gp._approx._vg_gaussian(th, y_t, None)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    emit({"phase": "lowrank_ops_trace", "ops": names, "scatters": bad})
    check(any("cholesky" in x for x in names), f"empty trace: {names}")
    check(not bad, f"the FSVA value-and-gradient scatters: {bad}")
    return names


def lowrank_paths(coords, y, pred, ng, seed, rounds, dev):
    """Phase 9 in order; returns (launches by path, timings, what
    ``lowrank_determinism`` repeats, the histogram checks)."""
    timings = {}
    l_fitc, t, _ = lowrank_gp(coords, y, pred, "fitc", dev)
    timings.update(t)
    l_fsva, t, fsva = lowrank_gp(coords, y, pred, "full_scale_vecchia", dev)
    timings.update(t)
    lowrank_vs_cpu(coords, y, pred, dev)
    timings.update(fsa_gp(coords, y, pred, dev))
    torch.cuda.empty_cache()
    timings.update(fsva_laplace(ng, dev))
    torch.cuda.empty_cache()
    timings.update(lowrank_clustered(coords, y, pred, seed, dev))
    X, yb, X_pred = make_boost_data(seed, y, len(pred))
    bd_g = dict(coords=coords, pred=pred, X=X, label=yb, X_pred=X_pred,
                seed=seed)
    bd_b = dict(coords=ng["coords"], pred=ng["pred"], X=ng["Xn"],
                label=ng["ybb"], X_pred=ng["X_pred"], seed=seed)
    l_b, t, bst_b, h_b = lowrank_boosting(bd_g, min(rounds, LR_FSVA_ROUNDS),
                                          dev)
    timings.update(t)
    l_l, t, bst_l, h_l = lowrank_boosting(bd_b, rounds, dev, binary=True)
    timings.update(t)
    launches = {"fitc_gp": l_fitc, "fsva_gp": l_fsva,
                "fsva_boosting": l_b, "fitc_lagaboost": l_l}
    firsts = dict(fsva=fsva, boost={"fsva_boosting": (bst_b, bd_g, False),
                                    "fitc_lagaboost": (bst_l, bd_b, True)})
    hist = ([c for cases, _ in (h_b, h_l) for c in cases],
            [shape for _, shape in (h_b, h_l)])
    return launches, timings, firsts, hist



# ---------------------------------------------------------------------------
# phase 10: the iterative methods (matrix_inversion_method="iterative")
# ---------------------------------------------------------------------------

IT_GR_RTOL, IT_GR_ATOL = 0.1, 0.02    # the JAX tests' tiers against Cholesky:
IT_GLMM_RTOL, IT_GLMM_ATOL = 0.15, 0.03   # tests/test_iterative.py
IT_PRECOND_RTOL = 2e-2                # tests/test_preconditioners.py
IT_RANKS = (50, 200)                  # piv_chol_rank of the CG-step counts
IT_LOWRANK_MAXIT = 1    # depth cut of the low-rank preconditioner's fit (at
                        # NG_MAXIT its line search takes many ~7 s evaluations)
FSA_IT_TAPER = 0.03     # at n = 1e5 the ~300 neighbours that FSA_TAPER
                        # gives at FSA_N
FSA_IT_MAXIT = 3        # depth cut of the n = 1e5 iterative FSA fit
FSA_IT_LANCZOS = 50     # its Lanczos steps (the value's; the package: 200)
FSA_IT_NSIM = 100       # nsim_var_pred of its prediction (the package: 1000)
FSA_IT_PROBES = 500     # the JAX test's probes for the n = FSA_N gate
# the n = FSA_N gate (tests/test_fitc_golden.py::
# TestFullScaleTaperingIterative holds the NLL within 0.1 at n = 100, an NLL
# of 124: 8e-4 relative; here relative, since the stochastic log-determinant's
# error grows with n) and the fit: the exact (Cholesky) NLL at the iterative
# optimum within 0.1 of the Cholesky optimum's (the JAX test's parameter tier,
# sum |d cov_pars| < 0.1, is reported: on this data both fits lie on the ridge
# of constant sigma1^2 / range, where the parameters are not identified)
FSA_IT_NLL_RTOL = 1e-3
FSA_IT_FIT_NLL_ATOL = 0.1
IT_POISSON_ROUNDS = 10


def _scopes():
    from gpboost_tpu_torch.utils import timer
    return {name: {"seconds": sec, "calls": calls}
            for name, (sec, calls) in sorted(timer.totals().items())}


def grouped_iterative(gd, lmm_fit, glmm_cov_pars, dev):
    """Grouped random effects with ``matrix_inversion_method="iterative"``
    on phase 8's data (n = GR_N, q = 12 000, float64): the LMM — construct,
    the public NLL (the Cholesky one, as in the JAX package) beside the
    iterative one, one value-and-gradient with its CG / Lanczos counts and
    timed scopes, the L-BFGS fit (cov_pars within IT_GR_RTOL / IT_GR_ATOL
    of phase 8's Cholesky fit), prediction with simulated variances at the
    prediction rows (unseen levels at their prior exactly),
    ``get_num_cg_steps``; then the ``bernoulli_logit`` GLMM (q = 11 000):
    fit (within IT_GLMM_RTOL / IT_GLMM_ATOL of phase 8's), prediction, and
    a second fit that must give the same bits. No kernel runs."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import grouped as tg
    from gpboost_tpu_torch.models import laplace_fit
    from gpboost_tpu_torch.utils import timer
    y, X = gd["y"], gd["X"]
    reset_counts()
    tg.GROUPED_COUNTS.clear()
    model, t_construct = _timed(lambda: gpt.GPModel(
        device=dev, matrix_inversion_method="iterative", **_lmm_kwargs(gd)))
    Z = model._Z
    init = model._default_init_cov_pars(y)
    fe_ols = X @ np.linalg.lstsq(X, y, rcond=None)[0]
    nll_pub, t_nll = _timed(lambda: model.neg_log_likelihood(
        init, y, fixed_effects=fe_ols))
    kw = laplace_fit.grouped_iter_kwargs(model.optim_cfg)
    th = model._tensor(np.log(init[1:] / init[0]))
    r = model._tensor(y - fe_ols)
    with torch.no_grad():
        (nll_it, _), t_nll_it = _timed(
            lambda: tg.nll_profiled_iterative(Z, torch.exp(th), r, **kw))
    tg.nll_profiled_iterative_value_and_grad(Z, th, r, **kw)
    tg.GROUPED_COUNTS.clear()
    timer.clear()
    timer.enable(True)
    (v, g, s2), t_vg = _timed(
        lambda: tg.nll_profiled_iterative_value_and_grad(Z, th, r, **kw))
    timer.enable(False)
    scopes, counts_vg = _scopes(), dict(tg.GROUPED_COUNTS)
    tg.GROUPED_COUNTS.clear()
    _, t_fit = _timed(lambda: model.fit(y, X=X, params={
        "optimizer_cov": "lbfgs"}))
    counts_fit = dict(tg.GROUPED_COUNTS)
    res = model._fit_result
    cp, coef = model.get_cov_pars(), model.get_coef()
    tg.GROUPED_COUNTS.clear()
    pred_kw = dict(group_data_pred=gd["group_pred"],
                   group_rand_coef_data_pred=gd["xs_pred"],
                   X_pred=gd["X_pred"], predict_var=True)
    out, t_pred = _timed(lambda: model.predict(**pred_kw))
    counts_pred = dict(tg.GROUPED_COUNTS)
    steps, t_steps = _timed(model.get_num_cg_steps)
    # the Cholesky route's variances at the same parameters (not gated:
    # the simulated ones carry 1000 draws' noise)
    model.matrix_inversion_method = "cholesky"
    out_ch = model.predict(**pred_kw)
    model.matrix_inversion_method = "iterative"
    launches = read_counts()
    check(all(v_ == 0 for v_ in launches.values()),
          f"grouped_iterative: a kernel launched: {launches}")
    check(math.isfinite(float(v)) and bool(torch.all(torch.isfinite(g))),
          "grouped_iterative: the value-and-gradient is not finite")
    want = np.asarray(lmm_fit["cov_pars"])
    check(bool(np.all(np.abs(cp - want) <= IT_GR_ATOL + IT_GR_RTOL
                      * np.abs(want))),
          f"grouped_iterative: cov_pars {cp} not within rtol {IT_GR_RTOL} / "
          f"atol {IT_GR_ATOL} of the Cholesky fit's {want}")
    mu, var = out["mu"], out["var"]
    u = gd["unseen"]
    prior = cp[0] + cp[1] + cp[2] + cp[3] * gd["xs_pred"][u] ** 2
    err_unseen = float(np.max(np.abs(var[u] - prior) / prior))
    check(bool(np.all(np.isfinite(mu)) and np.all(var > 0))
          and err_unseen < 1e-10,
          f"grouped_iterative: predictions not finite / positive, or the "
          f"unseen levels off their prior by {err_unseen}")
    seen = ~u
    var_rel = np.abs(var[seen] - out_ch["var"][seen]) / out_ch["var"][seen]
    emit({"phase": "grouped_iterative", "n": Z.n, "q": Z.q,
          "settings": kw, "nll_public_cholesky": nll_pub,
          "nll_iterative": float(nll_it), "vg_nll": float(v),
          "vg_grad": g.cpu().numpy().tolist(), "vg_scopes": scopes,
          "vg_counts": counts_vg, "fit_counts": counts_fit,
          "fit_iterations": res.num_it, "fit_evaluations": res.num_evals,
          "cov_pars": cp.tolist(), "coef": coef.tolist(),
          "cov_pars_cholesky": want.tolist(),
          "coef_cholesky": np.asarray(lmm_fit["coef"]).tolist(),
          "predict_counts": counts_pred, "nsim_var_pred": 1000,
          "pred_mean_max_abs_diff_vs_cholesky": float(np.max(np.abs(
              mu - out_ch["mu"]))),
          "pred_var_rel_diff_vs_cholesky": {
              "mean": float(np.mean(var_rel)),
              "max": float(np.max(var_rel))},
          "num_cg_steps": steps, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    timings = {"it_lmm_construct_s": t_construct, "it_lmm_nll_ms": t_nll * 1e3,
               "it_lmm_nll_iterative_ms": t_nll_it * 1e3,
               "it_lmm_vg_s": t_vg, "it_lmm_fit_lbfgs_s": t_fit,
               "it_lmm_fit_lbfgs_evaluations": res.num_evals,
               "it_lmm_predict_s": t_pred, "it_lmm_num_cg_steps_s": t_steps}
    del model, out_ch
    torch.cuda.empty_cache()

    glmm = []
    for _ in range(2):
        tg.GROUPED_COUNTS.clear()
        gm = gpt.GPModel(group_data=np.column_stack([gd["g1"], gd["g2"]]),
                         likelihood="bernoulli_logit",
                         matrix_inversion_method="iterative", device=dev)
        _, t_gfit = _timed(lambda: gm.fit(gd["yb"]))
        glmm.append((gm, t_gfit, dict(tg.GROUPED_COUNTS)))
    gm, t_gfit, counts_gfit = glmm[0]
    cp_g = gm.get_cov_pars()
    out_g, t_gpred = _timed(lambda: gm.predict(
        group_data_pred=gd["group_pred"], predict_var=True,
        predict_response=True))
    g_steps = gm.get_num_cg_steps()
    second = glmm[1][0]
    same = (np.array_equal(cp_g, second.get_cov_pars())
            and gm.current_nll_ == second.current_nll_
            and gm._fit_result.num_evals == second._fit_result.num_evals)
    want_g = np.asarray(glmm_cov_pars)
    check(bool(np.all(np.abs(cp_g - want_g) <= IT_GLMM_ATOL + IT_GLMM_RTOL
                      * np.abs(want_g))),
          f"grouped_iterative GLMM: cov_pars {cp_g} not within rtol "
          f"{IT_GLMM_RTOL} / atol {IT_GLMM_ATOL} of the Cholesky fit's "
          f"{want_g}")
    check(same, "grouped_iterative GLMM: two fits differ in their bits: "
          f"{cp_g} / {second.get_cov_pars()}, {gm.current_nll_} / "
          f"{second.current_nll_}")
    mu_g, var_g = out_g["mu"], out_g["var"]
    check(bool(np.all((mu_g > 0) & (mu_g < 1))
               and np.all((var_g > 0) & (var_g <= 0.25))),
          "grouped_iterative GLMM: predictions outside (0, 1) / (0, 0.25]")
    launches_g = read_counts()
    check(all(v_ == 0 for v_ in launches_g.values()),
          f"grouped_iterative GLMM: a kernel launched: {launches_g}")
    emit({"phase": "grouped_iterative_glmm", "q": gm._Z.q,
          "cov_pars": cp_g.tolist(), "cov_pars_cholesky": want_g.tolist(),
          "nll_fit": gm.current_nll_, "fit_evaluations":
          gm._fit_result.num_evals, "fit_counts": counts_gfit,
          "second_fit_same_bits": same, "num_cg_steps": g_steps,
          "pred_mu_range": [float(mu_g.min()), float(mu_g.max())],
          "launches": launches_g})
    del glmm, gm, second
    timings.update(it_glmm_fit_s=t_gfit, it_glmm_predict_s=t_gpred)
    return launches, timings


def vecchia_laplace_lowrank(ng, m, seed, dev):
    """Phase 7's non-Gaussian GP (n = 1e5, m = 20, ``bernoulli_logit``,
    float32, 200 probes, 100 Lanczos steps) with
    ``cg_preconditioner_type="pivoted_cholesky"`` (the randomised-Nystrom
    low-rank + diagonal preconditioner, rank ``piv_chol_rank`` = 50): the
    public NLL, one value-and-gradient with its breakdown, its NLL against
    the Jacobi ("vadu") one at the same parameters and probes (within
    IT_PRECOND_RTOL), the L-BFGS fit cut to IT_LOWRANK_MAXIT,
    ``get_num_cg_steps`` with vadu and the low-rank preconditioner of ranks
    IT_RANKS. No Vecchia kernel."""
    from gpboost_tpu_torch.models.vecchia_model import LAPLACE_COUNTS
    coords, yb = ng["coords"], ng["yb"]
    reset_counts()
    model = _ng_model(coords, m, seed, torch.float32, dev, IT_LOWRANK_MAXIT)
    model.set_optim_params({"cg_preconditioner_type": "pivoted_cholesky"})
    nll_pub, t_nll = _timed(lambda: model.neg_log_likelihood(NG_COV_PARS,
                                                             yb))
    nll_vg, grad, t_vg, scopes, counts = _laplace_vg(model, yb, True)
    kw = model._iter_kwargs(fit=True)
    kw["preconditioner"] = "vadu"
    LAPLACE_COUNTS.clear()
    with torch.no_grad():
        nll_vadu, t_vadu = _timed(lambda: float(
            model._approx.nll_laplace_iterative(
                model._tensor(NG_COV_PARS), model._y_tensor(yb), None, None,
                **kw)))
    counts_vadu = dict(LAPLACE_COUNTS)
    emit({"phase": "vecchia_laplace_lowrank_vg", "nll_vg": nll_vg,
          "vg_s": t_vg, "vg_scopes": scopes, "vg_counts": counts,
          "nll_vadu": nll_vadu, "nll_vadu_s": t_vadu,
          "nll_vadu_counts": counts_vadu})
    LAPLACE_COUNTS.clear()
    _, t_fit = _timed(lambda: model.fit(y=yb))
    counts_fit = dict(LAPLACE_COUNTS)
    steps = {}
    t_steps = {}
    for pname, rank in (("vadu", IT_RANKS[0]),) + tuple(
            ("pivoted_cholesky", r) for r in IT_RANKS):
        model.set_optim_params({"cg_preconditioner_type": pname,
                                "piv_chol_rank": rank})
        key = pname if pname == "vadu" else f"rank_{rank}"
        steps[key], t_steps[key] = _timed(model.get_num_cg_steps)
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"vecchia_laplace_lowrank launched a kernel: {launches}")
    check(math.isfinite(nll_vg) and bool(np.all(np.isfinite(grad))),
          f"vecchia_laplace_lowrank: NLL or gradient not finite: {nll_vg}")
    check(abs(nll_vg - nll_vadu) <= IT_PRECOND_RTOL * abs(nll_vadu),
          f"vecchia_laplace_lowrank: the low-rank NLL {nll_vg} not within "
          f"{IT_PRECOND_RTOL} of the vadu one {nll_vadu}")
    check(math.isfinite(model.get_current_neg_log_likelihood()),
          "vecchia_laplace_lowrank: fit NLL not finite")
    emit({"phase": "vecchia_laplace_lowrank", "n": len(yb), "m": m,
          "settings": model._iter_kwargs(fit=True) | {
              "preconditioner": "pivoted_cholesky", "piv_chol_rank": 50},
          "nll_public_50_probes": nll_pub, "nll_vg": nll_vg,
          "nll_vadu": nll_vadu, "grad": grad.tolist(), "vg_scopes": scopes,
          "vg_counts": counts, "fit_counts": counts_fit,
          "fit_maxit": IT_LOWRANK_MAXIT,
          "fit_cov_pars": model.get_cov_pars().tolist(),
          "fit_evaluations": model._fit_result.num_evals,
          "num_cg_steps": steps, "num_cg_steps_s": t_steps,
          "launches": launches})
    return launches, {"it_lowrank_nll_s": t_nll, "it_lowrank_vg_s": t_vg,
                      "it_lowrank_fit_s": t_fit,
                      "it_lowrank_fit_evaluations":
                          model._fit_result.num_evals}


def fsa_iterative(coords, y, pred, dev):
    """Full-scale tapering with ``matrix_inversion_method="iterative"`` on
    the GP data (n = 1e5, exponential, float64, LR_K kmeans++ inducing
    points, taper range FSA_IT_TAPER): construct (k_t and the taper
    structure's bytes), the NLL, one value-and-gradient with its breakdown,
    the L-BFGS fit cut to FSA_IT_MAXIT, prediction at the prediction
    points (FSA_IT_NSIM simulated draws for the variances); then on
    ``fsa_gp``'s data (FSA_N points, FSA_TAPER) the iterative NLL (within
    FSA_IT_NLL_RTOL) and the L-BFGS fit (its exact NLL within
    FSA_IT_FIT_NLL_ATOL of the Cholesky optimum's) against the Cholesky
    route."""
    from gpboost_tpu_torch.models.fitc_model import FSA_COUNTS
    from gpboost_tpu_torch.utils import timer
    reset_counts()
    FSA_COUNTS.clear()
    gp, t_construct = _timed(lambda: _lowrank_model(
        coords, "full_scale_tapering", dev, cov_fct_taper_range=FSA_IT_TAPER,
        matrix_inversion_method="iterative"))
    gp.set_optim_params({"cg_max_num_it_tridiag": FSA_IT_LANCZOS})
    ts = gp._approx.taper
    init = gp._default_init_cov_pars(y)
    nll0, t_nll = _timed(lambda: gp.neg_log_likelihood(init, y))
    th = torch.log(gp._tensor(init)).requires_grad_(True)
    y_t = gp._tensor(y)
    FSA_COUNTS.clear()
    timer.clear()
    timer.enable(True)
    t0 = clock()
    with timer.timed("forward", sync=True):
        nll = gp._approx.nll_gaussian(torch.exp(th), y_t, None)
    with timer.timed("backward", sync=True):
        (grad,) = torch.autograd.grad(nll, th)
    t_vg = clock() - t0
    timer.enable(False)
    scopes, counts = _scopes(), dict(FSA_COUNTS)
    FSA_COUNTS.clear()
    _, t_fit = _timed(lambda: gp.fit(y, params={
        "optimizer_cov": "lbfgs", "maxit": FSA_IT_MAXIT}))
    counts_fit = dict(FSA_COUNTS)
    gp.set_prediction_data(nsim_var_pred=FSA_IT_NSIM)
    FSA_COUNTS.clear()
    out, t_pred = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                            predict_var=True))
    counts_pred = dict(FSA_COUNTS)
    steps = gp.get_num_cg_steps()
    check(math.isfinite(float(nll.detach())) and bool(
        torch.all(torch.isfinite(grad))), "fsa_iterative: NLL or gradient")
    check(math.isfinite(gp.current_nll_) and gp.current_nll_ <= nll0 + 1.0,
          f"fsa_iterative: fit NLL {gp.current_nll_} vs {nll0} at the inits")
    check(bool(np.all(np.isfinite(out["mu"])) and np.all(out["var"] >= 0)),
          "fsa_iterative: predictions not finite / variances negative")
    # the JAX test's tiers against the Cholesky route at FSA_N points
    rows = slice(0, FSA_N)
    c, yy = coords[rows], y[rows]
    it = _lowrank_model(c, "full_scale_tapering", dev,
                        cov_fct_taper_range=FSA_TAPER,
                        matrix_inversion_method="iterative")
    ch = _lowrank_model(c, "full_scale_tapering", dev,
                        cov_fct_taper_range=FSA_TAPER)
    it.set_optim_params({"num_rand_vec_trace": FSA_IT_PROBES,
                         "cg_max_num_it_tridiag": FSA_IT_LANCZOS})
    init_s = ch._default_init_cov_pars(yy)
    nll_it, nll_ch = it.neg_log_likelihood(init_s, yy), \
        ch.neg_log_likelihood(init_s, yy)
    params = {"optimizer_cov": "lbfgs", "init_cov_pars": init_s}
    _, t_fit_s = _timed(lambda: it.fit(yy, params=params))
    ch.fit(yy, params=params)
    cp_it, cp_ch = it.get_cov_pars(), ch.get_cov_pars()
    gap = ch.neg_log_likelihood(cp_it, yy) - ch.current_nll_
    launches = read_counts()
    check(all(v_ == 0 for v_ in launches.values()),
          f"fsa_iterative: a kernel launched: {launches}")
    check(abs(nll_it - nll_ch) <= FSA_IT_NLL_RTOL * abs(nll_ch),
          f"fsa_iterative: NLL {nll_it} vs Cholesky {nll_ch}")
    check(gap < FSA_IT_FIT_NLL_ATOL,
          f"fsa_iterative: the exact NLL at the iterative optimum {cp_it} "
          f"is {gap} above the Cholesky optimum's {cp_ch}")
    emit({"phase": "fsa_iterative", "n": len(y), "k": LR_K,
          "taper_range": FSA_IT_TAPER, "k_t": int(ts.idx.shape[1]),
          "taper_bytes": ts.nbytes(),
          "settings": {"num_rand_vec_trace": gp._approx.num_rand_vec_trace,
                       "lanczos_steps": gp._approx.lanczos_steps,
                       "cg_tol": gp._approx.cg_tol},
          "nll_at_inits": nll0, "vg_nll": float(nll.detach()),
          "vg_grad": grad.cpu().numpy().tolist(), "vg_scopes": scopes,
          "vg_counts": counts, "fit_maxit": FSA_IT_MAXIT,
          "fit_counts": counts_fit, "fit_cov_pars": gp.get_cov_pars().tolist(),
          "fit_evaluations": gp._fit_result.num_evals,
          "predict_counts": counts_pred, "nsim_var_pred": FSA_IT_NSIM,
          "num_cg_steps": steps,
          "gate_n": FSA_N, "gate_nll_iterative": nll_it,
          "gate_nll_cholesky": nll_ch, "gate_cov_pars_iterative":
          cp_it.tolist(), "gate_cov_pars_cholesky": cp_ch.tolist(),
          "gate_fit_evaluations": it._fit_result.num_evals,
          "gate_exact_nll_gap_at_iterative_optimum": gap,
          "gate_cov_pars_abs_sum_diff": float(np.sum(np.abs(cp_it - cp_ch))),
          "gate_var_over_range": [float(cp_it[1] / cp_it[2]),
                                  float(cp_ch[1] / cp_ch[2])],
          "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return {"fsa_it_construct_s": t_construct, "fsa_it_nll_s": t_nll,
            "fsa_it_vg_s": t_vg, "fsa_it_fit_lbfgs_s": t_fit,
            "fsa_it_fit_lbfgs_evaluations": gp._fit_result.num_evals,
            "fsa_it_predict_s": t_pred, f"fsa_it_fit_{FSA_N}_s": t_fit_s}


def grouped_poisson_lagaboost(seed, n, n_pred, dev):
    """Fault C3 on the card: the grouped LaGaBoost recipe with a Poisson
    response, ``likelihood="poisson"``, ``objective="poisson"``,
    IT_POISSON_ROUNDS rounds; the histogram kernel once a leaf."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    bd = _grouped_boost_data(seed, n, n_pred)
    rng = np.random.default_rng(seed + 22)
    f = 2.0 * np.sin(5 * bd["X"][:, 0]) + bd["X"][:, 1] ** 2 + bd["X"][:, 2]
    lat = 0.5 * (f - f.mean()) + 0.5 * rng.standard_normal(GB_LEVELS)[bd["g"]]
    ypois = rng.poisson(np.exp(lat)).astype(float)
    reset_counts()
    ds = gpt.Dataset(bd["X"], label=ypois, device=dev)
    gp = gpt.GPModel(group_data=bd["g"], likelihood="poisson", device=dev)
    params = dict(NG_PARAMS, objective="poisson")
    bst, t_train = _timed(lambda: gpt.train(
        params, ds, gp_model=gp, num_boost_round=IT_POISSON_ROUNDS))
    launches = read_counts()
    reads = grow_tree.host_reads
    out, t_pred = _timed(lambda: bst.predict(
        bd["X_pred"], group_data_pred=bd["group_pred"], predict_var=True))
    entry = _boost_checks(bst, "grouped_poisson_lagaboost", launches, reads,
                          IT_POISSON_ROUNDS)
    mu, var = out["response_mean"], out["response_var"]
    check(bool(np.all(mu > 0) and np.all(var > 0) and np.all(np.isfinite(
        mu))), "grouped_poisson_lagaboost: predictions out of range")
    emit({"phase": "grouped_poisson_lagaboost", "n": n, "levels": GB_LEVELS,
          "rounds": IT_POISSON_ROUNDS, "cov_pars": gp.get_cov_pars().tolist(),
          **entry, "pred_mu_range": [float(mu.min()), float(mu.max())]})
    return launches, {
        f"grouped_poisson_lagaboost_train_{IT_POISSON_ROUNDS}r_s": t_train,
        "grouped_poisson_lagaboost_evaluations": entry["evaluations"],
        "grouped_poisson_lagaboost_predict_s": t_pred}


def iterative_keyword_cholesky(coords, y, m, seed, dev):
    """Fault C4 on the card: the exact GP (n = EX_N, the README's example)
    and the Gaussian Vecchia GP (the GP path's n, m, float32) built with
    ``matrix_inversion_method="iterative"`` take the Cholesky route, as in
    the JAX package: their NLLs are the Cholesky models' bits."""
    import gpboost_tpu_torch as gpt
    ex = make_exact_data(seed, EX_N, 10, dev)
    out = {}
    for tag, make, cp, yy in (
            ("exact", lambda meth: _exact_model(
                ex["coords"], dev, matrix_inversion_method=meth),
             EX_TRUTH, ex["y"] - ex["X"] @ np.asarray(EX_BETA)),
            ("vecchia", lambda meth: gpt.GPModel(
                gp_coords=coords, cov_function="exponential",
                gp_approx="vecchia", num_neighbors=m, seed=seed,
                matrix_inversion_method=meth, dtype=torch.float32,
                device=dev), [0.25, 1.0, 0.1], y)):
        vals = {}
        for meth in ("iterative", "cholesky"):
            model = make(meth)
            vals[meth] = model.neg_log_likelihood(cp, yy)
            del model
        check(vals["iterative"] == vals["cholesky"]
              and math.isfinite(vals["cholesky"]),
              f"{tag}: the iterative keyword's NLL {vals['iterative']} is "
              f"not the Cholesky route's {vals['cholesky']}")
        out[tag] = vals
    emit({"phase": "iterative_keyword_cholesky", "n_exact": EX_N,
          "n_vecchia": len(y), "nll": out, "same_bits": True})


def iterative_ops_trace(gd, coords, y, dev):
    """The iterative value-and-gradients on the card under the profiler
    (its CPU side): the grouped profiled NLL at GR_CPU_N rows and the
    full-scale-tapering NLL at LR_CPU_N points, forward and backward — no
    operation that adds with colliding indices."""
    from torch.profiler import ProfilerActivity, profile
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import grouped as tg
    rows = slice(0, GR_CPU_N)
    gm = gpt.GPModel(device=dev, matrix_inversion_method="iterative",
                     **_lmm_kwargs(gd, rows))
    th = gm._tensor(np.log(np.asarray(GR_TRUTH[1:]) / GR_TRUTH[0]))
    r = gm._tensor(gd["y"][rows] - gd["X"][rows] @ np.asarray(GR_BETA))
    fsa = _lowrank_model(coords[:LR_CPU_N], "full_scale_tapering", dev,
                         cov_fct_taper_range=FSA_TAPER,
                         matrix_inversion_method="iterative")
    th_f = torch.log(fsa._tensor(LR_INIT))
    y_f = fsa._tensor(y[:LR_CPU_N])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tg.nll_profiled_iterative_value_and_grad(gm._Z, th, r)
        fsa._approx._vg_gaussian(th_f, y_f, None)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    emit({"phase": "iterative_ops_trace", "ops": names, "scatters": bad})
    check(any("index" in x for x in names), f"empty trace: {names}")
    check(not bad, f"an iterative value-and-gradient scatters: {bad}")
    return names


def iterative_paths(gd, lmm_fit, glmm_cov_pars, ng, coords, y, pred, m,
                    seed, n, n_pred, dev):
    """Phase 10 in order; returns (launches by path, timings)."""
    timings = {}
    l_gr, t = grouped_iterative(gd, lmm_fit, glmm_cov_pars, dev)
    timings.update(t)
    l_lr, t = vecchia_laplace_lowrank(ng, m, seed, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    timings.update(fsa_iterative(coords, y, pred, dev))
    torch.cuda.empty_cache()
    l_po, t = grouped_poisson_lagaboost(seed, n, n_pred, dev)
    timings.update(t)
    iterative_keyword_cholesky(coords, y, m, seed, dev)
    torch.cuda.empty_cache()
    return {"grouped_iterative": l_gr, "vecchia_laplace_lowrank": l_lr,
            "grouped_poisson_lagaboost": l_po}, timings


# ---------------------------------------------------------------------------
# phase 11: the rest of the Vecchia GP (cluster_ids, the prediction types,
# GP random coefficients, grouped effects beside the GP, Laplace with
# clusters or coefficients, the heteroscedastic and latent models)
# ---------------------------------------------------------------------------

VR_CLUSTERS = 1000                # repeated surveys: 1 000 clusters of 100
VR_CLUSTER_SIZE = 100
VR_TRUTH = [0.25, 1.0, 0.1]       # nugget, variance, range (exponential)
VR_UNSEEN = 0.1                   # share of prediction rows in new clusters
VR_CPU_CLUSTERS = 20              # 2 000 points of the card-vs-CPU check
VR_CPU_RTOL = 1e-9
PT_N_PRED_FULL = 10_000           # order_obs_first_cond_all's points
PT_N_PRED = 1_000                 # order_pred_first's points
PT_LATENT_N_PRED = 50             # the latent types' (depth cut: their W
#                                   solves are CG on as many columns; 250
#                                   until phase 15 took the script past
#                                   its 1 200 s, 100 until phase 16)
PT_NN = (40, 60)                  # num_neighbors_pred: 2 m, and more
# a type's mean vs cond_obs_only's in that one's predictive standard
# deviations (largest, and averaged over the points), its variance relative:
# the types differ by their approximation errors, which grow with the main
# path's long fitted range; against the exact posterior at PT_CPU_N points
# the tighter PT_EXACT_*
PT_MU_SD_MAX, PT_MU_SD_MEAN, PT_VAR_RTOL = 1.0, 0.25, 0.25
PT_EXACT_SD_MAX, PT_EXACT_SD_MEAN, PT_EXACT_VAR_RTOL = 0.5, 0.1, 0.05
PT_CPU_N, PT_CPU_N_PRED = 2_000, 200
SVC_MAXIT = 10                    # depth cut of the SVC fit (L-BFGS)
CB_LEVELS = 1000
CB_N_PRED = 1_000
CB_ROUNDS = 10
CB_GATE_RTOL, CB_GATE_ATOL = 0.1, 0.02     # the grouped gate (PR 11)
LCS_MAXIT = 1                     # depth cut of the Laplace fits
LCS_N_PRED = 1_000
HET_N = 5_000                     # dense [n, n] precisions
HET_N_PRED = 1_000
HET_CPU_N = 1_000
HET_MAXIT = 5                     # depth cut of the heteroscedastic fit
VR_TRACE_N = 20_000               # points of the traced value-and-gradients


def make_vr_clustered_data(seed, dev, n_pred):
    """VR_CLUSTERS independent exponential-GP realisations on
    VR_CLUSTER_SIZE points each, uniform in the unit square (one batched
    [C, s, s] Cholesky on the card), plus the nugget; prediction points in
    training clusters and (VR_UNSEEN of them) in clusters training never
    saw."""
    rng = np.random.default_rng(seed + 110)
    C, s = VR_CLUSTERS, VR_CLUSTER_SIZE
    coords = rng.uniform(size=(C, s, 2))
    ct = torch.as_tensor(coords, device=dev)
    diff = ct[:, :, None, :] - ct[:, None, :, :]
    cov = VR_TRUTH[1] * torch.exp(-torch.sqrt(torch.sum(diff * diff, -1))
                                  / VR_TRUTH[2])
    cov.diagonal(dim1=1, dim2=2).add_(1e-8)
    z = torch.as_tensor(rng.standard_normal((C, s, 1)), device=dev)
    b = (torch.linalg.cholesky(cov) @ z)[..., 0].cpu().numpy().ravel()
    del cov, diff
    ids = np.repeat(np.arange(C) * 3 + 11, s)
    y = b + math.sqrt(VR_TRUTH[0]) * rng.standard_normal(C * s)
    unseen = rng.random(n_pred) < VR_UNSEEN
    ids_pred = np.where(unseen, 3 * C + 20 + rng.integers(0, 50, n_pred),
                        ids[rng.integers(0, C * s, n_pred)])
    return dict(coords=coords.reshape(-1, 2), y=y, ids=ids,
                pred=rng.uniform(size=(n_pred, 2)), ids_pred=ids_pred,
                unseen=unseen)


def _vr_model(coords, m, seed, dev, dtype=torch.float32, **kw):
    import gpboost_tpu_torch as gpt
    kw.setdefault("gp_approx", "vecchia")
    return gpt.GPModel(gp_coords=coords, cov_function="exponential",
                       num_neighbors=m, seed=seed, dtype=dtype, device=dev,
                       **kw)


def _kernels_on(vec, cp, y, pred32, nb_pred, tag):
    """Both Vecchia kernels against their plain versions on the model's
    own (cluster-padded) neighbour matrices, at the main path's tolerances,
    and timed there."""
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    nb, tab = vec.neighbors, vec.coords_perm
    n, m = nb.shape
    d = tab.shape[1]
    cp32 = torch.as_tensor(cp, dtype=torch.float32, device=tab.device)
    out = {}
    for case, table, nbrs, rows in (("train", tab, nb, None),
                                    ("predict", vec.coords, nb_pred, pred32)):
        a_k, d_k = vk.vecchia_factors(cp32[1:], table, nbrs, cp32[0], True,
                                      0.5, row_coords=rows)
        a_p, d_p = vk.vecchia_factors_plain(cp32[1:], table, nbrs, cp32[0],
                                            True, 0.5, row_coords=rows)
        err = max(float((a_k - a_p).abs().max()),
                  float((d_k - d_p).abs().max()))
        check(math.isfinite(err) and err <= 2e-5,
              f"vecchia_factors[{tag} {case}]: max abs err {err} > 2e-5 vs "
              "the float32 plain version")
        b_ms, b_by = bound("vecchia_factors", nbrs, d, table.shape[0],
                           rows is None, 1)
        out[f"factors_{case}"] = dict(
            case=f"{tag}_{case}", n=int(nbrs.shape[0]), m=int(nbrs.shape[1]),
            padded_row_share=float((nbrs < 0).any(1).double().mean()),
            max_abs_err=err,
            ms=time_ms(lambda: vk.vecchia_factors(
                cp32[1:], table, nbrs, cp32[0], True, 0.5, row_coords=rows),
                20),
            plain_ms=time_ms(lambda: vk.vecchia_factors_plain(
                cp32[1:], table, nbrs, cp32[0], True, 0.5, row_coords=rows),
                5),
            bound_ms=b_ms, bound_by=b_by)
    lp = torch.log(cp32)
    r32 = torch.as_tensor(y, dtype=torch.float32,
                          device=tab.device)[vec._perm_t]
    nll = check_nll_grad(lp, tab, nb, r32, 0.5, False)
    b_ms, b_by = bound("vecchia_nll_grad", nb, d, n, True, 1)
    out["nll_grad"] = dict(
        nll, case=tag, n=n, m=m,
        padded_row_share=float((nb < 0).any(1).double().mean()),
        ms=time_ms(lambda: vk.vecchia_nll_grad(lp, tab, nb, r32, 0.5), 20),
        plain_ms=time_ms(lambda: vk.vecchia_nll_grad_plain(
            lp, tab, nb, r32, 0.5), 5),
        bound_ms=b_ms, bound_by=b_by)
    return out


def vecchia_clustered(vc, m, seed, dev):
    """``cluster_ids`` on the float32 Gaussian Vecchia GP at n = 1e5
    (VR_CLUSTERS clusters): construct, NLL, L-BFGS fit, prediction at the
    prediction points (VR_UNSEEN of them in unseen clusters, which must be
    at the prior). Both Vecchia kernels run the path and are held against
    their plain versions on its cluster-padded neighbour matrix; a second
    fit gives the same bits; the float64 model on the card meets the CPU's
    at VR_CPU_CLUSTERS clusters within VR_CPU_RTOL."""
    reset_counts()
    gp, t_construct = _timed(lambda: _vr_model(
        vc["coords"], m, seed, dev, cluster_ids=vc["ids"]))
    init = gp._default_init_cov_pars(vc["y"])
    nll_init, t_nll = _timed(lambda: gp.neg_log_likelihood(init, vc["y"]))
    _, t_fit = _timed(lambda: gp.fit(vc["y"],
                                     params={"optimizer_cov": "lbfgs"}))
    pred, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=vc["pred"], cluster_ids_pred=vc["ids_pred"],
        predict_var=True))
    launches = read_counts()
    res = gp._fit_result
    cp = gp.get_cov_pars()
    check(launches["vecchia_factors"] > 0 and launches["vecchia_nll_grad"] > 0,
          f"vecchia_clustered launched {launches}")
    check(gp.get_current_neg_log_likelihood() < nll_init,
          "the clustered Vecchia fit did not lower the NLL")
    mu, var = pred["mu"], pred["var"]
    u = vc["unseen"]
    prior = float(cp[0] + cp[1])
    check(bool(np.all(mu[u] == 0.0)
               and np.allclose(var[u], prior, rtol=1e-6, atol=0)),
          "predictions in unseen clusters are not the prior")
    check(bool(np.all(np.isfinite(mu)) and np.all(var[~u] > 0)
               and np.all(var[~u] <= prior * (1 + 1e-5))),
          "clustered predictions not finite / above the prior")
    # a second fit from the same inits: the same bits
    gp2 = _vr_model(vc["coords"], m, seed, dev, cluster_ids=vc["ids"])
    gp2.fit(vc["y"], params={"optimizer_cov": "lbfgs"})
    check(np.array_equal(gp2.get_cov_pars(), cp)
          and gp2.get_current_neg_log_likelihood()
          == gp.get_current_neg_log_likelihood(),
          "two clustered Vecchia fits differ in their bits")
    del gp2
    # the kernels on this path's cluster-padded neighbour matrices
    from gpboost_tpu_torch.models.spec import map_cluster_ids
    vec = gp._approx
    pred32 = torch.as_tensor(vc["pred"], dtype=torch.float32, device=dev)
    codes = torch.as_tensor(map_cluster_ids(gp._cluster_map, vc["ids_pred"])
                            .astype(np.int32), device=dev)
    nb_pred = vec._pred_neighbors(None, pred32, codes)
    kern = _kernels_on(vec, cp, vc["y"], pred32, nb_pred, "clustered")
    # card vs CPU, float64, on the first VR_CPU_CLUSTERS clusters
    k = VR_CPU_CLUSTERS * VR_CLUSTER_SIZE
    cpu_vals = []
    for where in (dev, torch.device("cpu")):
        g64 = _vr_model(vc["coords"][:k], m, seed, where,
                        dtype=torch.float64, cluster_ids=vc["ids"][:k])
        nll = g64.neg_log_likelihood(VR_TRUTH, vc["y"][:k])
        th = torch.log(g64._tensor(VR_TRUTH))
        _, grad = g64._approx._vg_gaussian(th, g64._y_tensor(vc["y"][:k]),
                                           None)
        p = g64.predict(y=vc["y"][:k], gp_coords_pred=vc["pred"][:100],
                        cluster_ids_pred=vc["ids"][:100], cov_pars=VR_TRUTH,
                        predict_var=True)
        cpu_vals.append((nll, grad.cpu().numpy(), p["mu"], p["var"]))
    a, b = cpu_vals
    rel = max(abs(a[0] - b[0]) / abs(b[0]),
              float(np.max(np.abs(a[1] - b[1])) / np.max(np.abs(b[1]))),
              float(np.max(np.abs(a[2] - b[2]))),
              float(np.max(np.abs(a[3] - b[3]) / b[3])))
    check(rel <= VR_CPU_RTOL, f"clustered Vecchia card vs CPU: {rel}")
    emit({"phase": "vecchia_clustered", "n": len(vc["y"]),
          "clusters": VR_CLUSTERS, "cluster_size": VR_CLUSTER_SIZE,
          "truth": VR_TRUTH, "cov_pars": cp.tolist(),
          "nll_init": nll_init, "nll": gp.get_current_neg_log_likelihood(),
          "evaluations": res.num_evals, "n_pred": len(mu),
          "unseen_rows": int(u.sum()), "launches": launches,
          "padded_row_share": kern["nll_grad"]["padded_row_share"],
          "kernels_vs_plain": kern, "card_vs_cpu_max_rel_err": rel,
          "same_bits": True})
    timings = {"vr_clustered_construct_s": t_construct,
               "vr_clustered_nll_ms": t_nll * 1e3,
               "vr_clustered_fit_s": t_fit,
               "vr_clustered_fit_evaluations": res.num_evals,
               "vr_clustered_predict_s": t_pred}
    return launches, timings, kern


def vecchia_pred_types(coords, y, pred, cov_pars, m, seed, dev):
    """The prediction types on a float64 Gaussian Vecchia GP at the GP
    path's n with the main path's fitted parameters: cond_obs_only (the
    default) and order_obs_first_cond_all at PT_N_PRED_FULL points (mean,
    variance, the full covariance), order_pred_first at PT_N_PRED and both
    latent types at PT_LATENT_N_PRED, with num_neighbors_pred 2 m and 60 (the
    latent types at
    2 m); each type's mean within PT_MU_SD_MAX (largest) and PT_MU_SD_MEAN
    (averaged) of cond_obs_only's predictive standard deviations of it, its
    variance within PT_VAR_RTOL relative; at PT_CPU_N points every type
    within PT_EXACT_* of the exact GP's posterior (dense, on the card), and
    on the card against the CPU within VR_CPU_RTOL (1e-8 for the latent
    types, whose W solves are CG to 1e-10)."""
    from gpboost_tpu_torch.models import vecchia_model as tvm
    reset_counts()
    gp = _vr_model(coords, m, seed, dev, dtype=torch.float64)
    cp = [float(v) for v in cov_pars]
    out, timings = {}, {}
    tvm.LAPLACE_COUNTS.clear()
    for nn in PT_NN:
        gp.set_prediction_data(num_neighbors_pred=nn)
        for kind, n_p in (("order_obs_first_cond_obs_only", PT_N_PRED_FULL),
                          ("order_obs_first_cond_all", PT_N_PRED_FULL),
                          ("order_pred_first", PT_N_PRED),
                          ("latent_order_obs_first_cond_obs_only",
                           PT_LATENT_N_PRED),
                          ("latent_order_obs_first_cond_all",
                           PT_LATENT_N_PRED)):
            if kind.startswith("latent") and nn != PT_NN[0]:
                continue
            gp.set_prediction_data(vecchia_pred_type=kind)
            before = tvm.LAPLACE_COUNTS["latent_cg_iters"]
            p, t = _timed(lambda: gp.predict(
                y=y, gp_coords_pred=pred[:n_p], cov_pars=cp, predict_var=True,
                predict_cov_mat=kind != "order_obs_first_cond_obs_only"))
            check(bool(np.all(np.isfinite(p["mu"]))
                       and np.all(p["var"] > 0)),
                  f"{kind} (nn {nn}): predictions not finite / variances "
                  "not positive")
            if p["cov"] is not None:
                check(p["cov"].shape == (n_p, n_p)
                      and np.allclose(np.diag(p["cov"]), p["var"]),
                      f"{kind}: covariance shape / diagonal")
            out[(kind, nn)] = p
            timings[f"pt_{kind}_nn{nn}_s"] = t
            if kind.startswith("latent"):
                timings[f"pt_{kind}_cg_iters"] = (
                    tvm.LAPLACE_COUNTS["latent_cg_iters"] - before)
    dev_gate = {}
    for (kind, nn), p in out.items():
        ref = out[("order_obs_first_cond_obs_only", nn)]
        n_p = len(p["mu"])
        z = np.abs(p["mu"] - ref["mu"][:n_p]) / np.sqrt(ref["var"][:n_p])
        rv = np.abs(p["var"] - ref["var"][:n_p]) / ref["var"][:n_p]
        gate = dict(max_abs_mu=float(np.max(np.abs(
            p["mu"] - ref["mu"][:n_p]))), max_mu_in_sd=float(z.max()),
            mean_mu_in_sd=float(z.mean()), max_var_rel=float(rv.max()))
        dev_gate[f"{kind}_nn{nn}"] = gate
        check(gate["max_mu_in_sd"] <= PT_MU_SD_MAX
              and gate["mean_mu_in_sd"] <= PT_MU_SD_MEAN
              and gate["max_var_rel"] <= PT_VAR_RTOL,
              f"{kind} (nn {nn}) vs cond_obs_only: {gate}")
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the float64 prediction types launched {launches}")
    del gp
    torch.cuda.empty_cache()
    # every type on the card against the CPU, float64
    res = {}
    for where in ("card", "cpu"):
        g = _vr_model(coords[:PT_CPU_N], m, seed,
                      dev if where == "card" else torch.device("cpu"),
                      dtype=torch.float64)
        for kind in ("order_obs_first_cond_obs_only",
                     "order_obs_first_cond_all", "order_pred_first",
                     "latent_order_obs_first_cond_obs_only",
                     "latent_order_obs_first_cond_all"):
            g.set_prediction_data(vecchia_pred_type=kind)
            res[(where, kind)] = g.predict(
                y=y[:PT_CPU_N], gp_coords_pred=pred[:PT_CPU_N_PRED],
                cov_pars=cp, predict_var=True, predict_cov_mat=True)
    # the exact posterior at those points (float64, dense, on the card)
    co = torch.as_tensor(coords[:PT_CPU_N], device=dev)
    cq = torch.as_tensor(pred[:PT_CPU_N_PRED], device=dev)
    K = cp[1] * torch.exp(-torch.cdist(co, co) / cp[2])
    K.diagonal().add_(cp[0])
    Kpo = cp[1] * torch.exp(-torch.cdist(cq, co) / cp[2])
    L = torch.linalg.cholesky(K)
    mu_ex = (Kpo @ torch.cholesky_solve(torch.as_tensor(
        y[:PT_CPU_N], device=dev)[:, None], L))[:, 0].cpu().numpy()
    var_ex = (cp[0] + cp[1] - torch.sum(
        Kpo * torch.cholesky_solve(Kpo.T, L).T, 1)).cpu().numpy()
    cpu_err, exact_err = {}, {}
    for kind in {k for _, k in res}:
        a, b = res[("card", kind)], res[("cpu", kind)]
        z = np.abs(a["mu"] - mu_ex) / np.sqrt(var_ex)
        exact_err[kind] = dict(max_mu_in_sd=float(z.max()),
                               mean_mu_in_sd=float(z.mean()),
                               max_var_rel=float(np.max(np.abs(
                                   a["var"] - var_ex) / var_ex)))
        check(exact_err[kind]["max_mu_in_sd"] <= PT_EXACT_SD_MAX
              and exact_err[kind]["mean_mu_in_sd"] <= PT_EXACT_SD_MEAN
              and exact_err[kind]["max_var_rel"] <= PT_EXACT_VAR_RTOL,
              f"{kind} vs the exact GP at {PT_CPU_N} points: "
              f"{exact_err[kind]}")
        err = max(float(np.max(np.abs(a["mu"] - b["mu"]))),
                  float(np.max(np.abs(a["cov"] - b["cov"]))))
        cpu_err[kind] = err
        tol = 1e-8 if kind.startswith("latent") else VR_CPU_RTOL
        check(err <= tol, f"{kind}: card vs CPU {err} > {tol}")
    emit({"phase": "vecchia_pred_types", "n": len(y), "m": m,
          "cov_pars": cp, "num_neighbors_pred": list(PT_NN),
          "n_pred_full": PT_N_PRED_FULL, "n_pred": PT_N_PRED,
          "n_pred_latent": PT_LATENT_N_PRED,
          "vs_cond_obs_only": dev_gate, "vs_exact": exact_err,
          "card_vs_cpu": cpu_err,
          "launches": launches, "latent_cg_iters":
          {k: v for k, v in timings.items() if k.endswith("cg_iters")}})
    return launches, timings


def vecchia_svc(coords, pred, m, seed, dev):
    """GP random coefficients on a float32 Vecchia GP at the GP path's n:
    one coefficient column x ~ N(0, 1), y = sin(6 x1) + x cos(4 x2) + 0.5
    eps. A value-and-gradient, the L-BFGS fit (cut to SVC_MAXIT), the
    prediction with ``gp_rand_coef_data_pred``. The plain build on the
    card: the Vecchia kernels' counters read 0, as in the JAX package."""
    rng = np.random.default_rng(seed + 120)
    n = len(coords)
    x = rng.standard_normal(n)
    y = (np.sin(6 * coords[:, 0]) + x * np.cos(4 * coords[:, 1])
         + 0.5 * rng.standard_normal(n))
    x_pred = rng.standard_normal(len(pred))
    reset_counts()
    gp, t_construct = _timed(lambda: _vr_model(coords, m, seed, dev,
                                               gp_rand_coef_data=x))
    init = gp._default_init_cov_pars(y)
    nll_init = gp.neg_log_likelihood(init, y)
    th = torch.log(gp._tensor(init))
    (v, g), t_vg = _timed(lambda: gp._approx._vg_gaussian(
        th, gp._y_tensor(y), None))
    _, t_fit = _timed(lambda: gp.fit(y, params={"optimizer_cov": "lbfgs",
                                                "maxit": SVC_MAXIT}))
    p, t_pred = _timed(lambda: gp.predict(
        gp_coords_pred=pred, gp_rand_coef_data_pred=x_pred,
        predict_var=True))
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the SVC path launched a kernel: {launches}")
    check(bool(torch.isfinite(g).all()) and math.isfinite(float(v)),
          "SVC value-and-gradient not finite")
    check(gp.get_current_neg_log_likelihood() < nll_init,
          "the SVC fit did not lower the NLL")
    check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] > 0)),
          "SVC predictions not finite")
    emit({"phase": "vecchia_svc", "n": n, "m": m, "maxit": SVC_MAXIT,
          "nll_init": nll_init, "nll": gp.get_current_neg_log_likelihood(),
          "cov_pars": gp.get_cov_pars().tolist(),
          "evaluations": gp._fit_result.num_evals, "launches": launches})
    return launches, {"svc_construct_s": t_construct,
                      "svc_vg_ms": t_vg * 1e3, "svc_fit_s": t_fit,
                      "svc_fit_evaluations": gp._fit_result.num_evals,
                      "svc_predict_s": t_pred}


def vecchia_combined(coords, y, pred, m, seed, dev):
    """A float64 Vecchia GP with CB_LEVELS grouped levels beside it at the
    GP path's n: the L-BFGS fits of the Cholesky and the iterative routes
    within the grouped gate of each other, the prediction at CB_N_PRED
    points with 10 % unseen levels, then ``train(..., gp_model=gp,
    num_boost_round=CB_ROUNDS)`` twice: histogram launches = leaves, the
    same bits (the traced value-and-gradients: ``vecchia_rest_ops_trace``)."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    rng = np.random.default_rng(seed + 130)
    n = len(y)
    group = rng.integers(0, CB_LEVELS, n)
    yc = y + 0.5 * rng.standard_normal(CB_LEVELS)[group]
    unseen = rng.random(CB_N_PRED) < 0.1
    gp_pred = np.where(unseen, CB_LEVELS + 7,
                       rng.integers(0, CB_LEVELS, CB_N_PRED))
    init = [0.25, 0.25, 1.0, 0.1]

    def model(method):
        return _vr_model(coords, m, seed, dev, dtype=torch.float64,
                         group_data=group, matrix_inversion_method=method)

    reset_counts()
    fits, timings = {}, {}
    for method in ("cholesky", "iterative"):
        gp, t_c = _timed(lambda: model(method))
        _, t_f = _timed(lambda: gp.fit(yc, params={
            "optimizer_cov": "lbfgs", "init_cov_pars": init}))
        fits[method] = gp
        timings.update({f"cb_{method}_construct_s": t_c,
                        f"cb_{method}_fit_s": t_f,
                        f"cb_{method}_fit_evaluations":
                        gp._fit_result.num_evals})
    cpc = fits["cholesky"].get_cov_pars()
    cpi = fits["iterative"].get_cov_pars()
    check(bool(np.all(np.abs(cpi - cpc) <= CB_GATE_ATOL
                      + CB_GATE_RTOL * np.abs(cpc))),
          f"combined: iterative fit {cpi} vs Cholesky {cpc}")
    p, t_p = _timed(lambda: fits["cholesky"].predict(
        gp_coords_pred=pred[:CB_N_PRED], group_data_pred=gp_pred,
        predict_var=True))
    timings["cb_predict_s"] = t_p
    # exact cross-covariances with the approximate Psi^-1 (the JAX
    # package's algorithm) can undershoot: variances clamped at 0 counted
    check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] >= 0)),
          "combined predictions not finite")
    cb_clamped = int(np.sum(p["var"] == 0.0))
    launches_fit = read_counts()
    check(launches_fit == NO_LAUNCHES,
          f"the combined fits launched {launches_fit}")
    del fits
    torch.cuda.empty_cache()
    # GPBoost with the combined model, twice
    X, yb, X_pred = make_boost_data(seed, yc, CB_N_PRED)
    runs = []
    for _ in range(2):
        reset_counts()
        ds = gpt.Dataset(X, label=yb, device=dev)
        gp = model("cholesky")
        gp.set_optim_params({"optimizer_cov": "lbfgs", "init_cov_pars": init})
        bst, t_t = _timed(lambda: gpt.train(BOOST_PARAMS, ds, gp_model=gp,
                                            num_boost_round=CB_ROUNDS))
        launches = read_counts()
        reads = grow_tree.host_reads
        runs.append((bst, launches, reads, t_t))
    entry = _boost_checks(runs[0][0], "vecchia_combined_boosting",
                          runs[0][1], runs[0][2], CB_ROUNDS)
    a, b = runs[0][0], runs[1][0]
    check(np.array_equal(np.asarray(a._score), np.asarray(b._score))
          and np.array_equal(a.gp_model.get_cov_pars(),
                             b.gp_model.get_cov_pars()),
          "two combined GPBoost trainings differ in their bits")
    out = a.predict(X_pred, gp_coords_pred=pred[:CB_N_PRED],
                    group_data_pred=gp_pred, predict_var=True)
    check(bool(np.all(np.isfinite(out["response_mean"]))),
          "combined GPBoost predictions not finite")
    timings.update({f"cb_train_{CB_ROUNDS}r_s": runs[0][3],
                    "cb_train_evaluations": entry["evaluations"]})
    emit({"phase": "vecchia_combined", "n": n, "levels": CB_LEVELS,
          "cov_pars_cholesky": cpc.tolist(), "cov_pars_iterative":
          cpi.tolist(), "n_pred": CB_N_PRED, "unseen_rows": int(unseen.sum()),
          "pred_var_clamped_at_0": cb_clamped, **entry,
          "same_bits": True})
    return runs[0][1], timings


def vecchia_laplace_cluster_svc(ng, m, seed, dev):
    """``bernoulli_logit`` with ``matrix_inversion_method="iterative"`` at
    the non-Gaussian path's n, float32: with VR_CLUSTERS clusters of
    VR_CLUSTER_SIZE, and with one GP random coefficient. The fit cut to
    LCS_MAXIT, the prediction at LCS_N_PRED points through the Newton-CG
    mode and CG for the variances (above the dense limit)."""
    from gpboost_tpu_torch.models import vecchia_model as tvm
    n = len(ng["yb"])
    rng = np.random.default_rng(seed + 140)
    ids = np.repeat(np.arange(n // VR_CLUSTER_SIZE), VR_CLUSTER_SIZE)
    ids_pred = np.where(rng.random(LCS_N_PRED) < VR_UNSEEN, -1,
                        ids[rng.integers(0, n, LCS_N_PRED)])
    x = rng.standard_normal(n)
    out, timings = {}, {}
    reset_counts()
    tvm.LAPLACE_COUNTS.clear()
    for tag, kw, pkw in (
            ("cluster", dict(cluster_ids=ids),
             dict(cluster_ids_pred=ids_pred)),
            ("svc", dict(gp_rand_coef_data=x),
             dict(gp_rand_coef_data_pred=rng.standard_normal(LCS_N_PRED)))):
        gp = _vr_model(ng["coords"], m, seed, dev,
                       likelihood="bernoulli_logit",
                       matrix_inversion_method="iterative", **kw)
        init = gp._default_init_cov_pars(ng["yb"])
        gp.set_optim_params({"init_cov_pars": init, "maxit": LCS_MAXIT})
        _, t_f = _timed(lambda: gp.fit(ng["yb"]))
        p, t_p = _timed(lambda: gp.predict(
            gp_coords_pred=ng["pred"][:LCS_N_PRED], predict_var=True,
            predict_response=False, **pkw))
        check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] > 0)),
              f"laplace {tag}: predictions not finite")
        if tag == "cluster":
            u = ids_pred == -1
            cpl = gp.get_cov_pars()
            check(bool(np.all(p["mu"][u] == 0.0)
                       and np.allclose(p["var"][u], cpl[0], rtol=1e-5)),
                  "laplace cluster: unseen clusters not at the prior")
        out[tag] = dict(cov_pars=gp.get_cov_pars().tolist(),
                        nll=gp.get_current_neg_log_likelihood(),
                        evaluations=gp._fit_result.num_evals)
        timings.update({f"lcs_{tag}_fit_s": t_f, f"lcs_{tag}_predict_s": t_p,
                        f"lcs_{tag}_fit_evaluations":
                        gp._fit_result.num_evals})
        del gp
        torch.cuda.empty_cache()
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the Laplace cluster / SVC path launched {launches}")
    emit({"phase": "vecchia_laplace_cluster_svc", "n": n, "maxit": LCS_MAXIT,
          "n_pred": LCS_N_PRED, **out, "launches": launches,
          "counts": dict(tvm.LAPLACE_COUNTS)})
    return launches, timings


def make_het_data(seed, n, n_pred):
    rng = np.random.default_rng(seed + 150)
    coords = rng.uniform(size=(n, 2))
    f1 = np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
    f2 = 0.5 * np.sin(3 * coords[:, 1]) - 1.0
    y = f1 + np.exp(0.5 * f2) * rng.standard_normal(n)
    return coords, y, rng.uniform(size=(n_pred, 2))


def heteroscedastic_latent(seed, m, dev):
    """``gaussian_heteroscedastic`` and ``gp_approx="vecchia_latent"`` at
    n = HET_N, float64 (both build dense [n, n] precisions): NLL, fit (the
    heteroscedastic one cut to HET_MAXIT), prediction at HET_N_PRED
    points; the NLLs and predictions on the card against the CPU at
    HET_CPU_N points within VR_CPU_RTOL. No kernel runs."""
    coords, y, pred = make_het_data(seed, HET_N, HET_N_PRED)
    cps = {"heteroscedastic": [1.0, 0.2, 0.5, 0.2],
           "vecchia_latent": [1.0, 0.2]}
    kws = {"heteroscedastic": dict(likelihood="gaussian_heteroscedastic"),
           "vecchia_latent": dict(gp_approx="vecchia_latent")}
    reset_counts()
    out, timings = {}, {}
    for tag, kw in kws.items():
        gp = _vr_model(coords, m, seed, dev, dtype=torch.float64, **kw)
        aux = [0.3] if tag == "vecchia_latent" else None
        nll, t_n = _timed(lambda: gp.neg_log_likelihood(cps[tag], y,
                                                        aux_pars=aux))
        params = {"optimizer_cov": "lbfgs", "init_cov_pars": cps[tag]}
        if tag == "heteroscedastic":
            params["maxit"] = HET_MAXIT
        _, t_f = _timed(lambda: gp.fit(y, params=params))
        p, t_p = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                           predict_var=True))
        check(math.isfinite(nll) and gp.get_current_neg_log_likelihood()
              <= nll, f"{tag}: the fit did not lower the NLL")
        check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] > 0)),
              f"{tag}: predictions not finite")
        out[tag] = dict(nll_init=nll, nll=gp.get_current_neg_log_likelihood(),
                        cov_pars=gp.get_cov_pars().tolist(),
                        aux_pars=None if gp.get_aux_pars() is None
                        else gp.get_aux_pars().tolist(),
                        evaluations=gp._fit_result.num_evals)
        timings.update({f"{tag}_nll_s": t_n, f"{tag}_fit_s": t_f,
                        f"{tag}_fit_evaluations": gp._fit_result.num_evals,
                        f"{tag}_predict_s": t_p})
        del gp
        torch.cuda.empty_cache()
        vals = []
        for where in (dev, torch.device("cpu")):
            g = _vr_model(coords[:HET_CPU_N], m, seed, where,
                          dtype=torch.float64, **kw)
            nll_w = g.neg_log_likelihood(cps[tag], y[:HET_CPU_N],
                                         aux_pars=aux)
            if aux is not None:
                g.aux_pars_ = np.asarray(aux)
            pw = g.predict(y=y[:HET_CPU_N], gp_coords_pred=pred[:100],
                           cov_pars=cps[tag], predict_var=True)
            vals.append((nll_w, pw["mu"], pw["var"]))
        a, b = vals
        rel = max(abs(a[0] - b[0]) / abs(b[0]),
                  float(np.max(np.abs(a[1] - b[1]))),
                  float(np.max(np.abs(a[2] - b[2]) / b[2])))
        check(rel <= VR_CPU_RTOL, f"{tag}: card vs CPU {rel}")
        out[tag]["card_vs_cpu_max_rel_err"] = rel
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the heteroscedastic / latent paths launched {launches}")
    emit({"phase": "heteroscedastic_latent", "n": HET_N,
          "n_pred": HET_N_PRED, **out, "launches": launches})
    return launches, timings


def vecchia_rest_ops_trace(coords, y, m, seed, dev):
    """The value-and-gradients of a Vecchia GP with CB_LEVELS grouped levels
    beside it (Cholesky and iterative) and with a GP random coefficient, on
    the card under the profiler (its CPU side) at VR_TRACE_N points: no
    operation that adds with colliding indices."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(seed + 130)
    k = VR_TRACE_N
    group = rng.integers(0, CB_LEVELS, k)
    x = rng.standard_normal(k)
    models = [(_vr_model(coords[:k], m, seed, dev, dtype=torch.float64,
                         group_data=group, matrix_inversion_method=meth),
               [0.25, 0.25, 1.0, 0.1]) for meth in ("cholesky", "iterative")]
    models.append((_vr_model(coords[:k], m, seed, dev, dtype=torch.float64,
                             gp_rand_coef_data=x), [0.25, 1.0, 0.1, 0.5, 0.1]))

    def vg(gp, cp):
        return gp._approx._vg_gaussian(torch.log(gp._tensor(cp)),
                                       gp._y_tensor(y[:k]), None)

    for gp, cp in models:         # the structures built once (dense Z) first
        vg(gp, cp)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for gp, cp in models:
            vg(gp, cp)
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()})
    bad = [x for x in names if any(b in x for b in SCATTERS)]
    emit({"phase": "vecchia_rest_ops_trace", "n": k, "ops": names,
          "scatters": bad})
    check(any("index" in x for x in names), f"empty trace: {names}")
    check(not bad, f"a combined / SVC value-and-gradient scatters: {bad}")
    return names


def vecchia_rest_paths(coords, y, pred, cov_pars, ng, m, seed, dev):
    """Phase 11 in order; returns (launches by path, timings, the kernels'
    cases and times on the cluster-padded matrices)."""
    timings = {}
    vc = make_vr_clustered_data(seed, dev, len(pred))
    l_vc, t, kern = vecchia_clustered(vc, m, seed, dev)
    timings.update(t)
    del vc
    torch.cuda.empty_cache()
    l_pt, t = vecchia_pred_types(coords, y, pred, cov_pars, m, seed, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    l_svc, t = vecchia_svc(coords, pred, m, seed, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    l_cb, t = vecchia_combined(coords, y, pred, m, seed, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    l_lcs, t = vecchia_laplace_cluster_svc(ng, m, seed, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    l_het, t = heteroscedastic_latent(seed, m, dev)
    timings.update(t)
    torch.cuda.empty_cache()
    return {"vecchia_clustered": l_vc, "vecchia_pred_types": l_pt,
            "vecchia_svc": l_svc, "vecchia_combined": l_cb,
            "vecchia_laplace_cluster_svc": l_lcs,
            "heteroscedastic_latent": l_het}, timings, kern


# ---------------------------------------------------------------------------
# phase 12: the rest of the covariance families and the likelihood tail
# ---------------------------------------------------------------------------

ST_TIMES = 100                    # station networks: 100 equally spaced
ST_LOCS = 1000                    # times x 1 000 stations = n = 1e5
ST_PRED_TIMES = 10                # forecasting: the next 10 times
ST_ROUNDS = 5                     # depth cut of the space-time GPBoost run
ST_CPU_N = 2_000                  # points of the card-vs-CPU check
ST_CPU_RTOL = 1e-9
MS_MAXIT = 3                      # depth cut of the shape-Matern fits
TAP_RANGE = 0.1                   # taper range of the exact tapering phase
TAP_CPU_N = 2_000
CT_N = 5_000                      # the rest of the families, exact GP
CT_MAXIT = 3                      # depth cut of their fits
CT_CPU_N = 1_000
CENS_N = 100_000                  # censored GLMMs: 1 000 uniform levels
CENS_LEVELS = 1000
CENS_MAXIT = 1                    # depth cut of their fits
CENS_N_PRED = 10_000
CENS_CPU_N = 2_000
CENS_CPU_RTOL = 1e-9
ZOCB = "zero_one_censored_transformed_beta"
ZOCG = "zero_one_censored_shifted_gamma"


def make_space_time_data(seed):
    """Station networks measured over time: ST_LOCS stations uniform in the
    unit square at ST_TIMES equally spaced times in [0, 1], coordinates
    [t, x1, x2]; y = sin(6 x1) + cos(4 x2) + sin(2 pi t) + 0.5 eps. The
    prediction points: every station at the next ST_PRED_TIMES times."""
    rng = np.random.default_rng(seed + 160)
    locs = rng.uniform(size=(ST_LOCS, 2))
    times = np.linspace(0.0, 1.0, ST_TIMES)
    step = times[1] - times[0]

    def grid(ts):
        return np.column_stack([np.repeat(ts, ST_LOCS),
                                np.tile(locs, (len(ts), 1))])

    coords = grid(times)
    y = (np.sin(6 * coords[:, 1]) + np.cos(4 * coords[:, 2])
         + np.sin(2 * np.pi * coords[:, 0])
         + 0.5 * rng.standard_normal(len(coords)))
    pred = grid(1.0 + step * np.arange(1, ST_PRED_TIMES + 1))
    return coords, y, pred


def _st_model(coords, m, seed, dev, dtype=torch.float32, ordering=
              "time_random_space"):
    import gpboost_tpu_torch as gpt
    return gpt.GPModel(gp_coords=coords, cov_function="matern_space_time",
                       cov_fct_shape=1.5, gp_approx="vecchia",
                       num_neighbors=m, vecchia_ordering=ordering, seed=seed,
                       dtype=dtype, device=dev)


def space_time_vecchia(m, seed, dev):
    """``matern_space_time`` (shape 1.5) under Vecchia with
    ``vecchia_ordering="time_random_space"`` at n = 1e5, float32: construct,
    NLL, L-BFGS fit (neighbours redetermined in the scaled coordinates),
    forecasting at the next ST_PRED_TIMES times; one NLL with the "time"
    ordering; then ``train(..., gp_model=gp, num_boost_round=ST_ROUNDS)``
    on the boosting recipe's 5 features, twice to the same bits. The
    Vecchia kernels stay at 0 (the family is outside their gate, as in the
    JAX package); card vs CPU, float64, at ST_CPU_N points."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    coords, y, pred = make_space_time_data(seed)
    reset_counts()
    gp, t_c = _timed(lambda: _st_model(coords, m, seed, dev))
    init = gp._default_init_cov_pars(y)
    nll_init, t_n = _timed(lambda: gp.neg_log_likelihood(init, y))
    _, t_f = _timed(lambda: gp.fit(y, params={"optimizer_cov": "lbfgs"}))
    cp = gp.get_cov_pars()
    nll_fit = gp.get_current_neg_log_likelihood()
    check(math.isfinite(nll_fit) and nll_fit < nll_init,
          f"space-time: the fit did not lower the NLL {nll_init} -> "
          f"{nll_fit}")
    p, t_p = _timed(lambda: gp.predict(gp_coords_pred=pred, predict_var=True))
    check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] > 0)),
          "space-time forecasts not finite")
    gt, t_ct = _timed(lambda: _st_model(coords, m, seed, dev,
                                        ordering="time"))
    nll_time, t_nt = _timed(lambda: gt.neg_log_likelihood(cp, y))
    check(math.isfinite(nll_time), f"time ordering: NLL {nll_time}")
    del gt
    launches_gp = read_counts()
    check(launches_gp == NO_LAUNCHES,
          f"the space-time GP launched {launches_gp}")
    fit_evals = gp._fit_result.num_evals
    del gp
    torch.cuda.empty_cache()
    X, yb, X_pred = make_boost_data(seed, y, len(pred))
    runs = []
    for _ in range(2):
        reset_counts()
        ds = gpt.Dataset(X, label=yb, device=dev)
        g = _st_model(coords, m, seed, dev)
        g.set_optim_params({"optimizer_cov": "lbfgs", "init_cov_pars": cp})
        bst, t_t = _timed(lambda: gpt.train(BOOST_PARAMS, ds, gp_model=g,
                                            num_boost_round=ST_ROUNDS))
        runs.append((bst, read_counts(), grow_tree.host_reads, t_t))
    entry = _boost_checks(runs[0][0], "space_time_boosting", runs[0][1],
                          runs[0][2], ST_ROUNDS)
    a, b = runs[0][0], runs[1][0]
    check(np.array_equal(np.asarray(a._score), np.asarray(b._score))
          and np.array_equal(a.gp_model.get_cov_pars(),
                             b.gp_model.get_cov_pars()),
          "two space-time GPBoost trainings differ in their bits")
    out = a.predict(X_pred, gp_coords_pred=pred, predict_var=True)
    check(bool(np.all(np.isfinite(out["response_mean"]))),
          "space-time GPBoost predictions not finite")
    t_train = runs[0][3]
    del runs, a, b
    torch.cuda.empty_cache()
    # card vs CPU, float64, the same ordering and neighbours
    vals = []
    for where in (dev, torch.device("cpu")):
        g = _st_model(coords[:ST_CPU_N], m, seed, where,
                      dtype=torch.float64)
        nll_w = g.neg_log_likelihood(cp, y[:ST_CPU_N])
        pw = g.predict(y=y[:ST_CPU_N], gp_coords_pred=pred[:100],
                       cov_pars=cp, predict_var=True)
        vals.append((nll_w, pw["mu"], pw["var"]))
    c, d = vals
    rel = max(abs(c[0] - d[0]) / abs(d[0]),
              float(np.max(np.abs(c[1] - d[1])) / np.max(np.abs(d[1]))),
              float(np.max(np.abs(c[2] - d[2]) / d[2])))
    check(rel <= ST_CPU_RTOL, f"space-time: card vs CPU {rel}")
    emit({"phase": "space_time_vecchia", "n": len(y), "m": m,
          "n_pred": len(pred), "nll_init": nll_init, "nll_fit": nll_fit,
          "nll_time_ordering": nll_time, "cov_pars": cp.tolist(),
          "fit_evaluations": fit_evals, "launches_gp": launches_gp,
          **entry, "same_bits": True, "card_vs_cpu_max_rel_err": rel})
    return entry["launches"], {
        "st_construct_s": t_c, "st_nll_s": t_n, "st_fit_s": t_f,
        "st_fit_evaluations": fit_evals, "st_predict_s": t_p,
        "st_time_construct_s": t_ct, "st_time_nll_s": t_nt,
        f"st_train_{ST_ROUNDS}r_s": t_train}


def matern_shape_vecchia(coords, y, m, seed, dev):
    """The general-order Matern under Vecchia on the GP data (n = 1e5,
    m = 20, float64): a fixed shape nu = 1.0 (NLL, L-BFGS fit) and
    ``matern_estimate_shape`` (NLL, one value-and-gradient, L-BFGS fit),
    the fits cut to MS_MAXIT iterations; the Bessel series run in chunks
    (``ops/cov_fns.py::_Chunked``); the peak memory. No kernel runs."""
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    out, timings = {}, {}
    for tag, kw in (("nu1", dict(cov_function="matern", cov_fct_shape=1.0)),
                    ("estimate", dict(cov_function="matern_estimate_shape"))):
        import gpboost_tpu_torch as gpt
        gp, t_c = _timed(lambda: gpt.GPModel(
            gp_coords=coords, gp_approx="vecchia", num_neighbors=m,
            seed=seed, dtype=torch.float64, device=dev, **kw))
        init = gp._default_init_cov_pars(y)
        if tag == "estimate":
            init[-1] = 1.0                # start the shape at nu = 1
        nll_init, t_n = _timed(lambda: gp.neg_log_likelihood(init, y))
        if tag == "estimate":
            th = torch.log(gp._tensor(init))
            y_t = gp._y_tensor(y)
            (v, g), t_vg = _timed(lambda: gp._approx._vg_gaussian(th, y_t,
                                                                  None))
            check(bool(torch.all(torch.isfinite(g))),
                  f"estimate-shape gradient not finite: {g}")
            timings["ms_estimate_vg_s"] = t_vg
            out["estimate_grad"] = g.cpu().tolist()
        _, t_f = _timed(lambda: gp.fit(y, params={
            "optimizer_cov": "lbfgs", "init_cov_pars": init,
            "maxit": MS_MAXIT}))
        nll = gp.get_current_neg_log_likelihood()
        check(math.isfinite(nll) and nll < nll_init,
              f"matern {tag}: the fit did not lower the NLL {nll_init} -> "
              f"{nll}")
        out[tag] = dict(nll_init=nll_init, nll=nll,
                        cov_pars=gp.get_cov_pars().tolist(),
                        evaluations=gp._fit_result.num_evals)
        timings.update({f"ms_{tag}_construct_s": t_c, f"ms_{tag}_nll_s": t_n,
                        f"ms_{tag}_fit_s": t_f,
                        f"ms_{tag}_fit_evaluations":
                        gp._fit_result.num_evals})
        del gp
        torch.cuda.empty_cache()
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    timings["ms_peak_mem_gb"] = peak
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the shape-Matern paths launched {launches}")
    emit({"phase": "matern_shape_vecchia", "n": len(y), "m": m,
          "maxit": MS_MAXIT, **out, "peak_mem_gb": peak,
          "launches": launches})
    return launches, timings


def _fit_predict_exact(gp, y, pred, maxit=None):
    """L-BFGS fit (cut to ``maxit`` if given) and a prediction with
    variances; returns (seconds of each, the prediction)."""
    params = {"optimizer_cov": "lbfgs"}
    if maxit is not None:
        params["maxit"] = maxit
    _, t_f = _timed(lambda: gp.fit(y, params=params))
    p, t_p = _timed(lambda: gp.predict(gp_coords_pred=pred,
                                       predict_var=True))
    check(bool(np.all(np.isfinite(p["mu"])) and np.all(p["var"] > 0)),
          "predictions not finite")
    return t_f, t_p, p


def _card_vs_cpu_exact(kw, coords, y, pred, cp, dev):
    """NLL and a prediction (mean, variance) of an exact model on the card
    against the float64 CPU run: the largest relative difference."""
    import gpboost_tpu_torch as gpt
    vals = []
    for where in (dev, "cpu"):
        g = gpt.GPModel(gp_coords=coords, device=where, **kw)
        pw = g.predict(y=y, gp_coords_pred=pred, cov_pars=cp,
                       predict_var=True)
        vals.append((g.neg_log_likelihood(cp, y), pw["mu"], pw["var"]))
    a, b = vals
    return max(abs(a[0] - b[0]) / abs(b[0]),
               float(np.max(np.abs(a[1] - b[1])) / np.max(np.abs(b[1]))),
               float(np.max(np.abs(a[2] - b[2]) / b[2])))


def tapering_exact(seed, dev):
    """``gp_approx="tapering"`` (exponential, taper shape 0, range
    TAP_RANGE) and the wendland covariance (the same taper as its
    correlation) at the top of the exact GP, n = EX_N, float64: L-BFGS fit
    and prediction at EX_N_PRED points each; card vs CPU at TAP_CPU_N
    points within 1e-9. The JAX package forms the tapered covariance
    dense, and so does the port. No kernel runs."""
    import gpboost_tpu_torch as gpt
    coords, y, pred = make_data(seed + 170, EX_N, EX_N_PRED)
    reset_counts()
    out, timings = {}, {}
    for tag, kw in (
            ("exponential", dict(cov_function="exponential",
                                 gp_approx="tapering", cov_fct_taper_shape=0,
                                 cov_fct_taper_range=TAP_RANGE)),
            ("wendland", dict(cov_function="wendland", cov_fct_taper_shape=0,
                              cov_fct_taper_range=TAP_RANGE))):
        gp, t_c = _timed(lambda: gpt.GPModel(gp_coords=coords, device=dev,
                                             **kw))
        t_f, t_p, _ = _fit_predict_exact(gp, y, pred)
        cp = gp.get_cov_pars()
        rel = _card_vs_cpu_exact(kw, coords[:TAP_CPU_N], y[:TAP_CPU_N],
                                 pred[:200], cp, dev)
        check(rel <= EX_CPU_RTOL, f"tapering {tag}: card vs CPU {rel}")
        out[tag] = dict(cov_pars=cp.tolist(),
                        nll=gp.get_current_neg_log_likelihood(),
                        evaluations=gp._fit_result.num_evals,
                        card_vs_cpu_max_rel_err=rel)
        timings.update({f"tap_{tag}_construct_s": t_c,
                        f"tap_{tag}_fit_s": t_f, f"tap_{tag}_predict_s": t_p,
                        f"tap_{tag}_fit_evaluations":
                        gp._fit_result.num_evals})
        del gp
        torch.cuda.empty_cache()
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the tapering paths launched {launches}")
    emit({"phase": "tapering_exact", "n": EX_N, "n_pred": EX_N_PRED,
          "taper_range": TAP_RANGE, **out, "launches": launches})
    return launches, timings


def cov_tail_exact(seed, dev):
    """``powered_exponential`` (shape 1.5), ``linear``, ``hurst``,
    ``space_time_gneiting`` and ``matern_ard_estimate_shape`` on the exact
    GP at n = CT_N, float64: NLL at the default inits, one
    value-and-gradient, the L-BFGS fit cut to CT_MAXIT; card vs CPU at
    CT_CPU_N points (NLL and gradient) within 1e-9. No kernel runs."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.models import gaussian as tga
    rng = np.random.default_rng(seed + 180)
    c2 = rng.uniform(size=(CT_N, 2))
    c3 = np.column_stack([np.repeat(np.linspace(0, 1, 50), CT_N // 50),
                          rng.uniform(size=(CT_N, 2))])
    y = (np.sin(6 * c2[:, 0]) + np.cos(4 * c2[:, 1])
         + 0.5 * rng.standard_normal(CT_N))
    reset_counts()
    out, timings = {}, {}
    for tag, coords, kw in (
            ("powered_exponential", c2, dict(cov_fct_shape=1.5)),
            ("linear", c2, {}), ("hurst", c2, {}),
            ("space_time_gneiting", c3, {}),
            ("matern_ard_estimate_shape", c2, {})):
        def vg(where, n):
            g = gpt.GPModel(gp_coords=coords[:n], cov_function=tag,
                            device=where, **kw)
            init = g._default_init_cov_pars(y[:n])
            v, grad = tga.nll_value_and_grad_log_scale(
                g.spec, g.data, torch.log(g._tensor(init)),
                g._tensor(y[:n]))
            return g, init, float(v), grad.cpu().numpy()

        (gp, init, v, grad), t_vg = _timed(lambda: vg(dev, CT_N))
        nll, t_n = _timed(lambda: gp.neg_log_likelihood(init, y))
        check(math.isfinite(nll) and bool(np.all(np.isfinite(grad))),
              f"{tag}: NLL {nll}, gradient {grad}")
        _, t_f = _timed(lambda: gp.fit(y, params={
            "optimizer_cov": "lbfgs", "maxit": CT_MAXIT}))
        nll_fit = gp.get_current_neg_log_likelihood()
        check(math.isfinite(nll_fit) and nll_fit <= nll,
              f"{tag}: the fit did not lower the NLL {nll} -> {nll_fit}")
        evals = gp._fit_result.num_evals
        del gp
        torch.cuda.empty_cache()
        a, b = vg(dev, CT_CPU_N)[2:], vg("cpu", CT_CPU_N)[2:]
        rel = max(abs(a[0] - b[0]) / abs(b[0]),
                  float(np.max(np.abs(a[1] - b[1]))
                        / np.max(np.abs(b[1]))))
        check(rel <= EX_CPU_RTOL, f"{tag}: card vs CPU {rel}")
        out[tag] = dict(nll_init=nll, nll=nll_fit, evaluations=evals,
                        card_vs_cpu_max_rel_err=rel)
        timings.update({f"ct_{tag}_nll_s": t_n, f"ct_{tag}_vg_s": t_vg,
                        f"ct_{tag}_fit_s": t_f,
                        f"ct_{tag}_fit_evaluations": evals})
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the exact tail families launched {launches}")
    emit({"phase": "cov_tail_exact", "n": CT_N, "maxit": CT_MAXIT, **out,
          "launches": launches})
    return launches, timings


def make_censored_data(seed):
    """Proportions with exact 0s and 1s (percent cover per site): CENS_N
    rows, a random intercept on CENS_LEVELS uniform levels, X = [1, x];
    the transformed-beta response (precision 20, u = 0.15), the
    shifted-gamma one (shape 5, xi = 0.1), and binomial counts of Poisson(5)
    trials; prediction rows at training levels."""
    rng = np.random.default_rng(seed + 190)
    n = CENS_N
    group = rng.integers(0, CENS_LEVELS, n)
    x = rng.uniform(-1.0, 1.0, n)
    X = np.column_stack([np.ones(n), x])
    eta = 0.7 * rng.standard_normal(CENS_LEVELS)[group] + 0.8 * x
    p = 1.0 / (1.0 + np.exp(-eta))
    t = rng.beta(p * 20.0, (1.0 - p) * 20.0)
    y_beta = np.clip(-0.15 + 1.3 * t, 0.0, 1.0)
    y_gamma = np.clip(rng.gamma(5.0, np.exp(0.5 * eta) / 5.0) - 0.1, 0.0, 1.0)
    trials = rng.poisson(5.0, n).astype(np.float64)
    y_bin = rng.binomial(trials.astype(np.int64), p) / np.maximum(trials, 1.0)
    gp_ = rng.integers(0, CENS_LEVELS, CENS_N_PRED)
    xp = rng.uniform(-1.0, 1.0, CENS_N_PRED)
    return dict(group=group, X=X, y_beta=y_beta, y_gamma=y_gamma,
                trials=trials, y_bin=y_bin, group_pred=gp_,
                X_pred=np.column_stack([np.ones(CENS_N_PRED), xp]))


def censored_glmm(gd, seed, dev):
    """The likelihood tail through the public API, float64: the two
    zero-one-censored families on a grouped GLMM at CENS_N rows (the
    default L-BFGS fit cut to CENS_MAXIT, response prediction at
    CENS_N_PRED rows; the shifted gamma's model built as gaussian and
    switched by ``set_likelihood`` before its fit), ``binomial_logit`` with
    the trial counts as ``weights`` on the same rows, a weighted grouped
    LMM at the LMM recipe's n and q (NLL, L-BFGS fit); card vs CPU at
    CENS_CPU_N rows within 1e-9. No kernel runs (the grouped routes' work
    is gathers, fixed-order sums and ``torch.linalg``)."""
    import gpboost_tpu_torch as gpt
    cd = make_censored_data(seed)
    reset_counts()
    out, timings = {}, {}
    for tag, lik, ykey, kw in (
            ("beta", ZOCB, "y_beta", {}), ("gamma", ZOCG, "y_gamma", {}),
            ("binomial", "binomial_logit", "y_bin",
             dict(weights=cd["trials"]))):
        y = cd[ykey]
        if tag == "gamma":
            gp = gpt.GPModel(group_data=cd["group"], device=dev, **kw)
            gp.set_likelihood(lik)
        else:
            gp = gpt.GPModel(group_data=cd["group"], likelihood=lik,
                             device=dev, **kw)
        _, t_f = _timed(lambda: gp.fit(y, X=cd["X"],
                                       params={"maxit": CENS_MAXIT}))
        p, t_p = _timed(lambda: gp.predict(
            group_data_pred=cd["group_pred"], X_pred=cd["X_pred"],
            predict_var=True, predict_response=True))
        check(bool(np.all((p["mu"] >= 0) & (p["mu"] <= 1))
                   and np.all(p["var"] > 0)),
              f"censored {tag}: response predictions outside [0, 1]")
        nll = gp.get_current_neg_log_likelihood()
        check(math.isfinite(nll), f"censored {tag}: NLL {nll}")
        out[tag] = dict(nll=nll, cov_pars=gp.get_cov_pars().tolist(),
                        aux_pars=None if gp.get_aux_pars() is None
                        else gp.get_aux_pars().tolist(),
                        coef=gp.get_coef().tolist(),
                        evaluations=gp._fit_result.num_evals,
                        zeros=int(np.sum(y == 0)), ones=int(np.sum(y == 1)))
        aux = gp.get_aux_pars()
        cp = gp.get_cov_pars()
        timings.update({f"cens_{tag}_fit_s": t_f,
                        f"cens_{tag}_predict_s": t_p,
                        f"cens_{tag}_fit_evaluations":
                        gp._fit_result.num_evals})
        del gp
        torch.cuda.empty_cache()
        rows = slice(0, CENS_CPU_N)
        nlls = [gpt.GPModel(group_data=cd["group"][rows], likelihood=lik,
                            device=where,
                            **({} if not kw else
                               dict(weights=cd["trials"][rows]))
                            ).neg_log_likelihood(cp, y[rows], aux_pars=aux)
                for where in (dev, "cpu")]
        rel = abs(nlls[0] - nlls[1]) / abs(nlls[1])
        check(rel <= CENS_CPU_RTOL, f"censored {tag}: card vs CPU {rel}")
        out[tag]["card_vs_cpu_rel_err"] = rel
    # the weighted LMM at the LMM recipe's width
    w = np.random.default_rng(seed + 191).uniform(0.5, 2.0, len(gd["y"]))
    lmm, t_c = _timed(lambda: gpt.GPModel(device=dev, weights=w,
                                          **_lmm_kwargs(gd)))
    nll, t_n = _timed(lambda: lmm.neg_log_likelihood(
        GR_TRUTH, gd["y"], fixed_effects=gd["X"] @ np.asarray(GR_BETA)))
    _, t_f = _timed(lambda: lmm.fit(gd["y"], X=gd["X"], params={
        "optimizer_cov": "lbfgs"}))
    nll_fit = lmm.get_current_neg_log_likelihood()
    check(math.isfinite(nll) and math.isfinite(nll_fit),
          f"weighted LMM: NLL {nll}, fit {nll_fit}")
    out["weighted_lmm"] = dict(q=lmm._Z.q, nll_truth=nll, nll=nll_fit,
                               cov_pars=lmm.get_cov_pars().tolist(),
                               coef=lmm.get_coef().tolist())
    timings.update({"cens_wlmm_construct_s": t_c, "cens_wlmm_nll_s": t_n,
                    "cens_wlmm_fit_s": t_f})
    del lmm
    torch.cuda.empty_cache()
    rows = slice(0, CENS_CPU_N)
    nlls = [gpt.GPModel(device=where, weights=w[rows],
                        **_lmm_kwargs(gd, rows)).neg_log_likelihood(
        GR_TRUTH, gd["y"][rows]) for where in (dev, "cpu")]
    rel = abs(nlls[0] - nlls[1]) / abs(nlls[1])
    check(rel <= CENS_CPU_RTOL, f"weighted LMM: card vs CPU {rel}")
    out["weighted_lmm"]["card_vs_cpu_rel_err"] = rel
    launches = read_counts()
    check(launches == NO_LAUNCHES,
          f"the censored / weighted paths launched {launches}")
    emit({"phase": "censored_glmm", "n": CENS_N, "levels": CENS_LEVELS,
          "maxit": CENS_MAXIT, "n_pred": CENS_N_PRED,
          "lmm_n": len(gd["y"]), **out, "launches": launches})
    return launches, timings


def cov_likelihood_tail_paths(coords, y, gd, m, seed, dev):
    """Phase 12 in order; returns (launches by path, timings)."""
    launches, timings = {}, {}
    for name, run in (
            ("space_time_vecchia", lambda: space_time_vecchia(m, seed, dev)),
            ("matern_shape_vecchia",
             lambda: matern_shape_vecchia(coords, y, m, seed, dev)),
            ("tapering_exact", lambda: tapering_exact(seed, dev)),
            ("cov_tail_exact", lambda: cov_tail_exact(seed, dev)),
            ("censored_glmm", lambda: censored_glmm(gd, seed, dev))):
        t0 = clock()
        launches[name], t = run()
        timings.update(t)
        timings[f"phase12_{name}_s"] = clock() - t0
        torch.cuda.empty_cache()
    return launches, timings


# ---------------------------------------------------------------------------
# phase 13: validation, metrics, early stopping, cv and the objectives
# without a GP (ROADMAP item 18a)
# ---------------------------------------------------------------------------

VAL_MAX_ROUNDS = 30               # early stopping decides the rounds run
VAL_EARLY_STOP = 5
VAL_METRICS = ["l2", "test_neg_log_likelihood", "crps_gaussian"]
VAL_SAMPLING = {"bagging_fraction": 0.8, "bagging_freq": 1,
                "feature_fraction": 0.8}
VAL_CPU_N = 2_000                 # points of the card-vs-CPU check
VAL_CPU_N_PRED = 500
VAL_CPU_ROUNDS = 10
VAL_CPU_RTOL = 1e-9
OBJ_ROUNDS = 10
OBJ_CPU_N = 2_000
OBJ_CPU_TOL = 1e-9
# the objectives without a GP, each with its own parameters
OBJECTIVES_TAIL = (
    ("regression_l1", {}), ("huber", {}), ("fair", {}), ("poisson", {}),
    ("gamma", {}), ("tweedie", {}), ("quantile", {"alpha": 0.3}),
    ("mape", {}), ("tobit", {"sigma": 0.2, "yl": 0.0, "yu": 1.0}),
    ("cross_entropy", {}), ("cross_entropy_lambda", {}),
    ("mean_scale_regression", {}), ("multiclass", {"num_class": 3}),
    ("multiclassova", {"num_class": 3}))
CV_NFOLD = 4
CV_ROUNDS = 10
CV_EARLY_STOP = 5
# the README's GPBoost tuning example (examples/gpboost_algorithm.py:48-56)
README_N, README_GROUPS = 1000, 25
README_GRID = {"learning_rate": [0.1, 0.01], "max_depth": [3, 6]}
# depth cut (the README's 50): phase 14 needed the script's time, PERF.md
# section 4
README_ROUNDS = 10                # depth cut: 20 until phase 16


def _recipe_f(X):
    return 2.0 * np.sin(5 * X[:, 0]) + X[:, 1] ** 2 + X[:, 2]


def _valid_labels(seed, X_pred, pred):
    """The boosting recipe's response at the prediction points: f(X) plus
    the GP data's signal sin(6 x1) + cos(4 x2) and noise."""
    rng = np.random.default_rng(seed + 30)
    return (_recipe_f(X_pred) + np.sin(6 * pred[:, 0])
            + np.cos(4 * pred[:, 1]) + 0.5 * rng.standard_normal(len(pred)))


def _validation_train(X, yb, Xv, yv, coords, pv, m, seed, dtype, dev,
                      rounds, **extra):
    """``train`` with a validation set and the GP in its score: the
    boosting recipe with bagging and feature sampling, early stopping."""
    import gpboost_tpu_torch as gpt
    gp = _gp_model(coords, m, seed, dtype, dev)
    gp.set_prediction_data(gp_coords_pred=pv)
    ds = gpt.Dataset(X, label=yb, device=dev)
    dv = ds.create_valid(Xv, label=yv)
    ev = {}
    params = dict(BOOST_PARAMS, use_gp_model_for_validation=True,
                  metric=VAL_METRICS, **VAL_SAMPLING, **extra)
    bst = gpt.train(params, ds, gp_model=gp, num_boost_round=rounds,
                    valid_sets=[dv], early_stopping_rounds=VAL_EARLY_STOP,
                    evals_result=ev, verbose_eval=False)
    return bst, ev, ds


def _tree_pairs_agree(b1, b2, tol):
    """Trees of two trainings: the same split features and bins and leaf
    values within ``tol``, up to the first split that differs; there the
    two splits' gains must tie, within 1e-9 of the larger of the two and
    of the tree's root gain (two cut points that order the rows alike, or
    gains that are 0 in exact arithmetic and round to ~1e-14 — a leaf whose
    rows share one gradient —, broken by the last bits of sums taken in
    another order). Returns (trees identical, the tie or None)."""
    for k, (a, b) in enumerate(zip(b1.trees, b2.trees)):
        ia, ib = a.internal_nodes(), b.internal_nodes()
        same = (np.array_equal(ia, ib)
                and np.array_equal(a.split_feature[ia], b.split_feature[ib])
                and np.array_equal(a.threshold_bin[ia], b.threshold_bin[ib]))
        if same:
            err = float(np.max(np.abs(a.leaf_value - b.leaf_value)))
            check(err <= tol * max(1.0, float(np.max(np.abs(b.leaf_value)))),
                  f"tree {k}: leaf values {err} apart")
            continue
        for node in sorted(set(ia) | set(ib)):
            if (a.split_feature[node], a.threshold_bin[node], a.is_leaf[node]) \
                    != (b.split_feature[node], b.threshold_bin[node],
                        b.is_leaf[node]):
                ga, gb = float(a.split_gain[node]), float(b.split_gain[node])
                scale = max(abs(ga), abs(gb), abs(float(a.split_gain[0])))
                tie = {"tree": k, "node": int(node), "gains": [ga, gb],
                       "root_gain": float(a.split_gain[0]),
                       "splits": [[int(a.split_feature[node]),
                                   int(a.threshold_bin[node])],
                                  [int(b.split_feature[node]),
                                   int(b.threshold_bin[node])]]}
                check(abs(ga - gb) <= 1e-9 * scale,
                      f"the splits differ and their gains do not tie: {tie}")
                return k, tie
        return k, {"tree": k, "node": None}
    check(len(b1.trees) == len(b2.trees),
          f"{len(b1.trees)} vs {len(b2.trees)} trees")
    return len(b1.trees), None


def gpboost_validation(boost_data, coords, pred, m, seed, dev):
    """``train`` of the boosting recipe at full width with a validation set
    of the 10 000 prediction points, ``use_gp_model_for_validation`` (the
    float32 Vecchia GP's prediction added to the trees' score, every round:
    the ``vecchia_factors`` kernel at the prediction shape), three metrics,
    bagging and feature fraction, early stopping; trained twice to the same
    bits; card vs CPU at VAL_CPU_N points in float64."""
    from gpboost_tpu_torch.boosting.tree import grow_tree
    X, yb, X_pred = boost_data
    yv = _valid_labels(seed, X_pred, pred)
    reset_counts()
    t0 = clock()
    bst, ev, ds = _validation_train(X, yb, X_pred, yv, coords, pred, m, seed,
                                    torch.float32, dev, VAL_MAX_ROUNDS)
    t_train = clock() - t0
    launches = read_counts()
    reads = grow_tree.host_reads
    rounds = bst.current_iteration()
    curves = ev["valid_0"]
    leaves = sum(t.num_leaves for t in bst.trees)
    check(list(curves) == VAL_METRICS and all(
        len(c) == rounds for c in curves.values()),
        f"validation curves {[(k, len(c)) for k, c in curves.items()]} for "
        f"{rounds} rounds")
    check(all(math.isfinite(v) for c in curves.values() for v in c),
          "validation curves not finite")
    want_launches, want_reads = grower_counts(bst.trees,
                                              bst.grower.num_leaves)
    check(launches["histogram"] == want_launches, f"gpboost_validation: "
          f"histogram launched {launches['histogram']} times for {leaves} "
          f"leaves, {want_launches} expected")
    check(reads == want_reads, f"gpboost_validation: {reads} grower host "
          f"reads for {leaves} leaves, {want_reads} expected")
    check(launches["vecchia_factors"] > 0 and launches["vecchia_nll_grad"] > 0,
          f"gpboost_validation: Vecchia kernels {launches}")
    best = bst.best_iteration
    l2 = curves["l2"]
    check(best == -1 or (rounds - best == VAL_EARLY_STOP),
          f"best_iteration {best} after {rounds} rounds")
    check(min(l2) < l2[0], f"the validation l2 did not fall: {l2}")
    _check_trees(bst, "gpboost_validation")
    # one round's validation, timed alone, and its kernel launches
    reset_counts()
    t0 = clock()
    bst.eval_valid()
    t_valid = clock() - t0
    valid_launches = read_counts()
    check(valid_launches["vecchia_factors"] > 0,
          "the validation prediction launched no vecchia_factors")
    # the histogram kernel on this Dataset with the last round's bag
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    g, h = _hist_values(gen, ds.num_data, dev)
    bag = bst._bag_mask_t
    check(bag is not None and 0 < int(bag.sum()) < ds.num_data,
          "gpboost_validation: no bag")
    hist_cases, hist_timed = check_histogram_on(ds, seed, dev,
                                                "gpboost_validation")
    hist_cases.append(_hist_compare("gpboost_validation_bag", ds.binned,
                                    ds.binned_t, g, h, bag,
                                    ds.max_num_bins))
    # the same training again: the same bits
    bst2, ev2, _ = _validation_train(X, yb, X_pred, yv, coords, pred, m,
                                     seed, torch.float32, dev,
                                     VAL_MAX_ROUNDS)
    check(np.array_equal(bst._score, bst2._score) and ev == ev2
          and bst.best_iteration == bst2.best_iteration,
          "gpboost_validation: two trainings differ")
    # card vs CPU, float64, gpu_use_dp on the card
    n, npv = VAL_CPU_N, VAL_CPU_N_PRED
    sub = (X[:n], yb[:n], X_pred[:npv], yv[:npv], coords[:n], pred[:npv], m,
           seed, torch.float64)
    bc, evc, _ = _validation_train(*sub, dev, VAL_CPU_ROUNDS,
                                   gpu_use_dp=True)
    bh, evh, _ = _validation_train(*sub, torch.device("cpu"), VAL_CPU_ROUNDS)
    compared, tie = _tree_pairs_agree(bc, bh, VAL_CPU_RTOL)
    check(tie is None, f"card vs CPU: a tie of split gains: {tie}")
    score_err = float(np.max(np.abs(bc._score - bh._score)))
    check(score_err <= VAL_CPU_RTOL * float(np.max(np.abs(bh._score))),
          f"card vs CPU: training scores {score_err} apart")
    curve_err = max(float(np.max(np.abs(np.asarray(evc["valid_0"][k])
                                        - np.asarray(evh["valid_0"][k]))
                                 / np.abs(np.asarray(evh["valid_0"][k]))))
                    for k in VAL_METRICS)
    check(curve_err <= VAL_CPU_RTOL and bc.best_iteration == bh.best_iteration,
          f"card vs CPU: curves {curve_err} apart (relative), best "
          f"iterations {bc.best_iteration}, {bh.best_iteration}")
    emit({"phase": "gpboost_validation", "n": len(yb), "n_valid": len(yv),
          "metrics": VAL_METRICS, **VAL_SAMPLING,
          "early_stopping_rounds": VAL_EARLY_STOP, "rounds_run": rounds,
          "best_iteration": best, "evals_result": curves, "leaves": leaves,
          "launches": launches, "host_reads_per_tree": reads / len(bst.trees),
          "fits": len(bst.objective.fits), "cov_pars":
          bst.gp_model.get_cov_pars().tolist(),
          "validation_s_per_round": t_valid,
          "validation_launches_per_round": valid_launches,
          "same_bits": True,
          "vs_cpu": {"n": n, "n_valid": npv, "trees_compared": compared,
                     "score_max_abs_diff": score_err,
                     "curve_max_rel_diff": curve_err,
                     "best_iteration": bc.best_iteration,
                     "tolerance": VAL_CPU_RTOL}})
    return launches, {"val_train_s": t_train, "val_rounds": rounds,
                      "val_s_per_round_eval": t_valid}, (hist_cases,
                                                         hist_timed)


def _objective_labels(name, X, rng):
    f = _recipe_f(X)
    n = len(X)
    if name == "poisson":
        return rng.poisson(np.exp(0.5 * f - 1.0)).astype(float)
    if name in ("gamma", "mape"):          # positive, relative errors
        return np.exp(0.3 * f) * rng.gamma(2.0, 0.5, n)
    if name == "tweedie":
        return rng.poisson(np.exp(0.3 * f - 0.5)) * rng.gamma(2.0, 0.5, n)
    if name == "tobit":
        return np.clip((f + 1.0) / 5.0 + 0.1 * rng.standard_normal(n), 0, 1)
    if name.startswith("cross_entropy"):
        return 1.0 / (1.0 + np.exp(-(f - 1.5)))
    if name.startswith("multiclass"):
        return np.digitize(f + 0.5 * rng.standard_normal(n),
                           [0.5, 2.0]).astype(float)
    return f + 0.5 * rng.standard_normal(n)


def objectives_tail(boost_data, seed, dev):
    """Each objective without a GP on the recipe's 5 features at the full
    n, OBJ_ROUNDS rounds with the 10 000-row validation set and its default
    metric: histogram launches = leaves (num_models trees a round for the
    multiclass objectives and mean_scale_regression), float32 vs
    ``gpu_use_dp`` within CMP_SCORE_TOL, card vs CPU at OBJ_CPU_N rows."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    X, _, X_pred = boost_data
    out, timings, launches_all = {}, {}, None
    ds = gpt.Dataset(X, label=np.zeros(len(X)), device=dev)
    dv = ds.create_valid(X_pred, label=np.zeros(len(X_pred)))
    for k, (name, extra) in enumerate(OBJECTIVES_TAIL):
        rng = np.random.default_rng(seed + 40 + k)
        y = _objective_labels(name, X, rng)
        yv = _objective_labels(name, X_pred, rng)
        ds.set_label(y)
        dv.set_label(yv)
        params = dict(BOOST_PARAMS, objective=name, **extra)
        reset_counts()
        t0 = clock()
        ev = {}
        bst = gpt.train(params, ds, num_boost_round=OBJ_ROUNDS,
                        valid_sets=[dv], evals_result=ev, verbose_eval=False)
        t_train = clock() - t0
        launches = read_counts()
        reads = grow_tree.host_reads
        K = bst.num_models
        leaves = sum(t.num_leaves for t in bst.trees)
        check(len(bst.trees) == OBJ_ROUNDS * K,
              f"{name}: {len(bst.trees)} trees for {OBJ_ROUNDS} rounds x {K}")
        want_launches, want_reads = grower_counts(bst.trees,
                                                  bst.grower.num_leaves)
        check(launches["histogram"] == want_launches, f"{name}: histogram "
              f"launched {launches['histogram']} times for {leaves} leaves, "
              f"{want_launches} expected")
        check(reads == want_reads, f"{name}: {reads} grower host reads, "
              f"{want_reads} expected")
        check(launches["vecchia_factors"] == launches["vecchia_nll_grad"]
              == 0, f"{name} launched a Vecchia kernel")
        (metric, curve), = ev["valid_0"].items()
        check(all(math.isfinite(v) for v in curve) and curve[-1] < curve[0],
              f"{name}: the validation {metric} did not fall: {curve}")
        pred = bst.predict(X_pred)
        vals = (np.concatenate(list(pred.values())) if isinstance(pred, dict)
                else pred)
        check(bool(np.all(np.isfinite(vals))), f"{name}: predictions")
        # float32 (the kernel) vs float64 (gpu_use_dp) on the card
        b64 = gpt.train(dict(params, gpu_use_dp=True), ds,
                        num_boost_round=OBJ_ROUNDS)
        rms = float(np.sqrt(np.mean((bst._score - b64._score) ** 2))
                    / max(float(np.std(b64._score)), 1e-12))
        check(rms <= CMP_SCORE_TOL, f"{name}: float32 vs float64 scores "
              f"RMS {rms} of the score's sd")
        # card (float64) vs CPU at OBJ_CPU_N rows
        n = OBJ_CPU_N
        bc = gpt.train(dict(params, gpu_use_dp=True),
                       gpt.Dataset(X[:n], label=y[:n], device=dev),
                       num_boost_round=OBJ_ROUNDS)
        bh = gpt.train(params, gpt.Dataset(X[:n], label=y[:n], device="cpu"),
                       num_boost_round=OBJ_ROUNDS)
        compared, tie = _tree_pairs_agree(bc, bh, OBJ_CPU_TOL)
        err = float(np.max(np.abs(bc._score - bh._score)))
        cpu_rms = float(np.sqrt(np.mean((bc._score - bh._score) ** 2))
                        / max(float(np.std(bh._score)), 1e-12))
        if tie is not None:
            # an exact tie (counts share gradients, a two-valued gradient
            # makes gains equal): the card's fixed-point sums and the CPU's
            # sequential ones break it by their last bits, and the two
            # trainings go on as two valid runs. What came before the tie
            # is held: the scores of the iterations before its tree
            it = tie["tree"] // K
            err = (float(np.max(np.abs(bc.init_score - bh.init_score)))
                   if it == 0 else float(np.max(np.abs(
                       bc.predict(X[:n], num_iteration=it, raw_score=True)
                       - bh.predict(X[:n], num_iteration=it,
                                    raw_score=True)))))
            tie["iterations_before"] = it
        check(err <= OBJ_CPU_TOL * max(1.0, float(np.max(np.abs(
            bh._score)))), f"{name}: card vs CPU scores {err} apart "
            f"(tie: {tie})")
        entry = {"trees": len(bst.trees), "num_models": K, "leaves": leaves,
                 "metric": metric, "curve_first": curve[0],
                 "curve_last": curve[-1], "launches": launches,
                 "train_s": t_train, "f32_vs_f64_rms": rms,
                 "cpu_trees_identical": compared, "cpu_tie": tie,
                 "cpu_score_max_abs_diff": err, "cpu_score_rms": cpu_rms}
        out[name] = entry
        timings[f"obj_{name}_train_s"] = t_train
        launches_all = (launches if launches_all is None else
                        {k2: launches_all[k2] + v for k2, v in
                         launches.items()})
    emit({"phase": "objectives_tail", "n": len(X), "n_valid": len(X_pred),
          "rounds": OBJ_ROUNDS, "cpu_n": OBJ_CPU_N, **out})
    return launches_all, timings


def _readme_grouped(seed=1, n=README_N, m=README_GROUPS):
    """examples/gpboost_algorithm.py's simulate_grouped."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, 2))
    F = 1.7 * (1 / (1 + np.exp(-(X[:, 0] - 0.5) * 20)) + 0.75 * X[:, 0])
    group = np.arange(n) % m
    b = np.sqrt(0.3527) * rng.standard_normal(m)
    y = F + b[group] + np.sqrt(0.29 / 2) * rng.standard_normal(n)
    return X, y, group


def cv_grouped(seed, n, dev):
    """``cv`` of the grouped GPBoost recipe (GB_LEVELS levels) with
    GP-aware folds, early stopping and ``fit_GP_cov_pars_OOS``; then the
    README's ``grid_search_tune_parameters`` on the card and on the CPU."""
    import gpboost_tpu_torch as gpt
    bd = _grouped_boost_data(seed, n, 10)
    gp = gpt.GPModel(group_data=bd["g"], device=dev)
    ds = gpt.Dataset(bd["X"], label=bd["y"], device=dev)
    reset_counts()
    t0 = clock()
    res = gpt.cv(BOOST_PARAMS, ds, num_boost_round=CV_ROUNDS, gp_model=gp,
                 nfold=CV_NFOLD, early_stopping_rounds=CV_EARLY_STOP,
                 fit_GP_cov_pars_OOS=True, seed=seed, return_cvbooster=True)
    t_cv = clock() - t0
    launches = read_counts()
    cvb = res.pop("cvbooster")
    leaves = sum(t.num_leaves for b in cvb.boosters for t in b.trees)
    want_launches = sum(grower_counts(b.trees, b.grower.num_leaves)[0]
                        for b in cvb.boosters)
    check(launches["histogram"] == want_launches, f"cv: histogram launched "
          f"{launches['histogram']} times for {leaves} leaves, "
          f"{want_launches} expected")
    check(launches["vecchia_factors"] == launches["vecchia_nll_grad"] == 0,
          "cv launched a Vecchia kernel")
    curve = res["l2-mean"]
    check(len(curve) >= 1 and all(math.isfinite(v) for v in curve)
          and curve[-1] < curve[0], f"cv: l2-mean {curve}")
    oos = gp.get_cov_pars()
    check(bool(np.all(np.isfinite(oos)) and np.all(oos > 0)),
          f"cv: OOS cov_pars {oos}")
    # the README's tuning example, card and CPU
    Xr, yr, gr = _readme_grouped()
    best = {}
    t_grid = {}
    for tag, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = clock()
        best[tag] = gpt.grid_search_tune_parameters(
            param_grid=README_GRID,
            params={"objective": "regression", "verbose": 0},
            train_set=gpt.Dataset(Xr, label=yr, device=d),
            gp_model=gpt.GPModel(group_data=gr, likelihood="gaussian",
                                 device=d),
            num_boost_round=README_ROUNDS, nfold=4, verbose_eval=0, seed=1)
        t_grid[tag] = clock() - t0
    check(best["card"]["best_params"] == best["cpu"]["best_params"]
          and best["card"]["best_iter"] == best["cpu"]["best_iter"],
          f"grid search: card {best['card']} vs CPU {best['cpu']}")
    emit({"phase": "cv_grouped", "n": n, "levels": GB_LEVELS,
          "nfold": CV_NFOLD, "rounds": CV_ROUNDS,
          "early_stopping_rounds": CV_EARLY_STOP, "curves": res,
          "folds_rounds": [b.current_iteration() for b in cvb.boosters],
          "cv_s": t_cv, "s_per_fold": t_cv / CV_NFOLD,
          "oos_cov_pars": oos.tolist(), "launches": launches,
          "grid_search": {"n": README_N, "groups": README_GROUPS,
                          "grid": README_GRID, "rounds": README_ROUNDS,
                          "card": {k: (float(v) if k == "best_score" else v)
                                   for k, v in best["card"].items()},
                          "cpu": {k: (float(v) if k == "best_score" else v)
                                  for k, v in best["cpu"].items()},
                          "card_s": t_grid["card"], "cpu_s": t_grid["cpu"]}})
    return launches, {"cv_s": t_cv, "cv_s_per_fold": t_cv / CV_NFOLD,
                      "grid_search_card_s": t_grid["card"],
                      "grid_search_cpu_s": t_grid["cpu"]}


def boosting_tail_paths(boost_data, coords, pred, m, seed, n, dev):
    """Phase 13 in order; returns (launches by path, timings, the
    histogram's cases and timing on the validation path's Dataset)."""
    launches, timings = {}, {}
    t0 = clock()
    launches["gpboost_validation"], t, hist = gpboost_validation(
        boost_data, coords, pred, m, seed, dev)
    timings.update(t)
    timings["phase13_gpboost_validation_s"] = clock() - t0
    for name, run in (
            ("objectives_tail", lambda: objectives_tail(boost_data, seed,
                                                        dev)),
            ("cv_grouped", lambda: cv_grouped(seed, n, dev))):
        t0 = clock()
        launches[name], t = run()
        timings.update(t)
        timings[f"phase13_{name}_s"] = clock() - t0
        torch.cuda.empty_cache()
    return launches, timings, hist


# ---------------------------------------------------------------------------
# phase 14: the tree learner's tail and the data it reads (ROADMAP item 18b,
# part 1): categorical features, EFB, the grower's options, sparse input and
# the files
# ---------------------------------------------------------------------------

TT_ROUNDS = 10
TT_C1_LEVELS = 30                 # uniform levels, their effect added to f
TT_C2_LEVELS = 400                # Zipf levels, past the 255-bin cap
TT_ZIPF = 1.1
TT_NAN = 0.1                      # share of X1 missing
TT_UNSEEN = 0.05                  # share of prediction rows at unseen levels
TT_ONEHOT_LEVELS = 60
TT_CPU_N = 2_000                  # rows of the card-vs-CPU checks
TT_CPU_RTOL = 1e-9
TT_OPT_ROUNDS = 5                 # depth cut of tree_options (phase 14: 10)
TT_MDS = 1.0                      # max_delta_step of tree_options
TT_FORCED = {"feature": 0, "threshold": 0.5,
             "left": {"feature": 1, "threshold": 0.5}}
TT_FORCED_CASES = ("forced_splits", "forcedsplits_filename")
TT_GROUPS = [[0, 1], [2, 3, 4]]


def make_tree_tail_data(seed, X, yb, X_pred):
    """The Boosting recipe with two categorical columns: c1 (30 uniform
    levels, effect N(0, 1) added to the label) and c2 (400 Zipf-1.1 levels,
    no effect: more levels than the 255-bin cap), 10 % NaN in X1; the
    prediction rows with 5 % unseen levels in each."""
    rng = np.random.default_rng(seed + 140)
    n, n_pred = len(yb), len(X_pred)
    eff = rng.standard_normal(TT_C1_LEVELS)

    def cats(k):
        c1 = rng.integers(0, TT_C1_LEVELS, k).astype(float)
        c2 = ((rng.zipf(TT_ZIPF, k) - 1) % TT_C2_LEVELS).astype(float)
        return c1, c2

    c1, c2 = cats(n)
    Xc = np.column_stack([X, c1, c2])
    Xc[rng.random(n) < TT_NAN, 0] = np.nan
    y = yb + eff[c1.astype(int)]
    p1, p2 = cats(n_pred)
    p1[rng.random(n_pred) < TT_UNSEEN] = TT_C1_LEVELS + 7.0
    p2[rng.random(n_pred) < TT_UNSEEN] = TT_C2_LEVELS + 11.0
    Xc_pred = np.column_stack([X_pred, p1, p2])
    return Xc, y, Xc_pred


def make_onehot_data(seed, X, n_pred):
    """The recipe's 5 features and the 0/1 columns of a 60-level factor
    whose effect is added to f(X): 65 columns."""
    rng = np.random.default_rng(seed + 141)
    n = len(X)
    lv = rng.integers(0, TT_ONEHOT_LEVELS, n)
    eff = rng.standard_normal(TT_ONEHOT_LEVELS)
    oh = np.zeros((n, TT_ONEHOT_LEVELS))
    oh[np.arange(n), lv] = 1.0
    y = _recipe_f(X) + eff[lv] + 0.5 * rng.standard_normal(n)
    return np.hstack([X, oh]), y


def _tt_agree(b1, b2, X, tol):
    """Card vs CPU trees (``_tree_pairs_agree``: the same splits and leaf
    values within ``tol`` up to the first tie of two gains, checked to be
    one), the categorical left sets of the trees before it (a left set and
    its mirror image tie exactly too: where they differ, the two gains must
    tie within 1e-9 of the root gain, and the comparison stops there), the
    linear coefficients, and the raw predictions of the iterations before
    the tie within ``tol`` of the score's scale. Returns (trees identical,
    the tie or None, score difference)."""
    compared, tie = _tree_pairs_agree(b1, b2, tol)
    for k, (a, b) in enumerate(zip(b1.trees[:compared],
                                   b2.trees[:compared])):
        diff = np.flatnonzero((a.cat_mask != b.cat_mask).any(axis=1))
        if len(diff):
            node = int(diff[0])
            ga, gb = float(a.split_gain[node]), float(b.split_gain[node])
            root = abs(float(b.split_gain[0]))
            tie = {"tree": k, "node": node, "gains": [ga, gb],
                   "root_gain": root, "left_sets": "mirror images"}
            check(abs(ga - gb) <= 1e-9 * max(abs(ga), abs(gb), root),
                  f"card vs CPU: the categorical left sets differ and "
                  f"their gains do not tie: {tie}")
            compared = k
            break
        if a.lin_coefs is not None or b.lin_coefs is not None:
            err = float(np.max(np.abs(a.lin_coefs - b.lin_coefs)))
            check(err <= tol * max(1.0, float(np.max(np.abs(b.lin_coefs)))),
                  f"card vs CPU: linear coefficients {err} apart")
    K = b1.num_models
    it = (compared if tie is None else tie["tree"]) // K
    if it == 0:
        err = float(np.max(np.abs(b1.init_score - b2.init_score)))
    else:
        p1 = b1.predict(X, num_iteration=it, raw_score=True)
        p2 = b2.predict(X, num_iteration=it, raw_score=True)
        err = float(np.max(np.abs(p1 - p2)))
    scale = max(1.0, float(np.max(np.abs(b2._score))))
    check(err <= tol * scale, f"card vs CPU: raw scores {err} apart after "
          f"{it} iterations (tie: {tie})")
    if tie is not None:
        # reported, not gated: after a categorical left set and its mirror
        # image the two trainings hold the same partitions and stay close
        tie["iterations_before"] = it
        tie["scores_after_max_abs_diff"] = float(
            np.max(np.abs(b1._score - b2._score)))
    return compared, tie, err


def _cat_scan_ms(ds, seed, dev, reps=20):
    """What the categorical scan of one leaf costs (host clock, synchronised)
    on this Dataset's root histogram, with the ``min_data_per_group`` group
    scan (its kernel, a sequential pass over the bins) and without it: the
    difference is the group scan's cost a leaf."""
    from gpboost_tpu_torch.boosting import tree as tt
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    g, h = _hist_values(gen, ds.num_data, dev)
    full = torch.ones(ds.num_data, dtype=torch.bool, device=dev)
    hist = torch.stack(tt.build_histogram(ds.binned, g, h, full,
                                          ds.max_num_bins,
                                          binned_t=ds.binned_t))
    idx = torch.as_tensor(ds.categorical_feature, device=dev)
    nb = torch.as_tensor(ds.num_bins, device=dev)[idx]
    out = {}
    for key, mdpg in (("tt_cat_scan_ms", 100.0),
                      ("tt_cat_scan_no_group_ms", 0.0)):
        reads = tt.grow_tree.host_reads
        t0 = clock()
        for _ in range(reps):
            tt._cat_scan(hist[:, idx], nb, 0.0, 0.0, 20.0, 1e-3, 32, None,
                         10.0, 10.0, mdpg, 4)
        out[key] = (clock() - t0) / reps * 1e3
        tt.grow_tree.host_reads = reads
    out["tt_group_scan_ms_per_leaf"] = (out["tt_cat_scan_ms"]
                                        - out["tt_cat_scan_no_group_ms"])
    return out


def _cat_gpboost_train(Xc, y, coords, m, seed, dtype, dev, **extra):
    import gpboost_tpu_torch as gpt
    gp = _gp_model(coords, m, seed, dtype, dev)
    ds = gpt.Dataset(Xc, label=y, categorical_feature=[5, 6], device=dev)
    bst = gpt.train(dict(BOOST_PARAMS, **extra), ds, gp_model=gp,
                    num_boost_round=TT_ROUNDS)
    return bst, ds


def categorical_gpboost(tt_data, coords, pred, m, seed, dev):
    """GPBoost on the recipe with two categorical columns (c2 past the
    255-bin cap), 10 % NaN in X1, the float32 Vecchia GP with L-BFGS
    refits, TT_ROUNDS rounds; prediction at the 10 000 points with 5 %
    unseen levels; the histogram kernel on this Dataset; trained twice to
    the same bits; card vs CPU at TT_CPU_N points in float64."""
    from gpboost_tpu_torch.boosting.tree import grow_tree
    Xc, y, Xc_pred = tt_data
    reset_counts()
    t0 = clock()
    bst, ds = _cat_gpboost_train(Xc, y, coords, m, seed, torch.float32, dev)
    t_train = clock() - t0
    launches = read_counts()
    reads = grow_tree.host_reads
    leaves = sum(t.num_leaves for t in bst.trees)
    n_cat = sum(int(np.sum(t.is_categorical[t.internal_nodes()]))
                for t in bst.trees)
    # on the card the fixed-shape grower takes categorical trees: num_leaves
    # launches and one read (its fetch) a tree, the group scan once a leaf
    # scanned
    want_launches, want_reads = grower_counts(bst.trees,
                                              bst.grower.num_leaves)
    check(launches["histogram"] == want_launches, f"categorical_gpboost: "
          f"histogram launched {launches['histogram']} times for {leaves} "
          f"leaves, {want_launches} expected")
    check(reads == want_reads, f"categorical_gpboost: {reads} grower host "
          f"reads, {want_reads} expected")
    check(launches["cat_group_scan"]
          == TT_ROUNDS * (2 * bst.grower.num_leaves - 1),
          f"categorical_gpboost: the group scan launched "
          f"{launches['cat_group_scan']} times in {TT_ROUNDS} trees")
    check(n_cat > 0, "categorical_gpboost: no categorical split")
    check(launches["vecchia_factors"] > 0 and launches["vecchia_nll_grad"] > 0,
          f"categorical_gpboost: Vecchia kernels {launches}")
    check(ds.num_bins[6] == 255 and int(ds.binned[:, 6].max()) == 254,
          "categorical_gpboost: c2's bins are not capped at 255")
    t0 = clock()
    out = bst.predict(Xc_pred, gp_coords_pred=pred, predict_var=True)
    t_pred = clock() - t0
    for key in ("response_mean", "response_var", "fixed_effect"):
        v = np.asarray(out[key])
        check(v.shape == (len(Xc_pred),) and bool(np.all(np.isfinite(v))),
              f"categorical_gpboost: prediction {key}")
    hist_cases, hist_timed = check_histogram_on(ds, seed, dev,
                                                "categorical_gpboost")
    scan_ms = _cat_scan_ms(ds, seed, dev)
    bst2, _ = _cat_gpboost_train(Xc, y, coords, m, seed, torch.float32, dev)
    check(np.array_equal(bst._score, bst2._score)
          and np.array_equal(bst.gp_model.get_cov_pars(),
                             bst2.gp_model.get_cov_pars()),
          "categorical_gpboost: two trainings differ")
    n = TT_CPU_N
    bc, _ = _cat_gpboost_train(Xc[:n], y[:n], coords[:n], m, seed,
                               torch.float64, dev, gpu_use_dp=True)
    bh, _ = _cat_gpboost_train(Xc[:n], y[:n], coords[:n], m, seed,
                               torch.float64, torch.device("cpu"))
    compared, tie, err = _tt_agree(bc, bh, Xc[:n], TT_CPU_RTOL)
    emit({"phase": "categorical_gpboost", "n": len(y), "rounds": TT_ROUNDS,
          "levels": [TT_C1_LEVELS, TT_C2_LEVELS], "nan_share": TT_NAN,
          "num_bins": [int(b) for b in ds.num_bins], "leaves": leaves,
          "categorical_splits": n_cat, "launches": launches,
          "host_reads_per_leaf": reads / leaves, "train_s": t_train,
          "predict_s": t_pred, "same_bits": True, **scan_ms,
          "vs_cpu": {"n": n, "trees_identical": compared, "tie": tie,
                     "raw_score_max_abs_diff": err,
                     "tolerance": TT_CPU_RTOL}})
    return launches, {"tt_cat_train_s": t_train, "tt_cat_predict_s": t_pred,
                      **scan_ms}, \
        (hist_cases, hist_timed)


def efb_onehot(oh_data, seed, dev):
    """The recipe's features and a one-hot 60-level factor (65 columns,
    `regression`, TT_ROUNDS rounds): EFB bundles them, the kernel is held
    against its plain version on the bundle panel, and the training is held
    against the same one without bundling."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    X, y = oh_data
    ds = gpt.Dataset(X, label=y, device=dev)
    efb = ds.efb
    check(efb is not None and efb.binned_hist_t is not None,
          "efb_onehot: EFB did not engage")
    G = efb.binned_hist.shape[1]
    reset_counts()
    t0 = clock()
    bst = gpt.train(BOOST_PARAMS, ds, num_boost_round=TT_ROUNDS)
    t_train = clock() - t0
    launches = read_counts()
    reads = grow_tree.host_reads
    leaves = sum(t.num_leaves for t in bst.trees)
    want_launches, want_reads = grower_counts(bst.trees,
                                              bst.grower.num_leaves)
    check(launches["histogram"] == want_launches, f"efb_onehot: histogram "
          f"launched {launches['histogram']} times for {leaves} leaves, "
          f"{want_launches} expected")
    check(reads == want_reads, f"efb_onehot: {reads} grower host reads, "
          f"{want_reads} expected")
    off = gpt.Dataset(X, label=y, params={"enable_bundle": False},
                      device=dev)
    t0 = clock()
    b_off = gpt.train(dict(BOOST_PARAMS, enable_bundle=False), off,
                      num_boost_round=TT_ROUNDS)
    t_off = clock() - t0
    compared, tie = _tree_pairs_agree(bst, b_off, 1e-5)
    check(tie is None, f"efb_onehot: EFB on and off split differently: {tie}")
    diff = float(np.max(np.abs(bst._score - b_off._score)))
    hist_cases, hist_timed = check_histogram_on_panel(
        efb.binned_hist, efb.binned_hist_t, efb.max_bins_hist, seed, dev,
        "efb_bundle_panel")
    # one call's device time with and without bundling, all rows
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g, h = _hist_values(gen, ds.num_data, dev)
    full = torch.ones(ds.num_data, dtype=torch.bool, device=dev)
    sc = hk.fixed_point_scales(g, h)
    bundled_ms = graph_ms(lambda: hk.histogram(
        efb.binned_hist, g, h, full, efb.max_bins_hist,
        binned_t=efb.binned_hist_t, scales=sc), 50)
    unbundled_ms = graph_ms(lambda: hk.histogram(
        off.binned, g, h, full, off.max_num_bins, binned_t=off.binned_t,
        scales=sc), 50)
    emit({"phase": "efb_onehot", "n": len(y), "columns": X.shape[1],
          "bundles": G, "multi_member_bundles": efb.n_multi_bundles,
          "bundle_bins": [int(b) for b in efb.num_bins_hist],
          "rounds": TT_ROUNDS, "leaves": leaves, "launches": launches,
          "train_s": t_train, "train_unbundled_s": t_off,
          "same_splits_as_unbundled": compared,
          "score_max_abs_diff_vs_unbundled": diff,
          "hist_device_ms_bundled": bundled_ms,
          "hist_device_ms_unbundled": unbundled_ms})
    return launches, {"tt_efb_train_s": t_train,
                      "tt_efb_unbundled_train_s": t_off,
                      "tt_efb_hist_device_ms": bundled_ms,
                      "tt_efb_hist_unbundled_device_ms": unbundled_ms}, \
        (hist_cases, hist_timed), ds


def _tt_option_cases(tmp):
    """(name, training params, Dataset params, data variant) of
    tree_options; files of the forced splits and bins under ``tmp``."""
    import os
    fs_file = os.path.join(tmp, "forced_splits.json")
    fb_file = os.path.join(tmp, "forced_bins.json")
    with open(fs_file, "w") as fh:
        json.dump(TT_FORCED, fh)
    with open(fb_file, "w") as fh:
        json.dump([{"feature": 0, "bin_upper_bound": [0.25, 0.5, 0.75]}],
                  fh)
    mono = [1, 0, 0, 0, 0]
    return [
        ("monotone_basic", {"monotone_constraints": mono}, None, "x"),
        ("monotone_intermediate", {"monotone_constraints": mono,
                                   "monotone_constraints_method":
                                   "intermediate"}, None, "x"),
        ("monotone_advanced", {"monotone_constraints": mono,
                               "monotone_constraints_method": "advanced"},
         None, "x"),
        ("monotone_penalty", {"monotone_constraints": mono,
                              "monotone_penalty": 2.0}, None, "x"),
        ("interaction_constraints",
         {"interaction_constraints": TT_GROUPS}, None, "x"),
        ("forced_splits", {"forced_splits": TT_FORCED}, None, "x"),
        ("forcedsplits_filename", {"forcedsplits_filename": fs_file}, None,
         "x"),
        ("forcedbins_filename", {}, {"forcedbins_filename": fb_file}, "x"),
        ("extra_trees", {"extra_trees": True, "extra_seed": 7}, None, "x"),
        ("path_smooth", {"path_smooth": 50.0}, None, "x"),
        ("max_delta_step", {"max_delta_step": TT_MDS}, None, "x"),
        ("feature_contri", {"feature_contri": [0.2, 1.0, 1.0, 1.0, 0.5]},
         None, "x"),
        ("cegb_split", {"cegb_penalty_split": 1e-4}, None, "x"),
        ("cegb_coupled", {"cegb_penalty_feature_coupled": [50.0, 1.0, 1.0,
                                                           5.0, 5.0]},
         None, "x"),
        ("cegb_lazy", {"cegb_penalty_feature_lazy": [0.0, 0.01, 0.01, 0.1,
                                                     0.1]}, None, "x"),
        ("linear_tree", {"linear_tree": True, "linear_lambda": 0.1}, None,
         "x"),
        ("max_bin_by_feature", {}, {"max_bin_by_feature": [16, 0, 64, 0, 8]},
         "x"),
        ("zero_as_missing", {"zero_as_missing": True},
         {"zero_as_missing": True}, "missing"),
        ("use_missing_false", {"use_missing": False}, {"use_missing": False},
         "missing"),
    ]


def _tt_option_gates(name, bst, X):
    """The gate of each option on its trained booster."""
    lr = BOOST_PARAMS["learning_rate"]
    if name.startswith("monotone"):
        grid = np.linspace(0.01, 0.99, 50)
        for q in (0.25, 0.5, 0.75):
            probe = np.tile(np.quantile(X[:2000], q, axis=0), (50, 1))
            probe[:, 0] = grid
            d = np.diff(bst.predict(probe))
            check(bool(np.all(d >= -1e-6)), f"{name}: not monotone along "
                  f"X1 ({float(d.min())})")
    if name == "interaction_constraints":
        groups = [frozenset(g) for g in TT_GROUPS]
        for t in bst.trees:
            stack = [(0, frozenset())]
            while stack:
                node, feats = stack.pop()
                if t.is_leaf[node]:
                    check(any(feats <= g for g in groups),
                          f"{name}: a path uses {sorted(feats)}")
                    continue
                f = feats | {int(t.split_feature[node])}
                stack += [(int(t.left[node]), f), (int(t.right[node]), f)]
    if name in TT_FORCED_CASES:
        for t in bst.trees:
            lid = t.left[0]
            check(t.split_feature[0] == 0 and t.split_feature[lid] == 1
                  and not t.is_leaf[lid], f"{name}: the forced splits are "
                  "not at the root")
    if name == "max_delta_step":
        top = max(float(np.max(np.abs(t.leaf_value))) for t in bst.trees)
        check(top <= TT_MDS * lr + 1e-12, f"{name}: a leaf of {top}")
    if name == "linear_tree":
        check(any(t.lin_features is not None
                  and bool(np.any(t.lin_features >= 0)) for t in bst.trees),
              f"{name}: no linear leaf")


def tree_options(boost_data, seed, dev):
    """The recipe without a GP, one training a grower option
    (_tt_option_cases), TT_OPT_ROUNDS rounds at full width: histogram launches
    = leaves (+ one a forced split: both its children are built, as in the
    JAX package), each option's gate, card (gpu_use_dp) vs CPU at
    TT_CPU_N rows, and two trainings to the same bits for CEGB (lazy) and
    linear leaves."""
    import tempfile

    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting.tree import grow_tree
    X, yb, _ = boost_data
    rng = np.random.default_rng(seed + 142)
    Xm = X.copy()
    Xm[rng.random(len(X)) < 0.1, 1] = 0.0
    Xm[rng.random(len(X)) < 0.1, 0] = np.nan
    data = {"x": X, "missing": Xm}
    out, timings, total = {}, {}, None
    n = TT_CPU_N
    with tempfile.TemporaryDirectory() as tmp:
        for name, params, dparams, variant in _tt_option_cases(tmp):
            Xv = data[variant]
            p = dict(BOOST_PARAMS, **params)

            def train(d, rows=slice(None), **extra):
                ds = gpt.Dataset(Xv[rows], label=yb[rows], params=dparams,
                                 device=d)
                return gpt.train(dict(p, **extra), ds,
                                 num_boost_round=TT_OPT_ROUNDS)

            reset_counts()
            t0 = clock()
            bst = train(dev)
            t_train = clock() - t0
            launches = read_counts()
            leaves = sum(t.num_leaves for t in bst.trees)
            forced = 2 if name in TT_FORCED_CASES else 0
            check(launches["histogram"] == grower_counts(
                bst.trees, bst.grower.num_leaves, forced)[0],
                  f"{name}: histogram launched {launches['histogram']} times "
                  f"for {leaves} leaves")
            check(launches["vecchia_factors"] == launches["vecchia_nll_grad"]
                  == 0, f"{name} launched a Vecchia kernel")
            _tt_option_gates(name, bst, Xv)
            same_bits = None
            if name in ("cegb_lazy", "linear_tree"):
                same_bits = np.array_equal(bst._score, train(dev)._score)
                check(same_bits, f"{name}: two trainings differ")
            bc = train(dev, slice(0, n), gpu_use_dp=True)
            bh = train(torch.device("cpu"), slice(0, n))
            compared, tie, err = _tt_agree(bc, bh, Xv[:n], TT_CPU_RTOL)
            out[name] = {"leaves": leaves, "launches": launches,
                         "host_reads": grow_tree.host_reads,
                         "train_s": t_train, "same_bits": same_bits,
                         "cpu_trees_identical": compared, "cpu_tie": tie,
                         "cpu_raw_score_max_abs_diff": err}
            timings[f"tt_opt_{name}_train_s"] = t_train
            total = (launches if total is None else
                     {k: total[k] + v for k, v in launches.items()})
    emit({"phase": "tree_options", "n": len(yb), "rounds": TT_OPT_ROUNDS,
          "cpu_n": n, "tolerance": TT_CPU_RTOL, **out})
    return total, timings


def sparse_and_files(oh_data, ds_onehot, tt_data, seed, dev):
    """A scipy.sparse copy of efb_onehot's data trains the same trees as
    the dense array; ``save_binary`` and the reload give the same bins; a
    model with categorical and linear trees saved and reloaded predicts the
    same bits."""
    import os
    import tempfile

    import scipy.sparse as sp

    import gpboost_tpu_torch as gpt
    X, y = oh_data
    reset_counts()
    t0 = clock()
    b_sp = gpt.train(BOOST_PARAMS, gpt.Dataset(sp.csr_matrix(X), label=y,
                                               device=dev),
                     num_boost_round=3)
    t_sparse = clock() - t0
    launches = read_counts()
    b_dn = gpt.train(BOOST_PARAMS, gpt.Dataset(X, label=y, device=dev),
                     num_boost_round=3)
    check(np.array_equal(b_sp._score, b_dn._score),
          "sparse_and_files: the sparse matrix trains other trees")
    Xc, yc, Xc_pred = tt_data
    with tempfile.TemporaryDirectory() as tmp:
        f = os.path.join(tmp, "onehot.bin")
        ds_onehot.save_binary(f)
        back = gpt.Dataset(f, device=dev)
        check(torch.equal(back.binned, ds_onehot.binned)
              and torch.equal(back.efb.binned_hist,
                              ds_onehot.efb.binned_hist),
              "sparse_and_files: the reloaded bins differ")
        # linear leaves read raw values: X1 without its missing values (a
        # NaN in a leaf's feature gives NaN, as in the JAX package)
        Xl, Xl_pred = np.nan_to_num(Xc), np.nan_to_num(Xc_pred)
        bst = gpt.train(dict(BOOST_PARAMS, linear_tree=True),
                        gpt.Dataset(Xl, label=yc, categorical_feature=[5, 6],
                                    device=dev), num_boost_round=3)
        check(any(t.has_categorical() for t in bst.trees)
              and any(t.lin_features is not None for t in bst.trees),
              "sparse_and_files: no categorical split or linear leaf")
        mf = os.path.join(tmp, "model.json")
        bst.save_model(mf)
        loaded = gpt.Booster(model_file=mf, device=dev)
        p1, p2 = bst.predict(Xl_pred), loaded.predict(Xl_pred)
        check(np.array_equal(p1, p2) and bool(np.all(np.isfinite(p1))),
              "sparse_and_files: the reloaded model predicts other bits")
    emit({"phase": "sparse_and_files", "sparse_rounds": 3,
          "sparse_train_s": t_sparse, "sparse_same_bits": True,
          "binary_round_trip": True, "model_round_trip_same_bits": True,
          "launches": launches})
    return launches, {"tt_sparse_train_s": t_sparse}


def tree_tail_paths(boost_data, coords, pred, m, seed, dev):
    """Phase 14 in order; returns (launches by path, timings, the
    histogram's cases and timings on the categorical Dataset and the bundle
    panel)."""
    X, yb, X_pred = boost_data
    tt_data = make_tree_tail_data(seed, X, yb, X_pred)
    oh_data = make_onehot_data(seed, X, len(X_pred))
    launches, timings, hist_cases, hist_timed = {}, {}, [], []
    t0 = clock()
    launches["categorical_gpboost"], t, hist = categorical_gpboost(
        tt_data, coords, pred, m, seed, dev)
    timings.update(t)
    hist_cases += hist[0]
    hist_timed.append(hist[1])
    timings["phase14_categorical_gpboost_s"] = clock() - t0
    t0 = clock()
    launches["efb_onehot"], t, hist, ds_oh = efb_onehot(oh_data, seed, dev)
    timings.update(t)
    hist_cases += hist[0]
    hist_timed.append(hist[1])
    timings["phase14_efb_onehot_s"] = clock() - t0
    t0 = clock()
    launches["tree_options"], t = tree_options(boost_data, seed, dev)
    timings.update(t)
    timings["phase14_tree_options_s"] = clock() - t0
    t0 = clock()
    launches["sparse_and_files"], t = sparse_and_files(oh_data, ds_oh,
                                                       tt_data, seed, dev)
    timings.update(t)
    timings["phase14_sparse_and_files_s"] = clock() - t0
    del ds_oh
    torch.cuda.empty_cache()
    return launches, timings, (hist_cases, hist_timed)


# ---------------------------------------------------------------------------
# phase 15: the rest of the boosting tail (ROADMAP item 18c): DART, GOSS,
# random forests and Nesterov acceleration with the GP, the GP leaf steps,
# ranking, the model formats and the prediction options
# ---------------------------------------------------------------------------

BT_ROUNDS = 10                    # DART, RF, Nesterov, the leaf steps
BT_GOSS_ROUNDS = 20               # GOSS samples from round 1 / 0.1 = 10 on
BT_TYPES = (("dart", {"boosting": "dart"}, BT_ROUNDS),
            ("goss", {"boosting": "goss"}, BT_GOSS_ROUNDS),
            ("rf", {"boosting": "rf"}, BT_ROUNDS),
            ("nesterov", {"use_nesterov_acc": True}, BT_ROUNDS))
BT_PAIRS = ("dart", "goss")       # trained twice: the same bits
BT_LEAF_STEPS = (("newton", {"leaves_newton_update": True}),
                 ("line_search", {"line_search_step_length": True}))
BT_CPU_N = 2_000                  # rows of the card-vs-CPU checks
BT_CPU_ROUNDS = 3                 # their rounds (depth cut: 5 before)
BT_CPU_GOSS = (0.25, 5)           # GOSS's: learning rate 0.25, so that
#                                   round 5 samples, and its rounds
BT_CPU_RTOL = 1e-9
# web-search learning to rank: 1 000 queries, 1e5 documents in all, query
# lengths skewed as MSLR-WEB30K's (1 to ~1 250 documents; here lognormal,
# sigma 1, rescaled to the total) and labels 0-4 in about its shares
RK_QUERIES = 1000
RK_ROWS = 100_000
RK_MAX_PER_QUERY = 1250
RK_LABEL_SHARES = (0.52, 0.32, 0.13, 0.02, 0.01)
RK_VALID_QUERIES = 200
RK_ROUNDS = 10
RK_METRICS = ["ndcg@1,3,5", "map@5"]
RK_CPU_QUERIES = 20               # ~2 000 rows of the card-vs-CPU check
IO_CONTRIB_N = 200                # SHAP rows (host TreeSHAP; depth cut:
#                                   1 000 before)
IO_ROWS = 10_000                  # pred_leaf, pred_early_stop, refit rows
IO_C_TOL = 1e-12
IO_SHAP_TOL = 1e-9


def _bt_train(X, y, coords, m, seed, dtype, dev, extra, rounds):
    import gpboost_tpu_torch as gpt
    gp = _gp_model(coords, m, seed, dtype, dev)
    ds = gpt.Dataset(X, label=y, device=dev)
    return gpt.train(dict(BOOST_PARAMS, **extra), ds, gp_model=gp,
                     num_boost_round=rounds)


def _bt_cpu_case(extra, rounds):
    """A GP path's training as the card-vs-CPU check runs it: BT_CPU_ROUNDS
    rounds (GOSS: BT_CPU_GOSS, through a sampled round), the GP's L-BFGS
    refits started afresh each round (``reuse_learning_rates_gp_model=
    False``: its memory carried from refit to refit amplifies the last bits
    of the two devices' sums — a DART training's leaf values were 2.6e-8
    apart after three rounds on an H100; on the CPU a random forest's refits
    moved the JAX package's and the port's scores 1e-4 apart in ten rounds
    with the memory, 1e-16 without it)."""
    extra = dict(extra, reuse_learning_rates_gp_model=False)
    rounds = min(rounds, BT_CPU_ROUNDS)
    if extra.get("boosting") == "goss":
        extra["learning_rate"], rounds = BT_CPU_GOSS
    return extra, rounds


def gp_card_vs_cpu(boost_data, coords, m, seed, dev):
    """Phase 15's GP paths (BT_TYPES and BT_LEAF_STEPS) at BT_CPU_N rows,
    float64, on the card (``gpu_use_dp``) and on the CPU
    (:func:`_bt_cpu_case`): the same trees up to the first exact tie of
    split gains (checked to be one) and the raw scores of the iterations
    before it within BT_CPU_RTOL of the score's scale. The CPU trainings
    run together in a pool of threads, one each, with the host's cores
    shared out among them (intra-op threads), and the card's after them: at
    this size a CPU training is bound by the cost of each operation, whose
    work releases the GIL, so they overlap (the card's, host-bound, would
    only wait for the GIL among them)."""
    import concurrent.futures

    X, yb, _ = boost_data
    n = BT_CPU_N
    sub = (X[:n], yb[:n], coords[:n], m, seed, torch.float64)
    cases = {name: _bt_cpu_case(extra, rounds) for name, extra, rounds in
             BT_TYPES + tuple((name, extra, BT_ROUNDS)
                              for name, extra in BT_LEAF_STEPS)}
    threads = torch.get_num_threads()
    t0 = clock()
    torch.set_num_threads(max(1, threads // len(cases)))
    try:
        with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
            on_cpu = {name: pool.submit(_bt_train, *sub, torch.device("cpu"),
                                        extra, rounds)
                      for name, (extra, rounds) in cases.items()}
            on_cpu = {name: f.result() for name, f in on_cpu.items()}
    finally:
        torch.set_num_threads(threads)
    t_cpu = clock() - t0
    on_card = {name: _bt_train(*sub, dev, dict(extra, gpu_use_dp=True),
                               rounds)
               for name, (extra, rounds) in cases.items()}
    t_all = clock() - t0
    out = {}
    for name, (extra, rounds) in cases.items():
        compared, tie, err = _tt_agree(on_card[name], on_cpu[name], X[:n],
                                       BT_CPU_RTOL)
        out[name] = {"rounds": rounds,
                     "learning_rate": extra.get("learning_rate",
                                                BOOST_PARAMS["learning_rate"]),
                     "trees_identical": compared, "tie": tie,
                     "raw_score_max_abs_diff": err}
    emit({"phase": "gp_card_vs_cpu", "n": n, "tolerance": BT_CPU_RTOL,
          "cpu_s": t_cpu, "cpu_threads": len(cases),
          "intra_op_threads": max(1, threads // len(cases)),
          "card_s": t_all - t_cpu, **out})
    return {"phase15_gp_card_vs_cpu_s": t_all}


def _bt_path(tag, X, y, coords, pred, X_pred, m, seed, dev, extra, rounds):
    """One GPBoost training of the recipe with the float32 GP at full size:
    launches, prediction with the GP."""
    from gpboost_tpu_torch.boosting.tree import grow_tree
    reset_counts()
    t0 = clock()
    bst = _bt_train(X, y, coords, m, seed, torch.float32, dev, extra, rounds)
    t_train = clock() - t0
    train_launches = read_counts()
    t0 = clock()
    out = bst.predict(X_pred, gp_coords_pred=pred, predict_var=True)
    t_pred = clock() - t0
    launches = read_counts()
    leaves = sum(t.num_leaves for t in bst.trees)
    check(bst.num_trees() == rounds, f"{tag}: {bst.num_trees()} trees")
    _check_trees(bst, tag)
    check(launches["histogram"] == grower_counts(
        bst.trees, bst.grower.num_leaves)[0], f"{tag}: histogram launched "
          f"{launches['histogram']} times for {leaves} leaves")
    check(launches["vecchia_factors"] > 0 and launches["vecchia_nll_grad"] > 0,
          f"{tag}: Vecchia kernels {launches}")
    mu = np.asarray(out["response_mean"])
    check(mu.shape == (len(X_pred),) and bool(np.all(np.isfinite(mu)))
          and bool(np.all(np.asarray(out["response_var"]) > 0)),
          f"{tag}: the prediction with the GP")
    res = {"rounds": rounds, "leaves": leaves, "launches": launches,
           "train_launches": train_launches,
           "host_reads": grow_tree.host_reads,
           "fits": len(bst.objective.fits), "train_s": t_train,
           "predict_s": t_pred, "cov_pars": bst.gp_model.get_cov_pars().tolist(),
           "shrinkage": sorted({round(t.shrinkage, 9) for t in bst.trees})}
    return bst, res


def _goss_histogram(bst, sampled):
    """The histogram kernel against its float64 plain version on a sampled
    GOSS round of the full-size training: its own mask and amplified
    gradients (``sampled``: iteration, mask, gradients, hessians), with the
    fixed-point scales the grower takes from them."""
    it, mask, grad, hess = sampled
    ds, n = bst.train_set, len(grad)
    g = torch.as_tensor(grad, dtype=bst._grad_dtype, device=bst.device)
    h = torch.as_tensor(hess, dtype=bst._grad_dtype, device=bst.device)
    case = _hist_compare(f"goss_round_{it}", ds.binned, ds.binned_t, g, h,
                         mask, ds.max_num_bins)
    top_k = max(1, int(bst.top_rate * n))
    case["amplification"] = (n - top_k) / max(1, int(bst.other_rate * n))
    case["max_abs_g"] = float(np.max(np.abs(grad[np.asarray(
        mask.cpu())])))
    return case


def boosting_types_gp(boost_data, coords, pred, m, seed, dev):
    """DART, GOSS, random forests and Nesterov acceleration in GPBoost with
    the float32 Vecchia GP at the recipe's full width: histogram launches =
    leaves, both Vecchia kernels, prediction with the GP; DART and GOSS
    trained twice to the same bits; the histogram kernel against its plain
    version on GOSS's last sampled round. Returns (launches, timings, the
    DART booster, the histogram case)."""
    from gpboost_tpu_torch.boosting.booster import Booster
    X, yb, X_pred = boost_data
    out, timings, total, keep = {}, {}, None, None
    goss = Booster._goss
    sampled = {}

    def keep_sampled(self, it, n, grad, hess):     # the full-size rounds
        mask, g, h = goss(self, it, n, grad, hess)
        if mask is not None:
            sampled.update(round=(it, mask, g, h))
        return mask, g, h

    for name, extra, rounds in BT_TYPES:
        if name == "goss":
            Booster._goss = keep_sampled
        try:
            bst, res = _bt_path(name, X, yb, coords, pred, X_pred, m, seed,
                                dev, extra, rounds)
        finally:
            Booster._goss = goss
        if name == "goss":
            check("round" in sampled and sampled["round"][0] >= 10,
                  f"goss: no sampled round kept: {sampled.get('round')}")
            hist_case = _goss_histogram(bst, sampled.pop("round"))
            res["histogram_vs_plain"] = hist_case
        if name in BT_PAIRS:
            again = _bt_train(X, yb, coords, m, seed, torch.float32, dev,
                              extra, rounds)
            res["same_bits"] = bool(np.array_equal(bst._score, again._score))
            check(res["same_bits"], f"{name}: two trainings differ")
            del again
        if name == "dart":
            check(len(res["shrinkage"]) > 1, "dart: no tree renormalised")
            keep = bst
        if name == "rf":
            check(res["shrinkage"] == [1.0], "rf: shrunk trees")
        out[name] = res
        timings[f"bt_{name}_train_s"] = res["train_s"]
        total = (res["launches"] if total is None else
                 {k: total[k] + v for k, v in res["launches"].items()})
    emit({"phase": "boosting_types_gp", "n": len(yb), **out})
    return total, timings, keep, hist_case


def leaf_updates_gp(boost_data, coords, pred, m, seed, dev):
    """The Newton leaf re-solve and the step-length line search in GPBoost
    with the same GP: each adds exactly one ``vecchia_factors`` launch a
    round (the leaves' columns, or the new tree's values, through Psi^-1)
    to the refits' one each."""
    X, yb, X_pred = boost_data
    out, timings, total = {}, {}, None
    for name, extra in BT_LEAF_STEPS:
        bst, res = _bt_path(name, X, yb, coords, pred, X_pred, m, seed, dev,
                            extra, BT_ROUNDS)
        want = res["fits"] + BT_ROUNDS
        got = res["train_launches"]["vecchia_factors"]
        check(got == want, f"{name}: vecchia_factors launched {got} times "
              f"in training, expected {want} ({res['fits']} refits + one a "
              "round)")
        if name == "line_search":
            check(len(res["shrinkage"]) > 1, "line_search: no step length")
        out[name] = res
        timings[f"bt_{name}_train_s"] = res["train_s"]
        total = (res["launches"] if total is None else
                 {k: total[k] + v for k, v in res["launches"].items()})
    emit({"phase": "leaf_updates_gp", "n": len(yb), "rounds": BT_ROUNDS,
          **out})
    return total, timings


def _rk_lengths(rng, queries, rows):
    """Query lengths: lognormal (sigma 1), rescaled to ``rows`` in all,
    each within 1 and RK_MAX_PER_QUERY (the longest trimmed if the rounding
    passed ``rows``)."""
    raw = rng.lognormal(0.0, 1.0, queries)
    sizes = np.clip(np.floor(raw * rows / raw.sum()), 1,
                    RK_MAX_PER_QUERY).astype(np.int64)
    sizes[np.argmax(sizes)] -= max(0, int(sizes.sum()) - rows)
    return sizes


def _rk_labels(rng, Xq, sizes):
    """Graded labels 0-4 in RK_LABEL_SHARES within each query: the
    quantiles of f(X) + noise there."""
    s = _recipe_f(Xq) + 0.5 * rng.standard_normal(len(Xq))
    cuts = np.cumsum(RK_LABEL_SHARES)[:-1]
    out = np.empty(len(Xq))
    for a, k in zip(np.cumsum(sizes) - sizes, sizes):
        u = (np.argsort(np.argsort(s[a:a + k])) + 0.5) / k
        out[a:a + k] = np.searchsorted(cuts, u, side="right")
    return out


def make_ranking_data(seed, X):
    """RK_QUERIES queries of skewed lengths, RK_ROWS rows in all, on the
    recipe's features, graded labels 0-4 (:func:`_rk_labels`), and
    RK_VALID_QUERIES validation queries drawn alike."""
    rng = np.random.default_rng(seed + 150)
    g = _rk_lengths(rng, RK_QUERIES, RK_ROWS)
    gv = _rk_lengths(rng, RK_VALID_QUERIES,
                     RK_ROWS * RK_VALID_QUERIES // RK_QUERIES)
    Xr = X[:int(g.sum())]
    Xv = rng.uniform(size=(int(gv.sum()), X.shape[1]))
    return (Xr, _rk_labels(rng, Xr, g), g, Xv, _rk_labels(rng, Xv, gv), gv)


def _rk_train(objective, data, dev, queries=None, **extra):
    import gpboost_tpu_torch as gpt
    Xr, yr, gr, Xv, yv, gv = data
    if queries is not None:
        rows, rows_v = int(gr[:queries].sum()), int(gv[:queries].sum())
        Xr, yr, gr = Xr[:rows], yr[:rows], gr[:queries]
        Xv, yv, gv = Xv[:rows_v], yv[:rows_v], gv[:queries]
    ds = gpt.Dataset(Xr, label=yr, group=gr, device=dev)
    dv = gpt.Dataset(Xv, label=yv, group=gv, reference=ds, device=dev)
    ev = {}
    bst = gpt.train(dict(BOOST_PARAMS, objective=objective,
                         metric=RK_METRICS, **extra), ds,
                    num_boost_round=RK_ROUNDS, valid_sets=[dv],
                    evals_result=ev, verbose_eval=False)
    return bst, ev


def ranking(seed, X, dev):
    """``lambdarank`` and ``rank_xendcg`` on RK_QUERIES queries of skewed
    lengths (RK_ROWS rows) with RK_VALID_QUERIES validation queries scored
    by ndcg@1,3,5 and map@5: histogram launches = leaves, the validation
    NDCG up and map@5 below 1 (not saturated), LambdaRank trained twice to
    the same bits, its padded pairs beside the queries' own, the lambdas'
    time a round, card vs CPU at RK_CPU_QUERIES queries."""
    data = make_ranking_data(seed, X)
    g, yr = data[2], data[1]
    out, timings, total = {}, {}, None
    for objective in ("lambdarank", "rank_xendcg"):
        reset_counts()
        t0 = clock()
        bst, ev = _rk_train(objective, data, dev)
        t_train = clock() - t0
        launches = read_counts()
        leaves = sum(t.num_leaves for t in bst.trees)
        check(launches["histogram"] == grower_counts(
            bst.trees, bst.grower.num_leaves)[0], f"{objective}: histogram "
              f"launched {launches['histogram']} times for {leaves} leaves")
        curves = ev["valid_0"]
        check(set(curves) == {"ndcg@1", "ndcg@3", "ndcg@5", "map@5"}
              and all(len(c) == RK_ROUNDS for c in curves.values()),
              f"{objective}: curves {list(curves)}")
        check(curves["ndcg@5"][-1] > curves["ndcg@5"][0],
              f"{objective}: the validation ndcg@5 did not rise: "
              f"{curves['ndcg@5']}")
        check(max(curves["map@5"]) < 1.0, f"{objective}: map@5 saturated: "
              f"{curves['map@5']}")
        res = {"leaves": leaves, "launches": launches, "train_s": t_train,
               "valid_first": {k: c[0] for k, c in curves.items()},
               "valid_last": {k: c[-1] for k, c in curves.items()}}
        # the objective's gradients a round, alone (synchronised)
        t0 = clock()
        bst.objective.get_gradients(bst._score)
        res["gradients_ms"] = (clock() - t0) * 1e3
        if objective == "lambdarank":
            padded, real = bst.objective.padded_pairs()
            res.update(pairs_padded=padded, pairs_real=real,
                       blocks=len(bst.objective._blocks))
            again, _ = _rk_train(objective, data, dev)
            res["same_bits"] = bool(np.array_equal(bst._score, again._score))
            check(res["same_bits"], "lambdarank: two trainings differ")
        bc, _ = _rk_train(objective, data, dev, queries=RK_CPU_QUERIES,
                          gpu_use_dp=True)
        bh, _ = _rk_train(objective, data, torch.device("cpu"),
                          queries=RK_CPU_QUERIES)
        rows = int(g[:RK_CPU_QUERIES].sum())
        compared, tie, err = _tt_agree(bc, bh, data[0][:rows], BT_CPU_RTOL)
        res.update(cpu_rows=rows, cpu_trees_identical=compared, cpu_tie=tie,
                   cpu_raw_score_max_abs_diff=err)
        out[objective] = res
        timings[f"rk_{objective}_train_s"] = t_train
        timings[f"rk_{objective}_gradients_ms"] = res["gradients_ms"]
        total = (launches if total is None else
                 {k: total[k] + v for k, v in launches.items()})
    emit({"phase": "ranking", "queries": RK_QUERIES, "rows": int(g.sum()),
          "query_rows": {"min": int(g.min()), "median": float(np.median(g)),
                         "max": int(g.max())},
          "label_shares": [float(np.mean(yr == k)) for k in range(5)],
          "valid_queries": RK_VALID_QUERIES, "rounds": RK_ROUNDS,
          "metrics": RK_METRICS, **out})
    return total, timings


def _c_predictions(src, X, tmp, tag):
    """``src`` compiled by the host's C compiler into a shared library (a
    name of its own: the loader hands back a library loaded from the same
    path) and called a row at a time: (predict, predict_raw) for the rows
    of X."""
    import ctypes
    import os
    import shutil
    cc = shutil.which("cc") or shutil.which("gcc")
    check(cc is not None, "model_io: no host C compiler")
    cfile = os.path.join(tmp, f"model_{tag}.c")
    so = os.path.join(tmp, f"model_{tag}.so")
    with open(cfile, "w") as f:
        f.write(src)
    subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", so, cfile, "-lm"],
                   check=True)
    lib = ctypes.CDLL(so)
    out = []
    for fn in (lib.predict, lib.predict_raw):
        fn.argtypes = [ctypes.POINTER(ctypes.c_double)] * 2
        fn.restype = None
        row = (ctypes.c_double * X.shape[1])()
        res = (ctypes.c_double * 1)()
        vals = np.zeros(len(X))
        for i in range(len(X)):
            row[:] = [float(v) for v in X[i]]
            fn(row, res)
            vals[i] = res[0]
        out.append(vals)
    return out


def _io_checks(tag, bst, X, X_rows, tmp):
    """Text round trip, C export, SHAP and leaf indices of one booster."""
    import gpboost_tpu_torch as gpt
    dev = bst.device
    res = {}
    t0 = clock()
    text = bst.model_to_string(format="text")
    loaded = gpt.Booster(model_str=text, device=dev)
    again = loaded.model_to_string(format="text")
    res["text_s"] = clock() - t0

    def model_lines(t):      # the feature ranges come from training data
        return [ln for ln in t.splitlines()
                if not ln.startswith("feature_infos=")]

    check(model_lines(again) == model_lines(text),
          f"{tag}: the text round trip changed the model's text")
    raw = bst.predict(X_rows, raw_score=True)
    text_err = float(np.max(np.abs(loaded.predict(X_rows, raw_score=True)
                                   - raw)))
    check(text_err <= 1e-12 * max(1.0, float(np.max(np.abs(raw)))),
          f"{tag}: the loaded text model predicts {text_err} apart")
    res["text_raw_max_abs_diff"] = text_err
    Xc = X_rows[:IO_CONTRIB_N]
    t0 = clock()
    c_pred, c_raw = _c_predictions(bst.model_to_c(), Xc, tmp, tag)
    res["c_s"] = clock() - t0
    want = np.asarray(bst.objective.convert_output(raw[:IO_CONTRIB_N]))
    res["c_max_abs_diff"] = max(float(np.max(np.abs(c_pred - want))),
                                float(np.max(np.abs(c_raw
                                                    - raw[:IO_CONTRIB_N]))))
    check(res["c_max_abs_diff"] <= IO_C_TOL,
          f"{tag}: the C model {res['c_max_abs_diff']} apart")
    t0 = clock()
    contrib = bst.predict(Xc, pred_contrib=True)
    res["shap_s"] = clock() - t0
    res["shap_sum_max_abs_diff"] = float(np.max(np.abs(contrib.sum(axis=1)
                                                       - raw[:IO_CONTRIB_N])))
    check(contrib.shape == (IO_CONTRIB_N, X.shape[1] + 1)
          and res["shap_sum_max_abs_diff"] <= IO_SHAP_TOL,
          f"{tag}: SHAP rows {res['shap_sum_max_abs_diff']} from the raw "
          "score")
    t0 = clock()
    leaves = bst.predict(X_rows, pred_leaf=True)
    res["pred_leaf_s"] = clock() - t0
    vals = np.stack([t.leaf_value[t.leaf_index_order()[leaves[:, k]]]
                     for k, t in enumerate(bst.trees)], axis=1)
    leaf_err = float(np.max(np.abs(vals.sum(axis=1) + bst.init_score[0]
                                   - raw)))
    check(leaves.shape == (len(X_rows), bst.num_trees())
          and leaf_err <= 1e-9, f"{tag}: pred_leaf's leaves sum {leaf_err} "
          "from the raw score")
    return res


def model_io(dart, boost_data, seed, dev):
    """The DART GPBoost booster of boosting_types_gp and a ``binary``
    booster without a GP (BT_ROUNDS rounds at full width): a text round
    trip to the same text and within 1e-12, the C export compiled by the
    host's compiler within IO_C_TOL of ``predict``, SHAP on IO_CONTRIB_N
    rows summing to the raw score within IO_SHAP_TOL, ``pred_leaf``; on the
    binary booster the prediction early stop against its emulation,
    ``rollback_one_iter`` and ``refit`` on IO_ROWS rows."""
    import tempfile

    import gpboost_tpu_torch as gpt
    X, yb, X_pred = boost_data
    rng = np.random.default_rng(seed + 151)
    X_rows = rng.uniform(size=(IO_ROWS, X.shape[1]))
    label = (_recipe_f(X) + 0.5 * rng.standard_normal(len(X))
             > np.median(_recipe_f(X))).astype(np.float64)
    reset_counts()
    t0 = clock()
    binary = gpt.train(dict(BOOST_PARAMS, objective="binary"),
                       gpt.Dataset(X, label=label, device=dev),
                       num_boost_round=BT_ROUNDS)
    t_binary = clock() - t0
    launches = read_counts()
    leaves = sum(t.num_leaves for t in binary.trees)
    check(launches["histogram"] == grower_counts(
        binary.trees, binary.grower.num_leaves)[0], f"model_io: histogram "
          f"launched {launches['histogram']} times for {leaves} leaves")
    out = {"binary_train_s": t_binary, "launches": launches}
    with tempfile.TemporaryDirectory() as tmp:
        out["dart"] = _io_checks("dart", dart, X, X_rows, tmp)
        out["binary"] = _io_checks("binary", binary, X, X_rows, tmp)
    # the prediction early stop against its emulation from the
    # per-iteration raw scores (prediction_early_stop.cpp)
    full = binary.predict(X_rows, raw_score=True)
    freq, margin = 5, 0.5
    raws = [np.full(IO_ROWS, binary.init_score[0])] + [
        binary.predict(X_rows, raw_score=True, num_iteration=i)
        for i in range(1, BT_ROUNDS + 1)]
    want, active = raws[0].copy(), np.ones(IO_ROWS, dtype=bool)
    for i in range(1, BT_ROUNDS + 1):
        want[active] += (raws[i] - raws[i - 1])[active]
        if i % freq == 0:
            active &= 2.0 * np.abs(want) <= margin
    binary.params.update(pred_early_stop=True, pred_early_stop_freq=freq,
                         pred_early_stop_margin=margin)
    t0 = clock()
    es = binary.predict(X_rows, raw_score=True)
    out["pred_early_stop_s"] = clock() - t0
    binary.params["pred_early_stop"] = False
    es_err = float(np.max(np.abs(es - want)))
    out["pred_early_stop_rows_stopped"] = int(np.sum(es != full))
    check(es_err <= 1e-12 * max(1.0, float(np.max(np.abs(want))))
          and out["pred_early_stop_rows_stopped"] > 0,
          f"pred_early_stop: {es_err} from its emulation, "
          f"{out['pred_early_stop_rows_stopped']} rows stopped")
    # rollback: the scores are the model's of one round less
    binary.rollback_one_iter()
    rb_err = float(np.max(np.abs(binary._score
                                 - binary.predict(X, raw_score=True))))
    check(binary.num_trees() == BT_ROUNDS - 1 and rb_err <= 1e-9,
          f"rollback_one_iter: {binary.num_trees()} trees, scores {rb_err} "
          "from the model's")
    out["rollback_score_max_abs_diff"] = rb_err
    # refit on new rows with a shifted label: the loss falls
    y_new = (_recipe_f(X_rows) > np.median(_recipe_f(X))).astype(np.float64)

    def logloss(b):
        p = np.clip(b.predict(X_rows), 1e-15, 1 - 1e-15)
        return float(-np.mean(y_new * np.log(p) + (1 - y_new)
                              * np.log(1 - p)))

    before = logloss(binary)
    t0 = clock()
    binary.refit(X_rows, y_new, decay_rate=0.5)
    out["refit_s"] = clock() - t0
    out["refit_logloss"] = [before, logloss(binary)]
    check(out["refit_logloss"][1] < before, f"refit: logloss "
          f"{out['refit_logloss']}")
    emit({"phase": "model_io", "rows": IO_ROWS, "contrib_rows": IO_CONTRIB_N,
          **out})
    return launches, {"io_binary_train_s": t_binary,
                      "io_dart_shap_s": out["dart"]["shap_s"],
                      "io_binary_shap_s": out["binary"]["shap_s"],
                      "io_refit_s": out["refit_s"]}


def boosting_tail_2_paths(boost_data, coords, pred, m, seed, dev):
    """Phase 15 in order; returns (launches by path, timings, the
    histogram kernel's case on a sampled GOSS round)."""
    launches, timings = {}, {}
    t0 = clock()
    launches["boosting_types_gp"], t, dart, hist_case = boosting_types_gp(
        boost_data, coords, pred, m, seed, dev)
    timings.update(t)
    timings["phase15_boosting_types_gp_s"] = clock() - t0
    t0 = clock()
    launches["leaf_updates_gp"], t = leaf_updates_gp(boost_data, coords,
                                                     pred, m, seed, dev)
    timings.update(t)
    timings["phase15_leaf_updates_gp_s"] = clock() - t0
    timings.update(gp_card_vs_cpu(boost_data, coords, m, seed, dev))
    t0 = clock()
    launches["ranking"], t = ranking(seed, boost_data[0], dev)
    timings.update(t)
    timings["phase15_ranking_s"] = clock() - t0
    t0 = clock()
    launches["model_io"], t = model_io(dart, boost_data, seed, dev)
    timings.update(t)
    timings["phase15_model_io_s"] = clock() - t0
    del dart
    torch.cuda.empty_cache()
    return launches, timings, hist_case


# ---------------------------------------------------------------------------
# phase 16: the device-resident GPBoost loop and its fixed-shape grower
# ---------------------------------------------------------------------------

DL_TREE_REPS = 20             # trees timed a grower
DL_NG_ROUNDS = 1              # depth cuts of the LaGaBoost branch (phase 6:
DL_NG_MAXIT = 0               # NG_ROUNDS 2, refits at NG_REFIT_MAXIT 1): its
# refits' Armijo steps from 1 halve ~8 times at n = 1e5, each evaluation a
# CG solve near its iteration cap: on an H100 1 round at maxit 1 took
# 234.8 s with the trailing refit (PERF.md §4). At maxit 0 a refit is one
# value-and-gradient and the gradient d NLL / dF
# device loop vs phase 4's host loop (both refit memory-less L-BFGS on the
# card, grow with the same captured grower and add the trees in float64):
# scores and leaf values, max |difference| / max |value|
DL_HOST_RTOL = 1e-12
DL_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def grower_counts(trees, num_leaves, forced_splits=0):
    """(histogram launches, grower host reads) that growing ``trees`` on
    the card took: a tree of the fixed-shape grower (``tree.fixed_shape``)
    launches ``num_leaves`` (the root and every step, whether it split or
    not) and reads the host once (its fetch); one of the host grower
    launches once a leaf and reads twice a leaf (a packed read a leaf
    scanned and, once a tree, the fixed-point scales); each of a tree's
    ``forced_splits`` adds one launch on either (both children built)."""
    from gpboost_tpu_torch.boosting.tree import histogram_launches
    reads = sum(1 if getattr(t, "fixed_shape", False) else 2 * t.num_leaves
                for t in trees)
    return histogram_launches(trees, num_leaves, forced_splits), reads


def _trace_windows(path, names, until=None):
    """From a Chrome trace: for each annotation name (its first range on
    the host; ``until[name]``: from its start to the end of that other
    range), the device operations that start inside it, the union of their
    intervals inside it, and the device's idle share there
    (1 - union / window)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DL_DEVICE_OPS]

    def first_range(name):
        ann = [e for e in events if e.get("ph") == "X"
               and e.get("cat") == "user_annotation"
               and e.get("name") == name]
        check(len(ann) >= 1, f"trace: no range named {name}")
        return float(ann[0]["ts"]), float(ann[0]["ts"]) + float(ann[0]["dur"])

    out = {}
    for name in names:
        lo, hi = first_range(name)
        if until and name in until:
            hi = max(hi, first_range(until[name])[1])
        inside = sorted((float(e["ts"]), min(float(e["ts"]) + float(e["dur"]),
                                             hi), e["name"]) for e in ops
                        if lo <= float(e["ts"]) < hi)
        busy, end = 0.0, lo
        for a, b, _ in inside:
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        out[name] = {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
                     "idle_share": 1.0 - busy / max(hi - lo, 1e-9),
                     "device_ops": len(inside),
                     "op_names": [x[2] for x in inside[:16]],
                     # the histogram kernel's device-scales instance, the
                     # fixed-shape grower's, and the group scan
                     "hist_dev_scales_launches": sum(
                         "hist_kernel<true>" in x[2] for x in inside),
                     "cat_group_scan_launches": sum(
                         "cat_group_scan_kernel" in x[2] for x in inside)}
    return out


def _fixed_vs_host(fixed, tree, row_leaf, tag):
    """The fixed-shape grower's outputs against the host grower's tree:
    every node array and row_leaf the same bits."""
    from gpboost_tpu_torch.boosting import tree as tt
    got = {k: fixed[k].double().cpu().numpy()
           for k in tt.FIXED_NODE_FIELDS}
    got["catmask"] = fixed["catmask"].double().cpu().numpy()
    want = {"feature": tree.split_feature, "thresh": tree.threshold_bin,
            "left": tree.left, "right": tree.right,
            "leaf_value": tree.leaf_value, "is_leaf": tree.is_leaf,
            "cnt": tree.node_count, "sgain": tree.split_gain,
            "dleft": tree.default_left, "iscat": tree.is_categorical,
            "catmask": tree.cat_mask}
    for k, v in want.items():
        check(np.array_equal(got[k], np.asarray(v, np.float64)),
              f"{tag}: {k} of the fixed-shape grower differs from the host "
              "grower's")
    check(torch.equal(fixed["row_leaf"], row_leaf),
          f"{tag}: row_leaf of the fixed-shape grower differs")
    check(int(fixed["num_leaves"]) == tree.num_leaves,
          f"{tag}: {int(fixed['num_leaves'])} leaves, the host grower "
          f"{tree.num_leaves}")


def fixed_grower_path(ds, coords, m, seed, dev):
    """Phase 16 (a): the fixed-shape grower on the boosting path's Dataset
    with the round-1 gradients (the refit at the initial score): the same
    bits as the host grower, its graph replay the same bits as its eager
    run, histogram launches = leaves, no host read inside a tree (CUDA's
    sync debug mode set to error around the replay and an eager run), and
    ms a tree of the three."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting import tree as tt
    b = gpt.Booster(params=dict(BOOST_PARAMS), train_set=ds,
                    gp_model=_gp_model(coords, m, seed, torch.float32, dev))
    grad, hess = b.objective.get_gradients(b._score)
    g = torch.as_tensor(grad, dtype=torch.float32, device=dev)
    h = torch.as_tensor(hess, dtype=torch.float32, device=dev)
    n, B, L = ds.num_data, ds.max_num_bins, b.grower.num_leaves
    nb = b._num_bins_t
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def host_tree():
        return tt.grow_tree(ds.binned, nb, g, h, B, b.grower,
                            binned_t=ds.binned_t, nan_mask=ds.has_nan,
                            efb=ds.efb)

    reset_counts()
    tree, row_leaf = host_tree()
    host_counts = dict(read_counts(), host_reads=tt.grow_tree.host_reads)
    check(host_counts["histogram"] == tree.num_leaves,
          f"host grower: {host_counts['histogram']} histogram launches for "
          f"{tree.num_leaves} leaves")
    fg = tt.FixedGrower(ds.binned, B, b.grower, torch.float32,
                        nan_mask=ds.has_nan, binned_t=ds.binned_t,
                        efb=ds.efb)
    reset_counts()
    eager = {k: v.clone() for k, v in fg.grow(g, h, ones, nb).items()}
    eager_launches = read_counts()["histogram"]
    check(fg.captures == 1, "the fixed-shape grower did not capture")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay = {k: v.clone() for k, v in fg.grow(g, h, ones, nb).items()}
        direct = tt._grow_tree_fixed(g, h, ones, nb, fg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    replay_launches = read_counts()["histogram"]
    for k in eager:
        check(torch.equal(eager[k], replay[k])
              and torch.equal(direct[k], replay[k]),
              f"fixed-shape grower: {k} of the graph replay differs from "
              "the eager run")
    _fixed_vs_host(replay, tree, row_leaf, "fixed_grower_path")
    check(eager_launches == L and replay_launches == 2 * L,
          f"fixed-shape grower: {eager_launches} / {replay_launches} "
          f"histogram launches for 1 / 2 trees of {L} leaves at most")
    check(tree.num_leaves == L, f"the round-1 tree has {tree.num_leaves} "
          f"leaves, not {L}: launches = leaves needs a full tree")
    t0 = clock()
    for _ in range(DL_TREE_REPS):
        host_tree()
    host_ms = (clock() - t0) / DL_TREE_REPS * 1e3
    t0 = clock()
    for _ in range(DL_TREE_REPS):
        tt._grow_tree_fixed(g, h, ones, nb, fg)
    eager_ms = (clock() - t0) / DL_TREE_REPS * 1e3
    replay_ms = time_ms(lambda: fg.grow(g, h, ones, nb), DL_TREE_REPS)
    graph_only_ms = time_ms(fg._graph.replay, DL_TREE_REPS)
    out = {"n": n, "leaves": tree.num_leaves, "num_leaves": L,
           "same_bits_as_host_grower": True, "replay_same_bits_as_eager": True,
           "host_grower_launches": host_counts["histogram"],
           "host_grower_host_reads": host_counts["host_reads"],
           "fixed_launches_per_tree": eager_launches,
           "fixed_host_reads_inside_tree": 0,
           "host_grower_ms_per_tree": host_ms,
           "fixed_eager_ms_per_tree": eager_ms,
           "fixed_replay_ms_per_tree": replay_ms,
           "fixed_graph_replay_device_ms": graph_only_ms}
    emit({"phase": "fixed_grower", **out})
    return out, (g, h, nb, fg)


def device_loop_training(ds, yb, coords, m, seed, rounds, dev, host_bst):
    """Phase 16 (b): ``train(..., device_resident_boosting="true")`` for
    ``rounds`` rounds on the boosting path, cold (the grower's graph
    captured) and warm (replayed): the trees, the refits' NLL falling, the
    Vecchia kernels' launches, the host reads (the refits' evaluations and
    one fetch), the two runs and a stepwise orchestration of the loop's
    primitives on the card the same bits, the scores and leaf values
    against phase 4's host loop (``host_bst``) within DL_HOST_RTOL."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting import device_loop
    from gpboost_tpu_torch.models import optimizers as topt
    params = dict(BOOST_PARAMS, device_resident_boosting="true")
    # phase 4's host loop captured the grower of its Dataset: a new Dataset
    # of the same data for a cold run
    ds = gpt.Dataset(ds.raw_data, label=yb, device=dev)
    runs = []
    for tag in ("cold", "warm"):
        gp = _gp_model(coords, m, seed, torch.float32, dev)
        reset_counts()
        t0 = clock()
        # the warm run under the default, "auto": the loop it engages
        bst = gpt.train(params if tag == "cold" else dict(
            BOOST_PARAMS, device_resident_boosting="auto"), ds, gp_model=gp,
            num_boost_round=rounds)
        t_train = clock() - t0
        launches = read_counts()
        info = bst.device_training_info_
        evals = int(info["refit_evaluations"].sum())
        check(bst.num_trees() == rounds and "device_training_info_"
              in bst.__dict__, f"device loop {tag}: {bst.num_trees()} trees, "
              "or the host loop ran")
        _check_trees(bst, f"device_loop_{tag}")
        check(bool(np.all(np.isfinite(info["cov_nll"]))
                   and info["cov_nll"][-1] < info["cov_nll"][0]),
              f"device loop {tag}: refit NLLs {info['cov_nll']}")
        check(info["includes_compile"] == (tag == "cold"),
              f"device loop {tag}: includes_compile "
              f"{info['includes_compile']}")
        check(launches["vecchia_nll_grad"] >= evals,
              f"device loop {tag}: vecchia_nll_grad launched "
              f"{launches['vecchia_nll_grad']} times for {evals} evaluations")
        check(info["host_reads"] == evals + 1,
              f"device loop {tag}: {info['host_reads']} host reads for "
              f"{evals} refit evaluations")
        check(launches["histogram"] == rounds * bst.grower.num_leaves,
              f"device loop {tag}: {launches['histogram']} histogram "
              f"launches in {rounds} trees")
        runs.append((bst, gp, launches, t_train))
    (b1, gp1, l1, t_cold), (b2, gp2, l2, t_warm) = runs
    same = (np.array_equal(b1._score, b2._score)
            and np.array_equal(gp1.get_cov_pars(), gp2.get_cov_pars())
            and all(np.array_equal(x.leaf_value, y.leaf_value)
                    and np.array_equal(x.split_feature, y.split_feature)
                    for x, y in zip(b1.trees, b2.trees)))
    check(same, "device loop: two trainings differ")
    # the same rounds stepwise, from the loop's own primitives
    b3 = gpt.Booster(params=params, train_set=ds, gp_model=_gp_model(
        coords, m, seed, torch.float32, dev))
    vg, psi, kdt = device_loop._fns_for(b3)
    grower = device_loop._grower_of(b3)
    cfg = b3.gp_model.optim_cfg
    th = torch.log(torch.tensor(cfg.init_cov_pars, dtype=kdt, device=dev))
    F = torch.as_tensor(b3._score, dtype=torch.float64, device=dev)
    y_t = torch.as_tensor(yb, dtype=torch.float64, device=dev)
    ones_h = torch.ones(ds.num_data, dtype=torch.float32, device=dev)
    ones = torch.ones(ds.num_data, dtype=torch.bool, device=dev)
    lr = float(b3.learning_rate)
    for r in range(rounds):
        th, v, k, aux, _ = topt.lbfgs_device_loop(
            vg, th, cfg, kdt, (y_t - F).to(kdt), final_fn=psi)
        out = grower.grow((-aux).to(torch.float32), ones_h, ones,
                          b3._num_bins_t)
        check(np.array_equal(lr * out["leaf_value"].cpu().numpy(),
                             b1.trees[r].leaf_value),
              f"device loop vs stepwise: round {r}'s leaf values differ")
        F = F + (lr * out["leaf_value"])[out["row_leaf"].long()]
    check(np.array_equal(F.cpu().numpy(), b1._score),
          "device loop vs stepwise: the scores differ")
    # against the host loop, an independent orchestration: the same trees
    # and scores
    check(len(host_bst.trees) == rounds, f"the host loop has "
          f"{len(host_bst.trees)} trees, the device loop {rounds}")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))

    score_rel = rel(b1._score, host_bst._score)
    leaf_rel = max(rel(x.leaf_value, y.leaf_value)
                   for x, y in zip(b1.trees, host_bst.trees))
    splits_same = all(np.array_equal(x.split_feature, y.split_feature)
                      and np.array_equal(x.threshold_bin, y.threshold_bin)
                      for x, y in zip(b1.trees, host_bst.trees))
    same_as_host = bool(
        np.array_equal(b1._score, host_bst._score) and splits_same
        and all(np.array_equal(x.leaf_value, y.leaf_value)
                for x, y in zip(b1.trees, host_bst.trees)))
    check(splits_same and score_rel <= DL_HOST_RTOL
          and leaf_rel <= DL_HOST_RTOL,
          f"device loop vs the host loop: splits the same {splits_same}, "
          f"scores {score_rel:.3e} and leaf values {leaf_rel:.3e} apart "
          f"(relative; the bound {DL_HOST_RTOL})")
    mse = float(np.mean((yb - b1._score) ** 2))
    mse_host = float(np.mean((yb - host_bst._score) ** 2))
    info = b1.device_training_info_
    out = {"rounds": rounds, "train_cold_s": t_cold, "train_warm_s": t_warm,
           "device_seconds_cold": info["device_seconds"],
           "device_seconds_warm": b2.device_training_info_["device_seconds"],
           "refit_iterations": info["refit_iterations"].tolist(),
           "refit_evaluations": info["refit_evaluations"].tolist(),
           "host_reads": info["host_reads"],
           "host_reads_per_round": (info["host_reads"] - 1) / rounds,
           "cov_nll_first": float(info["cov_nll"][0]),
           "cov_nll_last": float(info["cov_nll"][-1]),
           "cov_pars": gp1.get_cov_pars().tolist(),
           "launches_cold": l1, "launches_warm": l2,
           "two_runs_same_bits": same, "stepwise_same_bits": True,
           "train_mse": mse, "host_loop_train_mse": mse_host,
           "train_mse_rel_diff": mse / mse_host - 1.0,
           "same_bits_as_host_loop": same_as_host,
           "score_rel_diff_vs_host_loop": score_rel,
           "leaf_rel_diff_vs_host_loop": leaf_rel,
           "host_loop_tolerance": DL_HOST_RTOL}
    emit({"phase": "device_loop", **out})
    return out, l1


def device_loop_lagaboost(ng, ds_ng, m, seed, dev):
    """Phase 16 (c): the LaGaBoost branch of the device loop on the
    non-Gaussian path's Dataset, DL_NG_ROUNDS rounds with refits at
    DL_NG_MAXIT: trees, finite NLLs, no Vecchia kernel (the latent factors
    are outside their gate), the histogram once a step, host reads = the
    refits' evaluations and CG iterations and one fetch."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import cg as cgops
    gp = _ng_model(ng["coords"], m, seed, torch.float32, dev, DL_NG_MAXIT)
    reset_counts()
    cg0 = cgops.pcg.host_reads
    t0 = clock()
    bst = gpt.train(dict(NG_PARAMS, device_resident_boosting="true"), ds_ng,
                    gp_model=gp, num_boost_round=DL_NG_ROUNDS)
    t_train = clock() - t0
    launches = read_counts()
    info = bst.device_training_info_
    check(bst.num_trees() == DL_NG_ROUNDS, f"device LaGaBoost: "
          f"{bst.num_trees()} trees")
    _check_trees(bst, "device_lagaboost")
    check(bool(np.all(np.isfinite(info["cov_nll"]))),
          f"device LaGaBoost: NLLs {info['cov_nll']}")
    check(launches["vecchia_factors"] == launches["vecchia_nll_grad"] == 0,
          f"device LaGaBoost launched a Vecchia kernel: {launches}")
    check(launches["histogram"] == DL_NG_ROUNDS * bst.grower.num_leaves,
          f"device LaGaBoost: {launches['histogram']} histogram launches")
    check(info["host_reads"] > int(info["refit_evaluations"].sum()),
          f"device LaGaBoost: {info['host_reads']} host reads")
    cov_pars = gp.get_cov_pars()
    check(bool(np.all(np.isfinite(cov_pars)) and np.all(cov_pars > 0)),
          f"device LaGaBoost: cov_pars {cov_pars}")
    out = {"rounds": DL_NG_ROUNDS, "refit_maxit": DL_NG_MAXIT,
           "train_s": t_train, "device_seconds": info["device_seconds"],
           "cov_nll": info["cov_nll"].tolist(),
           "refit_evaluations": info["refit_evaluations"].tolist(),
           "host_reads": info["host_reads"],
           "cg_host_reads_with_trailing_refit": cgops.pcg.host_reads - cg0,
           "includes_compile": info["includes_compile"],
           "launches": launches, "cov_pars": cov_pars.tolist()}
    emit({"phase": "device_lagaboost", **out})
    return out, launches


def device_loop_trace(ds, yb, coords, m, seed, dev, hist_call, go_data):
    """Phase 16 (d): one profiler session (the process's first with CUDA
    activities; a second records no device operation on this machine)
    over one histogram call, one host-grower tree, one graph replay of the
    fixed-shape grower, one replay of a categorical tree with a forced
    split (phase 17's Dataset, ``go_data``), one warm round of the host
    loop and one of the device loop (to the end of its fetch); their
    device idle shares from the trace, the memory snapshot's size, and the
    launches that ``FixedGrower.grow`` adds to the counts at a replay
    (what its capture counted) seen in the trace: ``num_leaves`` of the
    histogram's device-scales instance in the replay and in each round;
    ``num_leaves`` + one a forced split of it and ``2 num_leaves - 1`` of
    the group scan in the categorical replay. The trace and the snapshot
    go to a temporary directory that is removed after they are read.
    Returns the histogram call's device operations too."""
    import os
    import shutil
    import tempfile
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting import tree as tt
    from gpboost_tpu_torch.utils import profiler
    b = gpt.Booster(params=dict(BOOST_PARAMS,
                                device_resident_boosting="false"),
                    train_set=ds, gp_model=_gp_model(coords, m, seed,
                                                     torch.float32, dev))
    b.update()                                   # warm: refit memory, graph
    grad, hess = b.objective.get_gradients(b._score)
    g = torch.as_tensor(grad, dtype=torch.float32, device=dev)
    h = torch.as_tensor(hess, dtype=torch.float32, device=dev)
    fg = tt.fixed_grower(ds.binned, ds.max_num_bins, b.grower,
                         torch.float32, nan_mask=ds.has_nan,
                         binned_t=ds.binned_t, efb=ds.efb)
    ones = torch.ones(ds.num_data, dtype=torch.bool, device=dev)
    Xc, yc, _ = go_data
    b_cat = gpt.Booster(params=dict(BOOST_PARAMS, forced_splits=GO_FORCED),
                        train_set=gpt.Dataset(Xc, label=yc,
                                              categorical_feature=[5, 6],
                                              device=dev))
    fg_cat, _, n_ops = _option_grower(b_cat)
    fg_cat.grow(g, h, ones, b_cat._num_bins_t)           # its capture
    params = dict(BOOST_PARAMS, device_resident_boosting="true")
    # the device loop's round starts its refit where the host loop's does
    gp_dl = _gp_model(coords, m, seed, torch.float32, dev)
    gp_dl.cov_pars_ = np.array(b.gp_model.cov_pars_)
    hist_call()
    torch.cuda.synchronize()
    names = ("histogram_call", "host_grower_tree", "fixed_grower_replay",
             "categorical_grower_replay", "host_loop_round",
             "device_loop: round")
    # a device-loop round does not wait for its device work (the host loop's
    # round ends in a synchronise here): its window runs on to the end of the
    # loop's one fetch, which does
    until = {"device_loop: round": "device_loop: fetch"}
    tmp = tempfile.mkdtemp(prefix="phase16_trace_")
    with profiler.trace(tmp) as prof:
        with profiler.annotate("histogram_call"):
            hist_call()
            torch.cuda.synchronize()
        with profiler.annotate("host_grower_tree"):
            tt.grow_tree(ds.binned, b._num_bins_t, g, h, ds.max_num_bins,
                         b.grower, binned_t=ds.binned_t, nan_mask=ds.has_nan)
            torch.cuda.synchronize()
        with profiler.annotate("fixed_grower_replay"):
            fg.grow(g, h, ones, b._num_bins_t)
            torch.cuda.synchronize()
        reset_counts()
        with profiler.annotate("categorical_grower_replay"):
            fg_cat.grow(g, h, ones, b_cat._num_bins_t)
            torch.cuda.synchronize()
        cat_counts = read_counts()
        with profiler.annotate("host_loop_round"):
            b.update()
            torch.cuda.synchronize()
        gpt.train(params, ds, gp_model=gp_dl, num_boost_round=1)
    windows = _trace_windows(prof.trace_path, names, until)
    hist_ops = windows["histogram_call"]["op_names"]
    # a replay adds the launches its capture counted (FixedGrower.grow):
    # the trace shows what a replay launched, the grower's num_leaves
    L = b.grower.num_leaves
    for name in ("fixed_grower_replay", "host_loop_round",
                 "device_loop: round"):
        got = windows[name]["hist_dev_scales_launches"]
        check(got == L, f"trace: {got} launches of hist_kernel<true> in "
              f"{name}, {L} expected (one a step of the fixed-shape grower)")
    w = windows["categorical_grower_replay"]
    want = (L + n_ops, 2 * L - 1)
    traced = (w["hist_dev_scales_launches"], w["cat_group_scan_launches"])
    counted = (cat_counts["histogram"], cat_counts["cat_group_scan"])
    check(traced == want and counted == want,
          f"trace: the categorical replay launched hist_kernel<true> / "
          f"cat_group_scan_kernel {traced} times and counted {counted}, "
          f"{want} expected (one a step and one a forced split; one a leaf "
          f"scanned)")
    del fg_cat, b_cat
    snap = os.path.join(tmp, "memory_snapshot.pickle")
    profiler.device_memory_profile(snap)
    out = {"trace_bytes": os.path.getsize(prof.trace_path),
           "windows": windows, "memory_snapshot_bytes": os.path.getsize(snap)}
    shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "device_loop_trace", **out})
    return out, hist_ops


def device_loop_paths(ds, yb, coords, m, seed, rounds, ng, ds_ng, host_bst,
                      hist_call, go_data, dev):
    """Phase 16: the device-resident GPBoost loop and its fixed-shape grower
    (:func:`fixed_grower_path`, :func:`device_loop_training`,
    :func:`device_loop_lagaboost`, :func:`device_loop_trace`)."""
    timings, launches = {}, {}
    t0 = clock()
    grower, _ = fixed_grower_path(ds, coords, m, seed, dev)
    timings["dl_fixed_grower_s"] = clock() - t0
    t0 = clock()
    dl, launches["device_loop"] = device_loop_training(
        ds, yb, coords, m, seed, rounds, dev, host_bst)
    timings["dl_training_s"] = clock() - t0
    t0 = clock()
    ngl, launches["device_lagaboost"] = device_loop_lagaboost(
        ng, ds_ng, m, seed, dev)
    timings["dl_lagaboost_s"] = clock() - t0
    t0 = clock()
    trace, hist_ops = device_loop_trace(ds, yb, coords, m, seed, dev,
                                        hist_call, go_data)
    timings["dl_trace_s"] = clock() - t0
    timings.update({
        f"train_{rounds}r_device_s": dl["train_cold_s"],
        f"train_{rounds}r_device_warm_s": dl["train_warm_s"],
        "host_grower_ms_per_tree": grower["host_grower_ms_per_tree"],
        "fixed_eager_ms_per_tree": grower["fixed_eager_ms_per_tree"],
        "fixed_replay_ms_per_tree": grower["fixed_replay_ms_per_tree"],
        "device_lagaboost_train_s": ngl["train_s"],
        "idle_share_host_loop_round":
            trace["windows"]["host_loop_round"]["idle_share"],
        "idle_share_device_loop_round":
            trace["windows"]["device_loop: round"]["idle_share"]})
    return launches, timings, hist_ops


# ---------------------------------------------------------------------------
# phase 17: the fixed-shape grower's options (ROADMAP item 10b, part 1):
# categorical splits, monotone and interaction constraints, forced splits
# ---------------------------------------------------------------------------

GO_HOST_REPS = 3              # host-grower trees timed a case
GO_REPLAY_REPS = 20           # graph replays timed a case
GO_ROUNDS = 10                # the device loop with the options
GO_MONO = [0, 1, 0, 0, 0, 0, 0]   # X2 enters f as X2^2 on [0, 1]: increasing
GO_PENALTY = 1.0
GO_FORCED = {"feature": 0, "threshold": 0.5,
             "left": {"feature": 1, "threshold": 0.5}}
# (name, categorical Dataset, params): the numeric cases run on the same
# data with the two level columns as numbers
GO_CASES = (
    ("categorical", True, {}),
    ("mono_basic", False, {"monotone_constraints": GO_MONO,
                           "monotone_penalty": GO_PENALTY}),
    ("mono_intermediate", False, {"monotone_constraints": GO_MONO,
                                  "monotone_constraints_method":
                                  "intermediate",
                                  "monotone_penalty": GO_PENALTY}),
    ("mono_advanced", False, {"monotone_constraints": GO_MONO,
                              "monotone_constraints_method": "advanced",
                              "monotone_penalty": GO_PENALTY}),
    ("interaction", False, {"interaction_constraints": [[0, 1], [2, 3, 4],
                                                        [5, 6]]}),
    ("forced", False, {"forced_splits": GO_FORCED}),
    ("forced_monotone", False, {"forced_splits": GO_FORCED,
                                "monotone_constraints": GO_MONO,
                                "monotone_constraints_method":
                                "intermediate"}),
    ("cat_interaction_forced", True, {"interaction_constraints":
                                      [[0, 1, 5], [2, 3, 4, 6]],
                                      "forced_splits": GO_FORCED}),
)
# the device loop's options beside the float32 Vecchia GP
GO_LOOP_PARAMS = {"monotone_constraints": GO_MONO,
                  "forced_splits": {"feature": 0, "threshold": 0.5}}


def _option_grower(b):
    """The fixed-shape grower of the booster ``b``'s Dataset and tree
    options (float32 gradients), the host grower's keywords for those
    options, and the number of forced splits a tree takes."""
    from gpboost_tpu_torch.boosting import tree as tt
    ds = b.train_set
    opts = dict(categorical_mask=b._cat_mask,
                max_cat_threshold=b.max_cat_threshold,
                monotone_constraints=b._monotone,
                interaction_constraints=b._interaction_constraints,
                forced_splits=b._forced_splits)
    fg = tt.FixedGrower(ds.binned, ds.max_num_bins, b.grower, torch.float32,
                        nan_mask=ds.has_nan, binned_t=ds.binned_t,
                        efb=ds.efb, **opts)
    n_ops = len(tt.flatten_forced_splits(b._forced_splits,
                                         b.grower.num_leaves))
    return fg, opts, n_ops


def _grower_option_case(name, b, g, h, ones, dev):
    """One case of phase 17 on the booster ``b``'s Dataset and options with
    the round-1 gradients ``g`` / ``h``: the host grower's tree, the
    fixed-shape grower's eager run (its capture), its replay and a direct
    eager call under CUDA's sync debug mode "error", the launches, ms."""
    from gpboost_tpu_torch.boosting import tree as tt
    ds = b.train_set
    B, L = ds.max_num_bins, b.grower.num_leaves
    nb = b._num_bins_t
    fg, opts, n_ops = _option_grower(b)
    has_cat = b._cat_mask is not None

    def host_tree():
        return tt.grow_tree(ds.binned, nb, g, h, B, b.grower,
                            binned_t=ds.binned_t, nan_mask=ds.has_nan,
                            efb=ds.efb, **opts)

    reset_counts()
    tree, row_leaf = host_tree()
    host_counts = dict(read_counts(),
                       host_reads=tt.grow_tree.host_reads)
    check(host_counts["histogram"] == tree.num_leaves + n_ops,
          f"{name}: the host grower launched the histogram "
          f"{host_counts['histogram']} times for {tree.num_leaves} leaves "
          f"and {n_ops} forced splits")
    reset_counts()
    eager = {k: v.clone() for k, v in fg.grow(g, h, ones, nb).items()}
    eager_counts = read_counts()
    check(fg.captures == 1, f"{name}: the fixed-shape grower did not capture")
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay = {k: v.clone() for k, v in fg.grow(g, h, ones, nb).items()}
        direct = tt._grow_tree_fixed(g, h, ones, nb, fg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    replay_counts = read_counts()
    for k in eager:
        check(torch.equal(eager[k], replay[k])
              and torch.equal(direct[k], replay[k]),
              f"{name}: {k} of the graph replay differs from the eager run")
    _fixed_vs_host(replay, tree, row_leaf, name)
    # launches a tree: the histogram num_leaves + one a forced split, the
    # group scan once a leaf scanned (2 num_leaves - 1) on a categorical
    # Dataset
    want_hist = L + n_ops
    want_scan = (2 * L - 1) if has_cat else 0
    got = (eager_counts["histogram"], eager_counts["cat_group_scan"],
           replay_counts["histogram"], replay_counts["cat_group_scan"])
    check(got == (want_hist, want_scan, 2 * want_hist, 2 * want_scan),
          f"{name}: histogram / group-scan launches (eager, replay + direct) "
          f"{got}, expected {want_hist} / {want_scan} a tree")
    t0 = clock()
    for _ in range(GO_HOST_REPS):
        host_tree()
    host_ms = (clock() - t0) / GO_HOST_REPS * 1e3
    replay_ms = time_ms(lambda: fg.grow(g, h, ones, nb), GO_REPLAY_REPS)
    graph_only_ms = time_ms(fg._graph.replay, GO_REPLAY_REPS)
    n_cat = int(np.sum(tree.is_categorical[tree.internal_nodes()]))
    if has_cat:
        check(n_cat > 0, f"{name}: no categorical split")
    if n_ops:
        check(tree.split_feature[0] == 0 and tree.split_gain[0] == 0.0,
              f"{name}: the forced split is not at the root")
    del fg
    return {"leaves": tree.num_leaves, "forced_splits": n_ops,
            "categorical_splits": n_cat, "same_bits_as_host_grower": True,
            "replay_same_bits_as_eager": True,
            "fixed_histogram_launches_per_tree": eager_counts["histogram"],
            "fixed_group_scan_launches_per_tree":
                eager_counts["cat_group_scan"],
            "host_grower_host_reads": host_counts["host_reads"],
            "host_grower_ms_per_tree": host_ms,
            "fixed_replay_ms_per_tree": replay_ms,
            "fixed_graph_replay_device_ms": graph_only_ms}


def check_group_scan(b, seed, dev):
    """The group-scan kernel against its plain version on the categorical
    Dataset's root histogram: the inputs ``_cat_scan`` hands it (the
    forward and reverse rows of both categorical features), float32 as on
    the kernel route and float64 as under ``gpu_use_dp``; the same bits.
    Times the kernel (back to back, and its device time in a graph), the
    plain version, and the bound (bytes)."""
    from gpboost_tpu_torch.boosting import tree as tt
    from gpboost_tpu_torch.ops.kernels import cat_group_scan as gk
    ds = b.train_set
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    g, h = _hist_values(gen, ds.num_data, dev)
    full = torch.ones(ds.num_data, dtype=torch.bool, device=dev)
    hist = torch.stack(tt.build_histogram(ds.binned, g, h, full,
                                          ds.max_num_bins,
                                          binned_t=ds.binned_t))
    idx = torch.as_tensor(ds.categorical_feature, device=dev)
    nb = b._num_bins_t[idx]
    seen = []
    orig = tt.group_boundaries

    def record(counts, ok, mdpg):
        seen.append((counts.clone(), ok.clone(), mdpg))
        return orig(counts, ok, mdpg)

    tt.group_boundaries = record
    try:
        tt._cat_scan(hist[:, idx], nb, 0.0, 0.0, 20.0, 1e-3,
                     b.max_cat_threshold, None, b.grower.cat_l2,
                     b.grower.cat_smooth, b.grower.min_data_per_group,
                     b.grower.max_cat_to_onehot)
    finally:
        tt.group_boundaries = orig
    check(len(seen) == 1, f"group scan: _cat_scan called it {len(seen)} "
          "times")
    counts, ok, mdpg = seen[0]
    cases = []
    for c in (counts, counts.double()):
        before = gk.group_boundaries.launches
        got = gk.group_boundaries(c, ok, mdpg)
        check(gk.group_boundaries.launches == before + 1,
              "group scan: the wrapper did not launch")
        want = gk.group_boundaries_plain(c, ok, mdpg)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        check(mism == 0, f"group scan ({c.dtype}): {mism} positions differ "
              "from the plain version")
        cases.append({"dtype": str(c.dtype), "mismatches": mism,
                      "boundaries": int(got.sum())})
    D, Bn = counts.shape
    before = gk.group_boundaries.launches
    ms = time_ms(lambda: gk.group_boundaries(counts, ok, mdpg), 50)
    device_ms = graph_ms(lambda: gk.group_boundaries(counts, ok, mdpg), 50)
    plain_ms = time_ms(lambda: gk.group_boundaries_plain(counts, ok, mdpg),
                       3)
    gk.group_boundaries.launches = before
    # each input read once, each output written once: float32 counts,
    # bool ok, bool out
    nbytes = D * Bn * (4 + 1 + 1)
    timed = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
             "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "library_ms": None, "D": D, "B": Bn,
             "min_data_per_group": mdpg}
    return cases, timed


def grower_options_paths(tt_data, coords, m, seed, dev):
    """Phase 17: the fixed-shape grower's options on phase 14's categorical
    recipe at the path's n (c2 Zipf past the 255-bin cap, 10 % NaN in X1):
    every case of GO_CASES on the round-1 gradients of the GPBoost recipe
    (:func:`_grower_option_case`), the group-scan kernel against its plain
    version (:func:`check_group_scan`), and ``train(...,
    device_resident_boosting="true")`` for GO_ROUNDS rounds with a
    categorical feature, a monotone constraint and a forced split beside
    the float32 Vecchia GP against the host loop (the same trees and scores
    to the bit). Returns (launches of the device-loop training, timings,
    the group scan's cases and times)."""
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.boosting import tree as tt
    Xc, y, _ = tt_data
    t_start = clock()
    ds_cat = gpt.Dataset(Xc, label=y, categorical_feature=[5, 6], device=dev)
    ds_num = gpt.Dataset(Xc, label=y, device=dev)
    gp_b = gpt.Booster(params=dict(BOOST_PARAMS), train_set=ds_cat,
                       gp_model=_gp_model(coords, m, seed, torch.float32,
                                          dev))
    grad, hess = gp_b.objective.get_gradients(gp_b._score)
    g = torch.as_tensor(grad, dtype=torch.float32, device=dev)
    h = torch.as_tensor(hess, dtype=torch.float32, device=dev)
    ones = torch.ones(len(y), dtype=torch.bool, device=dev)
    out, timings = {}, {}
    for name, cat, params in GO_CASES:
        b = gpt.Booster(params=dict(BOOST_PARAMS, **params),
                        train_set=ds_cat if cat else ds_num)
        check(not tt.fixed_grower_gaps(b.grower, b._cegb),
              f"{name}: not the fixed grower's")
        out[name] = _grower_option_case(name, b, g, h, ones, dev)
        timings[f"go_{name}_replay_ms"] = out[name]["fixed_replay_ms_per_tree"]
        timings[f"go_{name}_host_ms"] = out[name]["host_grower_ms_per_tree"]
        emit({"phase": "grower_options", "case": name, **out[name]})
    scan_cases, scan_timed = check_group_scan(
        gpt.Booster(params=dict(BOOST_PARAMS), train_set=ds_cat), seed, dev)
    emit({"phase": "cat_group_scan", "cases": scan_cases, **scan_timed})
    # the device loop with the options, then the host loop on the same
    # Dataset (Booster.update grows with the same captured grower)
    loop = dict(BOOST_PARAMS, **GO_LOOP_PARAMS)
    runs = {}
    for mode in ("true", "false"):
        reset_counts()
        t0 = clock()
        bst = gpt.train(dict(loop, device_resident_boosting=mode), ds_cat,
                        gp_model=_gp_model(coords, m, seed, torch.float32,
                                           dev),
                        num_boost_round=GO_ROUNDS)
        runs[mode] = (bst, read_counts(), clock() - t0)
    (bd, ld, td), (bh, lh, th) = runs["true"], runs["false"]
    check("device_training_info_" in bd.__dict__
          and "device_training_info_" not in bh.__dict__,
          "grower options: the device loop did not engage, or the host "
          "loop did not run")
    L = bd.grower.num_leaves
    n_ops = len(tt.flatten_forced_splits(bd._forced_splits, L))
    for tag, bst, launches in (("device", bd, ld), ("host", bh, lh)):
        _check_trees(bst, f"grower_options_{tag}_loop")
        want_hist, _ = grower_counts(bst.trees, L, n_ops)
        check(launches["histogram"] == want_hist
              and launches["cat_group_scan"] == GO_ROUNDS * (2 * L - 1),
              f"grower options, {tag} loop: {launches} for {GO_ROUNDS} "
              f"trees of {L} leaves and {n_ops} forced splits")
        check(launches["vecchia_nll_grad"] > 0
              and launches["vecchia_factors"] > 0,
              f"grower options, {tag} loop: Vecchia kernels {launches}")
        check(all(t.split_feature[0] == 0 for t in bst.trees),
              f"grower options, {tag} loop: the forced root split is missing")
    check(any(t.has_categorical() for t in bd.trees),
          "grower options: no categorical split in the device loop")
    same = (np.array_equal(bd._score, bh._score) and all(
        np.array_equal(x.split_feature, z.split_feature)
        and np.array_equal(x.threshold_bin, z.threshold_bin)
        and np.array_equal(x.cat_mask, z.cat_mask)
        and np.array_equal(x.leaf_value, z.leaf_value)
        for x, z in zip(bd.trees, bh.trees)))
    check(same, "grower options: the device loop's trees and scores differ "
          "from the host loop's")
    timings.update(go_device_loop_train_s=td, go_host_loop_train_s=th,
                   phase17_s=clock() - t_start)
    emit({"phase": "grower_options_loop", "rounds": GO_ROUNDS,
          "params": GO_LOOP_PARAMS, "same_bits_as_host_loop": same,
          "device_loop_train_s": td, "host_loop_train_s": th,
          "device_launches": ld, "host_launches": lh,
          "device_host_reads": bd.device_training_info_["host_reads"],
          "phase17_s": timings["phase17_s"]})
    del ds_cat, ds_num, gp_b, bd, bh
    torch.cuda.empty_cache()
    return ld, timings, (scan_cases, scan_timed)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--n-pred", type=int, default=10_000)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--grouped-n", type=int, default=GR_N)
    args = ap.parse_args()
    t_script = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    # before anything is printed: without the package there is no result
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops.kernels import _build
    from gpboost_tpu_torch.ops.kernels import histogram as hk
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    vk._lib()
    hk._lib()
    ptxas = [ln for name in libs for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln
             or "Function properties" in ln]
    kernel_ptxas = {k: ptxas_report(_build.build_log(src), k)
                    for k, src in (("factors_kernel", "vecchia_factors"),
                                   ("nll_grad_kernel", "vecchia_factors"),
                                   ("hist_kernel", "histogram"),
                                   ("cat_group_scan_kernel",
                                    "cat_group_scan"))}
    for kernel, rep in kernel_ptxas.items():
        count = 3 if kernel in ("factors_kernel", "nll_grad_kernel") else 2
        check(len(rep) == count and all("registers" in x for x in rep),
              f"ptxas lines of {kernel}'s {count} instances (d <= 2, 4, 8 "
              f"for the Vecchia kernels; scales by value and from device "
              f"memory for the histogram; float and double counts for the "
              f"group scan) not found: {rep}")
        check(all(x["stack_frame_bytes"] == x["spill_store_bytes"]
                  == x["spill_load_bytes"] == 0 for x in rep),
              f"{kernel}: a stack frame or spills, its per-row arrays must "
              f"stay in shared memory and registers: {rep}")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(libs), "ptxas": ptxas, **kernel_ptxas})
    coords, y, pred = make_data(args.seed, args.n, args.n_pred)
    boost_data = make_boost_data(args.seed, y, args.n_pred)
    t0 = time.perf_counter()
    cases, timed = check_kernels(coords, y, pred, args.m, args.seed, dev)
    hist_ds = gpt.Dataset(boost_data[0], label=boost_data[1], device=dev)
    cases["histogram"], timed["histogram"], hist_call = check_histogram(
        hist_ds, args.seed, dev)
    del hist_ds
    t_check = time.perf_counter() - t0
    launches, timings, gp_model = main_path(coords, y, pred, args.m,
                                            args.seed, dev)
    bt = incoming_bt(gp_model, dev)
    main_cov_pars = gp_model.get_cov_pars()
    del gp_model
    boost_launches, boost_timings, bst, ds = boosting_path(
        boost_data, coords, pred, args.m, args.seed, args.rounds, dev)
    timings.update(boost_timings)
    gd_launches, gd_timings = gp_default_route(coords, y, args.m, args.seed,
                                               dev)
    timings.update(gd_timings)
    bgd_launches, bgd_timings = boosting_default_route(
        ds, boost_data[0], boost_data[1], coords, args.m, args.seed,
        args.rounds, dev)
    timings.update(bgd_timings)

    # the non-Gaussian path: GP, float32 vs float64, LaGaBoost
    ng = make_ng_data(args.seed, args.n, args.n_pred)
    ng_launches, ng_timings, ng_model = ng_path(ng, args.m, args.seed, dev)
    timings.update(ng_timings)
    ng_precision(ng, args.m, args.seed, dev)
    lg_launches, lg_timings, bst_ng, ds_ng = lagaboost(
        ng, args.m, args.seed, dev)
    timings.update(lg_timings)

    # grouped random effects: the LMM, GPBoost with them, the GLMM
    gd = make_grouped_data(args.seed, args.grouped_n, args.n_pred)
    lmm_launches, lmm_timings, lmm_fit = grouped_lmm(gd, args.seed, dev)
    timings.update(lmm_timings)
    torch.cuda.empty_cache()
    trace_model = grouped_vs_cpu(gd, dev)
    gb_launches, gb_timings, bst_g, gb_data = grouped_boosting(
        args.seed, args.n, args.n_pred, args.rounds, dev)
    timings.update(gb_timings)
    glmm_launches, glmm_timings, glmm_model = grouped_glmm(gd, dev)
    timings.update(glmm_timings)
    torch.cuda.empty_cache()

    # the exact GP: alone, clustered, combined, Laplace, boosting with it,
    # and LaGaBoost with grouped effects
    ex_launches, ex_timings, firsts, ex_hist = exact_paths(
        args.seed, args.n, args.n_pred, args.rounds, dev)
    timings.update(ex_timings)
    cases["histogram"] += ex_hist[0]
    timed["histogram"]["other_shapes"] += ex_hist[1]
    # the low-rank and full-scale approximations
    lr_launches, lr_timings, lr_firsts, lr_hist = lowrank_paths(
        coords, y, pred, ng, args.seed, args.rounds, dev)
    timings.update(lr_timings)
    cases["histogram"] += lr_hist[0]
    timed["histogram"]["other_shapes"] += lr_hist[1]
    # the iterative methods: grouped effects in b-space, the low-rank
    # preconditioner, full-scale tapering by CG; faults C3 and C4
    it_launches, it_timings = iterative_paths(
        gd, lmm_fit, glmm_model.get_cov_pars(), ng, coords, y, pred, args.m,
        args.seed, args.n, args.n_pred, dev)
    timings.update(it_timings)
    # the rest of the Vecchia GP: cluster_ids, the prediction types, GP
    # random coefficients, grouped effects beside the GP, the Laplace
    # routes with them, the heteroscedastic and latent models
    vr_launches, vr_timings, vr_kern = vecchia_rest_paths(
        coords, y, pred, main_cov_pars, ng, args.m, args.seed, dev)
    timings.update(vr_timings)
    cases["vecchia_factors"] += [vr_kern["factors_train"],
                                 vr_kern["factors_predict"]]
    cases["vecchia_nll_grad"].append(vr_kern["nll_grad"])
    # the rest of the covariance families and the likelihood tail, before
    # the second runs of the earlier paths: its general-order Bessel series
    # builds many autograd nodes inside backward passes, which moved a
    # later exact LaGaBoost training's last bits until the port ran its
    # backward passes on the calling thread (ROADMAP fault C5), so the
    # pairs below span it
    tail_launches, tail_timings = cov_likelihood_tail_paths(
        coords, y, gd, args.m, args.seed, dev)
    timings.update(tail_timings)
    # phase 13, the validation / objectives / cv slice, before the second
    # runs too
    bt_launches, bt_timings, bt_hist = boosting_tail_paths(
        boost_data, coords, pred, args.m, args.seed, args.n, dev)
    timings.update(bt_timings)
    cases["histogram"] += bt_hist[0]
    timed["histogram"]["other_shapes"].append(bt_hist[1])
    # phase 14, the tree learner's tail and its data, before the second
    # runs too
    t0 = clock()
    tt_launches, tt_timings, tt_hist = tree_tail_paths(
        boost_data, coords, pred, args.m, args.seed, dev)
    timings.update(tt_timings)
    timings["phase14_s"] = clock() - t0
    cases["histogram"] += tt_hist[0]
    timed["histogram"]["other_shapes"] += tt_hist[1]
    # phase 15, the rest of the boosting tail, before the second runs too
    t0 = clock()
    b15_launches, b15_timings, b15_hist = boosting_tail_2_paths(
        boost_data, coords, pred, args.m, args.seed, dev)
    timings.update(b15_timings)
    timings["phase15_s"] = clock() - t0
    cases["histogram"].append(b15_hist)
    # phase 16, the device-resident loop and its fixed-shape grower, before
    # the second runs too; its profiler session is the process's first with
    # CUDA activities and also gives the histogram call's stream operations
    # phase 14's categorical recipe, which phase 16's trace and phase 17 read
    go_data = make_tree_tail_data(args.seed, *boost_data)
    t0 = clock()
    dl_launches, dl_timings, hist_ops = device_loop_paths(
        ds, boost_data[1], coords, args.m, args.seed, args.rounds, ng, ds_ng,
        bst, hist_call, go_data, dev)
    timings.update(dl_timings)
    timings["phase16_s"] = clock() - t0
    # phase 17, the fixed-shape grower's options and the group-scan kernel,
    # before the second runs too
    go_launches, go_timings, go_scan = grower_options_paths(
        go_data, coords, args.m, args.seed, dev)
    timings.update(go_timings)
    determinism(bst, ds, boost_data[1], coords, args.m, args.seed, dev,
                ng_first=bst_ng, ng_ds=ds_ng, ng_coords=ng["coords"],
                grouped=(bst_g, gb_data), glmm=(glmm_model, gd))
    del bst, ds, bst_ng, ds_ng, bst_g, glmm_model
    exact_determinism(firsts["ex_boost"], firsts["ex_laga"], firsts["g_laga"],
                      firsts["clustered"], dev)
    lowrank_determinism(lr_firsts["fsva"], coords, y, lr_firsts["boost"], dev)
    del lr_firsts
    torch.cuda.empty_cache()
    timings.update(bt_sliced_ms=bt["sliced_ms"],
                   bt_scatter_ms=bt["scatter_ms"])
    timings["vecchia_nll_grad_ms"] = timed["nll_grad"]["ms"]
    timings["histogram_ms"] = timed["histogram"]["ms"]
    timings["kernel_checks_s"] = t_check
    emit({"timings": timings, "card": smi})

    # what one histogram call put on the stream (phase 16's trace)
    ops = hist_ops
    check(len(ops) == 1 and "hist_kernel" in ops[0],
          f"histogram: one call put {len(ops)} operations on the stream "
          f"(profiler trace), expected one, hist_kernel: {ops}")
    timed["histogram"].update(stream_ops_per_call=len(ops), stream_ops=ops)
    # after it: the process's first profiler session with CUDA activities
    # must be the histogram's (a second one records no device operation)
    precision_ops_trace(ng_model, dev)
    del ng_model
    grouped_ops_trace(trace_model, gd["yb"][:GR_CPU_N], dev)
    del trace_model
    exact_ops_trace(firsts["ex"], firsts["clustered"][0], dev)
    del firsts
    lowrank_ops_trace(coords, y, dev)
    iterative_ops_trace(gd, coords, y, dev)
    vecchia_rest_ops_trace(coords, y, args.m, args.seed, dev)

    # a kernel that a path runs must have been launched in that path's run
    paths = {"gp": launches, "boosting": boost_launches,
             "gp_default_route": gd_launches,
             "boosting_default_route": bgd_launches,
             "ng_path": ng_launches, "lagaboost": lg_launches,
             "grouped_lmm": lmm_launches, "grouped_boosting": gb_launches,
             "grouped_glmm": glmm_launches, **ex_launches, **lr_launches,
             **it_launches, **vr_launches, **tail_launches, **bt_launches,
             **tt_launches, **b15_launches, **dl_launches,
             "grower_options": go_launches}
    for path, counts, names in (
            ("gp", launches, ("vecchia_factors", "vecchia_nll_grad")),
            ("boosting", boost_launches, GP_BOOST_KERNELS),
            ("gp_default_route", gd_launches,
             ("vecchia_factors", "vecchia_nll_grad")),
            ("boosting_default_route", bgd_launches, GP_BOOST_KERNELS),
            ("lagaboost", lg_launches, ("histogram",)),
            ("grouped_boosting", gb_launches, ("histogram",)),
            ("exact_boosting", ex_launches["exact_boosting"], ("histogram",)),
            ("exact_lagaboost", ex_launches["exact_lagaboost"],
             ("histogram",)),
            ("grouped_lagaboost", ex_launches["grouped_lagaboost"],
             ("histogram",)),
            ("fsva_boosting", lr_launches["fsva_boosting"], ("histogram",)),
            ("fitc_lagaboost", lr_launches["fitc_lagaboost"],
             ("histogram",)),
            ("grouped_poisson_lagaboost",
             it_launches["grouped_poisson_lagaboost"], ("histogram",)),
            ("vecchia_clustered", vr_launches["vecchia_clustered"],
             ("vecchia_factors", "vecchia_nll_grad")),
            ("vecchia_combined", vr_launches["vecchia_combined"],
             ("histogram",)),
            ("space_time_vecchia", tail_launches["space_time_vecchia"],
             ("histogram",)),
            ("gpboost_validation", bt_launches["gpboost_validation"],
             GP_BOOST_KERNELS),
            ("objectives_tail", bt_launches["objectives_tail"],
             ("histogram",)),
            ("cv_grouped", bt_launches["cv_grouped"], ("histogram",)),
            ("categorical_gpboost", tt_launches["categorical_gpboost"],
             GP_BOOST_KERNELS + ("cat_group_scan",)),
            ("efb_onehot", tt_launches["efb_onehot"], ("histogram",)),
            ("tree_options", tt_launches["tree_options"], ("histogram",)),
            ("sparse_and_files", tt_launches["sparse_and_files"],
             ("histogram",)),
            ("boosting_types_gp", b15_launches["boosting_types_gp"],
             GP_BOOST_KERNELS),
            ("leaf_updates_gp", b15_launches["leaf_updates_gp"],
             GP_BOOST_KERNELS),
            ("ranking", b15_launches["ranking"], ("histogram",)),
            ("model_io", b15_launches["model_io"], ("histogram",)),
            ("device_loop", dl_launches["device_loop"], GP_BOOST_KERNELS),
            ("device_lagaboost", dl_launches["device_lagaboost"],
             ("histogram",)),
            ("grower_options", go_launches,
             GP_BOOST_KERNELS + ("cat_group_scan",))):
        for name in names:
            check(counts[name] > 0, f"the {path} path launched {name} "
                  f"{counts[name]} times")

    kernels = []
    for name, key in (("vecchia_factors", "train"),
                      ("vecchia_nll_grad", "nll_grad"),
                      ("histogram", "histogram")):
        t = timed[key]
        # launches: in the runs of the paths that the kernel was ported
        # for (the histogram's: the GPBoost path with the Vecchia GP and
        # with grouped random effects)
        own = (boost_launches[name] + gb_launches[name]
               if name == "histogram" else launches[name])
        entry = {"name": name, "route": "cuda", "source": SOURCE[name],
                 "replaces": REPLACES[name], "launches": own,
                 "launches_by_path": {k: v[name] for k, v in paths.items()},
                 "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": t.get("library_ms"), "n": t["n"]}
        if name == "histogram":
            entry.update(
                F=t["F"], B=t["B"], enqueue_ms=t["enqueue_ms"],
                device_ms=t["device_ms"],
                plain_f64_ms=t["plain_f64_ms"],
                empty_launch_ms=t["empty_launch_ms"],
                empty_launch_device_ms=t["empty_launch_device_ms"],
                stream_ops_per_call=t["stream_ops_per_call"],
                stream_ops=t["stream_ops"],
                cluster_blocks=t["cluster_blocks"],
                stack_frame_bytes=kernel_ptxas["hist_kernel"][0][
                    "stack_frame_bytes"],
                ptxas=kernel_ptxas["hist_kernel"],
                run_to_run_max_abs_diff=t["run_to_run_max_abs_diff"],
                run_to_run_bit_identical=t["run_to_run_bit_identical"],
                scales_host_ms=t["scales_host_ms"],
                # the device-scales entry (the fixed-shape grower's, every
                # tree of the main path on the card): "ms" and "device_ms"
                # above are the by-value entry's
                dev_scales_ms=t["dev_scales_ms"],
                dev_scales_device_ms=t["dev_scales_device_ms"],
                dev_scales_with_frexp_device_ms=t[
                    "dev_scales_with_frexp_device_ms"],
                static_smem_bytes=kernel_ptxas["hist_kernel"][0].get(
                    "static_smem_bytes"),
                library_is="one index_add_ on a prepared flat index",
                other_shapes=t["other_shapes"])
        else:
            entry["m"] = t["m"]
        if name == "vecchia_factors":
            entry.update(
                rows_per_block=t["rows_per_block"],
                threads_per_block=vk.BLOCK_THREADS,
                smem_bytes_per_block=t["smem_bytes_per_block"],
                stack_frame_bytes=max(x["stack_frame_bytes"]
                                      for x in kernel_ptxas["factors_kernel"]),
                ptxas=kernel_ptxas["factors_kernel"],
                padded_row_share=t["padded_row_share"],
                other_shapes=[timed["predict"], vr_kern["factors_train"],
                              vr_kern["factors_predict"]])
        elif name == "vecchia_nll_grad":
            entry["max_abs_err_is"] = ("largest gradient component error vs "
                                       "float64 autograd")
            rows, smem = vk.nll_launch_geometry(t["m"], coords.shape[1])
            entry.update(
                rows_per_block=rows, threads_per_block=vk.BLOCK_THREADS,
                smem_bytes_per_block=smem,
                stack_frame_bytes=max(x["stack_frame_bytes"]
                                      for x in kernel_ptxas["nll_grad_kernel"]),
                ptxas=kernel_ptxas["nll_grad_kernel"],
                padded_row_share=t["padded_row_share"],
                other_shapes=t["other_shapes"] + [vr_kern["nll_grad"]])
        kernels.append(entry)
    # the group scan: launches in phase 17's device-loop training (its
    # path), times on the categorical Dataset's root scan
    t = go_scan[1]
    kernels.append({
        "name": "cat_group_scan", "route": "cuda",
        "source": SOURCE["cat_group_scan"],
        "replaces": REPLACES["cat_group_scan"],
        "launches": go_launches["cat_group_scan"],
        "launches_by_path": {k: v["cat_group_scan"]
                             for k, v in paths.items()},
        "max_abs_err": float(max(c["mismatches"] for c in go_scan[0])),
        "max_abs_err_is": "positions that differ from the plain version",
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"], "D": t["D"], "B": t["B"],
        "ptxas": kernel_ptxas["cat_group_scan_kernel"]})
    # the script's wall time up to its result, the kernels' build included
    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
