"""The GPBoost training loop with its state on the device.

The counterpart of the JAX package's ``boosting/device_loop.py``, which
compiles every GPBoost round into one ``lax.fori_loop``. The host loop
(``Booster.update``) reads the host once a leaf and once a tree and carries
the score on the host; here every round keeps its state on the device:

    theta, nll, g = refit at the current score (L-BFGS,
                    optimizers.lbfgs_device_loop), whose final_fn gives the
                    tree's gradient: -Psi^-1 (y - F) (GPBoost) or
                    d NLL / dF (LaGaBoost), float32
    tree          = the fixed-shape grower (tree.FixedGrower: on CUDA one
                    captured graph, replayed every round) on g
    F             = F + lr * leaf_value[row_leaf]
    the tree's arrays written into preallocated [R, M] tensors

and after the last round ONE fetch brings the trees, the score and the
parameters to the host. The refit's L-BFGS loop is Python, as every fit of
the port: each evaluation reads the host once for its stop tests (the
iterative Laplace NLL of the LaGaBoost branch also once a CG iteration), and
these are the only host reads of a round. ``device_training_info_`` counts
them.

The round sequence is the host loop's: refits at F_0 .. F_{R-1} inside the
loop, the trailing refit at F_R through ``objective.get_gradients`` (the
host path), so the GPModel ends as the host loop leaves it. Each refit
restarts L-BFGS's curvature memory, as in the JAX package (the host loop
with ``reuse_learning_rates_gp_model`` carries it from refit to refit): the
two loops follow slightly different refit paths to the same optima.

``train`` engages the loop through :func:`eligible` (the parameter
``device_resident_boosting``). It has no fallback: an exception in
:func:`train_device` propagates (the JAX package's ``train`` falls back to
the host loop; ROADMAP.md, Not faults).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from gpboost_tpu_torch.boosting import tree as tree_mod
from gpboost_tpu_torch.utils.log import log_info
from gpboost_tpu_torch.utils.profiler import annotate

def _mode(booster) -> str:
    raw = booster.params.get("device_resident_boosting", "auto")
    mode = "auto" if raw is None else str(raw).lower()
    if mode not in ("auto", "true", "false"):
        raise ValueError("device_resident_boosting must be 'auto', 'true' or "
                         f"'false', got {raw!r}")
    return mode


def _vg_psi_for(vec, dtype):
    """(value-and-gradient fn, Psi^-1-solve fn, dtype) of a Gaussian
    VecchiaGP for the loop's refits: ``vg(theta, r)`` and ``psi(theta, r)``
    on the device, through the fused kernels inside their gate (float32 on
    CUDA) and the plain versions elsewhere. Cached on the model, so that
    their identities are stable."""
    cached = getattr(vec, "_device_loop_vg_psi", None)
    if cached is not None:
        return cached

    def vg_fn(th, r):
        return vec._vg_gaussian(th, r, None)

    kdt = torch.float32 if vec._kernel_shape is not None else dtype
    vec._device_loop_vg_psi = (vg_fn, vec._fit_psi_inv, kdt)
    return vec._device_loop_vg_psi


def _ng_fused_ok(gp, ds) -> bool:
    """Extra constraints of the LaGaBoost branch: the refit must be served
    by the iterative Laplace NLL (``vecchia_fit.ng_device_vg``) over theta =
    log cov_pars alone: no estimated aux parameters, no heteroscedastic
    model (the JAX package's ``device_loop._ng_fused_ok``)."""
    if gp.likelihood == "gaussian_heteroscedastic":
        return False
    from gpboost_tpu_torch import likelihoods as lk
    fam = lk.get_family(gp.likelihood)
    ia = fam.default_aux_pars(getattr(gp, "likelihood_additional_param",
                                      None))
    cfg = gp.optim_cfg
    if ia is not None and len(ia) and cfg.estimate_aux_pars:
        return False
    use_iter = (getattr(gp, "matrix_inversion_method", "cholesky")
                == "iterative" or ds.num_data > 8192)
    if not use_iter:
        return False
    from gpboost_tpu_torch.models import vecchia_fit
    return vecchia_fit.ng_device_fit_eligible(
        gp, cfg, is_het=False, has_coef=False, use_iterative=True)


def _grower_of(booster) -> tree_mod.FixedGrower:
    """The booster's fixed-shape grower with every option of its trees
    (the JAX package's ``grow_kwargs``)."""
    ds = booster.train_set
    return tree_mod.fixed_grower(
        ds.binned, ds.max_num_bins, booster.grower, torch.float32,
        nan_mask=ds.has_nan, binned_t=ds.binned_t, efb=ds.efb,
        categorical_mask=booster._cat_mask,
        max_cat_threshold=booster.max_cat_threshold,
        monotone_constraints=booster._monotone,
        interaction_constraints=booster._interaction_constraints,
        forced_splits=booster._forced_splits)


def eligible(booster, fobj=None, callbacks=None) -> bool:
    """Whether ``train`` runs the whole training as :func:`train_device`.

    The JAX package's hard constraints: a GPBoost / LaGaBoost objective that
    refits a Vecchia GP (isotropic, no coefficients on the GP, L-BFGS,
    no std errors, every parameter free; a Gaussian GP on CUDA inside the
    fused kernels' gate; a non-Gaussian one on the iterative Laplace
    route), one model a round, ``gbdt`` without Nesterov, no linear trees,
    leaf re-solve, line search, CEGB, extra trees, node- or tree-level
    feature sampling, bagging, validation sets, callbacks or ``fobj``.
    Categorical features, monotone and interaction constraints and forced
    splits are the fixed-shape grower's (``tree.fixed_grower_gaps``). The
    loop grows on float32 gradients, so ``gpu_use_dp`` keeps the host loop
    too.

    ``device_resident_boosting``: ``"false"`` never; ``"true"`` whenever the
    constraints allow, on the CPU too; ``"auto"`` (the default) never on
    the CPU, and on a GPU for a Gaussian GP whenever the constraints allow.
    Both loops capture the same grower graph on a new Dataset
    (``Booster.update`` grows with ``grow_tree_fast`` there), and
    ``tools/time_device_loop.py`` on an NVIDIA H100 80GB HBM3 at 700 W
    (PERF.md §6; the chip_smoke.py recipe, 3 runs a point) put the device
    loop's median at 0.84-0.98 of the host loop's at 5 and 30 rounds at
    n = 2 000, 1e4 and 1e5, cold and warm, and at 0.83-1.20 at 1 round,
    inside the runs' spread. The LaGaBoost branch has not been timed
    against the host loop at the same refit depth: ``"true"`` alone
    engages it.
    """
    mode = _mode(booster)
    if mode == "false":
        return False
    from gpboost_tpu_torch.boosting.objectives import GPBoostObjective
    obj = booster.objective
    if fobj is not None or callbacks:
        return False
    if booster.valid_sets:
        return False
    if not isinstance(obj, GPBoostObjective):
        return False
    gp = booster.gp_model
    if gp is None or not obj.train_gp_model_cov_pars:
        return False
    if mode == "auto" and (booster.device.type != "cuda"
                           or not gp.is_gaussian):
        return False
    ds = booster.train_set
    is_gaussian = gp.is_gaussian
    if not is_gaussian and not _ng_fused_ok(gp, ds):
        return False
    if booster.num_models != 1 or booster.trees:
        return False
    if booster.boosting_type != "gbdt" or booster.use_nesterov_acc:
        return False
    if (booster.linear_tree or booster.leaves_newton_update
            or booster.line_search_step_length):
        return False
    if tree_mod.fixed_grower_gaps(booster.grower, booster._cegb):
        return False
    if booster.feature_fraction < 1.0:
        return False
    if booster.bagging_freq > 0 and (
            booster.bagging_fraction < 1.0
            or booster.pos_bagging_fraction < 1.0
            or booster.neg_bagging_fraction < 1.0):
        return False
    if bool(booster.params.get("gpu_use_dp", False)):
        return False
    vec = gp._approx
    if type(vec).__name__ != "VecchiaGP" or vec.z is not None:
        return False
    if not vec.cov_fn.is_isotropic:
        return False
    cfg = gp.optim_cfg
    if cfg.optimizer_cov not in ("lbfgs", "lbfgs_linesearch_nocedal_wright"):
        return False
    if cfg.estimate_cov_par_index is not None or cfg.std_dev:
        return False
    if (is_gaussian and booster.device.type == "cuda"
            and vec._kernel_shape is None):
        return False
    return True


def _fns_for(booster):
    """(value-and-gradient fn, final fn, dtype) of the loop's refits:
    Gaussian = (the Vecchia NLL, the Psi^-1 solve); non-Gaussian = (the
    iterative Laplace NLL, d NLL / dF) from ``vecchia_fit.ng_device_vg``.
    Both cached on the VecchiaGP."""
    gp = booster.gp_model
    if gp.is_gaussian:
        return _vg_psi_for(gp._approx, gp.dtype)
    from gpboost_tpu_torch import likelihoods as lk
    from gpboost_tpu_torch.models import vecchia_fit
    fam = lk.get_family(gp.likelihood)
    init_cov = (gp.cov_pars_ if gp.cov_pars_ is not None
                else gp.optim_cfg.init_cov_pars)
    if init_cov is None:
        init_cov = gp._default_init_cov_pars(
            np.asarray(booster.train_set.label, np.float64))
    aux_fixed = getattr(gp, "aux_pars_", None)
    if aux_fixed is None:
        aux_fixed = fam.default_aux_pars(
            getattr(gp, "likelihood_additional_param", None))
    vg, grad_F = vecchia_fit.ng_device_vg(gp, len(init_cov), 0, aux_fixed,
                                          fam)
    return vg, grad_F, gp.dtype


def _host_reads():
    from gpboost_tpu_torch.models import optimizers
    from gpboost_tpu_torch.ops import cg
    return optimizers.lbfgs_device.host_reads + cg.pcg.host_reads


def train_device(booster, num_boost_round: int) -> None:
    """Run ``num_boost_round`` GPBoost / LaGaBoost rounds with the state on
    the device (the module's docstring), then materialise the trees, the
    score and the GP's state on ``booster`` and run the trailing refit.
    The booster is changed only after the loop and its fetch."""
    from gpboost_tpu_torch.models import optimizers

    ds = booster.train_set
    gp = booster.gp_model
    obj = booster.objective
    dev = booster.device
    n = ds.num_data
    R = int(num_boost_round)
    lr = float(booster.learning_rate)
    grower = _grower_of(booster)
    M = 2 * grower.num_leaves - 1
    is_gaussian = gp.is_gaussian
    vg_fn, aux_fn, kdt = _fns_for(booster)
    cfg = gp.optim_cfg
    y64 = np.asarray(ds.label, np.float64)
    resid0 = y64 - booster._score[:n]
    if gp.cov_pars_ is not None:
        init = np.asarray(gp.cov_pars_, np.float64)
    elif cfg.init_cov_pars is not None:
        init = np.asarray(cfg.init_cov_pars, np.float64)
    else:
        init = np.asarray(gp._default_init_cov_pars(
            resid0 if is_gaussian else y64), np.float64)
    captures0 = grower.captures
    reads0 = _host_reads()
    t0 = time.perf_counter()
    theta = torch.as_tensor(np.log(np.maximum(init, 1e-300)), dtype=kdt,
                            device=dev)
    y = torch.as_tensor(y64, dtype=torch.float64, device=dev)
    F = torch.as_tensor(booster._score[:n], dtype=torch.float64, device=dev)
    ones_h = torch.ones(n, dtype=torch.float32, device=dev)
    all_rows = torch.ones(n, dtype=torch.bool, device=dev)
    num_bins = torch.as_tensor(np.asarray(ds.num_bins), device=dev)
    fields = tree_mod.FIXED_NODE_FIELDS
    B = int(ds.max_num_bins)
    trees_t = torch.zeros((len(fields), R, M), dtype=torch.float64,
                          device=dev)
    catmask_t = torch.zeros((R, M * B), dtype=torch.float64, device=dev)
    num_leaves_t = torch.zeros(R, dtype=torch.float64, device=dev)
    nlls, iters, evals = [], [], []
    for i in range(R):
        with annotate("device_loop: round"):
            if is_gaussian:
                theta, v, k, aux, ne = optimizers.lbfgs_device_loop(
                    vg_fn, theta, cfg, kdt, (y - F).to(kdt), final_fn=aux_fn)
                g = (-aux).to(torch.float32)
            else:
                theta, v, k, aux, ne = optimizers.lbfgs_device_loop(
                    vg_fn, theta, cfg, kdt, y.to(kdt), F.to(kdt),
                    final_fn=aux_fn)
                g = aux.to(torch.float32)
            out = grower.grow(g, ones_h, all_rows, num_bins)
            F = F + (lr * out["leaf_value"])[out["row_leaf"].long()]
            for j, key in enumerate(fields):
                trees_t[j, i].copy_(out[key])
            catmask_t[i].copy_(out["catmask"].reshape(-1))
            num_leaves_t[i].copy_(out["num_leaves"])
        nlls.append(v)
        iters.append(k)
        evals.append(ne)
    # ONE fetch for the whole training run: it waits for the rounds' device
    # work, which a round does not (a trace's round window ends before its
    # replay has run)
    with annotate("device_loop: fetch"):
        host = torch.cat([trees_t.reshape(-1), catmask_t.reshape(-1),
                          num_leaves_t, F,
                          theta.to(torch.float64)]).cpu().numpy()
    t_run = time.perf_counter() - t0
    reads = _host_reads() - reads0 + 1
    size = len(fields) * R * M
    arrays = host[:size].reshape(len(fields), R, M)
    catmasks = host[size:size + R * M * B].reshape(R, M * B)
    size += R * M * B
    nl = host[size:size + R]
    F_host = host[size + R:size + R + n]
    theta_host = host[size + R + n:]
    tree_mod.check_finite_leaves(arrays[fields.index("leaf_value")],
                                 arrays[fields.index("is_leaf")],
                                 "device loop")
    if not np.all(np.isfinite(F_host)):
        raise ValueError("device loop: a score is not finite: a gradient or "
                         "hessian is not finite")

    trees = []
    for r in range(R):
        tr = tree_mod._fixed_tree(
            dict({k: arrays[j, r] for j, k in enumerate(fields)},
                 catmask=catmasks[r], num_leaves=nl[r], B=B), M)
        for node in tr.internal_nodes():
            if tr.is_categorical[node]:
                continue
            tr.threshold[node] = ds.threshold_value(
                int(tr.split_feature[node]), int(tr.threshold_bin[node]))
        tr.add_shrinkage(lr)
        tr.fixed_shape = True
        trees.append(tr)
    booster.trees = trees
    booster._score[:n] = F_host
    # the trailing refit at the final score through the host path
    # (gbdt.cpp:536-542): the GPModel's data, NLL and fit result, and the
    # objective's gradient cache, as the host loop leaves them
    gp.cov_pars_ = np.exp(theta_host)
    with annotate("device_loop: trailing refit"):
        obj.get_gradients(booster._score)
    booster.device_training_info_ = {
        "cov_nll": np.asarray(nlls, np.float64),
        "refit_iterations": np.asarray(iters, np.int64),
        "refit_evaluations": np.asarray(evals, np.int64),
        "device_seconds": float(t_run),
        "includes_compile": grower.captures > captures0,
        "host_reads": int(reads)}
    timing = (f"{t_run:.2f}s incl. the grower's graph capture"
              if grower.captures > captures0 else f"{t_run:.2f}s")
    log_info(f"[device_loop] {R} GPBoost rounds on the device ({timing}, "
             f"{int(np.sum(iters))} refit iterations, {reads} host reads)")
