#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``gpboost_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--n 100000] [--m 20] [--n-pred 10000]

Needs one NVIDIA GPU with ``nvcc`` on the machine; exits non-zero without
one. It

1. builds the CUDA kernels of ``gpboost_tpu_torch/csrc`` from source;
2. holds each kernel against its plain PyTorch version on the card, at the
   shapes the main path uses (all four covariance shapes, isotropic and ARD,
   neighbour sets with -1 padding), and times both;
3. drives the port's main path once through the public API at full size:
   ``GPModel`` construct (ordering + neighbour search), NLL, L-BFGS fit,
   prediction with variances — a Gaussian Vecchia GP with n = 100 000 points,
   m = 20 neighbours (40 for prediction), exponential covariance, float32 —
   and checks by the kernels' launch counters that it went through them;
4. checks the results against float64 plain versions.

One JSON object per line; any failed check raises (exit code non-zero). The
second to last line lists the kernels with their measurements, the last line
is ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import math
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
}
SOURCE = "gpboost_tpu_torch/csrc/vecchia_factors.cu"
SHAPES = (0.5, 1.5, 2.5, -1.0)


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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


def make_data(seed, n, n_pred):
    """The data recipe of the reference package's benchmark: uniform
    coordinates on the unit square, a smooth signal plus noise."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(size=(n, 2)).astype(np.float64)
    y = (np.sin(6 * coords[:, 0]) + np.cos(4 * coords[:, 1])
         + 0.5 * rng.standard_normal(n))
    pred = rng.uniform(size=(n_pred, 2)).astype(np.float64)
    return coords, y, pred


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
        grid = -(-n // 128)   # rows per block of the kernel
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
    c64, r64 = c32.double(), r32.double()

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
            lp = torch.log(cp)
            v_k, g_k = vk.vecchia_nll_grad(lp, c32, nb, r32, shape, ard=ard)
            torch.cuda.synchronize()
            v_k2, g_k2 = vk.vecchia_nll_grad(lp, c32, nb, r32, shape, ard=ard)
            check(torch.equal(v_k, v_k2) and torch.equal(g_k, g_k2),
                  "vecchia_nll_grad: two runs differ bit-wise")
            v32, g32 = vk.vecchia_nll_grad_plain(lp, c32, nb, r32, shape,
                                                 ard=ard)
            v64, g64 = vk.vecchia_nll_grad_plain(lp.double(), c64, nb, r64,
                                                 shape, ard=ard)
            rel = abs(float(v_k) - float(v64)) / abs(float(v64))
            check(rel < 1e-4, f"vecchia_nll_grad shape={shape} ard={ard}: "
                  f"relative NLL error {rel} vs float64 >= 1e-4")
            atol = 2e-2 * (n / 1500)
            e32 = (g_k - g32).abs()
            e64 = (g_k.double() - g64).abs()
            check(bool((e32 <= atol + 2e-3 * g32.abs()).all()),
                  f"vecchia_nll_grad shape={shape} ard={ard}: gradient "
                  f"{g_k.tolist()} vs float32 autograd {g32.tolist()}")
            check(bool((e64 <= atol + 1e-3 * g64.abs()).all()),
                  f"vecchia_nll_grad shape={shape} ard={ard}: gradient "
                  f"{g_k.tolist()} vs float64 autograd {g64.tolist()}")
            cases["vecchia_nll_grad"].append(dict(
                shape=shape, ard=ard, nll_rel_err_vs_f64=rel,
                grad_max_abs_err_vs_f64=float(e64.max()),
                grad_max_rel_err_vs_f64=float((e64 / g64.abs()).max()),
                max_abs_err=float(e64.max())))
            del v32, g32, v64, g64
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
        timed[tag] = dict(case=tag, n=int(nbrs.shape[0]),
                          m=int(nbrs.shape[1]), ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by)
    ms = time_ms(lambda: vk.vecchia_nll_grad(lp, c32, nb, r32, 0.5), 20)
    plain = time_ms(lambda: vk.vecchia_nll_grad_plain(lp, c32, nb, r32, 0.5),
                    5)
    b_ms, b_by = bound("vecchia_nll_grad", nb, d, n, True, 1)
    timed["nll_grad"] = dict(n=n, m=m, ms=ms, plain_ms=plain, bound_ms=b_ms,
                             bound_by=b_by)
    emit({"phase": "kernels_vs_plain", "cases": cases})
    return cases, timed


# ---------------------------------------------------------------------------
# phase 3: the main path through the public API
# ---------------------------------------------------------------------------

def main_path(coords, y, pred, m, seed, dev):
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.ops import vecchia as vops
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    vk.reset_launch_counts()
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
    launches = vk.launch_counts()

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
    return launches, timings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--n-pred", type=int, default=10_000)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        return 1
    # before anything is printed: without the package there is no result
    from gpboost_tpu_torch.ops.kernels import _build
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
    ptxas = [ln for name in libs for ln in _build.build_log(name).splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": sorted(libs), "ptxas": ptxas})

    coords, y, pred = make_data(args.seed, args.n, args.n_pred)
    t0 = time.perf_counter()
    cases, timed = check_kernels(coords, y, pred, args.m, args.seed, dev)
    t_check = time.perf_counter() - t0
    launches, timings = main_path(coords, y, pred, args.m, args.seed, dev)
    timings["vecchia_nll_grad_ms"] = timed["nll_grad"]["ms"]
    timings["kernel_checks_s"] = t_check
    emit({"timings": timings, "card": smi})

    kernels = []
    for name, key in (("vecchia_factors", "train"),
                      ("vecchia_nll_grad", "nll_grad")):
        t = timed[key]
        entry = {"name": name, "route": "cuda", "source": SOURCE,
                 "replaces": REPLACES[name], "launches": launches[name],
                 "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
                 "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None, "n": t["n"], "m": t["m"]}
        if name == "vecchia_factors":
            entry["other_shapes"] = [timed["predict"]]
        else:
            entry["max_abs_err_is"] = ("largest gradient component error vs "
                                       "float64 autograd")
        kernels.append(entry)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
