#!/usr/bin/env python3
"""Time of one censored Laplace value-and-gradient, with the censored
branches evaluated on their own rows only and with every row evaluated and
the branch selected.

    python3 tools/time_censored_rows.py [--n 100000] [--reps 2] [--device cuda]

The data are ``chip_smoke.py``'s censored GLMM (``make_censored_data``,
seed 0: a random intercept on 1 000 levels, ~2.5 % exact 0s and as many 1s
for the transformed beta, ~0.1 % 0s and ~38 % 1s for the shifted gamma),
its first ``--n`` rows, float64; the call is the grouped Laplace route's
``nll_laplace_value_and_grad`` at the family's default auxiliary
parameters. ``rows`` is the package's ``likelihoods._on_rows``: the
incomplete beta / gamma of a censored branch, and its nested shape
quadratures, run on the rows that take the branch. ``select`` evaluates them
on every row and selects, as the JAX package does. The two run in the order
rows, select, select, rows; each time is the median of ``--reps`` calls after
one warm-up, with the device synchronised around each call. Prints the
card's name and power limit (on a GPU), then one JSON object a family: the
seconds a call, the peak device memory, and the largest relative difference
of the two routes' values and gradients.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def select(mask, fn, *args):
    """``fn(*args)`` on every entry, 0 where ``mask`` does not hold."""
    shape = torch.broadcast_shapes(mask.shape, *(a.shape for a in args))
    out = fn(*(a.expand(shape) for a in args))
    return torch.where(mask.expand(shape), out, torch.zeros_like(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("time_censored_rows: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch import likelihoods as lk
    from gpboost_tpu_torch.models import grouped
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cd = smoke.make_censored_data(0)
    rows = slice(0, args.n)
    x = torch.tensor(cd["X"][rows, 1], device=dev)
    for lik, ykey in ((smoke.ZOCB, "y_beta"), (smoke.ZOCG, "y_gamma")):
        y = cd[ykey][rows]
        Z = gpt.GPModel(group_data=cd["group"][rows], likelihood=lik,
                        device=dev)._Z
        y_t = torch.tensor(y, device=dev)
        cp = torch.tensor([0.3], dtype=torch.float64, device=dev)
        aux = torch.tensor(lk.get_family(lik).default_aux_pars(),
                           device=dev)
        F = 0.8 * x

        def call():
            sync()
            t0 = time.perf_counter()
            out = grouped.nll_laplace_value_and_grad(Z, lik, cp, aux, y_t, F)
            sync()
            return time.perf_counter() - t0, out

        on_rows = lk._on_rows
        res = {}
        for name in ("rows", "select", "select", "rows"):
            lk._on_rows = on_rows if name == "rows" else select
            try:
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats(dev)
                _, out = call()
                secs = [call()[0] for _ in range(args.reps)]
            finally:
                lk._on_rows = on_rows
            r = res.setdefault(name, {"seconds": [], "out": out})
            r["seconds"].append(statistics.median(secs))
            if dev.type == "cuda":
                r["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        diffs = []
        for a, b in zip(res["rows"]["out"], res["select"]["out"]):
            a, b = (t.detach().double().cpu().numpy() for t in (a, b))
            diffs.append(float(np.max(np.abs(a - b))
                               / max(np.max(np.abs(a)), 1e-300)))
        print(json.dumps({
            "likelihood": lik, "n": len(y), "device": str(dev),
            "zeros": int(np.sum(y == 0)), "ones": int(np.sum(y == 1)),
            **{f"{k}_s": v["seconds"] for k, v in res.items()},
            **{f"{k}_peak_gb": v.get("peak_gb") for k, v in res.items()},
            "max_rel_diff": max(diffs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
