#!/usr/bin/env python3
"""L-BFGS iterations and evaluations of each GP refit of a GPBoost training
with a full-scale Vecchia GP, in the port and in the JAX reference, on the
CPU (float64):

    JAX_PLATFORMS=cpu python3 tools/fsva_refit_counts.py [--n 2000] [--rounds 10]

The recipe is ``chip_smoke.py``'s ``fsva_boosting`` (the boosting data of
``make_boost_data`` on ``make_data``'s points, FSVA with m = 30 and the
default 500 inducing points, L-BFGS refits from [0.25, 1.0, 0.1]) at n
points. Prints one JSON line per package: the (evaluations, iterations) of
every refit (the JAX package records no evaluation count: null) and the
final covariance parameters. A CPU comparison with the reference, like the
tests; it runs nothing on a GPU.
"""
import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    import gpboost_tpu as gpb
    import gpboost_tpu_torch as gpt
    import chip_smoke as cs
    coords, y, _ = cs.make_data(0, args.n, 10)
    X, label, _ = cs.make_boost_data(0, y, 10)
    for name, pkg, kw in (("jax", gpb, {}), ("port", gpt, {"device": "cpu"})):
        gp = pkg.GPModel(gp_coords=coords, cov_function="exponential",
                         gp_approx="full_scale_vecchia", num_neighbors=30,
                         **kw)
        gp.set_optim_params({"optimizer_cov": "lbfgs",
                             "init_cov_pars": cs.LR_INIT})
        refits = []
        fit = gp.fit

        def recorded(*a, _fit=fit, _gp=gp, _out=refits, **k):
            out = _fit(*a, **k)
            res = _gp._fit_result
            _out.append([getattr(res, "num_evals", None), int(res.num_it)])
            return out

        gp.fit = recorded
        pkg.train(dict(cs.BOOST_PARAMS), pkg.Dataset(X, label=label, **kw),
                  gp_model=gp, num_boost_round=args.rounds)
        print(json.dumps({"package": name, "n": args.n,
                          "rounds": args.rounds,
                          "refits_evaluations_iterations": refits,
                          "cov_pars": np.asarray(gp.get_cov_pars()).tolist()}),
              flush=True)


if __name__ == "__main__":
    main()
