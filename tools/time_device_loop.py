#!/usr/bin/env python3
"""Seconds of ``train`` with the host loop and with the device-resident loop
(``device_resident_boosting="false"`` / ``"true"``) on the GPBoost recipe of
``chip_smoke.py`` (its ``make_data`` / ``make_boost_data``, seed 0: a
float32 Vecchia GP with m = 20 exponential neighbours, L-BFGS refits, 5
features, 31 leaves) at several rows and rounds, repeated.

    python3 tools/time_device_loop.py [--n 2000 10000 100000] \
        [--rounds 1 5 30] [--reps 3]

After one untimed training of each loop, for each n, R and repetition:
each loop on a new Dataset (cold: both capture the same fixed-shape grower
graph, since ``Booster.update`` grows with ``grow_tree_fast`` on the card),
then each again on its own Dataset with a new GP (warm: both replay it);
the two loops' order alternates between repetitions. Host clock around
work that ends in a synchronise. Needs an NVIDIA GPU; prints the card's
name and power limit, one JSON object a training, and one a (n, R) with
every time, the medians and the device loop's median / the host loop's.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[2_000, 10_000, 100_000])
    ap.add_argument("--rounds", type=int, nargs="+", default=[1, 5, 30])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_device_loop: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import gpboost_tpu_torch as gpt
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)

    def train(ds, coords, mode, R):
        gp = smoke._gp_model(coords, 20, 0, torch.float32, dev)
        params = dict(smoke.BOOST_PARAMS, device_resident_boosting=mode)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bst = gpt.train(params, ds, gp_model=gp, num_boost_round=R)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, bst

    # one untimed training of each loop first: the kernels' libraries, the
    # allocator and the first calls' one-time costs out of the times
    coords, y, _ = smoke.make_data(1, 2_000, 10)
    X, yb, _ = smoke.make_boost_data(1, y, 10)
    for mode in ("false", "true"):
        train(gpt.Dataset(X, label=yb, device=dev), coords, mode, 2)
    summary = []
    for n in args.n:
        coords, y, _ = smoke.make_data(0, n, 10)
        X, yb, _ = smoke.make_boost_data(0, y, 10)
        for R in args.rounds:
            times = {f"{loop}_{kind}": [] for loop in ("host", "device")
                     for kind in ("cold", "warm")}
            for rep in range(args.reps):
                order = (("false", "host"), ("true", "device"))
                if rep % 2:
                    order = order[::-1]
                ds = {loop: gpt.Dataset(X, label=yb, device=dev)
                      for _, loop in order}
                for kind in ("cold", "warm"):
                    for mode, loop in order:
                        t, bst = train(ds[loop], coords, mode, R)
                        engaged = "device_training_info_" in bst.__dict__
                        assert engaged == (loop == "device"), (loop, engaged)
                        times[f"{loop}_{kind}"].append(t)
                        print(json.dumps({
                            "n": n, "rounds": R, "rep": rep, "loop": loop,
                            "kind": kind, "s": t,
                            "train_mse": float(np.mean((yb - bst._score)
                                                       ** 2))}), flush=True)
                del ds, bst
                torch.cuda.empty_cache()
            med = {k: float(np.median(v)) for k, v in times.items()}
            out = {"n": n, "rounds": R, "reps": args.reps, "times_s": times,
                   "median_s": med,
                   "device_over_host_cold": med["device_cold"]
                   / med["host_cold"],
                   "device_over_host_warm": med["device_warm"]
                   / med["host_warm"]}
            summary.append(out)
            print(json.dumps({"case": out}), flush=True)
    print(json.dumps({"summary": [
        {k: c[k] for k in ("n", "rounds", "median_s",
                           "device_over_host_cold", "device_over_host_warm")}
        for c in summary]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
