#!/usr/bin/env python3
"""Whether an exact Laplace fit's bits move with the autograd engine's
sequence counters.

    python3 tools/autograd_order_probe.py [--n 5000] [--device cuda]

PyTorch's autograd engine runs a backward pass on a worker thread of its own
on a GPU, and orders the nodes that are ready by a sequence number that each
thread counts for itself. The fit here is the first refit of exact LaGaBoost
in ``chip_smoke.py`` (``make_exact_boost_data``, seed 0: an exponential GP,
``bernoulli_logit``, the fixed effects at the logit of the mean label,
default optimizer). It runs once, then after graphs whose create_graph
backward builds nodes on the engine's worker (so that the worker's counter
passes the caller's), then after forward graphs that put the caller's counter
ahead again. It does so twice: with the port's backward passes on the
calling thread (``gpboost_tpu_torch.utils.autograd.grad``, the package as it
is) and with ``torch.autograd.grad`` in its place (the engine's worker
thread, as the port ran before). Prints the card's name and power limit (on
a GPU), then one JSON object a fit: the route, both counters before it, the
NLL in hex and whether NLL and covariance parameters equal the route's first
fit to the bit.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def counters(dev):
    """(the calling thread's sequence number, the worker's)."""
    x = torch.ones(2, dtype=torch.float64, device=dev, requires_grad=True)
    y = x * 2.0
    (g,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
    return y.grad_fn._sequence_nr(), g.grad_fn._sequence_nr()


def worker_nodes(dev, k):
    x = torch.rand(4, dtype=torch.float64, device=dev, requires_grad=True)
    y = x
    for _ in range(k):
        y = torch.sin(y) * 1.0001
    torch.autograd.grad(y.sum(), x, create_graph=True)


def caller_nodes(dev, k):
    x = torch.rand(4, dtype=torch.float64, device=dev, requires_grad=True)
    y = x
    for _ in range(k):
        y = y * 1.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=5_000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("autograd_order_probe: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import gpboost_tpu_torch as gpt
    from gpboost_tpu_torch.utils import autograd as ag
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    bd = smoke.make_exact_boost_data(0, args.n, 100)
    label = bd["ybin"]
    p = float(np.clip(label.mean(), 1e-12, 1 - 1e-12))
    score = np.full(len(label), np.log(p / (1 - p)))

    def fit():
        gp = gpt.GPModel(gp_coords=bd["coords"], cov_function="exponential",
                         likelihood="bernoulli_logit", device=dev)
        gp.fit(y=label, fixed_effects=score, params={})
        return gp.current_nll_, gp.get_cov_pars().tolist()

    on_caller = ag.grad
    for route in ("calling_thread", "engine_worker"):
        ag.grad = on_caller if route == "calling_thread" else \
            torch.autograd.grad
        try:
            first = None
            for step in ("first", "worker_ahead", "caller_ahead"):
                caller, worker = counters(dev)
                if step == "worker_ahead":
                    worker_nodes(dev, max(0, caller - worker) // 2 + 20_000)
                elif step == "caller_ahead":
                    caller_nodes(dev, max(0, worker - caller) + 20_000)
                seq = counters(dev)
                out = fit()
                first = first or out
                print(json.dumps({
                    "route": route, "step": step, "n": args.n,
                    "caller_counter": seq[0], "worker_counter": seq[1],
                    "nll_hex": float(out[0]).hex(), "cov_pars": out[1],
                    "same_bits_as_first": out == first}), flush=True)
        finally:
            ag.grad = on_caller
    return 0


if __name__ == "__main__":
    sys.exit(main())
