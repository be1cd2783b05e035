#!/usr/bin/env python3
"""Device time of the ``vecchia_nll_grad`` kernel of the checkout ``--root``
at n = 100 000 points and m = 20, 40, 64 neighbours.

    python3 tools/time_nll_grad.py [--root DIR]

The data, the parameters and the timing are those of ``chip_smoke.py``'s
kernel phase (its ``make_data`` and ``time_ms``, seed 0, exponential
covariance, isotropic), so that an older checkout, whose ``chip_smoke.py``
times the kernel at m = 20 only, can be timed at m = 40 and 64 in the same
run as this one. Needs an NVIDIA GPU; prints the card's name and power limit,
then one JSON object.
"""
import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(REPO))
    root = Path(ap.parse_args().root).resolve()
    if not torch.cuda.is_available():
        print("time_nll_grad: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sys.path.insert(0, str(root))
    from gpboost_tpu_torch.ops import vecchia as vops
    from gpboost_tpu_torch.ops.kernels import vecchia_factors as vk
    if not Path(vk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {vk.__file__}, not the one under {root}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    n = 100_000
    coords, y, _ = smoke.make_data(0, n, 0)
    perm = vops.apply_ordering(n, "random", 0)
    c32 = torch.as_tensor(coords[perm], dtype=torch.float32, device=dev)
    r32 = torch.as_tensor(y[perm], dtype=torch.float32, device=dev)
    lp = torch.log(torch.tensor([0.25, 1.0, 0.1], device=dev))
    times = {}
    for m in (20, 40, 64):
        nb = vops.find_neighbors(c32, m)
        times[m] = smoke.time_ms(
            lambda: vk.vecchia_nll_grad(lp, c32, nb, r32, 0.5), 20)
    print(json.dumps({"root": str(root), "n": n, "card": card,
                      "vecchia_nll_grad_ms_by_m": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
