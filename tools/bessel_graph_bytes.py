#!/usr/bin/env python3
"""Bytes that the autograd graph of the traced-order Matern series
(``gpboost_tpu_torch/ops/cov_fns.py::_matern_traced``) saves for each
entry of its input, float64, on the CPU; and what that makes at the shape
of a Vecchia build with n = 1e5 points and m = 20 neighbours ([n, m, m]
plus [n, m] entries). This is why above ``cov_fns.BESSEL_CHUNK`` entries
the series runs in chunks with a recomputing backward (``_Chunked``).

    python3 tools/bessel_graph_bytes.py [--entries 200000]
"""
import argparse

import torch

from gpboost_tpu_torch.ops import cov_fns


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=200_000)
    args = ap.parse_args()
    x = (torch.rand(args.entries, dtype=torch.float64) * 8.0
         ).requires_grad_(True)
    nu = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    saved = {}

    def pack(t):
        # tensors of the input's size; scalars of the order are negligible
        if t.numel() >= args.entries:
            saved[t.data_ptr()] = t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        cov_fns._matern_traced(x, nu).sum()
    per_entry = sum(saved.values()) / args.entries
    vecchia = 1e5 * 20 * 20 + 1e5 * 20
    print(f"saved bytes per entry: {per_entry:.0f}")
    print(f"at n = 1e5, m = 20 ({vecchia:.3g} entries): "
          f"{per_entry * vecchia / 1e9:.1f} GB")


if __name__ == "__main__":
    main()
