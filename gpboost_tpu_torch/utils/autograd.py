"""Reverse-mode derivatives with the backward pass on the calling thread.

On a GPU, PyTorch's autograd engine runs a backward pass on a worker thread
of its own, and it orders the nodes that are ready to run by a sequence
number that each thread counts for itself. The likelihoods' derivatives in
the location are nested ``grad(create_graph=True)`` calls, so their graphs
are built inside a backward pass: their nodes carry the worker's numbers,
the rest of the graph the caller's. Which of two such nodes runs first then
depends on how many nodes each thread built before, anywhere in the process,
and with it the order in which gradients are summed: the last bits of a fit
would move with whatever ran before it (a Matern of general order, whose
chunked backward builds its graphs on the worker, moved an exact LaGaBoost
training's covariance parameters). On the calling thread every node is
numbered by one counter, in the order the program created it, so the same
calls give the same bits. On the CPU the engine uses the calling thread
anyway.
"""
from __future__ import annotations

import torch


def grad(*args, **kwargs):
    """``torch.autograd.grad`` (same arguments) on the calling thread."""
    with torch.autograd.set_multithreading_enabled(False):
        return torch.autograd.grad(*args, **kwargs)
