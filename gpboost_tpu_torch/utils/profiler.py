"""Profiling glue: ``torch.profiler`` traces, named annotations and the
CUDA caching allocator's memory snapshot.

The counterpart of the JAX package's ``utils/profiler.py``. Usage::

    from gpboost_tpu_torch.utils import profiler

    with profiler.trace("traces/fit") as prof:
        model.fit(y=y)

    with profiler.annotate("factor-build"):
        ...

    profiler.device_memory_profile("snapshot.pickle")

``trace`` writes a Chrome / Perfetto trace (open it in ``ui.perfetto.dev``
or ``chrome://tracing``) with the host's operator calls and, on a CUDA
machine, the kernels, copies and memsets on the device. Wall-clock timers
live in :mod:`gpboost_tpu_torch.utils.timer`.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: host activity always, the device's too when CUDA
    is available. On exit the trace is written as Chrome / Perfetto JSON to
    ``logdir/trace_<pid>_<ns>.json``; the block receives the
    ``torch.profiler.profile`` object, so that ``prof.events()`` can be read
    after the block, and the file's path is ``prof.trace_path``."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    prof.trace_path = path


@contextlib.contextmanager
def annotate(name: str):
    """A named range on the profiler's timeline (``record_function``) and,
    on a CUDA machine, on the NVTX timeline of an outside tool. Ranges
    nest."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def device_memory_profile(path: str) -> None:
    """Write the CUDA caching allocator's snapshot
    (``torch.cuda.memory._snapshot()``: its segments, blocks and, when
    ``torch.cuda.memory._record_memory_history`` is on, the stacks that
    allocated them) to ``path``. The format is torch's pickle, which
    ``torch.cuda._memory_viz`` and ``pytorch.org/memory_viz`` read, not the
    pprof profile that the JAX package writes. Raises ``RuntimeError``
    without a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile: no CUDA device; the "
                           "memory snapshot is the CUDA allocator's")
    snapshot = torch.cuda.memory._snapshot()
    with open(path, "wb") as f:
        pickle.dump(snapshot, f)
