"""Named wall-clock timers (reference ``Timer``/``FunctionTimer``,
``include/LightGBM/utils/common.h:989-1073``, compiled in with USE_TIMETAG).

Enable with ``GPBOOST_TORCH_TIMETAG=1`` (or ``enable()``); nested scopes
accumulate per name and ``report()`` prints the table like the reference's
atexit dump. CUDA work is asynchronous: a scope that should include the
device time of what it enqueued passes ``sync=True``, which calls
``torch.cuda.synchronize()`` before the clock is read. For kernel-level
profiles use ``torch.profiler`` or CUDA events.
"""
from __future__ import annotations

import atexit
import os
import time
from collections import defaultdict
from contextlib import contextmanager

_ENABLED = os.environ.get("GPBOOST_TORCH_TIMETAG", "0") not in (
    "0", "", "false")
_ACC: dict = defaultdict(float)
_COUNT: dict = defaultdict(int)


def enable(on: bool = True):
    global _ENABLED
    _ENABLED = on


def enabled() -> bool:
    return _ENABLED


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextmanager
def timed(name: str, sync: bool = False):
    """RAII-style scope timer (reference ``FunctionTimer``)."""
    if not _ENABLED:
        yield
        return
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            _sync()
        _ACC[name] += time.perf_counter() - t0
        _COUNT[name] += 1


def totals() -> dict:
    """{name: (seconds, calls)} accumulated so far."""
    return {name: (_ACC[name], _COUNT[name]) for name in _ACC}


def clear() -> None:
    """Forget what was accumulated."""
    _ACC.clear()
    _COUNT.clear()


def report(reset: bool = False) -> str:
    lines = ["gpboost_tpu_torch timers:"]
    for name in sorted(_ACC, key=lambda k: -_ACC[k]):
        lines.append(f"  {name}: {_ACC[name]:.3f}s ({_COUNT[name]} calls)")
    out = "\n".join(lines)
    if reset:
        clear()
    return out


@atexit.register
def _report_at_exit():
    if _ENABLED and _ACC:
        print(report())
