"""The port's profiling glue (``utils/profiler.py``), the counterpart of the
JAX package's ``utils/profiler.py``: ``trace`` writes a Chrome / Perfetto
trace that holds the names of ``annotate``'s ranges, ranges nest (the
inner one inside the outer one on the profiler's timeline), and
``device_memory_profile`` raises without a GPU and writes the CUDA
allocator's snapshot with one (marker ``gpu``)."""
import json
import pickle

import pytest
import torch

from gpboost_tpu_torch.utils import profiler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests (the suite runs in several
    worker processes at once)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trace_writes_a_file_with_the_annotations(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("gpboost-fit"):
            torch.ones(100).cumsum(0)
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert prof.trace_path.startswith(str(tmp_path))
    assert any(e.get("name") == "gpboost-fit" for e in events)


def test_annotations_nest(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("outer"):
            torch.ones(10).sum()
            with profiler.annotate("inner"):
                torch.ones(10).sum()
    spans = {e.name: e.time_range for e in prof.events()
             if e.name in ("outer", "inner")}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"].start <= spans["inner"].start
    assert spans["inner"].end <= spans["outer"].end


def test_device_memory_profile_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the raise is the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiler.device_memory_profile(str(tmp_path / "snap.pickle"))


@pytest.mark.gpu
def test_device_memory_profile_writes_a_snapshot(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the snapshot is the CUDA caching "
                    "allocator's")
    x = torch.ones(1 << 20, device="cuda")
    path = tmp_path / "snap.pickle"
    profiler.device_memory_profile(str(path))
    with open(path, "rb") as f:
        snap = pickle.load(f)
    assert snap["segments"] and x.is_cuda
