"""Build, load and launch helpers of the port's CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first use, then loaded
with ``ctypes``. No PyTorch headers are involved, so a build takes seconds.
The build directory is not under version control; a library is rebuilt
whenever its source changes (the hash of the source is part of its name).

``build_all()`` starts one ``nvcc`` per source, all together, and waits for
them; ``load(name)`` builds a single source on demand. ``check_tensor``,
``raise_on_error`` and ``current_stream`` are what every wrapper does around
a launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict = {}


def sources() -> list[str]:
    """Names of the kernel sources in ``csrc/``."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, final) or None
    when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.nvcc.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> dict:
    """Build every kernel source, one ``nvcc`` process per source, all
    started together. Returns {name: path of the shared library}."""
    started = {name: _start(name) for name in sources()}
    for name, st in started.items():
        _finish(name, st)
    return {name: str(_lib_path(name)) for name in started}


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for ``name`` (registers, spills)."""
    path = BUILD_DIR / f"{name}.nvcc.log"
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise a ``ValueError`` naming the argument a kernel does not take."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: lies on {t.device}, the kernel runs on "
                         f"{device} (all arguments must share one device)")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")


def current_stream() -> int:
    """PyTorch's current CUDA stream as the integer a launcher takes."""
    return torch.cuda.current_stream().cuda_stream
