"""Build and load the port's CUDA kernels (`velocycle_tpu_torch/csrc/`).

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded with `ctypes`.  Builds happen at first use, into
``build/velocycle_tpu_torch/`` beside the package (listed in .gitignore;
`warmup.enable_compile_cache` points ``BUILD_DIR`` elsewhere), named by a
hash of the sources so an edited source rebuilds.  `build_all`
starts one ``nvcc`` per source, all at once.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "DEFAULT_BUILD_DIR", "build_all", "load",
           "build_log", "build_seconds", "loaded"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
                     / "velocycle_tpu_torch")
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# per source: nb_velo.cu and nb_wide.cu instantiate their bodies for every
# (S, U) count-type pair, so their compiler optimizations run on all of the
# machine's cores
SOURCE_FLAGS = {"nb_velo": ["-split-compile=0"], "nb_wide": ["-split-compile=0"]}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_LOGS: dict[str, str] = {}
_SECONDS: dict[str, float] = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME, CUDA_PATH): the port's CUDA "
            "kernels are built from source at first use"
        )
    return str(path)


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS + SOURCE_FLAGS.get(name, [])).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is built; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, []), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, (proc, tmp, time.perf_counter())


def _finish(name, target, pending):
    if pending is None:
        _LOGS.setdefault(name, f"{target.name}: already built")
        return
    proc, tmp, t0 = pending
    out, _ = proc.communicate()
    _SECONDS[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
    os.replace(tmp, target)   # atomic: a concurrent build never sees a half-written file
    _LOGS[name] = out


def build_all(names=None):
    """Build every csrc/*.cu (or the given stems), one nvcc each, all
    started before any is waited for."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    with _LOCK:
        started = {n: _start(n) for n in names if n not in _LIBS}
        for n, (target, pending) in started.items():
            _finish(n, target, pending)


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers / shared memory / spills) for the last
    build of csrc/<name>.cu in this process."""
    return _LOGS.get(name, "")


def build_seconds(name: str):
    """Seconds from the start of nvcc for csrc/<name>.cu to its end, for
    the last build in this process (None if it was built before)."""
    return _SECONDS.get(name)


def loaded() -> list[str]:
    """The stems of the libraries this process has loaded (from
    ``BUILD_DIR``)."""
    return sorted(_LIBS)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_target(name)))
        return _LIBS[name]
