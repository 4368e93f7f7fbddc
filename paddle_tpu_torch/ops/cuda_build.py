"""Builds the port's CUDA kernels from ``paddle_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface (``lib<name>-<hash>.so`` under
``paddle_tpu_torch/_build/``, which .gitignore lists), keyed by a hash of
the csrc sources and the flags, and loads with ctypes. Nothing builds at
import: the first launch builds what it needs, or a caller builds
everything up front with :func:`build` (one nvcc process per source,
all started together).
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "library_path", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd", "flash_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels build on a machine with the CUDA "
                       "toolkit")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, keyed by the sources' hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES):
    """Compile every library in ``names`` that is not built yet, all
    nvcc processes at once. Returns ``{name: seconds}`` for what was
    compiled; raises with nvcc's output on a failure. The compiler's
    report (``-Xptxas=-v``: registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    took, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        Path(f"{out}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name):
    """The ctypes handle of ``csrc/<name>.cu``'s library, built on first
    use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
