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
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "library_path", "sass_counts", "constexprs",
           "parse_constexprs", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("flash_fwd_f32mma", "flash_bwd_dq_f32mma", "flash_bwd_dkv_f32mma",
           "flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
           "flash_fwd_d256_wgmma", "flash_bwd_dq_d256_wgmma",
           "flash_bwd_dkv_d256_wgmma", "flash_fwd_f32_d256_wgmma",
           "flash_bwd_dq_f32_d256_wgmma", "flash_bwd_dkv_f32_d256_wgmma",
           "flash_fwd_d128_wgmma", "flash_bwd_dkv_d128_wgmma",
           "flash_bwd_dq_d128_wgmma", "flash_bwd_dkv_f32_d64_wgmma",
           "flash_bwd_dq_f32_d64_wgmma", "flash_fwd_f32_d64_wgmma",
           "flash_fwd_f32_d128_wgmma", "flash_bwd_dq_f32_d128_wgmma",
           "flash_bwd_dkv_f32_d128_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded = {}


def _tool(name):
    for cand in (shutil.which(name), f"/usr/local/cuda/bin/{name}"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found (PATH or /usr/local/cuda/bin): "
                       f"the CUDA kernels build on a machine with the CUDA "
                       f"toolkit")


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to, keyed by the sources' hash."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        if f.suffix == ".cuh" or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def constexprs(name):
    """The file-scope ``constexpr int NAME = expr;`` of ``csrc/<name>.cu``
    (tile sizes and the like), evaluated in order with C's integer
    division; an expression may name earlier constants."""
    return parse_constexprs((CSRC / f"{name}.cu").read_text())


def parse_constexprs(text):
    """:func:`constexprs` on the text of a source."""
    values = {}
    for const, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                  re.M):
        values[const] = eval(expr.replace("/", "//"),
                             {"__builtins__": {}}, dict(values))
    return values


def build(names=SOURCES):
    """Compile every library in ``names`` that is not built yet, all
    nvcc processes at once. Returns ``{name: seconds}`` for what was
    compiled; raises with nvcc's output on a failure. The compiler's
    report (``-Xptxas=-v``: registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``."""
    nvcc = _tool("nvcc")
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


def sass_counts(name, opcode):
    """``{kernel function: count}`` of the SASS instructions whose opcode
    starts with ``opcode`` (e.g. "HMMA", the tensor-core products) in
    each kernel of ``csrc/<name>.cu``'s built library, read with
    ``cuobjdump --dump-sass``. Function names are as compiled
    (mangled)."""
    out = subprocess.run([_tool("cuobjdump"), "--dump-sass",
                          str(library_path(name))],
                         capture_output=True, text=True, check=True).stdout
    return parse_sass_counts(out, opcode)


def parse_sass_counts(sass, opcode):
    """:func:`sass_counts` on the text of a ``cuobjdump --dump-sass``."""
    counts, fn = {}, None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and line.startswith("/*"):
            # "/*0c50*/  HMMA.16816.F32.BF16 R32, R40, R24, R32 ;  /* ... */"
            parts = line.split("*/", 1)[1].split()
            if parts and parts[0].startswith("@"):   # predicate
                parts = parts[1:]
            if parts and parts[0].startswith(opcode):
                counts[fn] += 1
    return counts
