"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface.  The library lands in ``dreamer_tpu_torch/_build/<hash>/``,
keyed by a hash of every file under ``csrc/`` (the sources and the headers
they include) and the flags, so a second run with unchanged files loads it
without building.  No header of PyTorch is compiled: that
keeps a cold build to seconds.

Nothing here runs at import: the build starts on the first ``library()`` call,
which a kernel wrapper makes when it is handed a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIB_NAME = "libdreamer_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: Optional[ctypes.CDLL] = None
_declared: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> Sequence[Path]:
    """The translation units: one ``nvcc`` each."""
    return sorted(CSRC_DIR.glob("*.cu"))


def files() -> Sequence[Path]:
    """Every file under ``csrc/``: the sources and the headers they include."""
    return sorted(p for p in CSRC_DIR.rglob("*") if p.is_file())


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files():
        h.update(str(src.relative_to(CSRC_DIR)).encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless this exact build exists; returns
    the library's path.  The compiler's resource report (``-Xptxas -v``) is
    kept beside it as ``build.log``."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp_lib, *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log.append(f"== built in {time.perf_counter() - start:.2f} s")
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent loader sees all or nothing
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.dt_error_string.argtypes = [ctypes.c_int]
        lib.dt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def kernel_fn(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` of the library with its argument types set:
    ``c_void_p`` for each pointer and the stream, ``c_int`` for each size."""
    fn = _declared.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _declared[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch was refused
    or an earlier call on this thread failed)."""
    if status != 0:
        msg = library().dt_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status}: {msg}")
